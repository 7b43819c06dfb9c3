"""The port's NTT plain versions (tpu_fhe_torch.ops.ntt on the CPU) against
tpu_fhe: bit-identical per limb to the XLA path at N = 1024 and 4096, and to
the interpret-mode Pallas kernels K1 (forward), K2 (inverse, scaled) and
K3 (fused forward landing) at N = 1024."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_fhe.core.ntt_tables import compute_shoup, make_ntt_tables as j_make_ntt_tables
from tpu_fhe.ops import ntt as jntt
from tpu_fhe.ops.w64 import W64

from tpu_fhe_torch.core import numth
from tpu_fhe_torch.core.ntt_tables import golden_forward_ntt, make_ntt_tables
from tpu_fhe_torch.ops import ntt
from tpu_fhe_torch.utils.convert import to_numpy, to_tensor

# The suite runs in several worker processes at once: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

VIEW = [2, 0]   # a limb-mapped view of the 3-limb key tables
PALLAS_VIEW = [2]  # one limb keeps the interpret-mode kernels quick


def _primes(n):
    return numth.get_primes(n, 50, 2) + numth.get_primes(n, 60, 1)


@pytest.fixture(scope="module", params=[1024, 4096])
def case(request):
    n = request.param
    log_n = n.bit_length() - 1
    qs = _primes(n)
    ours = ntt.build_device_ntt_tables([make_ntt_tables(log_n, q) for q in qs], "cpu")
    ref = jntt.build_device_ntt_tables([j_make_ntt_tables(log_n, q) for q in qs])
    vq = np.array([qs[i] for i in VIEW], dtype=np.uint64)
    rng = np.random.default_rng(n)

    def residues(*lead):
        return rng.integers(0, 2**62, size=lead + (len(VIEW), n), dtype=np.uint64) \
            % vq[:, None]

    scales = {}
    for name, v in (("post", 12345), ("pre", 65537)):
        s = np.array([[numth.invert_mod(v, int(q))] for q in vq], dtype=np.uint64)
        scales[name] = (s, np.array([[compute_shoup(int(x), int(q))] for x, q in zip(s[:, 0], vq)],
                                    dtype=np.uint64))
    x, sub = residues(2), residues(2)
    view = ref.slice_limbs(VIEW)
    (s, ss), (p, ps) = scales["post"], scales["pre"]

    def reference(v, w):
        return dict(
            fwd=jntt.forward_ntt(v, view),
            inv=jntt.inverse_ntt(v, view),
            inv_scaled=jntt.inverse_ntt_scaled(v, view, s, ss),
            sub_scale=jntt.forward_ntt_sub_scale(v, w, view, s, ss),
            sub_scale_pre=jntt.forward_ntt_sub_scale(v, w, view, s, ss, pre=p, pre_shoup=ps),
        )

    out = jax.jit(reference)(jnp.asarray(x), jnp.asarray(sub))
    return dict(n=n, qs=qs, ours=ours.slice_limbs(VIEW), x=x, sub=sub, scales=scales,
                ref={k: np.asarray(v) for k, v in out.items()})


def _pt(case, name):
    return tuple(to_tensor(v, "cpu") for v in case["scales"][name])


def test_forward_matches_xla_and_golden(case):
    got = to_numpy(ntt.forward_ntt(to_tensor(case["x"], "cpu"), case["ours"]))
    np.testing.assert_array_equal(got, case["ref"]["fwd"])
    tab = make_ntt_tables(case["n"].bit_length() - 1, case["qs"][VIEW[0]])
    np.testing.assert_array_equal(got[1, 0], np.array(golden_forward_ntt(case["x"][1, 0], tab),
                                                      dtype=np.uint64))


def test_inverse_matches_xla(case):
    x = to_tensor(case["x"], "cpu")
    got = to_numpy(ntt.inverse_ntt(x, case["ours"]))
    np.testing.assert_array_equal(got, case["ref"]["inv"])
    back = ntt.forward_ntt(ntt.inverse_ntt(x, case["ours"]), case["ours"])
    np.testing.assert_array_equal(to_numpy(back), case["x"])


def test_inverse_scaled_matches_xla(case):
    got = to_numpy(ntt.inverse_ntt_scaled(to_tensor(case["x"], "cpu"), case["ours"],
                                          *_pt(case, "post")))
    np.testing.assert_array_equal(got, case["ref"]["inv_scaled"])


@pytest.mark.parametrize("with_pre", [False, True])
def test_forward_sub_scale_matches_xla(case, with_pre):
    got = to_numpy(ntt.forward_ntt_sub_scale(
        to_tensor(case["x"], "cpu"), to_tensor(case["sub"], "cpu"), case["ours"],
        *_pt(case, "post"), *(_pt(case, "pre") if with_pre else (None, None))))
    np.testing.assert_array_equal(got, case["ref"]["sub_scale_pre" if with_pre else "sub_scale"])


# -- against the Pallas kernel bodies themselves, in interpret mode ---------

@pytest.fixture
def small(monkeypatch):
    monkeypatch.setenv("TPU_FHE_PALLAS", "always")
    n = 1024
    qs = _primes(n)
    ours = ntt.build_device_ntt_tables([make_ntt_tables(10, q) for q in qs], "cpu")
    ref = jntt.build_device_ntt_tables([j_make_ntt_tables(10, q) for q in qs])
    vq = np.array([qs[i] for i in PALLAS_VIEW], dtype=np.uint64)
    rng = np.random.default_rng(3)
    x = rng.integers(0, 2**62, size=(len(PALLAS_VIEW), n), dtype=np.uint64) % vq[:, None]
    s = np.array([[numth.invert_mod(777, int(q))] for q in vq], dtype=np.uint64)
    ss = np.array([[compute_shoup(int(a), int(q))] for a, q in zip(s[:, 0], vq)], np.uint64)
    return ours.slice_limbs(PALLAS_VIEW), ref.slice_limbs(PALLAS_VIEW), x, s, ss


def test_forward_matches_pallas_k1(small):
    ours, ref, x, _, _ = small
    got = to_numpy(ntt.forward_ntt(to_tensor(x, "cpu"), ours))
    np.testing.assert_array_equal(got, jntt.forward_ntt(W64.from_np(x), ref).to_np())


def test_inverse_scaled_matches_pallas_k2(small):
    ours, ref, x, s, ss = small
    got = to_numpy(ntt.inverse_ntt_scaled(to_tensor(x, "cpu"), ours, to_tensor(s, "cpu"),
                                          to_tensor(ss, "cpu")))
    np.testing.assert_array_equal(
        got, jntt.inverse_ntt_scaled(W64.from_np(x), ref, s, ss).to_np())


def test_forward_sub_scale_matches_pallas_k3(small):
    ours, ref, x, s, ss = small
    sub = (x[:, ::-1] * np.uint64(3)) % to_numpy(ours.q)
    t = lambda v: to_tensor(v, "cpu")  # noqa: E731
    got = to_numpy(ntt.forward_ntt_sub_scale(t(x), t(sub), ours, t(s), t(ss), t(s), t(ss)))
    ref_out = jntt.forward_ntt_sub_scale(W64.from_np(x), W64.from_np(sub), ref, s, ss,
                                         pre=s, pre_shoup=ss).to_np()
    np.testing.assert_array_equal(got, ref_out)
