"""The port's hybrid keyswitch on the CPU against tpu_fhe, bit for bit per
RNS limb: multiply, base conversion, the Shoup-key inner product, modup,
moddown, relinearize and rescale at N = 1024 and 4096 on a chain with beta = 3 and
a ragged last digit; the inner product (K8) and base conversion (K11)
also against their interpret-mode Pallas bodies at N = 1024.

The same key and inputs, made from a seed with numpy, go to both packages.
The key is random (not a valid encryption), which bit-identity does not
need; its Shoup words are exact Python-integer divisions."""

import functools

import jax
import numpy as np
import pytest
import torch

from tpu_fhe.core.modulus import CoeffModulus as JCoeffModulus
from tpu_fhe.core.params import EncryptionParameters as JParams, SchemeType as JScheme
from tpu_fhe.eval import evaluator as jev
from tpu_fhe.ops import bconv as jbconv
from tpu_fhe.ops.w64 import W64
from tpu_fhe.scheme.ciphertext import Ciphertext as JCiphertext
from tpu_fhe.scheme.context import FheContext as JContext
from tpu_fhe.scheme.keys import RelinKey as JRelinKey

from tpu_fhe_torch.core.modulus import CoeffModulus
from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
from tpu_fhe_torch.eval import evaluator as ev
from tpu_fhe_torch.ops.bconv import bconv_matmul
from tpu_fhe_torch.scheme.context import FheContext
from tpu_fhe_torch.utils.convert import (
    ciphertext_from_np, relin_key_from_np, to_numpy, to_tensor,
)

# The suite runs in several worker processes at once: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

BITS = [60, 50, 50, 50, 50, 60, 60]
SCALE = 2.0 ** 50
RAGGED = 2          # the last digit of beta = 3 holds one limb


@functools.lru_cache(maxsize=None)
def contexts(n):
    """The reference's and the port's contexts at ring size n (cached, so
    that every test module in one process shares the compiled reference)."""
    jctx = JContext(JParams(scheme=JScheme.ckks, poly_modulus_degree=n,
                            coeff_modulus=tuple(JCoeffModulus.create(n, BITS)),
                            special_modulus_size=2, allow_insecure=True))
    tctx = FheContext(EncryptionParameters(
        SchemeType.ckks, n, tuple(CoeffModulus.create(n, BITS)),
        special_modulus_size=2, allow_insecure=True), device="cpu")
    return jctx, tctx


@functools.lru_cache(maxsize=None)
def jax_reference(n):
    """One jitted tpu_fhe program per ring size: multiply two ciphertexts
    at chain index 1, relinearize the product under a Shoup-form key
    (recording the modup, inner-product and moddown outputs on the way),
    rescale the result, and base-convert one digit's residues.  Key and
    inputs are arguments, so every caller reuses the compiled program."""
    jctx, _ = contexts(n)
    jl = jctx.level(1)
    dt = jl.ks.digits[RAGGED]

    def reference(ca, cb, key_data, key_shoup, s):
        seen = {}

        def record(name, fn):
            def wrapped(*args, **kw):
                seen[name] = out = fn(*args, **kw)
                return out
            return wrapped

        key = JRelinKey(key_data, key_shoup)
        ct = jev.multiply(jctx, JCiphertext(ca, chain_index=1, scale=SCALE),
                          JCiphertext(cb, chain_index=1, scale=SCALE))
        with pytest.MonkeyPatch.context() as mp:
            for name in ("modup", "key_inner_product", "moddown_from_ntt"):
                mp.setattr(jev, name, record(name, getattr(jev, name)))
            relin = jev.relinearize(jctx, ct, key)
        return dict(
            prod=ct.data, modup=seen["modup"], inner=seen["key_inner_product"],
            moddown=seen["moddown_from_ntt"], relin=relin.data,
            rescale=jev.rescale_to_next(jctx, relin).data,
            bconv=jbconv.bconv_matmul(s, dt.qhat_mod_p, dt.comp_mod.q,
                                      dt.comp_mod.ratio_lo, dt.comp_mod.ratio_hi),
        )

    fn = jax.jit(reference)

    def run(ca, cb, key_data, key_shoup, s):
        out = fn(*(W64.from_np(a) for a in (ca, cb, key_data, key_shoup, s)))
        return {k: v.to_np() for k, v in out.items()}
    return run


def uniform(rng, qs, lead, n):
    q = np.asarray(qs, dtype=np.uint64)[:, None]
    return rng.integers(0, 2**62, size=tuple(lead) + (len(qs), n), dtype=np.uint64) % q


def _random_key(rng, ctx_qs, dnum, n):
    data = uniform(rng, ctx_qs, (dnum, 2), n)
    q = np.asarray(ctx_qs, dtype=object)[:, None]
    shoup = ((data.astype(object) << 64) // q).astype(np.uint64)
    return data, shoup


def ragged_digit_input(rng, tctx):
    dt = tctx.level(1).ks.digits[RAGGED]
    return uniform(rng, list(tctx.level(1).base.values)[dt.start:dt.end], (2,), tctx.n)


@pytest.fixture(scope="module", params=[1024, 4096])
def case(request):
    n = request.param
    _, tctx = contexts(n)
    rng = np.random.default_rng(n)
    key_qs = [m.value for m in tctx.key_modulus]
    kdata, kshoup = _random_key(rng, key_qs, 3, n)
    ca, cb = (uniform(rng, list(tctx.level(1).base.values), (2,), n) for _ in range(2))
    s = ragged_digit_input(rng, tctx)
    return dict(tctx=tctx, ca=ca, cb=cb, s=s, key=relin_key_from_np(tctx, kdata, kshoup),
                ref=jax_reference(n)(ca, cb, kdata, kshoup, s))


def test_multiply_matches_reference(case):
    tctx = case["tctx"]
    a, b = (ciphertext_from_np(tctx, case[k], chain_index=1, scale=SCALE) for k in ("ca", "cb"))
    got = ev.multiply(tctx, a, b)
    assert got.scale == SCALE * SCALE and got.size == 3
    np.testing.assert_array_equal(to_numpy(got.data), case["ref"]["prod"])


def test_bconv_matches_reference(case):
    dt = case["tctx"].level(1).ks.digits[RAGGED]
    got = bconv_matmul(to_tensor(case["s"], "cpu"), dt.qhat_mod_p, dt.comp_mod.q,
                       dt.comp_mod.ratio_lo, dt.comp_mod.ratio_hi)
    np.testing.assert_array_equal(to_numpy(got), case["ref"]["bconv"])


def test_modup_matches_reference(case):
    tctx = case["tctx"]
    got = ev.modup(tctx, tctx.level(1), to_tensor(case["ref"]["prod"][2], "cpu"))
    np.testing.assert_array_equal(to_numpy(got), case["ref"]["modup"])


def test_key_inner_product_matches_reference(case):
    tctx = case["tctx"]
    t_mod_up = to_tensor(case["ref"]["modup"], "cpu")
    got = ev.key_inner_product(tctx, tctx.level(1), t_mod_up, case["key"])
    np.testing.assert_array_equal(to_numpy(got), case["ref"]["inner"])


def test_moddown_matches_reference(case):
    tctx = case["tctx"]
    got = ev.moddown_from_ntt(tctx, tctx.level(1), to_tensor(case["ref"]["inner"], "cpu"))
    np.testing.assert_array_equal(to_numpy(got), case["ref"]["moddown"])


def test_relinearize_matches_reference(case):
    tctx = case["tctx"]
    ct = ciphertext_from_np(tctx, case["ref"]["prod"], chain_index=1, scale=SCALE * SCALE)
    got = ev.relinearize(tctx, ct, case["key"])
    np.testing.assert_array_equal(to_numpy(got.data), case["ref"]["relin"])


def test_rescale_matches_reference(case):
    tctx = case["tctx"]
    ct = ciphertext_from_np(tctx, case["ref"]["relin"], chain_index=1, scale=SCALE * SCALE)
    got = ev.rescale_to_next(tctx, ct)
    assert got.chain_index == 2 and got.scale == SCALE * SCALE / tctx.q_values[4]
    np.testing.assert_array_equal(to_numpy(got.data), case["ref"]["rescale"])


# -- against the Pallas kernel bodies themselves, in interpret mode ---------

@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setenv("TPU_FHE_PALLAS", "always")


@pytest.mark.parametrize("n", [1024])
def test_inner_product_matches_pallas_k8(pallas, n):
    jctx, tctx = contexts(n)
    rng = np.random.default_rng(8)
    qlp = list(tctx.level(1).base.values) + [m.value for m in tctx.key_modulus[5:]]
    kdata, kshoup = _random_key(rng, [m.value for m in tctx.key_modulus], 3, n)
    t_mod_up = uniform(rng, qlp, (3,), n)
    ref = jev.key_inner_product(jctx, jctx.level(1), W64.from_np(t_mod_up),
                                JRelinKey(W64.from_np(kdata), W64.from_np(kshoup)))
    got = ev.key_inner_product(tctx, tctx.level(1), to_tensor(t_mod_up, "cpu"),
                               relin_key_from_np(tctx, kdata, kshoup))
    np.testing.assert_array_equal(to_numpy(got), ref.to_np())


@pytest.mark.parametrize("n", [1024])
def test_bconv_matches_pallas_k11(pallas, n):
    jctx, tctx = contexts(n)
    rng = np.random.default_rng(11)
    jdt, tdt = jctx.level(1).ks.digits[RAGGED], tctx.level(1).ks.digits[RAGGED]
    s = ragged_digit_input(rng, tctx)
    ref = jbconv.bconv_matmul(W64.from_np(s), jdt.qhat_mod_p, jdt.comp_mod.q,
                              jdt.comp_mod.ratio_lo, jdt.comp_mod.ratio_hi)
    got = bconv_matmul(to_tensor(s, "cpu"), tdt.qhat_mod_p, tdt.comp_mod.q,
                       tdt.comp_mod.ratio_lo, tdt.comp_mod.ratio_hi)
    np.testing.assert_array_equal(to_numpy(got), ref.to_np())
