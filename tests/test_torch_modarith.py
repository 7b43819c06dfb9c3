"""The port's u64 modular arithmetic (int64 tensors, 31-bit digit products)
against tpu_fhe.ops.w64 and exact Python integers, including residues at
0 and q - 1 and 61-bit primes."""

import numpy as np
import pytest
import torch

from tpu_fhe.ops import w64
from tpu_fhe.ops.w64 import W64

from tpu_fhe_torch.core import numth
from tpu_fhe_torch.core.modulus import Modulus
from tpu_fhe_torch.ops import modarith as ma
from tpu_fhe_torch.utils.convert import to_numpy, to_tensor

# The suite runs in several worker processes at once: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

W = 512   # values per limb


@pytest.fixture(scope="module", params=[61, 50], ids=["q61", "q50"])
def case(request):
    bits = request.param
    qs = numth.get_primes(1024, bits, 2)
    mods = [Modulus(q) for q in qs]
    rng = np.random.default_rng(bits)
    qcol = np.array([[q] for q in qs], dtype=np.uint64)
    a = np.stack([rng.integers(0, q, size=W, dtype=np.uint64) for q in qs])
    b = np.stack([rng.integers(0, q, size=W, dtype=np.uint64) for q in qs])
    a[:, 0] = 0
    a[:, 1] = 1
    a[:, 3:6] = qcol - np.uint64(1)
    b[:, 3:5] = qcol - np.uint64(1)
    b[:, 5] = 0
    consts = {
        "q": qcol,
        "rlo": np.array([[m.const_ratio[0]] for m in mods], dtype=np.uint64),
        "rhi": np.array([[m.const_ratio[1]] for m in mods], dtype=np.uint64),
    }
    return qs, a, b, consts


def _t(x):
    return to_tensor(x, "cpu")


def _j(x):
    return W64.from_np(np.asarray(x, dtype=np.uint64))


def _exact(fn, *arrays):
    out = np.empty(arrays[0].shape, dtype=np.uint64)
    for idx in np.ndindex(out.shape):
        out[idx] = fn(*(int(x[idx]) for x in arrays), idx[0])
    return out


def test_add_sub_neg(case):
    qs, a, b, c = case
    q = c["q"]
    for ours, ref in ((ma.add_mod(_t(a), _t(b), _t(q)), w64.add_mod(_j(a), _j(b), _j(q))),
                      (ma.sub_mod(_t(a), _t(b), _t(q)), w64.sub_mod(_j(a), _j(b), _j(q))),
                      (ma.neg_mod(_t(a), _t(q)), w64.neg_mod(_j(a), _j(q)))):
        np.testing.assert_array_equal(to_numpy(ours), ref.to_np())


def test_mul_mod(case):
    qs, a, b, c = case
    got = to_numpy(ma.mul_mod(_t(a), _t(b), _t(c["q"]), _t(c["rlo"]), _t(c["rhi"])))
    ref = w64.mul_mod(_j(a), _j(b), _j(c["q"]), _j(c["rlo"]), _j(c["rhi"])).to_np()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, _exact(lambda x, y, l: x * y % qs[l], a, b))


def test_mul_mod_shoup_and_lazy(case):
    qs, a, b, c = case
    q = c["q"]
    ws = np.array([[(int(b[l, i]) << 64) // qs[l] for i in range(W)] for l in range(2)],
                  dtype=np.uint64)
    got = to_numpy(ma.mul_mod_shoup(_t(a), _t(b), _t(ws), _t(q)))
    ref = w64.mul_mod_shoup(_j(a), _j(b), _j(ws), _j(q)).to_np()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, _exact(lambda x, y, l: x * y % qs[l], a, b))
    # the lazy form takes Harvey-lazy inputs in [0, 4q) and returns [0, 2q)
    a4 = a + np.uint64(3) * q
    lazy = to_numpy(ma.mul_mod_shoup_lazy(_t(a4), _t(b), _t(ws), _t(q)))
    np.testing.assert_array_equal(
        lazy, w64.mul_mod_shoup_lazy(_j(a4), _j(b), _j(ws), _j(q)).to_np())
    assert (lazy < np.uint64(2) * q).all()
    np.testing.assert_array_equal(lazy % q, got)


def test_barrett_reduce_u128_and_u64(case):
    qs, a, b, c = case
    rng = np.random.default_rng(5)
    hi = rng.integers(0, 2**64 - 1, size=a.shape, dtype=np.uint64, endpoint=True)
    lo = rng.integers(0, 2**64 - 1, size=a.shape, dtype=np.uint64, endpoint=True)
    hi[:, 0] = np.uint64(2**64 - 1)
    lo[:, 0] = np.uint64(2**64 - 1)
    got = to_numpy(ma.barrett_reduce_u128(_t(hi), _t(lo), _t(c["q"]), _t(c["rlo"]),
                                          _t(c["rhi"])))
    ref = w64.barrett_reduce_u128(_j(hi), _j(lo), _j(c["q"]), _j(c["rlo"]),
                                  _j(c["rhi"])).to_np()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, _exact(lambda h, l_, l: ((h << 64) | l_) % qs[l], hi, lo))
    got64 = to_numpy(ma.barrett_reduce_u64(_t(lo), _t(c["q"]), _t(c["rhi"])))
    ref64 = w64.barrett_reduce_u64(_j(lo), _j(c["q"]), _j(c["rhi"])).to_np()
    np.testing.assert_array_equal(got64, ref64)
    np.testing.assert_array_equal(got64, _exact(lambda x, l: x % qs[l], lo))


def test_shoup_of(case):
    qs, a, b, c = case
    got = to_numpy(ma.shoup_of(_t(a), _t(c["q"]), _t(c["rlo"]), _t(c["rhi"])))
    ref = w64.shoup_of(_j(a), _j(c["q"]), _j(c["rlo"]), _j(c["rhi"])).to_np()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, _exact(lambda w, l: (w << 64) // qs[l], a))


def test_mulhi_matches_python():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2**64 - 1, size=300, dtype=np.uint64, endpoint=True)
    b = rng.integers(0, 2**64 - 1, size=300, dtype=np.uint64, endpoint=True)
    a[:2] = np.uint64(2**64 - 1)
    hi = to_numpy(ma.mulhi(_t(a), _t(b)))
    np.testing.assert_array_equal(hi, np.array([(int(x) * int(y)) >> 64 for x, y in zip(a, b)],
                                               np.uint64))
