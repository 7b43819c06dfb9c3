"""The port's q32 composite-scaling path on the CPU against tpu_fhe, bit for
bit per RNS limb: the composite chain builder and the 128-prime q32 cap,
the single-word modular helpers, the plain versions of the q32 kernels (K4,
K5, K6 forward/inverse/landing NTTs, K10 inner product, K13 base
conversion) against the Pallas bodies in interpret mode, and multiply ->
relinearize -> rescale_composite with a carried key on a composite chain
with beta = 2 and a ragged last digit.  Also the decoded error of the
port's own round trip at the configuration where tpu_fhe pins its figure
(tests/test_q32_composite.py: < 1e-9 at scale 2^56).

Inputs come from numpy seeds and go to both packages; q32 state crosses as
uint32 arrays.  The switching key is random (not a valid encryption),
which bit-identity does not need; its Shoup32 words are exact."""

import functools

import jax
import numpy as np
import pytest
import torch

from tpu_fhe.core.modulus import CoeffModulus as JCoeffModulus
from tpu_fhe.core.params import EncryptionParameters as JParams, SchemeType as JScheme
from tpu_fhe.eval import evaluator as jev
from tpu_fhe.ops import ntt as jntt, u32pair, w64
from tpu_fhe.ops.bconv_mxu_pallas import bconv_matmul_mxu_pallas32
from tpu_fhe.ops.ks_pallas import key_inner_prod_shoup_pallas32
from tpu_fhe.ops.w64 import W64
from tpu_fhe.scheme import ckks_encoder as jencoder
from tpu_fhe.scheme.ciphertext import Ciphertext as JCiphertext, Plaintext as JPlaintext
from tpu_fhe.scheme.context import FheContext as JContext
from tpu_fhe.scheme.keys import RelinKey as JRelinKey

from tpu_fhe_torch.core.modulus import CoeffModulus
from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
from tpu_fhe_torch.eval import evaluator as ev
from tpu_fhe_torch.ops import bconv, ks, modarith as mm, ntt
from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder
from tpu_fhe_torch.scheme.context import FheContext
from tpu_fhe_torch.scheme.keys import SecretKey, encrypt_asymmetric
from tpu_fhe_torch.utils.convert import (
    ciphertext_from_np, plaintext_from_np, relin_key_from_np, to_numpy, word_tensor,
)

# The suite runs in several worker processes at once: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

N = 1024
SCALE = 2.0 ** 58
# an anchor pair, two data pairs, four special primes: at chain index 1
# the digits are 4 + 2 limbs (beta = 2, the last one ragged)
COMPOSITE = dict(scale_bits=58, levels=2, degree=2, anchor_bits=30, special_bits=30,
                 special_count=4)


@functools.lru_cache(maxsize=None)
def contexts(n):
    """The reference's and the port's composite q32 contexts at ring size n."""
    def params(cm, ep, st):
        mods = cm.create_composite(n, **COMPOSITE)
        return ep(st.ckks, n, tuple(mods), special_modulus_size=COMPOSITE["special_count"],
                  composite_degree=2, allow_insecure=True)
    jctx = JContext(params(JCoeffModulus, JParams, JScheme))
    tctx = FheContext(params(CoeffModulus, EncryptionParameters, SchemeType), device="cpu")
    assert tctx.is_q32 and jctx.is_q32
    return jctx, tctx


def uniform(rng, qs, lead, n=N):
    q = np.asarray(qs, dtype=np.uint64)[:, None]
    return rng.integers(0, 2**62, size=tuple(lead) + (len(qs), n), dtype=np.uint64) % q


def shoup32(vals, qs):
    """Exact floor(v * 2^32 / q) of residues (..., L, N) for moduli (L,)."""
    q = np.asarray(qs, dtype=np.uint64).reshape(-1, 1)
    return (vals.astype(np.uint64) << np.uint64(32)) // q


@functools.lru_cache(maxsize=None)
def jax_reference(n):
    """One jitted tpu_fhe program (its XLA path): multiply two ciphertexts at
    chain index 1, square one and multiply it by a plaintext, relinearize the
    product under a Shoup32-form key (recording the modup, inner-product and
    moddown outputs), rescale_composite and mod_drop_to_next the result; also
    the encoder's forward NTT of decomposed coefficients.  Key and inputs are arguments, so every caller reuses the
    compiled program."""
    jctx, _ = contexts(n)

    def reference(ca, cb, pt, coeffs, key_data, key_shoup):
        seen = {}

        def record(name, fn):
            def wrapped(*args, **kw):
                seen[name] = out = fn(*args, **kw)
                return out
            return wrapped

        a, b = (JCiphertext(c, chain_index=1, scale=SCALE) for c in (ca, cb))
        ct = jev.multiply(jctx, a, b)
        with pytest.MonkeyPatch.context() as mp:
            for name in ("modup", "key_inner_product", "moddown_from_ntt"):
                mp.setattr(jev, name, record(name, getattr(jev, name)))
            relin = jev.relinearize(jctx, ct, JRelinKey(key_data, key_shoup))
        return dict(
            prod=ct.data, square=jev.square(jctx, a).data,
            mul_plain=jev.multiply_plain(jctx, a, JPlaintext(pt, chain_index=1,
                                                             scale=SCALE)).data,
            modup=seen["modup"], inner=seen["key_inner_product"],
            moddown=seen["moddown_from_ntt"], relin=relin.data,
            composite=jev.rescale_composite(jctx, relin).data,
            drop=jev.mod_drop_to_next(jctx, relin).data,
            encoded=jntt.forward_ntt(coeffs, jctx.level(1).ntt),
        )

    fn = jax.jit(reference)

    def run(ca, cb, pt, coeffs, key_data, key_shoup):
        out = fn(*(W64.from_np(a) for a in (ca, cb, pt, coeffs)), key_data, key_shoup)
        return {k: np.asarray(v.to_np()).astype(np.uint32) for k, v in out.items()}
    return run


@pytest.fixture(scope="module")
def case():
    jctx, tctx = contexts(N)
    rng = np.random.default_rng(32)
    key_qs = [m.value for m in tctx.key_modulus]
    kdata = uniform(rng, key_qs, (2, 2)).astype(np.uint32)
    kshoup = shoup32(kdata, key_qs).astype(np.uint32)
    qs = list(tctx.level(1).base.values)
    ca, cb = (uniform(rng, qs, (2,)) for _ in range(2))
    pt = uniform(rng, qs, ())
    # the encoder's host layer is held against the reference in
    # test_torch_slice.py; its rounded coefficients feed the reference NTT
    x = rng.standard_normal(N // 2)
    coeffs = jencoder._round_decompose(
        CkksEncoder(tctx)._embed_inverse(x) * SCALE, jctx.level(1).base)
    ref = jax_reference(N)(ca, cb, pt, coeffs, kdata, kshoup)
    return dict(tctx=tctx, jctx=jctx, ca=ca, cb=cb, pt=pt, x=x, ref=ref,
                key=relin_key_from_np(tctx, kdata, kshoup))


# -- chain, caps and single-word helpers ------------------------------------

@pytest.mark.parametrize("n,cfg", [
    (1024, COMPOSITE),
    (1024, dict(scale_bits=56, levels=3, degree=2, special_count=3)),
    (1024, dict(scale_bits=60, levels=2, degree=3, anchor_bits=29, special_count=2)),
])
def test_create_composite_matches_reference(n, cfg):
    got = [m.value for m in CoeffModulus.create_composite(n, **cfg)]
    assert got == [m.value for m in JCoeffModulus.create_composite(n, **cfg)]


def test_q32_count_cap_matches_reference():
    """Up to 128 primes of at most 30 bits, 64 otherwise, in both packages."""
    assert len(CoeffModulus.create(1024, [30] * 100)) == 100
    for cm in (CoeffModulus, JCoeffModulus):
        for bits in ([30] * 129, [31] * 65):
            with pytest.raises(ValueError):
                cm.create(1024, bits)
    mods = CoeffModulus.create(1024, [30] * 100)
    jmods = JCoeffModulus.create(1024, [30] * 100)
    assert [m.value for m in mods] == [m.value for m in jmods]
    EncryptionParameters(SchemeType.ckks, 1024, tuple(mods), special_modulus_size=50,
                         composite_degree=2, allow_insecure=True)
    for kw in (dict(special_modulus_size=49, composite_degree=2),   # size_Q odd
               dict(special_modulus_size=50, composite_degree=0)):
        with pytest.raises(ValueError):
            EncryptionParameters(SchemeType.ckks, 1024, tuple(mods), allow_insecure=True, **kw)


def test_single_word_helpers_match_reference(case):
    """mul_mod_q32, shoup32_of and mul_mod_shoup32 against w64/u32pair."""
    tctx = case["tctx"]
    level = tctx.level(1)
    qs = np.asarray(level.base.values, dtype=np.uint64)
    rng = np.random.default_rng(5)
    a, b = (uniform(rng, qs, (2,)).astype(np.uint32) for _ in range(2))

    @jax.jit
    def reference(a, b):
        ws = w64.shoup32_of(b, qs)
        q32 = jax.numpy.asarray(qs.astype(np.uint32)[:, None])
        return (w64.mul_mod_q32(W64(a, None), W64(b, None), w64.q32_mul_consts(qs)).lo, ws,
                u32pair.mul_mod_shoup32(a, b, ws, q32))

    mul, ws, mul_shoup = (np.asarray(v) for v in reference(a, b))
    ta, tb = word_tensor(tctx, a), word_tensor(tctx, b)
    got = level.mod.mul(ta, tb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(to_numpy(got), mul)
    np.testing.assert_array_equal(to_numpy(mm.shoup32_of(tb, level.mod.q)), ws)
    got = mm.mul_mod_shoup32(ta, tb, word_tensor(tctx, ws), level.mod.q)
    np.testing.assert_array_equal(to_numpy(got), mul_shoup)


# -- the plain versions of K4, K5, K6, K10, K13 against interpret-mode Pallas

@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setenv("TPU_FHE_PALLAS", "always")


def test_ntt_plain_k4_k5_k6_match_pallas(pallas):
    """forward (K4), inverse with a fused scale (K5) and the landing (K6,
    without the pre factor, as moddown and rescale call it), on a batched
    lead axis and a two-limb view of the key-level tables (limbs 1 and 4: a
    limb map that is no prefix)."""
    jctx, tctx = contexts(N)
    limbs = [1, 4]
    jt, tt = jctx.level(1).ntt.slice_limbs(limbs), tctx.level(1).ntt.slice_limbs(limbs)
    qs = np.asarray(tctx.level(1).base.values, dtype=np.uint64)[limbs]
    rng = np.random.default_rng(45)
    x, sub = uniform(rng, qs, (2,)), uniform(rng, qs, (2,))
    scale = uniform(rng, qs, (), 1)
    tx, tsub = word_tensor(tctx, x), word_tensor(tctx, sub)
    ts, tss = word_tensor(tctx, scale), word_tensor(tctx, shoup32(scale, qs))

    def check(got, ref):
        np.testing.assert_array_equal(to_numpy(got), np.asarray(ref.lo))

    check(ntt.forward_ntt(tx, tt), jntt.forward_ntt(W64.from_np(x), jt))
    check(ntt.inverse_ntt_scaled(tx[0], tt, ts, tss),
          jntt.inverse_ntt_scaled(W64.from_np(x[0]), jt, scale, None))
    check(ntt.forward_ntt_sub_scale(tx, tsub, tt, ts, tss),
          jntt.forward_ntt_sub_scale(W64.from_np(x), W64.from_np(sub), jt, scale, None))


def test_inner_product_plain_k10_matches_pallas(case):
    tctx, jctx = case["tctx"], case["jctx"]
    kst = tctx.level(1).ks
    rng = np.random.default_rng(10)
    qlp = to_numpy(kst.qlp_mod.q).reshape(-1)
    t = uniform(rng, qlp, (kst.beta,)).astype(np.uint32)
    data, shoup = (to_numpy(v) for v in (case["key"].data, case["key"].shoup))
    ref = key_inner_prod_shoup_pallas32(W64(jax.numpy.asarray(t), None), W64(data, None),
                                        shoup, kst.qlp_key_rows.numpy(), qlp)
    got = ks.key_inner_prod_shoup(word_tensor(tctx, t), case["key"].data, case["key"].shoup,
                                  kst.qlp_key_rows, kst.qlp_mod.q)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(ref.lo))


@pytest.mark.parametrize("which", ["ragged digit", "moddown"])
def test_bconv_plain_k13_matches_pallas(which):
    """K13 on the ragged digit's modup conversion (2 -> 8 limbs) and on
    moddown's P -> Ql conversion (4 -> 6 limbs, batch 2), by the plain
    version and by the kernel's digit-plane arithmetic from the digit
    matrix the context keeps beside the table."""
    _, tctx = contexts(N)
    level = tctx.level(1)
    kst = level.ks
    rng = np.random.default_rng(13)
    if which == "moddown":
        s = uniform(rng, to_numpy(kst.p_mod.q).reshape(-1), (2,))
        table, diag, out = kst.p_hat_mod_q, kst.p_hat_mod_q_diag, level.mod
    else:
        dt = kst.digits[1]
        s = uniform(rng, level.base.values[dt.start:dt.end], ())
        table, diag, out = dt.qhat_mod_p, dt.qhat_mod_p_diag, dt.comp_mod
    ref = bconv_matmul_mxu_pallas32(W64.from_np(s), to_numpy(table).astype(np.uint64),
                                    to_numpy(out.q).astype(np.uint64))
    got = bconv.bconv_matmul32(word_tensor(tctx, s), table, out.q, out.fold)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(ref.lo))
    got = bconv.bconv_matmul32_digits_plain(word_tensor(tctx, s), table, out.q, out.fold, diag)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(ref.lo))


# -- the slice: multiply -> relinearize -> rescale_composite ---------------

def test_multiply_square_and_plain_match_reference(case):
    tctx = case["tctx"]
    a, b = (ciphertext_from_np(tctx, case[k], 1, SCALE) for k in ("ca", "cb"))
    assert a.data.dtype == torch.int32
    np.testing.assert_array_equal(to_numpy(ev.multiply(tctx, a, b).data), case["ref"]["prod"])
    np.testing.assert_array_equal(to_numpy(ev.square(tctx, a).data), case["ref"]["square"])
    pt = plaintext_from_np(tctx, case["pt"], 1, SCALE)
    np.testing.assert_array_equal(to_numpy(ev.multiply_plain(tctx, a, pt).data),
                                  case["ref"]["mul_plain"])


def test_keyswitch_stages_match_reference(case):
    """modup (K5, K13, K4), the Shoup32 inner product (K10) and moddown
    (K5, K13, K6), each from the reference's previous stage."""
    tctx, ref = case["tctx"], case["ref"]
    level = tctx.level(1)
    got = ev.modup(tctx, level, word_tensor(tctx, ref["prod"][2]))
    np.testing.assert_array_equal(to_numpy(got), ref["modup"])
    got = ev.key_inner_product(tctx, level, word_tensor(tctx, ref["modup"]), case["key"])
    np.testing.assert_array_equal(to_numpy(got), ref["inner"])
    got = ev.moddown_from_ntt(tctx, level, word_tensor(tctx, ref["inner"]))
    np.testing.assert_array_equal(to_numpy(got), ref["moddown"])


def test_relinearize_and_rescales_match_reference(case):
    tctx, ref = case["tctx"], case["ref"]
    ct = ciphertext_from_np(tctx, ref["prod"], 1, SCALE * SCALE)
    relin = ev.relinearize(tctx, ct, case["key"])
    np.testing.assert_array_equal(to_numpy(relin.data), ref["relin"])
    out = ev.rescale_composite(tctx, relin)
    qd = tctx.q_values[4:6]
    assert out.chain_index == 3 and out.scale == SCALE * SCALE / qd[0] / qd[1]
    np.testing.assert_array_equal(to_numpy(out.data), ref["composite"])
    drop = ev.mod_drop_to_next(tctx, relin)
    assert drop.chain_index == 2
    np.testing.assert_array_equal(to_numpy(drop.data), ref["drop"])


def test_encoder_compact_plaintext_matches_reference(case):
    """The encoder's int32 plaintext equals the reference's compact one
    (its rounded coefficients through its forward NTT)."""
    got = CkksEncoder(case["tctx"]).encode(case["x"], SCALE).data
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(to_numpy(got), case["ref"]["encoded"])


def test_round_trip_error_at_reference_figure():
    """tests/test_q32_composite.py's configuration (N = 2048, an anchor
    pair of 30 bits, two 28-bit data pairs, a 29-bit special pair, scale
    2^56): multiply -> relinearize -> rescale_composite decodes within the
    reference's pinned 1e-9, and so do two sequential rescale_to_next."""
    n, scale = 2048, 2.0 ** 56
    bits = [30, 30] + [28, 28] * 2 + [29, 29]
    ctx = FheContext(EncryptionParameters(
        SchemeType.ckks, n, tuple(CoeffModulus.create(n, bits)), special_modulus_size=2,
        composite_degree=2, allow_insecure=True), device="cpu")
    sk = SecretKey(ctx, seed=9)
    enc = CkksEncoder(ctx)
    rng = np.random.default_rng(17)
    x, y = rng.uniform(-1, 1, n // 2), rng.uniform(-1, 1, n // 2)
    ct_x = sk.encrypt_symmetric(enc.encode(x, scale))
    ct_y = encrypt_asymmetric(ctx, sk.public_key(), enc.encode(y, scale),
                              torch.Generator().manual_seed(18))
    relin = ev.relinearize(ctx, ev.multiply(ctx, ct_x, ct_y), sk.relin_key())
    prod = ev.rescale_composite(ctx, relin)
    assert 0.5 < prod.scale / scale < 2.0 and prod.data.dtype == torch.int32
    assert np.max(np.abs(enc.decode(sk.decrypt(prod)).real - x * y)) < 1e-9
    seq = ev.rescale_to_next(ctx, ev.rescale_to_next(ctx, relin))
    assert seq.chain_index == prod.chain_index
    assert np.max(np.abs(enc.decode(sk.decrypt(seq)).real - x * y)) < 1e-9
