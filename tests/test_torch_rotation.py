"""The port's rotation path on the CPU against tpu_fhe, bit for bit per RNS
limb, on both plans at N = 1024: the u64 plan on test_torch_keyswitch.py's
chain (beta = 3, a ragged last digit) and the q32 plan on test_torch_q32.py's
composite chain (beta = 2, a ragged last digit).

One jitted tpu_fhe program per plan takes the inputs and the Galois keys as
arguments and computes: the NTT-form and coefficient-form automorphisms,
the inner product with keys without Shoup words (the reference's XLA path,
which is also what it runs for keys with them), apply_galois_with_key,
rotate by a keyed step and by a NAF-composed one, conjugate, and every
function of eval/hoisting.py, hoisted_rotation_sum with both key forms.
The plain K7 and K9 are also held against the interpret-mode Pallas
bodies, and keys the port generates under the reference's secret decrypt
rotated and conjugated vectors.

Keys and inputs are made from numpy seeds and go to both packages; the keys
are random (not valid encryptions), which bit-identity does not need."""

import functools

import jax
import numpy as np
import pytest
import torch

from tpu_fhe.core import numth as jnumth
from tpu_fhe.eval import evaluator as jev, hoisting as jho
from tpu_fhe.ops import galois as jgalois, w64
from tpu_fhe.ops.ks_pallas import key_inner_prod_pallas, key_inner_prod_pallas32
from tpu_fhe.ops.w64 import W64
from tpu_fhe.scheme.ciphertext import Ciphertext as JCiphertext, Plaintext as JPlaintext
from tpu_fhe.scheme.keys import (
    GaloisKey as JGaloisKey, RelinKey as JRelinKey, SecretKey as JSecretKey,
)

import test_torch_keyswitch
import test_torch_q32
from tpu_fhe_torch.core import numth
from tpu_fhe_torch.eval import evaluator as ev, hoisting as ho
from tpu_fhe_torch.ops import galois, ks
from tpu_fhe_torch.scheme.ciphertext import Ciphertext, Plaintext
from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder
from tpu_fhe_torch.utils.convert import (
    ciphertext_from_np, galois_key_from_np, galois_key_to_np, secret_key_from_np, to_numpy,
    word_tensor,
)

# The suite runs in several worker processes at once: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

N = 1024
SCALE = 2.0 ** 50
PLANS = ["u64", "q32"]
KEY_STEPS = (-1, 4)         # plus conjugation
NAF_STEP = 3                # no key: naf(3) = [-1, 4]
HOIST_STEPS = (0, -1, 4)


def contexts(plan):
    mod = test_torch_q32 if plan == "q32" else test_torch_keyswitch
    return mod.contexts(N)


def elts():
    return [jgalois.galois_elt_from_step(s, N) for s in KEY_STEPS] + [jgalois.conj_elt(N)]


def uniform(rng, qs, lead):
    q = np.asarray(qs, dtype=np.uint64)[:, None]
    return rng.integers(0, 2**62, size=tuple(lead) + (len(qs), N), dtype=np.uint64) % q


def shoup_words(data, qs, bits):
    q = np.asarray(qs, dtype=object)[:, None]
    return ((data.astype(object) << bits) // q).astype(np.uint64)


def _staged(fn, per_component=False):
    """`fn(ctx, level, x, *rest)` of tpu_fhe.eval.evaluator, compiled once
    per level and key form instead of once per call site; with
    `per_component`, x's leading components go through one compiled
    (limbs, N) program in turn (moddown treats them independently)."""
    compiled = {}

    def run(ctx, level, x, *rest, **kw):
        if per_component and x.ndim == 3:
            return w64.stack([run(ctx, level, x[i], *rest, **kw) for i in range(x.shape[0])])
        key = (level.chain_index, x.ndim, tuple(r.shoup is None for r in rest),
               tuple(sorted(kw.items())))
        if key not in compiled:
            compiled[key] = jax.jit(lambda *a: fn(ctx, level, *a, **kw))
        return compiled[key](x, *rest)
    return run


class _CompiledW64:
    """tpu_fhe.ops.w64 with its elementwise products and sums compiled once
    per shape, for the glue of tpu_fhe.eval.hoisting (which runs op by op
    otherwise)."""

    def __init__(self):
        for name in ("add_mod", "mul_mod", "mul_mod_q32", "mul_mod_shoup"):
            setattr(self, name, jax.jit(getattr(w64, name)))

    def __getattr__(self, name):
        return getattr(w64, name)


@functools.lru_cache(maxsize=None)
def jax_reference(plan):
    """The reference's outputs for one plan; inputs and keys are arguments.
    Its NTT-bearing stages (modup, the inner product, moddown) are each one
    jitted program per plan, shared by every rotation; the glue around
    them runs op by op."""
    jctx, _ = contexts(plan)
    level = jctx.level(1)
    e_m1, e_4, e_conj = elts()
    stages = {name: _staged(getattr(jev, name), name == "moddown_from_ntt")
              for name in ("modup", "key_inner_product", "moddown_from_ntt")}
    glue = _CompiledW64()

    def reference(ct, x_ext, pt_ext, x_coeff, keys):
        gk = JGaloisKey({e: JRelinKey(k, None) for e, k in zip(elts(), keys)})
        c = JCiphertext(ct, chain_index=1, scale=SCALE)
        ext = JCiphertext(x_ext, chain_index=1, scale=SCALE)
        pre = jho.fast_rotation_precompute(jctx, c)
        lifted = jho.keyswitch_ext(jctx, c)
        return dict(
            galois_ntt=jgalois.apply_galois_ntt(x_ext, e_m1, N),
            galois_coeff=jgalois.apply_galois_coeff(x_coeff, e_4, N, level.mod.q),
            modup=pre,
            inner=jev.key_inner_product(jctx, level, pre, gk.key_for_elt(e_m1)),
            rotate=jev.rotate(jctx, c, KEY_STEPS[0], gk).data,
            rotate_naf=jev.rotate(jctx, c, NAF_STEP, gk).data,
            conjugate=jev.conjugate(jctx, c, gk).data,
            fast_add_first=jho.fast_rotation_ext(jctx, c, pre, e_4, gk.key_for_elt(e_4),
                                                 True).data,
            fast=jho.fast_rotation_ext(jctx, c, pre, e_4, gk.key_for_elt(e_4), False).data,
            keyswitch_ext=lifted.data,
            keyswitch_down=jho.keyswitch_down(jctx, ext).data,
            keyswitch_down_first=jho.keyswitch_down_first(jctx, ext).data,
            mult_ext=jho.eval_mult_ext(jctx, ext, JPlaintext(pt_ext, chain_index=1,
                                                             scale=SCALE)).data,
            add_ext=jho.eval_add_ext(jctx, ext, lifted).data,
            reset=jho.reset_poly_ext(jctx, ext, 1).data,
            rotate_c0=jho.rotate_c0(jctx, c, e_conj).data,
            hoisted=jho.hoisted_rotation_sum(jctx, c, HOIST_STEPS, gk).data,
        )

    def run(ct, x_ext, pt_ext, x_coeff, keys):
        if plan == "q32":
            keys = [jax.numpy.asarray(k.astype(np.uint32)) for k in keys]
        else:
            keys = [W64.from_np(k) for k in keys]
        with pytest.MonkeyPatch.context() as mp:
            for name, fn in stages.items():
                mp.setattr(jev, name, fn)
                if hasattr(jho, name):
                    mp.setattr(jho, name, fn)
            mp.setattr(jho, "mm", glue)
            out = reference(*(W64.from_np(a) for a in (ct, x_ext, pt_ext, x_coeff)), keys)
        word = np.uint32 if plan == "q32" else np.uint64
        return {k: np.asarray(v.to_np() if isinstance(v, W64) else v).astype(word)
                for k, v in out.items()}
    return run


@pytest.fixture(scope="module", params=PLANS)
def case(request):
    plan = request.param
    _, tctx = contexts(plan)
    rng = np.random.default_rng(77)
    level = tctx.level(1)
    ql = list(level.base.values)
    qlp = to_numpy(level.ks.qlp_mod.q).reshape(-1).tolist()
    key_qs = [m.value for m in tctx.key_modulus]
    dnum = -(-tctx.params.size_Q // tctx.params.size_P)
    bits = 32 if tctx.is_q32 else 64
    keys = [uniform(rng, key_qs, (dnum, 2)) for _ in elts()]
    shoups = [shoup_words(k, key_qs, bits) for k in keys]
    inputs = dict(ct=uniform(rng, ql, (2,)), x_ext=uniform(rng, qlp, (2,)),
                  pt_ext=uniform(rng, qlp, ()), x_coeff=uniform(rng, ql, ()))
    ref = jax_reference(plan)(*inputs.values(), keys)
    word = np.uint32 if tctx.is_q32 else np.uint64
    plain = {e: (k.astype(word), None) for e, k in zip(elts(), keys)}
    shoup = {e: (k.astype(word), s.astype(word)) for e, k, s in zip(elts(), keys, shoups)}
    return dict(plan=plan, tctx=tctx, ref=ref, gk=galois_key_from_np(tctx, plain),
                gk_shoup=galois_key_from_np(tctx, shoup),
                **{k: word_tensor(tctx, v) for k, v in inputs.items()})


def _ct(case, data):
    return Ciphertext(data, chain_index=1, scale=SCALE)


def check(got, want):
    np.testing.assert_array_equal(to_numpy(got), want)


# -- the host layer ------------------------------------------------------------

def test_naf_and_permutations_match_reference():
    for v in [*range(-40, 41), 1000, -12345, (1 << 20) - 1]:
        assert numth.naf(v) == jnumth.naf(v)
        assert sum(numth.naf(v)) == v
    for n in (8, 1024):
        steps = (0, 1, 2, -1, 3, n // 4, n // 2 + 1)
        assert [galois.galois_elt_from_step(s, n) for s in steps] == \
            [jgalois.galois_elt_from_step(s, n) for s in steps]
        assert galois.conj_elt(n) == jgalois.conj_elt(n)
        for elt in {jgalois.galois_elt_from_step(s, n) for s in steps[1:]} | {2 * n - 1}:
            np.testing.assert_array_equal(galois._ntt_permutation(n, elt),
                                          jgalois._ntt_permutation(n, elt))
            for got, want in zip(galois._coeff_permutation(n, elt),
                                 jgalois._coeff_permutation(n, elt)):
                np.testing.assert_array_equal(got, want)


# -- the slice against the jitted reference ------------------------------------

def test_automorphisms_match_reference(case):
    """apply_galois_ntt on (2, QlP, N) and apply_galois_coeff on (L, N)."""
    tctx, ref = case["tctx"], case["ref"]
    e_m1, e_4, _ = elts()
    check(galois.apply_galois_ntt(case["x_ext"], e_m1, N), ref["galois_ntt"])
    check(galois.apply_galois_coeff(case["x_coeff"], e_4, N, tctx.level(1).mod.q),
          ref["galois_coeff"])


def test_inner_product_without_shoup_matches_reference(case):
    """modup of c1, then K7's (u64) or K9's (q32) function."""
    tctx, ref = case["tctx"], case["ref"]
    level = tctx.level(1)
    pre = ho.fast_rotation_precompute(tctx, _ct(case, case["ct"]))
    check(pre, ref["modup"])
    key = case["gk"].key_for_elt(elts()[0])
    assert key.shoup is None
    check(ev.key_inner_product(tctx, level, pre, key), ref["inner"])


def test_rotations_match_reference(case):
    tctx, ref, gk = case["tctx"], case["ref"], case["gk"]
    ct = _ct(case, case["ct"])
    e_m1, _, e_conj = elts()
    check(ev.apply_galois_with_key(tctx, ct, e_m1, gk.key_for_elt(e_m1)).data, ref["rotate"])
    check(ev.rotate(tctx, ct, KEY_STEPS[0], gk).data, ref["rotate"])
    assert galois.galois_elt_from_step(NAF_STEP, N) not in gk.keys
    check(ev.rotate(tctx, ct, NAF_STEP, gk).data, ref["rotate_naf"])
    check(ev.conjugate(tctx, ct, gk).data, ref["conjugate"])
    check(ev.apply_galois(tctx, ct, e_conj, gk).data, ref["conjugate"])
    assert ev.rotate(tctx, ct, 0, gk) is ct


def test_hoisting_matches_reference(case):
    tctx, ref, gk = case["tctx"], case["ref"], case["gk"]
    ct, ext = _ct(case, case["ct"]), _ct(case, case["x_ext"])
    _, e_4, e_conj = elts()
    pre = ho.fast_rotation_precompute(tctx, ct)
    for add_first, name in ((True, "fast_add_first"), (False, "fast")):
        check(ho.fast_rotation_ext(tctx, ct, pre, e_4, gk.key_for_elt(e_4), add_first).data,
              ref[name])
    lifted = ho.keyswitch_ext(tctx, ct)
    check(lifted.data, ref["keyswitch_ext"])
    check(ho.keyswitch_down(tctx, ext).data, ref["keyswitch_down"])
    check(ho.keyswitch_down_first(tctx, ext).data, ref["keyswitch_down_first"])
    pt = Plaintext(case["pt_ext"], chain_index=1, scale=SCALE)
    got = ho.eval_mult_ext(tctx, ext, pt)
    assert got.scale == SCALE * SCALE and got.noise_scale_deg == 2
    check(got.data, ref["mult_ext"])
    check(ho.eval_add_ext(tctx, ext, lifted).data, ref["add_ext"])
    check(ho.reset_poly_ext(tctx, ext, 1).data, ref["reset"])
    check(ho.rotate_c0(tctx, ct, e_conj).data, ref["rotate_c0"])


@pytest.mark.parametrize("form", ["plain", "shoup"])
def test_hoisted_rotation_sum_matches_reference(case, form):
    """With keys without Shoup words (K7/K9) and with them (K8/K10); the
    reference's inner product on the CPU is the same program for both."""
    gk = case["gk_shoup"] if form == "shoup" else case["gk"]
    got = ho.hoisted_rotation_sum(case["tctx"], _ct(case, case["ct"]), HOIST_STEPS, gk)
    check(got.data, case["ref"]["hoisted"])


# -- the plain K7 and K9 against the Pallas bodies in interpret mode ----------

@pytest.mark.parametrize("plan", PLANS)
def test_plain_k7_k9_match_pallas(plan):
    _, tctx = contexts(plan)
    kst = tctx.level(1).ks
    qlp_mod = kst.qlp_mod
    qlp = to_numpy(qlp_mod.q).reshape(-1)
    rng = np.random.default_rng(79)
    key_qs = [m.value for m in tctx.key_modulus]
    dnum = -(-tctx.params.size_Q // tctx.params.size_P)
    data = uniform(rng, key_qs, (dnum, 2))
    t = uniform(rng, qlp, (kst.beta,))
    rows = kst.qlp_key_rows.numpy()
    tt, tdata = word_tensor(tctx, t), word_tensor(tctx, data)
    if plan == "q32":
        ref = key_inner_prod_pallas32(W64(jax.numpy.asarray(t.astype(np.uint32)), None),
                                      W64(data.astype(np.uint32), None), rows, qlp)
        got = ks.key_inner_prod32(tt, tdata, kst.qlp_key_rows, qlp_mod.q, qlp_mod.fold)
        np.testing.assert_array_equal(to_numpy(got), np.asarray(ref.lo))
    else:
        ref = key_inner_prod_pallas(W64.from_np(t), W64.from_np(data), rows, qlp,
                                    to_numpy(qlp_mod.ratio_lo).reshape(-1),
                                    to_numpy(qlp_mod.ratio_hi).reshape(-1))
        got = ks.key_inner_prod(tt, tdata, kst.qlp_key_rows, qlp_mod.q, qlp_mod.ratio_lo,
                                qlp_mod.ratio_hi)
        check(got, ref.to_np())


# -- keys the port generates -----------------------------------------------------

@pytest.mark.parametrize("plan", PLANS)
def test_port_galois_keys_decrypt_rotations(plan):
    """Under the reference's secret: rotate by keyed and NAF-composed steps,
    conjugate and a hoisted sum, each decoded within 1e-6."""
    jctx, tctx = contexts(plan)
    s = JSecretKey(jctx, 3).s_ntt.to_np()
    sk = secret_key_from_np(tctx, s.astype(np.uint32) if tctx.is_q32 else s, seed=4)
    gk = sk.galois_key(list(KEY_STEPS), include_conj=True)
    assert set(gk.keys) == set(elts())
    assert all(k.shoup is None and k.data.dtype == tctx.dtype for k in gk.keys.values())
    enc = CkksEncoder(tctx)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(N // 2) + 1j * rng.standard_normal(N // 2)
    ct = sk.encrypt_symmetric(enc.encode(x, SCALE))

    def err(c, want):
        return np.max(np.abs(enc.decode(sk.decrypt(c)) - want))

    for step in (KEY_STEPS[0], NAF_STEP):
        assert err(ev.rotate(tctx, ct, step, gk), np.roll(x, -step)) < 1e-6
    assert err(ev.conjugate(tctx, ct, gk), np.conj(x)) < 1e-6
    want = sum(np.roll(x, -s) for s in HOIST_STEPS)
    assert err(ho.hoisted_rotation_sum(tctx, ct, HOIST_STEPS, gk), want) < 1e-6


def test_galois_key_sets_and_errors(monkeypatch):
    _, tctx = contexts("u64")
    sk = secret_key_from_np(tctx, np.zeros((tctx.key_level.size, N), dtype=np.uint64))
    with monkeypatch.context() as mp:
        mp.setattr(sk, "_galois_key_for_elt", lambda elt, shoup=False: (elt, shoup))
        steps = [s for i in range(N.bit_length() - 2) for s in (1 << i, -(1 << i))]
        want = {jgalois.galois_elt_from_step(s, N) for s in steps}
        assert set(sk.galois_key_power_of_2().keys) == want
        got = sk.galois_key_power_of_2(include_conj=True, shoup=True).keys
        assert set(got) == want | {2 * N - 1} and all(v[1] for v in got.values())
    gk = sk.galois_key([1, -1])
    back = galois_key_from_np(tctx, galois_key_to_np(gk))
    assert all(torch.equal(back.keys[e].data, k.data) and back.keys[e].shoup is None
               for e, k in gk.keys.items())
    with pytest.raises(ValueError, match="no Galois key"):
        gk.key_for_elt(jgalois.conj_elt(N))
    ct = ciphertext_from_np(tctx, np.zeros((2, tctx.level(1).size, N), dtype=np.uint64), 1)
    one = sk.galois_key([1])
    with pytest.raises(ValueError, match="no Galois key"):
        ev.rotate(tctx, ct, 2, one)            # a power of two: no NAF to compose
    with pytest.raises(ValueError, match="size-2"):
        ev.rotate(tctx, Ciphertext(ct.data[:1], 1), 1, one)
    with pytest.raises(ValueError, match="size-2"):
        ho.hoisted_rotation_sum(tctx, Ciphertext(ct.data[:1], 1), (0, 1), one)
    t = torch.zeros((65, 3, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="beta"):
        ks.key_inner_prod(t, torch.zeros((65, 2, 3, 8), dtype=torch.int64),
                          torch.arange(3), *(torch.ones((3, 1), dtype=torch.int64),) * 3)
