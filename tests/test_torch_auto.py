"""The port's FLEXIBLEAUTO layer (eval/auto.py) and Chebyshev series
(eval/chebyshev.py) on the CPU against tpu_fhe, bit for bit per RNS limb, on
both plans at N = 128: the u64 plan on tests/test_auto_chebyshev.py's own
stack (a 45-bit q0, eight 40-bit primes, one 50-bit special prime) and the
q32 plan on a composite chain (an anchor pair, four data pairs of 29-30
bits, a special pair), where mod_reduce divides by a prime pair and
raise_mod composes the anchor pair by Garner.

Inputs are random residues made from numpy seeds at chosen chain indices,
noise-scale degrees and ladder scales, and a random switching key (not
valid encryptions, which bit identity does not need).  The reference's
``auto`` and ``chebyshev`` modules run eagerly once per plan, in a
fixture, on the same values: their level and depth decisions, every
branch of ``_adjust_lower``, their CRT scalar lifts and their w64
arithmetic run as they are.  The evaluator operations they call
(``multiply``, ``square``, ``relinearize``, ``rescale_to_next``,
``rescale_composite``, ``mod_drop_to_next``, ``add``, ``sub``) and the two
NTTs ``auto`` calls directly are served, for that run, by the port's own
functions on the same values.  Those functions are held bit for bit
against the reference's in tests/test_torch_keyswitch.py,
tests/test_torch_q32.py and tests/test_torch_ntt.py; the reference's
eager XLA path for them costs 9-22 s per operation and chain level on a
CPU (every level is a new shape to compile), too slow for a unit test.

The port's own decoded-error checks at the reference's tolerances
(tests/test_auto_chebyshev.py) run with the port's keys alone."""

import math
from dataclasses import replace

import numpy as np
import pytest
import torch

from tpu_fhe.core.modulus import CoeffModulus as JCoeffModulus
from tpu_fhe.core.params import EncryptionParameters as JParams, SchemeType as JScheme
from tpu_fhe.eval import auto as jauto, chebyshev as jcheb, evaluator as jev
from tpu_fhe.ops.w64 import W64
from tpu_fhe.scheme.ciphertext import Ciphertext as JCiphertext, Plaintext as JPlaintext
from tpu_fhe.scheme.context import FheContext as JContext

from tpu_fhe_torch.core.modulus import CoeffModulus
from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
from tpu_fhe_torch.eval import auto, chebyshev as cheb, evaluator as ev
from tpu_fhe_torch.ops import ntt
from tpu_fhe_torch.scheme.ciphertext import Ciphertext, Plaintext
from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder, _compose_signed
from tpu_fhe_torch.scheme.context import FheContext
from tpu_fhe_torch.scheme.keys import SecretKey
from tpu_fhe_torch.utils.convert import relin_key_from_np, to_numpy, word_tensor

# The suite runs in several worker processes at once: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

N = 128
STACK_BITS = [45] + [40] * 8 + [50]          # tests/test_auto_chebyshev.py:19-33
COMPOSITE = dict(scale_bits=58, levels=4, degree=2, anchor_bits=30, special_bits=30,
                 special_count=2)
PLANS = ["u64", "q32"]
PS_DEGREE = 12      # the smallest degree whose PS evaluation recurses (m = 3)


def _params(plan, cm, ep, st):
    if plan == "u64":
        return ep(scheme=st.ckks, poly_modulus_degree=N, allow_insecure=True,
                  coeff_modulus=tuple(cm.create(N, STACK_BITS)), special_modulus_size=1)
    return ep(st.ckks, N, tuple(cm.create_composite(N, **COMPOSITE)),
              special_modulus_size=COMPOSITE["special_count"], composite_degree=2,
              allow_insecure=True)


def _port_ctx(plan):
    return FheContext(_params(plan, CoeffModulus, EncryptionParameters, SchemeType),
                      device="cpu")


# -- the same operations, written once for both packages ------------------

def _sine(t):
    return math.sin(2 * t) * math.exp(-t * t)


CASES = {
    "mod_reduce": lambda P, c, x: P.auto.mod_reduce(c, x["l0d2"], 1),
    "mod_reduce 2 levels": lambda P, c, x: P.auto.mod_reduce(c, x["l0d2"], 2),
    "mod_switch_level": lambda P, c, x: P.auto.mod_switch_level(c, x["l0"], 2),
    "mult_const_core": lambda P, c, x: P.auto.mult_const_core(c, x["l0"], 3.5),
    "mult_const at degree 2": lambda P, c, x: P.auto.mult_const(c, x["l0d2"], -0.75),
    "mult_const": lambda P, c, x: P.auto.mult_const(c, x["l1"], 0.3),
    "add_const": lambda P, c, x: P.auto.add_const(c, x["l0d2"], 1.25),
    "add_const 0": lambda P, c, x: P.auto.add_const(c, x["l1"], 0.0),
    "sub_const": lambda P, c, x: P.auto.sub_const(c, x["l1"], 0.5),
    # adjust_levels_and_depth: the same-level depth branches, then every
    # branch of _adjust_lower (lo's depth, hi's depth, the level gap), one
    # with the operands swapped
    "adjust same level, c1 shallower": lambda P, c, x:
        P.auto.adjust_levels_and_depth(c, x["l0"], x["l0d2"]),
    "adjust same level, c2 shallower": lambda P, c, x:
        P.auto.adjust_levels_and_depth(c, x["l0d2"], x["l0"]),
    "adjust lo 2 hi 2": lambda P, c, x: P.auto.adjust_levels_and_depth(c, x["l0d2"], x["l2d2"]),
    "adjust lo 2 hi 1, next level": lambda P, c, x:
        P.auto.adjust_levels_and_depth(c, x["l0d2"], x["l1"]),
    "adjust lo 2 hi 1, three levels": lambda P, c, x:
        P.auto.adjust_levels_and_depth(c, x["l0d2"], x["l3"]),
    "adjust lo 1 hi 2": lambda P, c, x: P.auto.adjust_levels_and_depth(c, x["l2d2"], x["l0"]),
    "adjust lo 1 hi 1": lambda P, c, x: P.auto.adjust_levels_and_depth(c, x["l0"], x["l2"]),
    "eval_add_auto": lambda P, c, x: P.auto.eval_add_auto(c, x["l0"], x["l1d2"]),
    "eval_add_auto, scale drift": lambda P, c, x:
        P.auto.eval_add_auto(c, x["l0"], replace(x["l0b"], scale=x["l0b"].scale * 1.01)),
    "eval_sub_auto": lambda P, c, x: P.auto.eval_sub_auto(c, x["l2"], x["l0d2"]),
    "eval_mult_auto": lambda P, c, x: P.auto.eval_mult_auto(c, x["l0"], x["l1d2"], x["rlk"]),
    "eval_mult_auto at degree 2": lambda P, c, x:
        P.auto.eval_mult_auto(c, x["l0d2"], x["l0d2b"], x["rlk"]),
    "eval_square_auto": lambda P, c, x: P.auto.eval_square_auto(c, x["l0"], x["rlk"]),
    "eval_square_auto at degree 2": lambda P, c, x:
        P.auto.eval_square_auto(c, x["l0d2"], x["rlk"]),
    "eval_mult_plain_auto": lambda P, c, x: P.auto.eval_mult_plain_auto(c, x["l1"], x["pt"]),
    "eval_mult_plain_auto at degree 2": lambda P, c, x:
        P.auto.eval_mult_plain_auto(c, x["l0d2"], x["pt"]),
    "raise_mod": lambda P, c, x: P.auto.raise_mod(c, x["anchor"]),
    "mult_by_monomial": lambda P, c, x: P.auto.mult_by_monomial(c, x["l0"], N // 2),
    "mult_by_monomial past n": lambda P, c, x: P.auto.mult_by_monomial(c, x["l1"], N + 3),
    "mult_by_integer": lambda P, c, x: P.auto.mult_by_integer(c, x["l0"], -7),
    "eval_linear_wsum_mutable": lambda P, c, x: P.cheb.eval_linear_wsum_mutable(
        c, [x["l0"], x["l1d2"], x["l0d2"]], [0.5, -1.25, 2.0]),
    "chebyshev linear, degree 4": lambda P, c, x: P.cheb.eval_chebyshev_series(
        c, x["l0"], x["rlk"], P.cheb.eval_chebyshev_coefficients(math.exp, -1.0, 1.0, 4),
        -1.0, 1.0),
    "chebyshev linear on [-2, 3]": lambda P, c, x: P.cheb.eval_chebyshev_series_linear(
        c, x["l0"], x["rlk"], P.cheb.eval_chebyshev_coefficients(math.cos, -2.0, 3.0, 3),
        -2.0, 3.0),
    f"chebyshev PS, degree {PS_DEGREE}": lambda P, c, x: P.cheb.eval_chebyshev_series(
        c, x["l0"], x["rlk"], P.cheb.eval_chebyshev_coefficients(_sine, -1.0, 1.0, PS_DEGREE),
        -1.0, 1.0),
}


class _Pkg:
    def __init__(self, auto_mod, cheb_mod, ev_mod):
        self.auto, self.cheb, self.ev = auto_mod, cheb_mod, ev_mod


def _inputs(tctx, rng):
    """Random NTT-form residues for every operand name the cases use, as
    (chain index, size, noise-scale degree, scale, numpy data); ladder
    scales as a fresh (degree 1) or once-multiplied (degree 2) ciphertext
    at that level carries them."""
    d = auto.composite_degree(tctx)
    sf, _ = auto.scaling_factors(tctx)

    def draw(ci, size):
        q = np.asarray(tctx.level(ci).base.values, dtype=np.uint64)[:, None]
        lead = (size,) if size else ()
        return rng.integers(0, 2**62, size=lead + (len(q), N), dtype=np.uint64) % q

    out = {}
    for lvl in range(4):
        ci = lvl * d + 1
        out[f"l{lvl}"] = (ci, 2, 1, sf[lvl], draw(ci, 2))
        out[f"l{lvl}d2"] = (ci, 2, 2, sf[lvl] * sf[lvl], draw(ci, 2))
    out["l0b"] = (1, 2, 1, sf[0], draw(1, 2))
    out["l0d2b"] = (1, 2, 2, sf[0] * sf[0], draw(1, 2))
    out["pt"] = (1, 0, 1, sf[0], draw(1, 0))
    anchor = len(tctx.chain) - d       # the last level: q0, or the anchor pair
    out["anchor"] = (anchor, 2, 1, sf[0], draw(anchor, 2))
    return out


def _port_inputs(tctx, raw, rlk):
    x = {"rlk": rlk}
    for name, (ci, size, deg, scale, data) in raw.items():
        t = word_tensor(tctx, data)
        x[name] = (Plaintext(t, ci, scale, deg) if size == 0 else
                   Ciphertext(t, ci, scale, deg))
    return x


def _ref_inputs(raw, rlk):
    x = {"rlk": rlk}
    for name, (ci, size, deg, scale, data) in raw.items():
        w = W64.from_np(data)
        x[name] = (JPlaintext(w, ci, scale, deg) if size == 0 else
                   JCiphertext(w, ci, scale, noise_scale_deg=deg))
    return x


def _to_port(tctx, ct):
    return Ciphertext(word_tensor(tctx, ct.data.to_np()), ct.chain_index, ct.scale,
                      ct.noise_scale_deg)


def _to_ref(ct):
    return JCiphertext(W64.from_np(to_numpy(ct.data).astype(np.uint64)), ct.chain_index,
                       ct.scale, noise_scale_deg=ct.noise_scale_deg)


def _bridge(monkeypatch, jctx, tctx):
    """Serve the reference's evaluator operations and auto's two NTTs with
    the port's functions on the same values (see the module docstring)."""
    def op(port_fn):
        def run(_jctx, *args):
            args = [_to_port(tctx, a) if isinstance(a, JCiphertext) else a for a in args]
            return _to_ref(port_fn(tctx, *args))
        return run

    for name in ("multiply", "square", "relinearize", "rescale_to_next",
                 "rescale_composite", "mod_drop_to_next", "add", "sub"):
        monkeypatch.setattr(jev, name, op(getattr(ev, name)))
    tables = {id(jctx.level(ci).ntt): tctx.level(ci).ntt for ci in range(len(jctx.chain))}

    def transform(port_fn):
        def run(x, t):
            return W64.from_np(to_numpy(port_fn(word_tensor(tctx, x.to_np()),
                                                tables[id(t)])).astype(np.uint64))
        return run

    monkeypatch.setattr(jauto, "forward_ntt", transform(ntt.forward_ntt))
    monkeypatch.setattr(jauto, "inverse_ntt", transform(ntt.inverse_ntt))


def _flatten(out):
    """A case's result as (metadata, residues) pairs, in order."""
    cts = out if isinstance(out, (tuple, list)) else (out,)
    return [((c.chain_index, c.scale, c.noise_scale_deg),
             np.asarray(to_numpy(c.data) if isinstance(c.data, torch.Tensor)
                        else c.data.to_np()).astype(np.uint64)) for c in cts]


@pytest.fixture(scope="module", params=PLANS)
def case(request):
    plan = request.param
    jctx = JContext(_params(plan, JCoeffModulus, JParams, JScheme))
    tctx = _port_ctx(plan)
    rng = np.random.default_rng(90)
    key_q = np.asarray([m.value for m in tctx.key_modulus], dtype=np.uint64)[:, None]
    dnum = -(-tctx.params.size_Q // tctx.params.size_P)
    key = rng.integers(0, 2**62, size=(dnum, 2, len(key_q), N), dtype=np.uint64) % key_q
    rlk = relin_key_from_np(tctx, key)
    raw = _inputs(tctx, rng)
    ref = {}
    with pytest.MonkeyPatch.context() as mp:
        _bridge(mp, jctx, tctx)
        jx = _ref_inputs(raw, rlk)
        for name, fn in CASES.items():
            ref[name] = _flatten(fn(_Pkg(jauto, jcheb, jev), jctx, jx))
    return dict(plan=plan, tctx=tctx, jctx=jctx, x=_port_inputs(tctx, raw, rlk), ref=ref)


@pytest.mark.parametrize("name", list(CASES))
def test_auto_and_chebyshev_match_reference(case, name):
    got = _flatten(CASES[name](_Pkg(auto, cheb, ev), case["tctx"], case["x"]))
    want = case["ref"][name]
    assert [m for m, _ in got] == [m for m, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_ladder_matches_reference(case):
    tctx, jctx = case["tctx"], case["jctx"]
    assert auto.scaling_factors(tctx) == jauto.scaling_factors(jctx)
    assert auto.default_scale(tctx) == jauto.default_scale(jctx)
    assert auto.composite_degree(tctx) == jauto.composite_degree(jctx)
    for size in range(auto.composite_degree(tctx), tctx.params.size_Q + 1):
        assert auto.level_group_product(tctx, size) == jauto.level_group_product(jctx, size)
    for name, ct in case["x"].items():
        if isinstance(ct, Ciphertext):
            assert auto._level(ct, tctx) == jauto._level(_to_ref(ct), jctx)


def test_host_polynomial_helpers_match_reference():
    f = [0.3, -1.2, 0.7, 0.1, 2.0, -0.4, 1.1]
    g = [0.5, 0.2, 1.0, 0.0, 1.0]
    for fn in ("long_division_chebyshev", "long_division_poly"):
        assert getattr(cheb, fn)(f, g) == getattr(jcheb, fn)(f, g)
    for n in (1, 5, 12, 13, 27, 44, 88, 89, 1000, 2204, 2300):
        assert cheb.compute_degrees_ps(n) == jcheb.compute_degrees_ps(n)
    for deg in (5, 13, 44, 88, 2031):
        coeffs = [1.0] * (deg + 1)
        for norm in (True, False):
            assert (cheb.get_mult_depth_by_coeff_vector(coeffs, norm)
                    == jcheb.get_mult_depth_by_coeff_vector(coeffs, norm))
    assert (cheb.eval_chebyshev_coefficients(_sine, -1.5, 2.0, 17)
            == jcheb.eval_chebyshev_coefficients(_sine, -1.5, 2.0, 17))
    assert cheb.degree([1.0, 0.0, 2.0, 0.0]) == jcheb.degree([1.0, 0.0, 2.0, 0.0]) == 2


def test_errors_match_reference(case):
    """A scale mismatch beyond 5% still raises in add; composite raise_mod
    wants the anchor level."""
    tctx, x = case["tctx"], case["x"]
    with pytest.raises(ValueError, match="scale"):
        auto.eval_add_auto(tctx, x["l0"], replace(x["l0b"], scale=x["l0b"].scale * 2.0))
    if case["plan"] == "q32":
        with pytest.raises(ValueError, match="anchor level"):
            auto.raise_mod(tctx, x["l1"])


# -- the port's own decoded errors, at the reference's tolerances ----------

@pytest.fixture(scope="module")
def stack():
    """tests/test_auto_chebyshev.py's stack with the port's own keys."""
    tctx = _port_ctx("u64")
    sk = SecretKey(tctx, seed=9)
    return tctx, CkksEncoder(tctx), sk, sk.relin_key()


def _enc(stack, vals):
    ctx, enc, sk, _ = stack
    return sk.encrypt_symmetric(enc.encode(vals, auto.default_scale(ctx)))


def _dec(stack, ct):
    return stack[1].decode(stack[2].decrypt(ct)).real


def test_decoded_mult_add_const_and_mixed_levels(stack):
    ctx, _, _, rlk = stack
    rng = np.random.default_rng(5)
    x, y = rng.standard_normal(64), rng.standard_normal(64)
    ct = auto.mult_const_core(ctx, _enc(stack, x), 3.5)
    assert ct.noise_scale_deg == 2
    np.testing.assert_allclose(_dec(stack, ct), 3.5 * x, atol=1e-4)
    ct = auto.add_const(ctx, ct, 1.25)
    np.testing.assert_allclose(_dec(stack, ct), 3.5 * x + 1.25, atol=1e-4)
    ct = auto.mod_reduce(ctx, ct, 1)
    assert ct.noise_scale_deg == 1 and ct.chain_index == 2
    np.testing.assert_allclose(_dec(stack, ct), 3.5 * x + 1.25, atol=1e-4)
    cx, cy = _enc(stack, x), _enc(stack, y)
    cy = auto.mult_const_core(ctx, auto.mod_reduce(ctx, auto.mult_const_core(ctx, cy, 2.0), 1),
                              0.5)
    np.testing.assert_allclose(_dec(stack, auto.eval_mult_auto(ctx, cx, cy, rlk)), x * y,
                               atol=1e-3)
    np.testing.assert_allclose(_dec(stack, auto.eval_add_auto(ctx, cx, cy)), x + y, atol=1e-3)


def test_decoded_monomial_and_raise_mod(stack):
    ctx, enc, sk, _ = stack
    rng = np.random.default_rng(6)
    x = rng.standard_normal(64)
    got = enc.decode(sk.decrypt(auto.mult_by_monomial(ctx, _enc(stack, x), ctx.n // 2)))
    np.testing.assert_allclose(got, 1j * x, atol=1e-4)
    ct = _enc(stack, 0.1 * rng.standard_normal(64))
    while ct.chain_index + 1 < len(ctx.chain):
        ct = ev.mod_drop_to_next(ctx, ct)
    raised = auto.raise_mod(ctx, ct)
    assert raised.chain_index == 1
    residual = _coeff_residual(ctx, sk, ct, raised)
    assert all(r % ctx.q_values[0] == 0 for r in residual)
    assert any(r != 0 for r in residual)


def _coeff_residual(ctx, sk, small, raised):
    """Composed decryption coefficients of `raised` minus those of `small`."""
    def coeffs(ct):
        level = ctx.level(ct.chain_index)
        data = ntt.inverse_ntt(sk.decrypt(ct).data, level.ntt)
        return _compose_signed(to_numpy(data), level.base)
    return [b - s for b, s in zip(coeffs(raised), coeffs(small))]


def test_decoded_composite_raise_mod():
    """_raise_mod_composite: the raised decryption differs from the anchor
    level's by exact multiples of the anchor pair's product Qa."""
    ctx = _port_ctx("q32")
    sk = SecretKey(ctx, seed=4)
    enc = CkksEncoder(ctx)
    x = 0.1 * np.random.default_rng(7).standard_normal(N // 2)
    anchor = len(ctx.chain) - 2
    ct = sk.encrypt_symmetric(enc.encode(x, 2.0 ** 40, chain_index=anchor))
    raised = auto.raise_mod(ctx, ct)
    qa = ctx.q_values[0] * ctx.q_values[1]
    residual = _coeff_residual(ctx, sk, ct, raised)
    assert all(r % qa == 0 for r in residual)
    assert any(r != 0 for r in residual)


@pytest.mark.parametrize("deg,func,tol", [(4, "exp", 1e-2), (13, "sine", 2e-2)])
def test_decoded_chebyshev(stack, deg, func, tol):
    ctx, _, _, rlk = stack
    x = np.random.default_rng(deg).uniform(-1, 1, 64)
    f = math.exp if func == "exp" else _sine
    coeffs = cheb.eval_chebyshev_coefficients(f, -1.0, 1.0, deg)
    out = cheb.eval_chebyshev_series(ctx, _enc(stack, x), rlk, coeffs, -1.0, 1.0)
    np.testing.assert_allclose(_dec(stack, out), [f(t) for t in x], atol=tol)


def test_decoded_scale_drift(stack):
    ctx, enc, sk, _ = stack
    x = np.random.default_rng(8).uniform(-1, 1, ctx.n // 2)
    ct = sk.encrypt_symmetric(enc.encode(x, 2.0 ** 40))
    out = auto.eval_add_auto(ctx, ct, replace(ct, scale=ct.scale * 1.01))
    np.testing.assert_allclose(_dec(stack, out), 2 * x, atol=0.05)
