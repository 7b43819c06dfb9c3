"""FLEXIBLEAUTO CKKS semantics (OpenFHE-style automatic rescaling).

Port of ``tpu_fhe/eval/auto.py`` on both words: the scaling-factor
ladder, level/depth adjustment (AdjustLevelsAndDepth, branch for branch),
the auto add/sub/multiply/square, scalar ops through CRT lifts, ModReduce,
RaiseMod (mod-raise to the full chain for bootstrapping) and
MultByMonomial.

noiseScaleDeg in {1, 2} is the degree of the scaling factor a ciphertext
carries; logical level l spans ``composite_degree`` limbs and starts at
chain index l * composite_degree + 1.  Scalars are lifted on the host with
exact Python integers and go to the device as (k, 1) columns in the
context's word; the data work is ``ModulusVec.mul``, ``modarith.add_mod`` /
``sub_mod`` and the evaluator's ops, so on a CUDA context the NTTs, base
conversions and inner products run as the port's kernels.  A ciphertext
may carry leading batch axes ((..., size, L, N)); the scalar columns
broadcast over them, and every branch reads metadata, which a batch shares.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..ops import modarith as mm
from ..ops.ntt import forward_ntt, inverse_ntt
from ..scheme.ciphertext import Ciphertext, Plaintext
from ..scheme.context import FheContext
from ..scheme.keys import RelinKey
from . import evaluator as ev


# --------------------------------------------------------------------------
# scaling factor ladder
# --------------------------------------------------------------------------

def composite_degree(ctx: FheContext) -> int:
    """Limbs per logical CKKS level (1 = classic; > 1 = composite scaling,
    the q32 regime where a logical level is a group of ~30-bit primes)."""
    return ctx.params.composite_degree


def level_group_product(ctx: FheContext, size_Ql: int) -> float:
    """Product of the primes one mod_reduce at limb count size_Ql divides
    by: the last `composite_degree` primes of the level."""
    prod = 1.0
    for v in ctx.q_values[size_Ql - composite_degree(ctx):size_Ql]:
        prod *= float(v)
    return prod


def scaling_factors(ctx: FheContext) -> tuple[list[float], list[float]]:
    """sf[0] = Qg_{G-1}; sf[k] = sf[k-1]^2 / Qg_{G-k}; big[k] = sf[k]^2,
    where Qg_j is the product of logical level group j's primes.  Computed
    once per context."""
    cached = ctx.__dict__.get("_flexauto_sf")
    if cached is not None:
        return cached
    q = ctx.q_values
    d = composite_degree(ctx)
    G = len(q) // d
    qg = []
    for j in range(G):
        prod = 1.0
        for v in q[d * j:d * j + d]:
            prod *= float(v)
        qg.append(prod)
    sf = [qg[G - 1]]
    for k in range(1, G):
        sf.append(sf[k - 1] * sf[k - 1] / qg[G - k])
        if not 0.5 < sf[k] / sf[0] < 2.0:
            raise ValueError("FLEXIBLEAUTO scaling-factor drift out of range; choose "
                             "data primes closer to 2^p")
    out = (sf, [s * s for s in sf])
    ctx.__dict__["_flexauto_sf"] = out
    return out


def default_scale(ctx: FheContext) -> float:
    return scaling_factors(ctx)[0][0]


def _level(ct: Ciphertext, ctx: FheContext) -> int:
    """The logical level of `ct`: its chain index in groups of
    `composite_degree` limbs."""
    return (ct.chain_index - 1) // composite_degree(ctx)


# --------------------------------------------------------------------------
# ModReduce / level switching (logical levels: `composite_degree` limbs each)
# --------------------------------------------------------------------------

def mod_reduce(ctx: FheContext, ct: Ciphertext, levels: int = 1) -> Ciphertext:
    d = composite_degree(ctx)
    out = ct
    for _ in range(levels):
        # composite: one fused divide-and-round by the group product
        out = ev.rescale_composite(ctx, out, d) if d > 1 else ev.rescale_to_next(ctx, out)
    return replace(out, noise_scale_deg=ct.noise_scale_deg - levels)


def mod_switch_level(ctx: FheContext, ct: Ciphertext, levels: int) -> Ciphertext:
    out = ct
    for _ in range(levels * composite_degree(ctx)):
        out = ev.mod_drop_to_next(ctx, out)
    return out


# --------------------------------------------------------------------------
# scalar CRT lifts (GetElementForEvalMult / AddOrSub)
# --------------------------------------------------------------------------

def _crt_lift_mult(ctx: FheContext, ct: Ciphertext, operand: float) -> list[int]:
    """round(operand * sf[level]) as residues mod each q_i: the float
    product keeps f64 precision and Python's float -> int is exact."""
    sf, _ = scaling_factors(ctx)
    large = int(round(operand * sf[_level(ct, ctx)]))
    return [large % q for q in ctx.level(ct.chain_index).base.values]


def _crt_lift_addsub(ctx: FheContext, ct: Ciphertext, operand: float) -> list[int]:
    """round(operand * sf) * round(sf)^(noiseDeg - 1) mod q_i."""
    sf, _ = scaling_factors(ctx)
    scf = sf[_level(ct, ctx)]
    const = int(round(operand * scf))
    int_scf = int(round(scf))
    for _ in range(1, ct.noise_scale_deg):
        const *= int_scf
    return [const % q for q in ctx.level(ct.chain_index).base.values]


def _scalar_col(ctx: FheContext, residues: list[int]) -> torch.Tensor:
    """Per-limb scalars as a (k, 1) column in the context's word."""
    arr = np.array(residues, dtype=np.uint64).reshape(-1, 1)
    return (mm.u32_tensor if ctx.is_q32 else mm.u64_tensor)(arr, ctx.device)


def _mul_col(ctx: FheContext, ct: Ciphertext, residues: list[int]) -> torch.Tensor:
    """ct's data times per-limb scalars, canonical."""
    mod = ctx.level(ct.chain_index).mod
    return mod.mul(ct.data, _scalar_col(ctx, residues)[None])


def mult_const_core(ctx: FheContext, ct: Ciphertext, operand: float) -> Ciphertext:
    """Multiply by a double: noiseScaleDeg += 1, scale *= sf[level]."""
    sf, _ = scaling_factors(ctx)
    return replace(ct, data=_mul_col(ctx, ct, _crt_lift_mult(ctx, ct, operand)),
                   noise_scale_deg=ct.noise_scale_deg + 1,
                   scale=ct.scale * sf[_level(ct, ctx)])


def mult_const(ctx: FheContext, ct: Ciphertext, operand: float) -> Ciphertext:
    """EvalMultConst: mod-reduce first when noiseScaleDeg == 2, so the degree
    never exceeds 2."""
    if ct.noise_scale_deg == 2:
        ct = mod_reduce(ctx, ct, 1)
    return mult_const_core(ctx, ct, operand)


def _c0_op(ctx: FheContext, ct: Ciphertext, operand: float, op) -> Ciphertext:
    q = ctx.level(ct.chain_index).mod.q
    c0 = op(ct.data[..., 0, :, :], _scalar_col(ctx, _crt_lift_addsub(ctx, ct, operand)), q)
    return ev.with_c0(ct, c0)


def add_const(ctx: FheContext, ct: Ciphertext, operand: float) -> Ciphertext:
    if operand == 0:
        return ct
    return _c0_op(ctx, ct, operand, mm.add_mod)


def sub_const(ctx: FheContext, ct: Ciphertext, operand: float) -> Ciphertext:
    return _c0_op(ctx, ct, operand, mm.sub_mod)


# --------------------------------------------------------------------------
# AdjustLevelsAndDepth (branch for branch)
# --------------------------------------------------------------------------

def adjust_levels_and_depth(ctx: FheContext, c1: Ciphertext,
                            c2: Ciphertext) -> tuple[Ciphertext, Ciphertext]:
    sf, sf_big = scaling_factors(ctx)
    c1lvl, c2lvl = _level(c1, ctx), _level(c2, ctx)
    if c1lvl < c2lvl:
        c1 = _adjust_lower(ctx, c1, c2, sf, sf_big)
    elif c1lvl > c2lvl:
        c2 = _adjust_lower(ctx, c2, c1, sf, sf_big)
    elif c1.noise_scale_deg < c2.noise_scale_deg:
        c1 = mult_const_core(ctx, c1, 1.0)
    elif c2.noise_scale_deg < c1.noise_scale_deg:
        c2 = mult_const_core(ctx, c2, 1.0)
    return c1, c2


def _adjust_lower(ctx: FheContext, lo: Ciphertext, hi: Ciphertext, sf, sf_big) -> Ciphertext:
    """Bring `lo` (at the lower level = larger modulus) to `hi`'s level."""
    lolvl, hilvl = _level(lo, ctx), _level(hi, ctx)
    q1 = level_group_product(ctx, ctx.level(lo.chain_index).size)
    scf = sf[lolvl]
    if lo.noise_scale_deg == 2:
        if hi.noise_scale_deg == 2:
            lo = mult_const_core(ctx, lo, hi.scale / lo.scale * q1 / scf)
            lo = mod_reduce(ctx, lo, 1)
            if lolvl + 1 < hilvl:
                lo = mod_switch_level(ctx, lo, hilvl - lolvl - 1)
            return replace(lo, scale=hi.scale)
        if lolvl + 1 == hilvl:
            return mod_reduce(ctx, lo, 1)
        lo = mult_const_core(ctx, lo, sf_big[hilvl - 1] / lo.scale * q1 / scf)
        lo = mod_reduce(ctx, lo, 1)
        if lolvl + 2 < hilvl:
            lo = mod_switch_level(ctx, lo, hilvl - lolvl - 2)
        lo = mod_reduce(ctx, lo, 1)
        return replace(lo, scale=hi.scale)
    if hi.noise_scale_deg == 2:
        lo = mult_const_core(ctx, lo, hi.scale / lo.scale / scf)
        lo = mod_switch_level(ctx, lo, hilvl - lolvl)
        return replace(lo, scale=hi.scale)
    lo = mult_const_core(ctx, lo, sf_big[hilvl - 1] / lo.scale / scf)
    if lolvl + 1 < hilvl:
        lo = mod_switch_level(ctx, lo, hilvl - lolvl - 1)
    lo = mod_reduce(ctx, lo, 1)
    return replace(lo, scale=hi.scale)


# --------------------------------------------------------------------------
# auto ops
# --------------------------------------------------------------------------

def _snap_scales(a: Ciphertext, b: Ciphertext):
    """FLEXIBLEAUTO add/sub tolerance: after level/depth adjustment the two
    operands' ladder scales can still differ by the per-level sf-ratio
    drift.  Within 5% relative, b takes a's scale (the bounded relative
    error the reference accepts); beyond that add/sub still raises."""
    if a.chain_index == b.chain_index and b.scale != a.scale:
        if abs(a.scale - b.scale) < 0.05 * abs(a.scale):
            b = replace(b, scale=a.scale)
    return a, b


def eval_add_auto(ctx: FheContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    a, b = _snap_scales(*adjust_levels_and_depth(ctx, a, b))
    return ev.add(ctx, a, b)


def eval_sub_auto(ctx: FheContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    a, b = _snap_scales(*adjust_levels_and_depth(ctx, a, b))
    return ev.sub(ctx, a, b)


def eval_mult_auto(ctx: FheContext, a: Ciphertext, b: Ciphertext,
                   rlk: RelinKey) -> Ciphertext:
    a, b = adjust_levels_and_depth(ctx, a, b)
    if a.noise_scale_deg == 2:
        a = mod_reduce(ctx, a, 1)
        b = mod_reduce(ctx, b, 1)
    deg = a.noise_scale_deg + b.noise_scale_deg
    out = ev.relinearize(ctx, ev.multiply(ctx, a, b), rlk)
    return replace(out, noise_scale_deg=deg)


def eval_square_auto(ctx: FheContext, a: Ciphertext, rlk: RelinKey) -> Ciphertext:
    if a.noise_scale_deg == 2:
        a = mod_reduce(ctx, a, 1)
    deg = 2 * a.noise_scale_deg
    out = ev.relinearize(ctx, ev.square(ctx, a), rlk)
    return replace(out, noise_scale_deg=deg)


def eval_mult_plain_auto(ctx: FheContext, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
    """Multiply by a plaintext: treat it as a size-1 ciphertext, adjust,
    multiply slot-wise."""
    morph = Ciphertext(data=pt.data[None], chain_index=pt.chain_index, scale=pt.scale,
                       noise_scale_deg=pt.noise_scale_deg)
    ct2, morph = adjust_levels_and_depth(ctx, ct, morph)
    if ct2.noise_scale_deg == 2:
        ct2 = mod_reduce(ctx, ct2, 1)
        morph = mod_reduce(ctx, morph, 1)
    data = ctx.level(ct2.chain_index).mod.mul(ct2.data, morph.data[..., 0:1, :, :])
    return replace(ct2, data=data, scale=ct2.scale * morph.scale,
                   noise_scale_deg=ct2.noise_scale_deg + morph.noise_scale_deg)


# --------------------------------------------------------------------------
# RaiseMod and MultByMonomial
# --------------------------------------------------------------------------

def raise_mod(ctx: FheContext, ct: Ciphertext) -> Ciphertext:
    """Mod-raise to the full chain: compose the anchor's residues of each
    component to its exact coefficient mod Qa (the anchor prime q0, or on a
    composite chain the product of the anchor group's primes by Garner,
    below 2^62), centre it against Qa, reduce it into every limb of Q and
    forward-NTT the result.  A composite chain takes the ciphertext at the
    anchor level only."""
    d = composite_degree(ctx)
    level = ctx.level(ct.chain_index)
    if d > 1 and level.size != d:
        raise ValueError("composite RaiseMod expects the ciphertext at the anchor level "
                         f"(size {d}), got size {level.size}")
    qs = ctx.q_values[:d]
    anchor = ct.data if level.size == d else ct.data[..., :d, :].contiguous()
    coeff = inverse_ntt(anchor, ctx.ntt_view(level.ntt, tuple(range(d))))
    cur = ev._garner_compose_u64(level.mod, coeff, 0, d, qs)         # [0, Qa)
    qa = 1
    for v in qs:
        qa *= v
    first = ctx.first_data_level
    # (cur - Qa) mod q_j as (cur + (q_j - Qa mod q_j)) mod q_j: the sum
    # stays below 2^62
    shift = mm.u64_tensor([[q - qa % q] for q in first.base.values], ctx.device)
    lifted = torch.where(cur > qa >> 1, cur + shift, cur)
    data = forward_ntt(ev._reduce(lifted, first.mod), first.ntt)
    return replace(ct, data=data, chain_index=1)


def mult_by_monomial(ctx: FheContext, ct: Ciphertext, power: int) -> Ciphertext:
    """Multiply by x^power (exact, scale-free)."""
    level = ctx.level(ct.chain_index)
    n = ctx.n
    power %= 2 * n
    mono = np.zeros((level.size, n), dtype=np.uint64)
    mono[:, power % n] = 1 if power < n else [q - 1 for q in level.base.values]
    word = mm.u32_tensor if ctx.is_q32 else mm.u64_tensor
    mono_ntt = forward_ntt(word(mono, ctx.device), level.ntt)
    return ct.with_data(level.mod.mul(ct.data, mono_ntt[None]))


def mult_by_integer(ctx: FheContext, ct: Ciphertext, value: int) -> Ciphertext:
    """Multiply by an exact integer (no scale change)."""
    return ct.with_data(_mul_col(ctx, ct, [value % q for q in
                                           ctx.level(ct.chain_index).base.values]))
