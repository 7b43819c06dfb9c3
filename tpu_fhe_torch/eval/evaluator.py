"""CKKS evaluator core: add/sub/multiply, hybrid key switching, rescale,
rotations.

Port of the single-device path of ``tpu_fhe/eval/evaluator.py``, on the
u64 plan and on the q32 plan of composite scaling, with the keyswitch's
BFV and BGV branches (coefficient-form input and output, BGV's
t-preserving moddown):

  * tensor products are elementwise NTT-domain modmuls over (L, N) planes
    (the single-word ``mul_mod_q32`` on a q32 context);
  * hybrid key switching = modup (iNTT + per-digit fast base conversion to
    the complement of QlP + NTT) -> beta-digit inner product with the evk
    -> moddown (BEHZ P->Ql conversion + P^{-1} scale fused into the
    forward NTT);
  * rescale divides by q_last with round-half-up via the half-lift trick;
    ``rescale_composite`` divides by the product of the last limbs at once;
  * rotations and conjugation keyswitch the unrotated c1 with a fused
    Galois key and apply the automorphism (a gather) to the result; a step
    with no key rotates through its NAF decomposition.

The NTT, base conversion and inner product run as CUDA kernels on a CUDA
context (K1-K3, K11 and K8 or K7 on the u64 plan; K4-K6, K13 and K10 or
K9 on the q32 plan, the inner product by whether the key has Shoup words)
and as their plain torch versions on a CPU context; the glue between them
is plain torch.  Every function returns new tensors.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from ..core.numth import invert_mod, naf
from ..ops import modarith as mm
from ..ops.bconv import bconv_matmul, bconv_matmul32
from ..ops.galois import apply_galois_ntt, conj_elt, galois_elt_from_step
from ..ops.ks import key_inner_prod, key_inner_prod32, key_inner_prod_shoup
from ..ops.ntt import forward_ntt, forward_ntt_sub_scale, inverse_ntt, inverse_ntt_scaled
from ..scheme.ciphertext import Ciphertext, Plaintext
from ..scheme.context import ContextLevel, FheContext, ModulusVec, SchemeType
from ..scheme.keys import GaloisKey, RelinKey


def _check_compatible(a: Ciphertext, b: Ciphertext):
    if a.chain_index != b.chain_index:
        raise ValueError("ciphertexts at different levels; adjust first")
    if abs(a.scale - b.scale) > 1e-6 * a.scale:
        raise ValueError("scale mismatch in add/sub")


def add(ctx: FheContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    _check_compatible(a, b)
    q = ctx.level(a.chain_index).mod.q
    if a.size == b.size:
        return a.with_data(mm.add_mod(a.data, b.data, q))
    big, small = (a, b) if a.size > b.size else (b, a)
    head = mm.add_mod(big.data[: small.size], small.data, q)
    return a.with_data(torch.cat([head, big.data[small.size:]]))


def sub(ctx: FheContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    _check_compatible(a, b)
    q = ctx.level(a.chain_index).mod.q
    if a.size == b.size:
        return a.with_data(mm.sub_mod(a.data, b.data, q))
    if a.size > b.size:
        head = mm.sub_mod(a.data[: b.size], b.data, q)
        return a.with_data(torch.cat([head, a.data[b.size:]]))
    head = mm.sub_mod(a.data, b.data[: a.size], q)
    return a.with_data(torch.cat([head, mm.neg_mod(b.data[a.size:], q)]))


def negate(ctx: FheContext, a: Ciphertext) -> Ciphertext:
    return a.with_data(mm.neg_mod(a.data, ctx.level(a.chain_index).mod.q))


def add_plain(ctx: FheContext, a: Ciphertext, pt: Plaintext) -> Ciphertext:
    head = mm.add_mod(a.data[0], pt.data, ctx.level(a.chain_index).mod.q)
    return a.with_data(torch.cat([head[None], a.data[1:]]))


def sub_plain(ctx: FheContext, a: Ciphertext, pt: Plaintext) -> Ciphertext:
    head = mm.sub_mod(a.data[0], pt.data, ctx.level(a.chain_index).mod.q)
    return a.with_data(torch.cat([head[None], a.data[1:]]))


def multiply(ctx: FheContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """NTT-domain tensor product: size-m x size-n -> size (m+n-1),
    c_k = sum_{i+j=k} a_i * b_j; scales multiply."""
    if a.chain_index != b.chain_index:
        raise ValueError("operands at different chain indices")
    mod = ctx.level(a.chain_index).mod
    comps: list = [None] * (a.size + b.size - 1)
    for i in range(a.size):
        for j in range(b.size):
            t = mod.mul(a.data[i], b.data[j])
            k = i + j
            comps[k] = t if comps[k] is None else mm.add_mod(comps[k], t, mod.q)
    return replace(a, data=torch.stack(comps), scale=a.scale * b.scale,
                   noise_scale_deg=a.noise_scale_deg + b.noise_scale_deg)


def square(ctx: FheContext, a: Ciphertext) -> Ciphertext:
    mod = ctx.level(a.chain_index).mod
    a0, a1 = a.data[0], a.data[1]
    c0, c2, cross = mod.mul(a0, a0), mod.mul(a1, a1), mod.mul(a0, a1)
    cross = mm.add_mod(cross, cross, mod.q)
    return replace(a, data=torch.stack([c0, cross, c2]), scale=a.scale * a.scale,
                   noise_scale_deg=a.noise_scale_deg * 2)


def multiply_plain(ctx: FheContext, a: Ciphertext, pt: Plaintext) -> Ciphertext:
    data = ctx.level(a.chain_index).mod.mul(a.data, pt.data[None])
    return replace(a, data=data, scale=a.scale * pt.scale,
                   noise_scale_deg=a.noise_scale_deg + pt.noise_scale_deg)


# --------------------------------------------------------------------------
# hybrid key switching (the hot path)
# --------------------------------------------------------------------------

def _bconv(scaled: torch.Tensor, table: torch.Tensor, diag: torch.Tensor,
           out: ModulusVec) -> torch.Tensor:
    """Base conversion into the moduli `out`, with the table's digit matrix
    `diag`: K13's form on a q32 context, K12's (K11's for k >= 64)
    otherwise."""
    if out.fold is not None:
        return bconv_matmul32(scaled, table, out.q, out.fold, diag)
    return bconv_matmul(scaled, table, out.q, out.ratio_lo, out.ratio_hi, diag)


def _reduce(x: torch.Tensor, out: ModulusVec) -> torch.Tensor:
    """x mod q_i, in the word of `out`, for non-negative x below 2^62."""
    if out.fold is not None:
        return torch.remainder(x, out.q).to(torch.int32)
    return mm.barrett_reduce_u64(x, out.q, out.ratio_hi)


def modup(ctx: FheContext, level: ContextLevel, c2: torch.Tensor, *,
          is_ntt: bool = True) -> torch.Tensor:
    """Digit-decompose c2 ((size_Ql, N)) into (beta, size_QlP, N), NTT form:
    iNTT with the per-digit partQlHatInv scale fused, fast-convert each
    digit to the complement of QlP, NTT the converted limbs, and splice the
    digit's own NTT limbs in unchanged.  With is_ntt=False (BFV's
    coefficient-form input) the digits are scaled without a transform and
    each digit's own limbs are forward-transformed instead."""
    ks = level.ks
    if is_ntt:
        scaled = inverse_ntt_scaled(c2, level.ntt, ks.part_qhatinv, ks.part_qhatinv_shoup)
    else:
        scaled = mm.mul_shoup(c2, ks.part_qhatinv, ks.part_qhatinv_shoup, level.mod.q)
    digits = []
    for dt in ks.digits:
        conv = _bconv(scaled[dt.start:dt.end], dt.qhat_mod_p, dt.qhat_mod_p_diag, dt.comp_mod)
        conv_ntt = forward_ntt(conv, dt.comp_ntt)
        own = c2[dt.start:dt.end]
        if not is_ntt:
            own = forward_ntt(own, ctx.ntt_view(level.ntt, tuple(range(dt.start, dt.end))))
        digits.append(torch.cat([conv_ntt[: dt.start], own, conv_ntt[dt.start:]]))
    return torch.stack(digits)


def key_inner_product(ctx: FheContext, level: ContextLevel, t_mod_up: torch.Tensor,
                      key: RelinKey) -> torch.Tensor:
    """(beta, size_QlP, N) x evk -> (2, size_QlP, N): K8/K10 for a key with
    Shoup words (the relin key's default), K7/K9 for one without (the
    Galois keys' default)."""
    ks = level.ks
    t = t_mod_up[: ks.beta].contiguous()
    qlp = ks.qlp_mod
    if key.shoup is not None:
        return key_inner_prod_shoup(t, key.data, key.shoup, ks.qlp_key_rows, qlp.q)
    if qlp.fold is not None:
        return key_inner_prod32(t, key.data, ks.qlp_key_rows, qlp.q, qlp.fold)
    return key_inner_prod(t, key.data, ks.qlp_key_rows, qlp.q, qlp.ratio_lo, qlp.ratio_hi)


def moddown_from_ntt(ctx: FheContext, level: ContextLevel, cx: torch.Tensor, *,
                     output_ntt: bool = True) -> torch.Tensor:
    """(..., size_QlP, N) NTT -> (..., size_Ql, N): subtract the BEHZ
    P->Ql conversion of the P part and scale by P^{-1}, fused into the
    forward transform's landing.  With output_ntt=False (BFV) the Ql part
    is inverse-transformed and the subtraction happens in the coefficient
    domain instead.  On a BGV context the subtraction preserves t: delta =
    t*U with U = [x * t^-1]_P, so delta = x (mod P) and 0 (mod t), and the
    conversion's alpha*t*P overshoot divides to alpha*t = 0 (mod t)."""
    ks = level.ks
    size_Ql = level.size
    p_part = cx[..., size_Ql:, :].contiguous()
    pre = pre_shoup = None
    if ctx.scheme == SchemeType.bgv:
        scaled = inverse_ntt_scaled(p_part, ks.p_ntt, ks.tinv_p_hatinv, ks.tinv_p_hatinv_shoup)
        pre, pre_shoup = ks.t_mod_q, ks.t_mod_q_shoup
    else:
        scaled = inverse_ntt_scaled(p_part, ks.p_ntt, ks.p_hatinv, ks.p_hatinv_shoup)
    delta = _bconv(scaled, ks.p_hat_mod_q, ks.p_hat_mod_q_diag, level.mod)
    if output_ntt:
        # (cx - pre * NTT(delta)) * P^{-1}, fused into the forward transform
        return forward_ntt_sub_scale(delta, cx[..., :size_Ql, :].contiguous(), level.ntt,
                                     ks.big_pinv_mod_q, ks.big_pinv_mod_q_shoup,
                                     pre=pre, pre_shoup=pre_shoup)
    if pre is not None:
        delta = mm.mul_shoup(delta, pre, pre_shoup, level.mod.q)
    ql_coeff = inverse_ntt(cx[..., :size_Ql, :].contiguous(), level.ntt)
    return mm.mul_shoup(mm.sub_mod(ql_coeff, delta, level.mod.q), ks.big_pinv_mod_q,
                        ks.big_pinv_mod_q_shoup, level.mod.q)


def keyswitch_core(ctx: FheContext, level: ContextLevel, c2: torch.Tensor, key: RelinKey, *,
                   input_ntt: bool = True, output_ntt: bool = True) -> torch.Tensor:
    """Full hybrid keyswitch of one polynomial: returns (2, size_Ql, N), in
    NTT form unless output_ntt is False; c2 in NTT form unless input_ntt
    is False."""
    t_mod_up = modup(ctx, level, c2, is_ntt=input_ntt)
    cx = key_inner_product(ctx, level, t_mod_up, key)
    return moddown_from_ntt(ctx, level, cx, output_ntt=output_ntt)


def relinearize(ctx: FheContext, a: Ciphertext, rlk: RelinKey) -> Ciphertext:
    """size-3 -> size-2 using the relinearization key."""
    if a.size != 3:
        raise ValueError("relinearize expects a size-3 ciphertext")
    level = ctx.level(a.chain_index)
    delta = keyswitch_core(ctx, level, a.data[2].contiguous(), rlk)
    return a.with_data(mm.add_mod(a.data[:2], delta, level.mod.q))


def rescale_to_next(ctx: FheContext, a: Ciphertext) -> Ciphertext:
    """Divide by q_last with rounding; drops one limb and one chain level."""
    if a.chain_index + 1 >= len(ctx.chain):
        raise ValueError("already at the last level; cannot rescale")
    level = ctx.level(a.chain_index)
    size_Ql = level.size
    q_last = level.mod.q[-1:]                  # (1, 1)
    half = q_last >> 1
    last_coeff = inverse_ntt(a.data[:, -1:, :].contiguous(),
                             ctx.ntt_view(level.ntt, (size_Ql - 1,)))
    # add q_last/2 for rounding, then reduce into each remaining q_i
    last_half = mm.add_mod(last_coeff, half, q_last)
    next_level = ctx.level(a.chain_index + 1)
    rest = next_level.mod
    reduced = _reduce(last_half, rest)           # (size, L-1, N)
    tmp = mm.sub_mod(reduced, _reduce(half, rest), rest.q)
    # (ct - NTT(tmp)) * q_last^{-1}, fused into the forward transform
    out = forward_ntt_sub_scale(tmp, a.data[:, :-1, :].contiguous(), next_level.ntt,
                                level.inv_q_last_mod_q, level.inv_q_last_mod_q_shoup)
    return replace(a, data=out, chain_index=a.chain_index + 1,
                   scale=a.scale / ctx.q_values[size_Ql - 1])


def _garner_compose_u64(level: ContextLevel, coeff: torch.Tensor, start: int, count: int,
                        qs: list[int]) -> torch.Tensor:
    """CRT-compose `count` consecutive limb residues (chain positions
    start .. start+count-1 of `level`) into the exact value mod their
    product, which the caller guarantees is below 2^62, as int64.  Garner:
    extend one prime at a time with v_i = (x_i - cur) * inv(prod_prev) mod q_i."""
    cur = coeff[..., 0:1, :].to(torch.int64)
    prod_prev = qs[0]
    for i in range(1, count):
        mod = level.mod.rows(slice(start + i, start + i + 1))
        diff = mm.sub_mod(coeff[..., i:i + 1, :], _reduce(cur, mod), mod.q)
        v = mod.mul(diff, torch.full_like(mod.q, invert_mod(prod_prev % qs[i], qs[i])))
        cur = v.to(torch.int64) * prod_prev + cur
        prod_prev *= qs[i]
    return cur


def rescale_composite(ctx: FheContext, a: Ciphertext, limbs: int = 2) -> Ciphertext:
    """Composite-scaling rescale: one divide-and-round by the product Q2 of
    the last `limbs` primes, dropping `limbs` chain levels.  One logical
    CKKS level of the q32 regime spans a pair of ~30-bit primes, so a
    multiplication rescales by both.  When Q2 fits 62 bits: iNTT only the
    dropped limbs, Garner-compose them to the exact value mod Q2, apply the
    rounding shift, and land the subtraction and the Q2^{-1} scale in one
    fused forward pass; otherwise `limbs` sequential rescales."""
    if limbs == 1:
        return rescale_to_next(ctx, a)
    if a.chain_index + limbs >= len(ctx.chain):
        raise ValueError("not enough levels left to rescale")
    level = ctx.level(a.chain_index)
    size_Ql = level.size
    if size_Ql - limbs < 1:
        raise ValueError("no modulus left to rescale")
    keep = size_Ql - limbs
    qd = ctx.q_values[keep:size_Ql]
    q2 = 1
    for v in qd:
        q2 *= v
    if q2.bit_length() > 62:
        for _ in range(limbs):
            a = rescale_to_next(ctx, a)
        return a

    drop_ntt, inv_q2, inv_q2_shoup, half_mod = ctx.composite_rescale_tables(a.chain_index,
                                                                            limbs)
    coeff = inverse_ntt(a.data[:, keep:, :].contiguous(), drop_ntt)
    v = _garner_compose_u64(level, coeff, keep, limbs, qd)            # [0, Q2)
    # w = (v + Q2/2) mod Q2, then per remaining limb tmp_i = (w - Q2/2) mod
    # q_i, so that x - tmp == round(x / Q2) * Q2 (mod q_i)
    w = mm.csub(v + (q2 >> 1), q2)
    next_level = ctx.level(a.chain_index + limbs)
    tmp = mm.sub_mod(_reduce(w, next_level.mod), half_mod, next_level.mod.q)
    out = forward_ntt_sub_scale(tmp, a.data[:, :keep, :].contiguous(), next_level.ntt,
                                inv_q2, inv_q2_shoup)
    scale = a.scale
    for v_ in qd:
        scale /= float(v_)
    return replace(a, data=out, chain_index=a.chain_index + limbs, scale=scale)


def mod_drop_to_next(ctx: FheContext, a: Ciphertext) -> Ciphertext:
    """Drop the last limb without scaling (mod switch)."""
    if a.chain_index + 1 >= len(ctx.chain):
        raise ValueError("already at the last level; cannot drop further")
    return replace(a, data=a.data[:, :-1, :].contiguous(), chain_index=a.chain_index + 1)


# --------------------------------------------------------------------------
# rotations
# --------------------------------------------------------------------------

def rotate(ctx: FheContext, a: Ciphertext, step: int, gk: GaloisKey) -> Ciphertext:
    """Rotate the slots left by `step`.  When `gk` has no key for the
    step, rotate by the parts of its NAF decomposition in turn (each a
    power of two), so the O(log N) key set of galois_key_power_of_2 serves
    every step."""
    elt = galois_elt_from_step(step, ctx.n)
    if elt == 1:
        return a
    try:
        key = gk.key_for_elt(elt)
    except ValueError:
        parts = naf(step)
        if len(parts) <= 1:
            raise      # a power-of-two step with no key: nothing to compose
        out = a
        slots = ctx.n // 2
        for s in parts:
            if abs(s) != slots:
                out = rotate(ctx, out, s, gk)
        return out
    return apply_galois_with_key(ctx, a, elt, key)


def conjugate(ctx: FheContext, a: Ciphertext, gk: GaloisKey) -> Ciphertext:
    return apply_galois(ctx, a, conj_elt(ctx.n), gk)


def apply_galois(ctx: FheContext, a: Ciphertext, elt: int, gk: GaloisKey) -> Ciphertext:
    if elt == 1:
        return a
    return apply_galois_with_key(ctx, a, elt, gk.key_for_elt(elt))


def apply_galois_with_key(ctx: FheContext, a: Ciphertext, elt: int,
                          key: RelinKey) -> Ciphertext:
    """Fused-form automorphism: keyswitch the unrotated c1 with the key
    Enc_{sigma^-1(s)}(P*s), add c0, then apply sigma to both components."""
    if a.size != 2:
        raise ValueError("rotate expects a size-2 ciphertext")
    level = ctx.level(a.chain_index)
    d = keyswitch_core(ctx, level, a.data[1].contiguous(), key)
    c0 = mm.add_mod(a.data[0], d[0], level.mod.q)
    return a.with_data(apply_galois_ntt(torch.stack([c0, d[1]]), elt, ctx.n))
