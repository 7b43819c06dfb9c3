"""CKKS evaluator core: add/sub/multiply, hybrid key switching, rescale.

Port of the single-device u64 path of ``tpu_fhe/eval/evaluator.py``:

  * tensor products are elementwise NTT-domain modmuls over (L, N) planes;
  * hybrid key switching = modup (iNTT + per-digit fast base conversion to
    the complement of QlP + NTT) -> beta-digit inner product with the
    Shoup-form evk -> moddown (BEHZ P->Ql conversion + P^{-1} scale fused
    into the forward NTT);
  * rescale divides by q_last with round-half-up via the half-lift trick.

The NTT, base conversion and inner product run as CUDA kernels on a CUDA
context and as their plain torch versions on a CPU context; the glue
between them is plain torch.  Every function returns new tensors.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from ..ops import modarith as mm
from ..ops.bconv import bconv_matmul
from ..ops.ks import key_inner_prod_shoup
from ..ops.ntt import forward_ntt, forward_ntt_sub_scale, inverse_ntt, inverse_ntt_scaled
from ..scheme.ciphertext import Ciphertext, Plaintext
from ..scheme.context import ContextLevel, FheContext
from ..scheme.keys import RelinKey


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


def multiply(ctx: FheContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """NTT-domain tensor product: size-m x size-n -> size (m+n-1),
    c_k = sum_{i+j=k} a_i * b_j; scales multiply."""
    if a.chain_index != b.chain_index:
        raise ValueError("operands at different chain indices")
    mod = ctx.level(a.chain_index).mod
    comps: list = [None] * (a.size + b.size - 1)
    for i in range(a.size):
        for j in range(b.size):
            t = mm.mul_mod(a.data[i], b.data[j], mod.q, mod.ratio_lo, mod.ratio_hi)
            k = i + j
            comps[k] = t if comps[k] is None else mm.add_mod(comps[k], t, mod.q)
    return replace(a, data=torch.stack(comps), scale=a.scale * b.scale,
                   noise_scale_deg=a.noise_scale_deg + b.noise_scale_deg)


def square(ctx: FheContext, a: Ciphertext) -> Ciphertext:
    mod = ctx.level(a.chain_index).mod
    a0, a1 = a.data[0], a.data[1]
    c0 = mm.mul_mod(a0, a0, mod.q, mod.ratio_lo, mod.ratio_hi)
    c2 = mm.mul_mod(a1, a1, mod.q, mod.ratio_lo, mod.ratio_hi)
    cross = mm.mul_mod(a0, a1, mod.q, mod.ratio_lo, mod.ratio_hi)
    cross = mm.add_mod(cross, cross, mod.q)
    return replace(a, data=torch.stack([c0, cross, c2]), scale=a.scale * a.scale,
                   noise_scale_deg=a.noise_scale_deg * 2)


def multiply_plain(ctx: FheContext, a: Ciphertext, pt: Plaintext) -> Ciphertext:
    mod = ctx.level(a.chain_index).mod
    data = mm.mul_mod(a.data, pt.data[None], mod.q, mod.ratio_lo, mod.ratio_hi)
    return replace(a, data=data, scale=a.scale * pt.scale,
                   noise_scale_deg=a.noise_scale_deg + pt.noise_scale_deg)


# --------------------------------------------------------------------------
# hybrid key switching (the hot path)
# --------------------------------------------------------------------------

def modup(ctx: FheContext, level: ContextLevel, c2: torch.Tensor) -> torch.Tensor:
    """Digit-decompose c2 ((size_Ql, N), NTT form) into (beta, size_QlP, N),
    NTT form: iNTT with the per-digit partQlHatInv scale fused, fast-convert
    each digit to the complement of QlP, NTT the converted limbs, and splice
    the digit's own NTT limbs in unchanged."""
    ks = level.ks
    scaled = inverse_ntt_scaled(c2, level.ntt, ks.part_qhatinv, ks.part_qhatinv_shoup)
    digits = []
    for dt in ks.digits:
        conv = bconv_matmul(scaled[dt.start:dt.end], dt.qhat_mod_p, dt.comp_mod.q,
                            dt.comp_mod.ratio_lo, dt.comp_mod.ratio_hi)
        conv_ntt = forward_ntt(conv, dt.comp_ntt)
        digits.append(torch.cat(
            [conv_ntt[: dt.start], c2[dt.start:dt.end], conv_ntt[dt.start:]]))
    return torch.stack(digits)


def key_inner_product(ctx: FheContext, level: ContextLevel, t_mod_up: torch.Tensor,
                      key: RelinKey) -> torch.Tensor:
    """(beta, size_QlP, N) x evk -> (2, size_QlP, N).  Only Shoup-form keys
    (the relin key's default) are supported in this slice."""
    if key.shoup is None:
        raise ValueError("key_inner_product needs a key with Shoup words "
                         "(SecretKey.relin_key(shoup=True))")
    ks = level.ks
    return key_inner_prod_shoup(t_mod_up[: ks.beta].contiguous(), key.data, key.shoup,
                                ks.qlp_key_rows, ks.qlp_q)


def moddown_from_ntt(ctx: FheContext, level: ContextLevel, cx: torch.Tensor) -> torch.Tensor:
    """(..., size_QlP, N) NTT -> (..., size_Ql, N) NTT: subtract the BEHZ
    P->Ql conversion of the P part and scale by P^{-1}."""
    ks = level.ks
    size_Ql = level.size
    scaled = inverse_ntt_scaled(cx[..., size_Ql:, :].contiguous(), ks.p_ntt,
                                ks.p_hatinv, ks.p_hatinv_shoup)
    delta = bconv_matmul(scaled, ks.p_hat_mod_q, level.mod.q, level.mod.ratio_lo,
                         level.mod.ratio_hi)
    # (cx - NTT(delta)) * P^{-1}, fused into the forward transform
    return forward_ntt_sub_scale(delta, cx[..., :size_Ql, :].contiguous(), level.ntt,
                                 ks.big_pinv_mod_q, ks.big_pinv_mod_q_shoup)


def keyswitch_core(ctx: FheContext, level: ContextLevel, c2: torch.Tensor,
                   key: RelinKey) -> torch.Tensor:
    """Full hybrid keyswitch of one polynomial: returns (2, size_Ql, N)."""
    t_mod_up = modup(ctx, level, c2)
    cx = key_inner_product(ctx, level, t_mod_up, key)
    return moddown_from_ntt(ctx, level, cx)


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
                             level.ntt.slice_limbs([size_Ql - 1]))
    # add q_last/2 for rounding, then reduce into each remaining q_i
    last_half = mm.add_mod(last_coeff, half, q_last)
    next_level = ctx.level(a.chain_index + 1)
    rest = next_level.mod
    reduced = mm.barrett_reduce_u64(last_half, rest.q, rest.ratio_hi)   # (size, L-1, N)
    half_mod = mm.barrett_reduce_u64(half, rest.q, rest.ratio_hi)
    tmp = mm.sub_mod(reduced, half_mod, rest.q)
    # (ct - NTT(tmp)) * q_last^{-1}, fused into the forward transform
    out = forward_ntt_sub_scale(tmp, a.data[:, :-1, :].contiguous(), next_level.ntt,
                                level.inv_q_last_mod_q, level.inv_q_last_mod_q_shoup)
    return replace(a, data=out, chain_index=a.chain_index + 1,
                   scale=a.scale / ctx.q_values[size_Ql - 1])
