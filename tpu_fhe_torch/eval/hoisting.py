"""Hoisted rotations and operations at the extended basis QlP.

Port of ``tpu_fhe/eval/hoisting.py``: one modup of c1 is shared by every
rotation of a ciphertext; the per-rotation work is the inner product with
the fused Galois key (K7/K9, or K8/K10 with Shoup words) and a gather,
sums accumulate at QlP, and one moddown lands the result.

An extended ("ext") ciphertext is an ordinary Ciphertext whose limb axis
has size_Ql + size_P limbs and whose data is P times its logical value.
Every function returns new tensors, and takes a ciphertext with leading
batch axes ((..., size, L, N)) as well as one.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from ..ops import modarith as mm
from ..ops.galois import apply_galois_ntt, galois_elt_from_step
from ..scheme.ciphertext import Ciphertext, Plaintext
from ..scheme.context import FheContext
from ..scheme.keys import GaloisKey, RelinKey
from .evaluator import key_inner_product, moddown_from_ntt, modup, with_c0


def _times_p(ctx: FheContext, ct: Ciphertext, data: torch.Tensor) -> torch.Tensor:
    """[P * data]_{q_i} on the Ql limbs of `ct`'s level."""
    level = ctx.level(ct.chain_index)
    ks = level.ks
    return mm.mul_shoup(data, ks.big_p_mod_q, ks.big_p_mod_q_shoup, level.mod.q)


def fast_rotation_precompute(ctx: FheContext, ct: Ciphertext) -> torch.Tensor:
    """The one modup of c1 that every rotation of `ct` shares:
    (..., beta, size_QlP, N)."""
    return modup(ctx, ctx.level(ct.chain_index), ct.data[..., 1, :, :].contiguous())


def _rotation_ext(ctx: FheContext, ct: Ciphertext, precomp: torch.Tensor, elt: int,
                  key: RelinKey, p_c0: torch.Tensor | None) -> Ciphertext:
    """fast_rotation_ext with P*c0 given (None: not added)."""
    level = ctx.level(ct.chain_index)
    cx = key_inner_product(ctx, level, precomp, key)     # (..., 2, QlP, N), P * (...)
    if p_c0 is not None:
        size_Ql = level.size
        c0 = mm.add_mod(cx[..., 0, :size_Ql, :], p_c0, level.mod.q)
        c0 = torch.cat([c0, cx[..., 0, size_Ql:, :]], dim=-2)
        cx = torch.stack([c0, cx[..., 1, :, :]], dim=-3)
    return ct.with_data(apply_galois_ntt(cx, elt, ctx.n))


def fast_rotation_ext(ctx: FheContext, ct: Ciphertext, precomp: torch.Tensor, elt: int,
                      key: RelinKey, add_first: bool) -> Ciphertext:
    """A rotation at QlP: the inner product of the hoisted digits with the
    fused key, with `add_first` plus P*c0 on the Ql limbs of its first
    component, then the automorphism."""
    p_c0 = _times_p(ctx, ct, ct.data[..., 0, :, :]) if add_first else None
    return _rotation_ext(ctx, ct, precomp, elt, key, p_c0)


def keyswitch_ext(ctx: FheContext, ct: Ciphertext) -> Ciphertext:
    """Lift a ciphertext from Ql to QlP: every Ql limb times P mod q_j, the
    P limbs zero."""
    scaled = _times_p(ctx, ct, ct.data)
    zeros = scaled.new_zeros(scaled.shape[:-2] + (ctx.level(ct.chain_index).ks.alpha, ctx.n))
    return ct.with_data(torch.cat([scaled, zeros], dim=-2))


def keyswitch_down(ctx: FheContext, ct_ext: Ciphertext) -> Ciphertext:
    """Moddown every component: QlP -> Ql, dividing by P."""
    return ct_ext.with_data(moddown_from_ntt(ctx, ctx.level(ct_ext.chain_index), ct_ext.data))


def keyswitch_down_first(ctx: FheContext, ct_ext: Ciphertext) -> Ciphertext:
    """Moddown c0 only; returns a size-1 ciphertext."""
    level = ctx.level(ct_ext.chain_index)
    return ct_ext.with_data(moddown_from_ntt(ctx, level, ct_ext.data[..., 0:1, :, :]))


def eval_mult_ext(ctx: FheContext, ct_ext: Ciphertext, pt_ext: Plaintext) -> Ciphertext:
    """Multiply an ext ciphertext by a plaintext encoded at QlP (the
    single-word multiply on a q32 context)."""
    qlp = ctx.level(ct_ext.chain_index).ks.qlp_mod
    return replace(ct_ext, data=qlp.mul(ct_ext.data, pt_ext.data[None]),
                   scale=ct_ext.scale * pt_ext.scale,
                   noise_scale_deg=ct_ext.noise_scale_deg + pt_ext.noise_scale_deg)


def eval_add_ext(ctx: FheContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    q = ctx.level(a.chain_index).ks.qlp_mod.q
    return a.with_data(mm.add_mod(a.data, b.data, q))


def reset_poly_ext(ctx: FheContext, ct_ext: Ciphertext, index: int = 0) -> Ciphertext:
    """Zero one component."""
    data = ct_ext.data.clone()
    data[..., index, :, :] = 0
    return ct_ext.with_data(data)


def rotate_c0(ctx: FheContext, ct: Ciphertext, elt: int) -> Ciphertext:
    """Apply the automorphism to c0 only."""
    return with_c0(ct, apply_galois_ntt(ct.data[..., 0, :, :], elt, ctx.n))


def hoisted_rotation_sum(ctx: FheContext, ct: Ciphertext, steps, gk: GaloisKey) -> Ciphertext:
    """The sum over `steps` of rotate(ct, step) with one modup shared by
    every rotation and one moddown at the end; step 0 adds the unrotated
    ciphertext.  Every nonzero step needs its own key (no NAF fallback).
    P*c0, which every rotation adds, is computed once."""
    if ct.size != 2:
        raise ValueError("hoisted rotation-sum expects a size-2 ciphertext")
    pre = fast_rotation_precompute(ctx, ct)
    p_c0 = _times_p(ctx, ct, ct.data[..., 0, :, :])
    acc = None
    for step in steps:
        elt = galois_elt_from_step(step, ctx.n)
        if elt == 1:
            term = keyswitch_ext(ctx, ct)
        else:
            term = _rotation_ext(ctx, ct, pre, elt, gk.key_for_elt(elt), p_c0)
        acc = term if acc is None else eval_add_ext(ctx, acc, term)
    return keyswitch_down(ctx, acc)
