"""The keyswitch and rotation with the ring dimension sharded over 'coeff'.

Port of ``tpu_fhe/parallel/coeff_eval.py``.  Every transform is the 4-step
NTT (``ntt4step.py``: local stages and one all-to-all between them), and
the rest of the keyswitch is local to each coefficient: the per-digit base
conversions contract over the limb axis, so each rank converts its own
columns (K12/K13 on (..., k, N/c)); the inner product with the key's
columns (K7-K10) and the digit sum are elementwise.  The digits splice the
input's own NTT rows into the converted complement as the one-process
modup does; the rows are whole on every rank, so the splice is local (the
reference's mask-select form exists for its limb-sharded partitioner).
The Galois permutation of the NTT-form index crosses shards: ``rotate_4step``
does it through one all-gather of the two output components.

A ciphertext's shard is its rows layout (NTT form: the contiguous r-th
chunk of the N axis, ``ntt4step.rows_shard``), a key's is its rows layout
too (``shard_key``).  The mesh's 'limb' axis must be 1: ranks shard the
ring only, as the reference's tests run it.  Results are bit-identical to
the one-process evaluator.
"""

from __future__ import annotations

import torch

from ..eval import evaluator as ev
from ..ops import modarith as mm
from ..ops.galois import apply_galois_ntt, galois_elt_from_step
from ..scheme.ciphertext import Ciphertext
from ..scheme.context import ContextLevel, FheContext
from ..scheme.keys import GaloisKey, RelinKey
from .ntt4step import forward_ntt_4step, gather_rows_layout, inverse_ntt_4step, rows_shard
from .sharding import Mesh


def _check(mesh: Mesh) -> None:
    if mesh.size("limb") != 1:
        raise ValueError("the coefficient-sharded path shards the ring only: the mesh's "
                         "'limb' axis must be 1")


def shard_key(key: RelinKey, mesh: Mesh) -> RelinKey:
    """This rank's columns of a switching key (and of its Shoup words)."""
    return RelinKey(rows_shard(key.data, mesh),
                    None if key.shoup is None else rows_shard(key.shoup, mesh))


def shard_galois_key(gk: GaloisKey, mesh: Mesh) -> GaloisKey:
    return GaloisKey({elt: shard_key(k, mesh) for elt, k in gk.keys.items()})


def shard_ciphertext(ct: Ciphertext, mesh: Mesh) -> Ciphertext:
    return ct.with_data(rows_shard(ct.data, mesh))


def gather(ct: Ciphertext, mesh: Mesh) -> Ciphertext:
    """The whole ciphertext from every rank's shard (one all-gather)."""
    return ct.with_data(gather_rows_layout(ct.data, mesh))


def modup_4step(ctx: FheContext, level: ContextLevel, c2: torch.Tensor, mesh: Mesh,
                n1: int | None = None) -> torch.Tensor:
    """(..., size_Ql, N/c) NTT-form shard -> (..., beta, size_QlP, N/c)."""
    _check(mesh)
    ks = level.ks
    coeff = inverse_ntt_4step(c2, level.ntt, mesh, n1)
    scaled = mm.mul_shoup(coeff, ks.part_qhatinv, ks.part_qhatinv_shoup, level.mod.q)
    digits = []
    for dt in ks.digits:
        conv = ev._bconv(scaled[..., dt.start:dt.end, :].contiguous(), dt.qhat_mod_p,
                         dt.qhat_mod_p_diag, dt.comp_mod)
        conv_ntt = forward_ntt_4step(conv, dt.comp_ntt, mesh, n1)
        digits.append(torch.cat([conv_ntt[..., :dt.start, :], c2[..., dt.start:dt.end, :],
                                 conv_ntt[..., dt.start:, :]], dim=-2))
    return torch.stack(digits, dim=-3)


def moddown_4step(ctx: FheContext, level: ContextLevel, cx: torch.Tensor, mesh: Mesh,
                  n1: int | None = None) -> torch.Tensor:
    """(..., size_QlP, N/c) NTT form -> (..., size_Ql, N/c): the P part's
    iNTT and scale, the conversion P -> Ql, its NTT, the subtraction and
    the P^-1 scale (the one-process path fuses the last three into K3;
    unfused they land the same)."""
    _check(mesh)
    ks = level.ks
    size_ql = level.size
    p_coeff = inverse_ntt_4step(cx[..., size_ql:, :].contiguous(), ks.p_ntt, mesh, n1)
    scaled = mm.mul_shoup(p_coeff, ks.p_hatinv, ks.p_hatinv_shoup, ks.p_mod.q)
    delta = ev._bconv(scaled, ks.p_hat_mod_q, ks.p_hat_mod_q_diag, level.mod)
    delta_ntt = forward_ntt_4step(delta, level.ntt, mesh, n1)
    diff = mm.sub_mod(cx[..., :size_ql, :], delta_ntt, level.mod.q)
    return mm.mul_shoup(diff, ks.big_pinv_mod_q, ks.big_pinv_mod_q_shoup, level.mod.q)


def keyswitch_core_4step(ctx: FheContext, level: ContextLevel, c2: torch.Tensor,
                         key: RelinKey, mesh: Mesh, n1: int | None = None) -> torch.Tensor:
    """The hybrid keyswitch of one shard (..., size_Ql, N/c) with the key's
    shard: (..., 2, size_Ql, N/c).  beta + 3 all-to-alls, one a transform
    (modup's iNTT, its forward NTT per digit, moddown's two) and no other
    collective."""
    t_mod_up = modup_4step(ctx, level, c2, mesh, n1)
    cx = ev.key_inner_product(ctx, level, t_mod_up, key)
    return moddown_4step(ctx, level, cx, mesh, n1)


def relinearize_4step(ctx: FheContext, a: Ciphertext, rlk: RelinKey, mesh: Mesh) -> Ciphertext:
    """size-3 -> size-2 on a shard, with the relin key's shard."""
    if a.size != 3:
        raise ValueError("relinearize expects a size-3 ciphertext")
    level = ctx.level(a.chain_index)
    delta = keyswitch_core_4step(ctx, level, a.data[..., 2, :, :].contiguous(), rlk, mesh)
    return a.with_data(mm.add_mod(a.data[..., :2, :, :], delta, level.mod.q))


def rotate_4step(ctx: FheContext, ct: Ciphertext, step: int, gk: GaloisKey,
                 mesh: Mesh) -> Ciphertext:
    """Fused-form rotation of a shard with the Galois keys' shards: the
    keyswitch, c0 added, then the automorphism across shards (one
    all-gather of both components, each rank keeping its chunk)."""
    elt = galois_elt_from_step(step, ctx.n)
    if elt == 1:
        return ct
    level = ctx.level(ct.chain_index)
    d = keyswitch_core_4step(ctx, level, ct.data[..., 1, :, :].contiguous(),
                             gk.key_for_elt(elt), mesh)
    c0 = mm.add_mod(ct.data[..., 0, :, :], d[..., 0, :, :], level.mod.q)
    whole = gather_rows_layout(torch.stack([c0, d[..., 1, :, :]], dim=-3), mesh)
    return ct.with_data(rows_shard(apply_galois_ntt(whole, elt, ctx.n), mesh))
