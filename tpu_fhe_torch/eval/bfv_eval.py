"""BFV evaluator: BEHZ and HPS multiplication, relinearization, rotations,
plain ops, modulus switching.

Port of ``tpu_fhe/eval/bfv_eval.py``.  BFV ciphertexts are coefficient
form.  BEHZ multiplication lifts both operands exactly to the auxiliary
base Bsk = B + {m_sk} (Montgomery m_tilde = 2^32 reduction), tensors in the
NTT domain over q and Bsk independently, multiplies by t, floors by Q (the
BEHZ approximate floor) and converts back to q with the Shenoy-Kumaresan
exact conversion.  HPS multiplication (hps, hps_overq, hps_overq_leveled)
extends to Ql ++ Rl, tensors there and scales and rounds by t/Q or t/Rl
with a fixed-point rounding correction.  Relinearization and rotations run
the hybrid keyswitch on coefficient-form input and output.

On a CUDA context the transforms and base conversions run as the port's
kernels (K1, K2, K3, K12, and K8 or K7 in the keyswitch); the glue between
them is plain torch.  Where the reference runs two conversions of one
input, or two transforms, the port runs one of the stacked rows: the
values are the same.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from ..core.params import MulTech
from ..ops import modarith as mm
from ..ops.bconv import bconv_matmul
from ..ops.galois import apply_galois_coeff, conj_elt, galois_elt_from_step
from ..ops.ntt import forward_ntt, inverse_ntt
from ..scheme.bfv import BehzTables, BfvTools, HpsTables
from ..scheme.ciphertext import Ciphertext, Plaintext
from ..scheme.context import ContextLevel, ModulusVec
from ..scheme.keys import GaloisKey, RelinKey
from . import evaluator as ev

# scheme-agnostic elementwise ops mod q
add = ev.add
sub = ev.sub
negate = ev.negate

M32 = mm.M32


def _mul_lo32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for a, b in [0, 2^32), every product below 2^48."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & M32


# --------------------------------------------------------------------------
# BEHZ multiplication
# --------------------------------------------------------------------------

def _behz_lift(level: ContextLevel, bz: BehzTables, x: torch.Tensor) -> torch.Tensor:
    """x (..., k, N) in base q -> (..., k + 1, N) in Bsk, exact: scale by
    m_tilde * qhat^-1, fast-convert to Bsk and to m_tilde = 2^32 (whose sum
    wraps mod 2^32), then remove the alpha*Q overshoot with the centered
    Montgomery correction."""
    scaled = mm.mul_mod_shoup(x, bz.mtilde_qhatinv_mod_q, bz.mtilde_qhatinv_mod_q_shoup,
                              level.mod.q)
    bsk = bz.bsk_mod
    to_bsk = bconv_matmul(scaled, bz.qhat_mod_bsk, bsk.q, bsk.ratio_lo, bsk.ratio_hi,
                          bz.qhat_mod_bsk_diag)
    # the conversion to m_tilde = 2^32 reads the residues' low words only
    r = _mul_lo32(scaled & M32, bz.qhat_mod_mtilde).sum(-2, keepdim=True) & M32
    r = _mul_lo32(r, bz.neg_inv_q_mod_mtilde)                  # (..., 1, N)
    # centered: r - 2^32 when r >= 2^31, represented mod b as r + (b - 2^32)
    r_center = torch.where(r >= 1 << 31, r + bz.bsk_minus_mtilde, r)
    dest = mm.add_mod(to_bsk, bsk.mul(r_center, bz.q_mod_bsk), bsk.q)
    return mm.mul_mod_shoup(dest, bz.inv_mtilde_mod_bsk, bz.inv_mtilde_mod_bsk_shoup, bsk.q)


def _fast_floor(level: ContextLevel, bz: BehzTables, xq: torch.Tensor,
                xbsk: torch.Tensor) -> torch.Tensor:
    """floor(x / Q) in Bsk, from x's residues in q and in Bsk (error at
    most k, absorbed into the noise)."""
    bsk = bz.bsk_mod
    scaled = mm.mul_mod_shoup(xq, bz.qhatinv_mod_q, bz.qhatinv_mod_q_shoup, level.mod.q)
    conv = bconv_matmul(scaled, bz.qhat_mod_bsk, bsk.q, bsk.ratio_lo, bsk.ratio_hi,
                        bz.qhat_mod_bsk_diag)
    return mm.mul_mod_shoup(mm.sub_mod(xbsk, conv, bsk.q), bz.inv_q_mod_bsk,
                            bz.inv_q_mod_bsk_shoup, bsk.q)


def _fastbconv_sk(level: ContextLevel, bz: BehzTables, x: torch.Tensor) -> torch.Tensor:
    """Shenoy-Kumaresan exact conversion Bsk -> q: one conversion of the B
    limbs to q ++ {m_sk}, whose m_sk row against x's m_sk limb gives the
    B-overshoot alpha, removed centered."""
    k = level.size
    mod = level.mod
    msk = bz.msk_mod
    scaled = mm.mul_mod_shoup(x[..., :k, :], bz.bhatinv_mod_b, bz.bhatinv_mod_b_shoup,
                              bz.bsk_mod.q[:k]).contiguous()
    conv = bconv_matmul(scaled, bz.bhat_mod_q_msk, bz.q_msk_mod.q, bz.q_msk_mod.ratio_lo,
                        bz.q_msk_mod.ratio_hi, bz.bhat_mod_q_msk_diag)
    conv_q, conv_msk = conv[..., :k, :], conv[..., k:, :]
    alpha = msk.mul(mm.sub_mod(conv_msk, x[..., k:, :], msk.q), bz.inv_b_mod_msk)
    m_sk = bz.m_sk.value
    hi_branch = mm.add_mod(conv_q, mod.mul(m_sk - alpha, bz.b_mod_q), mod.q)
    lo_branch = mm.sub_mod(conv_q, mod.mul(alpha, bz.b_mod_q), mod.q)
    return torch.where(alpha > m_sk >> 1, hi_branch, lo_branch)


def _tensor(a: torch.Tensor, b: torch.Tensor, mod: ModulusVec) -> torch.Tensor:
    """(2, L, N) x (2, L, N) -> (3, L, N) NTT-domain tensor product."""
    cross = mm.add_mod(mod.mul(a[0], b[1]), mod.mul(a[1], b[0]), mod.q)
    return torch.stack([mod.mul(a[0], b[0]), cross, mod.mul(a[1], b[1])])


def multiply(tools: BfvTools, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """BFV multiply on the context's mul_tech: (2, k, N) x (2, k, N) ->
    a size-3 ciphertext."""
    if a.chain_index != b.chain_index:
        raise ValueError("operands at different levels")
    if a.size != 2 or b.size != 2:
        raise ValueError("BFV multiply expects size-2 ciphertexts")
    if tools.context.params.mul_tech == MulTech.behz:
        return _multiply_behz(tools, a, b)
    return _multiply_hps(tools, a, b)


def square(tools: BfvTools, a: Ciphertext) -> Ciphertext:
    return multiply(tools, a, a)


def _multiply_behz(tools: BfvTools, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    level = tools.context.level(a.chain_index)
    bz = tools.behz(a.chain_index)
    tab = tools.level_tables(a.chain_index)
    both = torch.cat([a.data, b.data])                         # (4, k, N)
    lifted = _behz_lift(level, bz, both)
    # tensor in the NTT domain over q and over Bsk
    q_ntt = forward_ntt(both, level.ntt)
    prod_q = inverse_ntt(_tensor(q_ntt[:2], q_ntt[2:], level.mod), level.ntt)
    bsk_ntt = forward_ntt(lifted, bz.bsk_ntt)
    prod_bsk = inverse_ntt(_tensor(bsk_ntt[:2], bsk_ntt[2:], bz.bsk_mod), bz.bsk_ntt)
    # multiply by t, floor by Q, convert back to q
    tq = mm.mul_mod_shoup(prod_q, tab.t_mod_q, tab.t_mod_q_shoup, level.mod.q)
    tbsk = mm.mul_mod_shoup(prod_bsk, bz.t_mod_bsk, bz.t_mod_bsk_shoup, bz.bsk_mod.q)
    return a.with_data(_fastbconv_sk(level, bz, _fast_floor(level, bz, tq, tbsk)))


# --------------------------------------------------------------------------
# HPS multiplication (hps, hps_overq, hps_overq_leveled)
# --------------------------------------------------------------------------

def _multiply_hps(tools: BfvTools, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    mul_tech = tools.context.params.mul_tech
    levels_dropped = 0
    if mul_tech == MulTech.hps_overq_leveled:
        depth = max(a.noise_scale_deg, b.noise_scale_deg) - 1
        levels_dropped = tools.find_levels_to_drop(depth, False,
                                                   a.is_asymmetric or b.is_asymmetric)
    hp = tools.hps(a.chain_index, levels_dropped)
    out = a.with_data(_hps_product(hp, mul_tech, a.data, b.data))
    if mul_tech == MulTech.hps_overq_leveled:
        out = replace(out, noise_scale_deg=max(a.noise_scale_deg, b.noise_scale_deg) + 1)
    return out


def _hps_product(hp: HpsTables, mul_tech: MulTech, ad: torch.Tensor,
                 bd: torch.Tensor) -> torch.Tensor:
    k = hp.size_ql
    rl = hp.qlrl_mod.rows(slice(k, None))

    def lift_ct1(d: torch.Tensor) -> torch.Tensor:
        """Ql residues (scaled and rounded from Q when leveled) and their
        exact conversion to Rl."""
        ql = hp.qq_sr.apply(d[:, k:, :], d[:, :k, :]) if hp.levels_dropped else d
        return torch.cat([ql, hp.ql_to_rl.apply(ql)], dim=1)

    def lift_ct2(d: torch.Tensor) -> torch.Tensor:
        if mul_tech == MulTech.hps:
            return torch.cat([d, hp.ql_to_rl.apply(d)], dim=1)
        # overQ: an approximate scaled lift to Rl (scale by [-Rl*qhat^-1]_q,
        # then q_i^-1 mod r_j), then exact back to Ql
        scaled = mm.mul_mod_shoup(d, hp.var1_scale, hp.var1_scale_shoup, hp.var1_q).contiguous()
        r = bconv_matmul(scaled, hp.var1_matrix, rl.q, rl.ratio_lo, rl.ratio_hi,
                         hp.var1_matrix_diag)
        return torch.cat([hp.rl_to_ql.apply(r), r], dim=1)

    ext = forward_ntt(torch.cat([lift_ct1(ad), lift_ct2(bd)]), hp.qlrl_ntt)
    prod = inverse_ntt(_tensor(ext[:2], ext[2:], hp.qlrl_mod), hp.qlrl_ntt)
    if mul_tech == MulTech.hps:
        # round(t/Q * x): QR -> R, then exact Rl -> Ql
        return hp.rl_to_ql.apply(hp.sr.apply(prod[:, :k, :], prod[:, k:, :]))
    # overQ: round(t/Rl * x): QlRl -> Ql
    out = hp.sr.apply(prod[:, k:, :], prod[:, :k, :])
    if hp.levels_dropped:
        # re-expand Ql -> Q: multiply by [QlDrop]_q, zero the dropped limbs
        out = mm.mul_mod_shoup(out, hp.expand_mod_ql, hp.expand_mod_ql_shoup,
                               hp.qlrl_mod.q[:k])
        out = torch.cat([out, out.new_zeros(out.shape[:1] + (hp.levels_dropped, out.shape[-1]))],
                        dim=1)
    return out


# --------------------------------------------------------------------------
# relinearization / rotations (the keyswitch on coefficient form)
# --------------------------------------------------------------------------

def relinearize(tools: BfvTools, a: Ciphertext, rlk: RelinKey) -> Ciphertext:
    if a.size != 3:
        raise ValueError("relinearize expects a size-3 ciphertext")
    ctx = tools.context
    level = ctx.level(a.chain_index)
    delta = ev.keyswitch_core(ctx, level, a.data[2].contiguous(), rlk, input_ntt=False,
                              output_ntt=False)
    return a.with_data(mm.add_mod(a.data[:2], delta, level.mod.q))


def rotate_rows(tools: BfvTools, a: Ciphertext, step: int, gk: GaloisKey) -> Ciphertext:
    """Rotate within each of the two slot rows by `step` (sigma_{5^step})."""
    return _apply_galois(tools, a, galois_elt_from_step(step, tools.context.n), gk)


def rotate_columns(tools: BfvTools, a: Ciphertext, gk: GaloisKey) -> Ciphertext:
    """Swap the two slot rows (sigma_{2N-1})."""
    return _apply_galois(tools, a, conj_elt(tools.context.n), gk)


def _apply_galois(tools: BfvTools, a: Ciphertext, elt: int, gk: GaloisKey) -> Ciphertext:
    if elt == 1:
        return a
    if a.size != 2:
        raise ValueError("rotate expects a size-2 ciphertext")
    ctx = tools.context
    level = ctx.level(a.chain_index)
    key = gk.key_for_elt(elt)
    d = ev.keyswitch_core(ctx, level, a.data[1].contiguous(), key, input_ntt=False,
                          output_ntt=False)
    c0 = mm.add_mod(a.data[0], d[0], level.mod.q)
    return a.with_data(apply_galois_coeff(torch.stack([c0, d[1]]), elt, ctx.n, level.mod.q))


# --------------------------------------------------------------------------
# plain ops / modulus switching
# --------------------------------------------------------------------------

def add_plain(tools: BfvTools, a: Ciphertext, pt: Plaintext) -> Ciphertext:
    """c0 += Delta*m + fix."""
    return _axpy_plain(tools, a, pt, sign=+1)


def sub_plain(tools: BfvTools, a: Ciphertext, pt: Plaintext) -> Ciphertext:
    return _axpy_plain(tools, a, pt, sign=-1)


def _axpy_plain(tools: BfvTools, a: Ciphertext, pt: Plaintext, sign: int) -> Ciphertext:
    level = tools.context.level(a.chain_index)
    dm = tools.scale_plain_to_q(level, pt.data)
    op = mm.add_mod if sign > 0 else mm.sub_mod
    c0 = op(a.data[0], dm, level.mod.q)
    return a.with_data(torch.cat([c0[None], a.data[1:]]))


def multiply_plain(tools: BfvTools, a: Ciphertext, pt: Plaintext) -> Ciphertext:
    """The dyadic product with the centered lift of m."""
    level = tools.context.level(a.chain_index)
    pt_ntt = forward_ntt(tools.lift_plain_to_q(level, pt.data).contiguous(), level.ntt)
    ct_ntt = forward_ntt(a.data.contiguous(), level.ntt)
    return a.with_data(inverse_ntt(level.mod.mul(ct_ntt, pt_ntt[None]), level.ntt))


def mod_switch_to_next(tools: BfvTools, a: Ciphertext) -> Ciphertext:
    """Divide and round by q_last in the coefficient domain."""
    ctx = tools.context
    if a.chain_index + 1 >= len(ctx.chain):
        raise ValueError("already at the last level")
    level = ctx.level(a.chain_index)
    if level.size < 2:
        raise ValueError("no modulus left to drop")
    rest = ctx.level(a.chain_index + 1).mod
    q_last = level.mod.q[-1:]
    half = q_last >> 1
    last_half = mm.add_mod(a.data[:, -1:, :], half, q_last)
    tmp = mm.sub_mod(mm.barrett_reduce_u64(last_half, rest.q, rest.ratio_hi),
                     mm.barrett_reduce_u64(half, rest.q, rest.ratio_hi), rest.q)
    diff = mm.sub_mod(a.data[:, :-1, :], tmp, rest.q)
    data = mm.mul_mod_shoup(diff, level.inv_q_last_mod_q, level.inv_q_last_mod_q_shoup, rest.q)
    return replace(a, data=data, chain_index=a.chain_index + 1)
