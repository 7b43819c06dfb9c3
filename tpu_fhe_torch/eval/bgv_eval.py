"""BGV evaluator: NTT-domain multiply, correction factors, t-preserving
modulus switching.

Port of ``tpu_fhe/eval/bgv_eval.py``: multiply is the CKKS tensor product
with the correction factors multiplying; addition first balances the
correction factors; modulus switching divides by q_last with a delta that
is 0 mod t, and multiplies the correction factor by q_last^-1 mod t.
Relinearization and rotations are the evaluator's: on a BGV context its
moddown preserves t (eval/evaluator.py moddown_from_ntt).
"""

from __future__ import annotations

from dataclasses import replace

import torch

from ..core import numth
from ..ops import modarith as mm
from ..ops.ntt import forward_ntt, forward_ntt_sub_scale, inverse_ntt
from ..scheme.bgv import BgvTools
from ..scheme.ciphertext import Ciphertext, Plaintext
from . import evaluator as ev

relinearize = ev.relinearize
rotate = ev.rotate
conjugate = ev.conjugate


def multiply(tools: BgvTools, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    out = ev.multiply(tools.context, a, b)
    return replace(out, correction_factor=(a.correction_factor * b.correction_factor)
                   % tools.t.value, scale=1.0, noise_scale_deg=1)


def _scale_by_int(tools: BgvTools, a: Ciphertext, f: int) -> Ciphertext:
    """The ciphertext's data times the centered representative of f mod t."""
    t = tools.t.value
    f %= t
    if f == 1:
        return a
    mod = tools.context.level(a.chain_index).mod
    if f > t // 2:
        return a.with_data(mm.neg_mod(mod.mul(a.data, torch.full_like(mod.q, t - f)), mod.q))
    return a.with_data(mod.mul(a.data, torch.full_like(mod.q, f)))


def balance_and(op):
    """An additive evaluator op with the operands' correction factors
    balanced first: a is brought to b's factor."""

    def wrapped(tools: BgvTools, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        t = tools.t.value
        if a.correction_factor != b.correction_factor:
            f = (b.correction_factor * numth.invert_mod(a.correction_factor % t, t)) % t
            a = replace(_scale_by_int(tools, a, f), correction_factor=b.correction_factor)
        return op(tools.context, a, b)

    return wrapped


add = balance_and(ev.add)
sub = balance_and(ev.sub)


def add_plain(tools: BgvTools, a: Ciphertext, m: Plaintext) -> Ciphertext:
    return _axpy_plain(tools, a, m, sign=+1)


def sub_plain(tools: BgvTools, a: Ciphertext, m: Plaintext) -> Ciphertext:
    return _axpy_plain(tools, a, m, sign=-1)


def _axpy_plain(tools: BgvTools, a: Ciphertext, m: Plaintext, sign: int) -> Ciphertext:
    """c0 +-= cf * lift(m) in the NTT domain (a plain operand takes the
    ciphertext's correction factor)."""
    level = tools.context.level(a.chain_index)
    cf = a.correction_factor % tools.t.value
    lifted = tools.lift_plain_to_q(level, m.data)
    if cf != 1:
        lifted = level.mod.mul(lifted, torch.full_like(level.mod.q, cf))
    pt_ntt = forward_ntt(lifted.contiguous(), level.ntt)
    op = mm.add_mod if sign > 0 else mm.sub_mod
    c0 = op(a.data[0], pt_ntt, level.mod.q)
    return a.with_data(torch.cat([c0[None], a.data[1:]]))


def multiply_plain(tools: BgvTools, a: Ciphertext, m: Plaintext) -> Ciphertext:
    level = tools.context.level(a.chain_index)
    pt_ntt = forward_ntt(tools.lift_plain_to_q(level, m.data).contiguous(), level.ntt)
    return a.with_data(level.mod.mul(a.data, pt_ntt[None]))


def mod_switch_to_next(tools: BgvTools, a: Ciphertext) -> Ciphertext:
    """Divide by q_last with delta = t*u = c_last (mod q_last), 0 (mod t),
    landed in the forward transform (K3); the correction factor gains
    q_last^-1 mod t."""
    ctx = tools.context
    if a.chain_index + 1 >= len(ctx.chain):
        raise ValueError("already at the last level")
    level = ctx.level(a.chain_index)
    if level.size < 2:
        raise ValueError("no modulus left to drop")
    next_level = ctx.level(a.chain_index + 1)
    tab = tools.level_tables(a.chain_index)
    t = tools.t.value
    rest = next_level.mod
    last_mod = level.mod.rows(slice(level.size - 1, None))
    last = inverse_ntt(a.data[:, -1:, :].contiguous(),
                       ctx.ntt_view(level.ntt, (level.size - 1,)))
    # u = [c_last * t^-1]_{q_last}; delta = t*u, centered by subtracting
    # t*q_last when 2u >= q_last
    u = last_mod.mul(last, tab.inv_t_mod_q_last)
    delta = rest.mul(u, tab.t_mod_rest)
    centered = mm.sub_mod(delta, tab.t_q_last_mod_rest, rest.q)
    delta = torch.where(u + u >= last_mod.q, centered, delta)
    # (c - NTT(delta)) * q_last^-1 mod q_i, fused into the forward transform
    data = forward_ntt_sub_scale(delta, a.data[:, :-1, :].contiguous(), next_level.ntt,
                                 level.inv_q_last_mod_q, level.inv_q_last_mod_q_shoup)
    q_last = level.base.values[-1]
    return replace(a, data=data, chain_index=a.chain_index + 1,
                   correction_factor=(a.correction_factor
                                      * numth.invert_mod(q_last % t, t)) % t)
