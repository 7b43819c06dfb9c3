"""BGV scheme tools: encrypt/decrypt with t-scaled noise, exact mod-t decode.

Port of ``tpu_fhe/scheme/bgv.py``: plaintexts sit in the low bits (c0 = b +
m with noise t*e), decryption reduces the centered value of [c0 + c1 s]_Q
modulo t exactly, and a multiplicative correction factor rides on the
ciphertext's metadata, updated by modulus switching and multiplication and
balanced on addition.

The exact conversion runs on the context's device: the CRT overshoot alpha
in sum(xhat_i * qhat_i) = X + alpha*Q is recovered by rounding the 64.64
fixed-point sum of xhat_i * floor(2^128/q_i) / 2^64 (rounding, not floor,
makes the result the centered residue), summed in 31-bit digit columns.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import numth
from ..core.rns import BaseConverter, RNSBase
from ..ops import modarith as mm
from ..ops.bconv import bconv_matmul
from ..ops.ntt import forward_ntt, inverse_ntt
from .bfv import _Tables
from .ciphertext import Ciphertext, Plaintext
from .context import ContextLevel, FheContext
from .keys import PublicKey, SecretKey, encrypt_asymmetric


@dataclass(frozen=True)
class BgvLevelTables:
    """Per-level tables of BGV's encode, decrypt and modulus switching."""

    qhatinv_mod_q: torch.Tensor           # (k, 1) + Shoup
    qhatinv_mod_q_shoup: torch.Tensor
    qhat_mod_t: torch.Tensor              # (1, k)
    qhat_mod_t_diag: torch.Tensor
    q_mod_t: torch.Tensor                 # (1, 1)
    # centered plain lift: c < (t+1)/2 ? c : c + (q_i - t)
    plain_upper_half_threshold: int
    plain_upper_half_increment: torch.Tensor   # (k, 1)
    # t-preserving divide by q_last (None at one limb)
    inv_t_mod_q_last: torch.Tensor | None       # (1, 1) [t^-1]_{q_last}
    t_mod_rest: torch.Tensor | None             # (k - 1, 1) t mod q_i
    t_q_last_mod_rest: torch.Tensor | None      # (k - 1, 1) [t * q_last]_{q_i}


class BgvTools:
    """BGV's per-level tables for one context (built on first use) and its
    encrypt and decrypt."""

    def __init__(self, context: FheContext):
        if context.params.plain_modulus is None:
            raise ValueError("BGV requires a plain modulus")
        self.context = context
        self.t = context.params.plain_modulus
        self._tab = _Tables(context.device)
        self.t_mod = self._tab.mods((self.t,))
        self._tables: dict[int, BgvLevelTables] = {}

    def level_tables(self, chain_index: int) -> BgvLevelTables:
        tab = self._tables.get(chain_index)
        if tab is None:
            tab = self._tables[chain_index] = self._build(chain_index)
        return tab

    def _build(self, chain_index: int) -> BgvLevelTables:
        T = self._tab
        level = self.context.level(chain_index)
        t = self.t.value
        qs = level.base.values
        qhat_mod_t, qhat_mod_t_diag = T.matrix(
            BaseConverter(level.base, RNSBase((self.t,))).q_hat_mod_p)
        last = dict(inv_t_mod_q_last=None, t_mod_rest=None, t_q_last_mod_rest=None)
        if len(qs) > 1:
            q_last = qs[-1]
            last = dict(inv_t_mod_q_last=T.col([numth.invert_mod(t % q_last, q_last)]),
                        t_mod_rest=T.col([t % q for q in qs[:-1]]),
                        t_q_last_mod_rest=T.col([(t * q_last) % q for q in qs[:-1]]))
        qhatinv, qhatinv_shoup = T.pair(level.base.q_hat_inv_mod_q, qs)
        return BgvLevelTables(
            qhatinv_mod_q=qhatinv,
            qhatinv_mod_q_shoup=qhatinv_shoup,
            qhat_mod_t=qhat_mod_t,
            qhat_mod_t_diag=qhat_mod_t_diag,
            q_mod_t=T.col([level.base.big_modulus % t]),
            plain_upper_half_threshold=(t + 1) >> 1,
            plain_upper_half_increment=T.col([q - t for q in qs]),
            **last,
        )

    # -- plaintext lift ------------------------------------------------------
    def lift_plain_to_q(self, level: ContextLevel, m: torch.Tensor) -> torch.Tensor:
        """Centered lift m (1, N) mod t -> (k, N) mod q_i."""
        tab = self.level_tables(level.chain_index)
        mb = m.expand(level.size, m.shape[-1])
        return torch.where(mb >= tab.plain_upper_half_threshold,
                           mb + tab.plain_upper_half_increment, mb)

    # -- exact centered RNS -> t conversion ------------------------------------
    def exact_convert_to_t(self, level: ContextLevel, x: torch.Tensor) -> torch.Tensor:
        """[X]_t for the centered X = CRT(x), X in (-Q/2, Q/2]: alpha' =
        round(sum_i xhat_i / q_i) from the Barrett words floor(2^128/q_i),
        each term xhat_i * ratio_hi_i + floor(xhat_i * ratio_lo_i / 2^64),
        summed exactly; then [sum_i xhat_i qhat_i - alpha' Q]_t."""
        tab = self.level_tables(level.chain_index)
        mod = level.mod
        t = self.t_mod
        xhat = mm.mul_mod_shoup(x, tab.qhatinv_mod_q, tab.qhatinv_mod_q_shoup, mod.q)
        cols = mm.dot_columns(mm.digits(xhat, 2), mm.digits(mod.ratio_hi))
        cols = mm.dot_columns(mm.digits(mm.mulhi(xhat, mod.ratio_lo), 2), [1], cols=cols)
        cols[2] = cols[2] + 2                            # + 2^63 = 2^(2*31 + 1)
        alpha = mm.bits_at(mm.carry_digits(cols), 64)    # (..., 1, N), below k
        conv = bconv_matmul(xhat.contiguous(), tab.qhat_mod_t, t.q, t.ratio_lo, t.ratio_hi,
                            tab.qhat_mod_t_diag)
        return mm.sub_mod(conv, t.mul(alpha, tab.q_mod_t), t.q)

    # -- encryption ------------------------------------------------------------
    def _lifted_plaintext(self, m: Plaintext) -> Plaintext:
        level = self.context.level(m.chain_index)
        data = forward_ntt(self.lift_plain_to_q(level, m.data).contiguous(), level.ntt)
        return Plaintext(data, chain_index=m.chain_index, is_ntt_form=True)

    def encrypt_symmetric(self, sk: SecretKey, m: Plaintext) -> Ciphertext:
        return sk.encrypt_symmetric(self._lifted_plaintext(m))

    def encrypt_asymmetric(self, pk: PublicKey, m: Plaintext,
                           gen: torch.Generator) -> Ciphertext:
        return encrypt_asymmetric(self.context, pk, self._lifted_plaintext(m), gen)

    # -- decryption --------------------------------------------------------------
    def decrypt(self, sk: SecretKey, ct: Ciphertext) -> Plaintext:
        """m = [X]_t * cf^-1 mod t for X = [c0 + c1 s + ...]_Q centered."""
        level = self.context.level(ct.chain_index)
        t = self.t.value
        s = sk.s_ntt[: level.size]
        acc = ct.data[ct.size - 1]
        for i in range(ct.size - 2, -1, -1):
            acc = mm.add_mod(level.mod.mul(acc, s), ct.data[i], level.mod.q)
        m = self.exact_convert_to_t(level, inverse_ntt(acc.contiguous(), level.ntt))
        cf_inv = numth.invert_mod(ct.correction_factor % t, t)
        m = self.t_mod.mul(m, torch.full_like(self.t_mod.q, cf_inv))
        return Plaintext(m, chain_index=ct.chain_index, is_ntt_form=False)
