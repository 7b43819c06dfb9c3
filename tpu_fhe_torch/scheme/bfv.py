"""BFV scheme tools: Delta-scaling encryption, BEHZ decrypt, noise budget,
and the tables of BEHZ and HPS multiplication.

Port of ``tpu_fhe/scheme/bfv.py``:
  * encrypt adds Delta*m + fix to c0 with the exact rounding correction
    fix = round(m*(Q mod t)/t) computed modularly (no division);
  * decrypt computes x = [c0 + c1 s]_Q, then scales and rounds by t/Q
    through the BEHZ {t, gamma} correction;
  * invariant_noise_budget composes t*x by CRT in 31-bit digit columns on
    the context's device and takes the bit length of the centered norm;
  * BehzTables and HpsTables hold the auxiliary bases of multiplication
    (BEHZ's B + {m_sk}, HPS's R), their NTT tables (built like the chain's,
    outside it) and every conversion table with its digit matrix (K12's
    operand, built once per table on the device, as the keyswitch tables'
    are).

BFV ciphertexts are coefficient-form, in int64 words on the u64 plan.
Every table is a tensor on the context's device; the tables of a level are
built on first use and kept.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core import numth
from ..core.modulus import Modulus
from ..core.ntt_tables import make_ntt_tables
from ..core.params import MulTech
from ..core.rns import BaseConverter, RNSBase
from ..ops import modarith as mm
from ..ops.bconv import (
    bconv_hps, bconv_matmul, digit_matrix, frac_alpha, scale_and_round_hps, sr_table,
)
from ..ops.ntt import DeviceNTTTables, build_device_ntt_tables, forward_ntt, inverse_ntt
from .ciphertext import Ciphertext, Plaintext
from .context import ContextLevel, FheContext, ModulusVec
from .keys import PublicKey, SecretKey, encrypt_asymmetric


class _Tables:
    """Builds a level's tensors on one device: per-limb (k, 1) columns,
    Shoup pairs, conversion tables with their digit matrices."""

    def __init__(self, device):
        self.device = device

    def col(self, vals) -> torch.Tensor:
        return mm.u64_tensor(np.asarray([int(v) for v in vals], dtype=np.uint64).reshape(-1, 1),
                             self.device)

    def pair(self, vals, mods) -> tuple[torch.Tensor, torch.Tensor]:
        """Multipliers and their Shoup words floor(v * 2^64 / q)."""
        vals = [int(v) for v in vals]
        return self.col(vals), self.col([(v << 64) // int(q) for v, q in zip(vals, mods)])

    def matrix(self, rows) -> tuple[torch.Tensor, torch.Tensor | None]:
        """A conversion table (m, k) and its digit matrix (None for k >= 64,
        where the conversion takes K11's kernel)."""
        t = mm.u64_tensor(np.asarray(rows, dtype=object).astype(np.uint64), self.device)
        return t, (digit_matrix(t) if t.shape[1] < 64 else None)

    def mods(self, moduli) -> ModulusVec:
        return ModulusVec.from_moduli(tuple(moduli), self.device)

    def ntt(self, log_n: int, values) -> DeviceNTTTables:
        return build_device_ntt_tables([make_ntt_tables(log_n, v) for v in values],
                                       self.device, q32=False)


@dataclass(frozen=True)
class BfvLevelTables:
    """Per-level Delta / plain-lift / decrypt tables."""

    coeff_div_plain: torch.Tensor         # floor(Q/t) mod q_i, (k, 1) + Shoup
    coeff_div_plain_shoup: torch.Tensor
    q_mod_t: int                          # Q mod t
    inv_t_mod_q: torch.Tensor             # t^-1 mod q_i, (k, 1) + Shoup
    inv_t_mod_q_shoup: torch.Tensor
    t_mod_q: torch.Tensor                 # t mod q_i, (k, 1) + Shoup
    t_mod_q_shoup: torch.Tensor
    # centered plain lift: c < (t+1)/2 ? c : c + (q_i - t)
    plain_upper_half_threshold: int
    plain_upper_half_increment: torch.Tensor   # (k, 1)
    # decrypt's {t, gamma} correction
    gamma: Modulus
    gamma_t_mod_q: torch.Tensor           # (k, 1) gamma*t mod q_i + Shoup
    gamma_t_mod_q_shoup: torch.Tensor
    qhatinv_mod_q: torch.Tensor           # (k, 1) qhat_i^-1 mod q_i + Shoup
    qhatinv_mod_q_shoup: torch.Tensor
    qhat_mod_tg: torch.Tensor             # (2, k): rows qhat mod t, qhat mod gamma
    qhat_mod_tg_diag: torch.Tensor
    tg_mod: ModulusVec                    # {t, gamma}
    neg_inv_q_mod_tg: torch.Tensor        # (2, 1) [-Q^-1] mod t, mod gamma
    inv_gamma_mod_t: torch.Tensor         # (1, 1)


@dataclass(frozen=True)
class BehzTables:
    """Per-level BEHZ multiplication bases and tables: B (k primes of 60
    bits), m_sk, Bsk = B + {m_sk}, m_tilde = 2^32."""

    m_sk: Modulus
    bsk_ntt: DeviceNTTTables
    bsk_mod: ModulusVec
    # q -> Bsk (the lift's and the floor's conversion), and q -> m_tilde
    mtilde_qhatinv_mod_q: torch.Tensor    # (k, 1) [m_tilde * qhat_i^-1]_{q_i} + Shoup
    mtilde_qhatinv_mod_q_shoup: torch.Tensor
    qhat_mod_bsk: torch.Tensor            # (k + 1, k)
    qhat_mod_bsk_diag: torch.Tensor
    qhat_mod_mtilde: torch.Tensor         # (k, 1) qhat_i mod 2^32
    neg_inv_q_mod_mtilde: int
    q_mod_bsk: torch.Tensor               # (k + 1, 1)
    bsk_minus_mtilde: torch.Tensor        # (k + 1, 1) b - 2^32
    inv_mtilde_mod_bsk: torch.Tensor      # (k + 1, 1) + Shoup
    inv_mtilde_mod_bsk_shoup: torch.Tensor
    # fast floor
    qhatinv_mod_q: torch.Tensor
    qhatinv_mod_q_shoup: torch.Tensor
    inv_q_mod_bsk: torch.Tensor
    inv_q_mod_bsk_shoup: torch.Tensor
    t_mod_bsk: torch.Tensor
    t_mod_bsk_shoup: torch.Tensor
    # Shenoy-Kumaresan B -> q (through m_sk): one conversion to q ++ {m_sk}
    bhatinv_mod_b: torch.Tensor           # (k, 1) + Shoup
    bhatinv_mod_b_shoup: torch.Tensor
    bhat_mod_q_msk: torch.Tensor          # (k + 1, k)
    bhat_mod_q_msk_diag: torch.Tensor
    q_msk_mod: ModulusVec                 # q ++ {m_sk}
    msk_mod: ModulusVec
    inv_b_mod_msk: torch.Tensor           # (1, 1)
    b_mod_q: torch.Tensor                 # (k, 1) prod(B) mod q_i


@dataclass(frozen=True)
class HpsConv:
    """Exact (centered) HPS base conversion ibase -> obase (qiInv as
    128-bit fixed point)."""

    qhatinv: torch.Tensor
    qhatinv_shoup: torch.Tensor
    q: torch.Tensor
    qinv_hi: torch.Tensor
    qinv_lo: torch.Tensor
    qhat_mod_p: torch.Tensor
    qhat_mod_p_diag: torch.Tensor
    alpha_q_mod_p: torch.Tensor           # (k + 1, m)
    p: ModulusVec

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return bconv_hps(x, self.qhatinv, self.qhatinv_shoup, self.q, self.qinv_hi,
                         self.qinv_lo, self.qhat_mod_p, self.alpha_q_mod_p, self.p.q,
                         self.p.ratio_lo, self.p.ratio_hi, self.qhat_mod_p_diag)


@dataclass(frozen=True)
class SRTables:
    """One scale-and-round table set: out_j = sum_i a_i*cross[j,i]
    + b_j*diag[j] + round(sum_i a_i*frac_i) over the output base."""

    table: torch.Tensor                   # sr_table(cross, diag) of cross (m, k)
    table_diag: torch.Tensor | None       # its digit matrix
    diag: torch.Tensor                    # (m, 1)
    frac_hi: torch.Tensor                 # (k, 1)
    frac_lo: torch.Tensor
    p: ModulusVec

    def apply(self, x_a: torch.Tensor, x_b: torch.Tensor) -> torch.Tensor:
        return scale_and_round_hps(x_a, x_b, self.table, self.diag, self.frac_hi,
                                   self.frac_lo, self.p.q, self.p.ratio_lo, self.p.ratio_hi,
                                   self.table_diag)


@dataclass(frozen=True)
class HpsTables:
    """Per-(level, levels dropped) HPS multiplication tables."""

    levels_dropped: int
    size_ql: int
    qlrl_ntt: DeviceNTTTables             # Ql ++ Rl
    qlrl_mod: ModulusVec
    ql_to_rl: HpsConv
    rl_to_ql: HpsConv
    # t/Q (hps: QR -> R) or t/Rl (overq: QlRl -> Ql) scale and round
    sr: SRTables
    # overq's lift of ct2 (scale by [-Rl*qhat^-1]_q, then q_i^-1 mod r_j)
    var1_scale: torch.Tensor | None
    var1_scale_shoup: torch.Tensor | None
    var1_matrix: torch.Tensor | None
    var1_matrix_diag: torch.Tensor | None
    var1_q: torch.Tensor | None
    # leveled: Q -> Ql scale and round, and the re-expansion by [QlDrop]_q
    qq_sr: SRTables | None
    expand_mod_ql: torch.Tensor | None
    expand_mod_ql_shoup: torch.Tensor | None


def _fix128(num: int, den: int) -> tuple[int, int]:
    """(hi, lo) u64 words of floor(num/den * 2^128) for 0 <= num < den."""
    v = (num << 128) // den
    return v >> 64, v & ((1 << 64) - 1)


class BfvTools:
    """BFV's per-level tables for one context (built on first use) and its
    encrypt, decrypt and noise budget."""

    def __init__(self, context: FheContext):
        if context.params.plain_modulus is None:
            raise ValueError("BFV requires a plain modulus")
        self.context = context
        self.t = context.params.plain_modulus
        self._tab = _Tables(context.device)
        self.t_mod = self._tab.mods((self.t,))
        self._level_tables: dict[int, BfvLevelTables] = {}
        self._behz: dict[int, BehzTables] = {}
        self._hps: dict[tuple[int, int], HpsTables] = {}

    # -- table builders ---------------------------------------------------
    def level_tables(self, chain_index: int) -> BfvLevelTables:
        tab = self._level_tables.get(chain_index)
        if tab is None:
            tab = self._level_tables[chain_index] = self._build_level_tables(chain_index)
        return tab

    def _build_level_tables(self, chain_index: int) -> BfvLevelTables:
        T = self._tab
        level = self.context.level(chain_index)
        t = self.t.value
        qs = level.base.values
        big_q = level.base.big_modulus
        delta = big_q // t
        # gamma: a word-size prime coprime to t and every q_i, off the NTT
        # chain (decrypt's correction only needs it as a modulus)
        gamma = Modulus(_find_coprime_prime(61, exclude=set(qs) | {t}))
        g = gamma.value
        conv = BaseConverter(level.base, RNSBase((self.t, gamma)))
        qhat_mod_tg, qhat_mod_tg_diag = T.matrix(conv.q_hat_mod_p)
        pairs = dict(
            coeff_div_plain=T.pair([delta % q for q in qs], qs),
            inv_t_mod_q=T.pair([numth.invert_mod(t % q, q) for q in qs], qs),
            t_mod_q=T.pair([t % q for q in qs], qs),
            gamma_t_mod_q=T.pair([(g * t) % q for q in qs], qs),
            qhatinv_mod_q=T.pair(level.base.q_hat_inv_mod_q, qs),
        )
        return BfvLevelTables(
            q_mod_t=big_q % t,
            plain_upper_half_threshold=(t + 1) >> 1,
            plain_upper_half_increment=T.col([q - t for q in qs]),
            gamma=gamma,
            qhat_mod_tg=qhat_mod_tg,
            qhat_mod_tg_diag=qhat_mod_tg_diag,
            tg_mod=T.mods((self.t, gamma)),
            neg_inv_q_mod_tg=T.col([(-numth.invert_mod(big_q % m, m)) % m for m in (t, g)]),
            inv_gamma_mod_t=T.col([numth.invert_mod(g % t, t)]),
            **{name: v[0] for name, v in pairs.items()},
            **{name + "_shoup": v[1] for name, v in pairs.items()},
        )

    def behz(self, chain_index: int) -> BehzTables:
        tab = self._behz.get(chain_index)
        if tab is None:
            tab = self._behz[chain_index] = self._build_behz(chain_index)
        return tab

    def _build_behz(self, chain_index: int) -> BehzTables:
        T = self._tab
        ctx = self.context
        level = ctx.level(chain_index)
        t = self.t.value
        qs = level.base.values
        k = len(qs)
        big_q = level.base.big_modulus
        m_tilde = 1 << 32
        # base B: k NTT-friendly 60-bit primes disjoint from QP and t; m_sk
        # one more
        exclude = {m.value for m in ctx.key_modulus} | {t}
        extra = _find_ntt_primes(ctx.n, 60, k + 1, exclude)
        base_B = RNSBase(tuple(Modulus(p) for p in extra[:k]))
        m_sk = Modulus(extra[k])
        base_Bsk = base_B.extend(m_sk)
        bsk = base_Bsk.values
        big_b = base_B.big_modulus
        qhatinv = level.base.q_hat_inv_mod_q
        qhat_mod_bsk, qhat_mod_bsk_diag = T.matrix(BaseConverter(level.base, base_Bsk).q_hat_mod_p)
        bhat_q_msk, bhat_q_msk_diag = T.matrix(
            BaseConverter(base_B, RNSBase(level.base.base + (m_sk,))).q_hat_mod_p)
        mtilde_qhatinv = [(m_tilde * v) % q for v, q in zip(qhatinv, qs)]
        pairs = dict(
            mtilde_qhatinv_mod_q=T.pair(mtilde_qhatinv, qs),
            inv_mtilde_mod_bsk=T.pair([numth.invert_mod(m_tilde % b, b) for b in bsk], bsk),
            qhatinv_mod_q=T.pair(qhatinv, qs),
            inv_q_mod_bsk=T.pair([numth.invert_mod(big_q % b, b) for b in bsk], bsk),
            t_mod_bsk=T.pair([t % b for b in bsk], bsk),
            bhatinv_mod_b=T.pair(base_B.q_hat_inv_mod_q, base_B.values),
        )
        return BehzTables(
            m_sk=m_sk,
            bsk_ntt=T.ntt(ctx.params.log_n, bsk),
            bsk_mod=T.mods(base_Bsk.base),
            qhat_mod_bsk=qhat_mod_bsk,
            qhat_mod_bsk_diag=qhat_mod_bsk_diag,
            qhat_mod_mtilde=T.col([qh % m_tilde for qh in level.base.punctured_products]),
            neg_inv_q_mod_mtilde=(-numth.invert_mod(big_q % m_tilde, m_tilde)) % m_tilde,
            q_mod_bsk=T.col([big_q % b for b in bsk]),
            bsk_minus_mtilde=T.col([b - m_tilde for b in bsk]),
            bhat_mod_q_msk=bhat_q_msk,
            bhat_mod_q_msk_diag=bhat_q_msk_diag,
            q_msk_mod=T.mods(level.base.base + (m_sk,)),
            msk_mod=T.mods((m_sk,)),
            inv_b_mod_msk=T.col([numth.invert_mod(big_b % m_sk.value, m_sk.value)]),
            b_mod_q=T.col([big_b % q for q in qs]),
            **{name: v[0] for name, v in pairs.items()},
            **{name + "_shoup": v[1] for name, v in pairs.items()},
        )

    def hps(self, chain_index: int, levels_dropped: int = 0) -> HpsTables:
        key = (chain_index, levels_dropped)
        tab = self._hps.get(key)
        if tab is None:
            tab = self._hps[key] = self._build_hps(chain_index, levels_dropped)
        return tab

    def _hps_conv(self, ib: RNSBase, ob: RNSBase) -> HpsConv:
        T = self._tab
        conv = BaseConverter(ib, ob)
        fix = [_fix128(1, q) for q in ib.values]
        qhat_mod_p, diag = T.matrix(conv.q_hat_mod_p)
        qhatinv, qhatinv_shoup = T.pair(ib.q_hat_inv_mod_q, ib.values)
        return HpsConv(
            qhatinv=qhatinv,
            qhatinv_shoup=qhatinv_shoup,
            q=T.col(ib.values),
            qinv_hi=T.col([f[0] for f in fix]),
            qinv_lo=T.col([f[1] for f in fix]),
            qhat_mod_p=qhat_mod_p,
            qhat_mod_p_diag=diag,
            alpha_q_mod_p=mm.u64_tensor(np.asarray(conv.alpha_q_mod_p, dtype=np.uint64),
                                        self.context.device),
            p=T.mods(ob.base),
        )

    def _scale_round_tables(self, s_base: RNSBase, mult: int, a_idx: list[int],
                            b_idx: list[int]) -> SRTables:
        """Tables of out_j = round(mult / prod(a) * x) over the base {s_b}:
        num_i = mult * [(S/s_i)^-1]_{s_i}."""
        T = self._tab
        s = s_base.values
        nums = [mult * s_base.q_hat_inv_mod_q[i] for i in range(len(s))]
        cross = mm.u64_tensor(np.asarray([[(nums[i] // s[i]) % s[j] for i in a_idx]
                                          for j in b_idx], dtype=object).astype(np.uint64),
                              self.context.device)
        diag = T.col([(nums[j] // s[j]) % s[j] for j in b_idx])
        fix = [_fix128(nums[i] % s[i], s[i]) for i in a_idx]
        table = sr_table(cross, diag)
        return SRTables(
            table=table,
            table_diag=digit_matrix(table) if table.shape[1] < 64 else None,
            diag=diag,
            frac_hi=T.col([f[0] for f in fix]), frac_lo=T.col([f[1] for f in fix]),
            p=T.mods([s_base.base[j] for j in b_idx]),
        )

    def _build_hps(self, chain_index: int, levels_dropped: int) -> HpsTables:
        T = self._tab
        ctx = self.context
        mul_tech = ctx.params.mul_tech
        base_q = ctx.level(chain_index).base
        size_q = len(base_q)
        size_ql = size_q - levels_dropped
        if size_ql < 1:
            raise ValueError("levels_dropped leaves no data prime")
        base_ql = RNSBase(tuple(base_q.base[:size_ql]))
        t = self.t.value
        # Rl: NTT primes strictly below min(Q); k + 1 of them for plain HPS
        # (t/Q scale and round needs R > Q), k for the overQ forms
        size_rl = size_ql + 1 if mul_tech == MulTech.hps else size_ql
        rl_vals = numth.get_primes_below(ctx.n, min(base_q.values), size_rl)
        base_rl = RNSBase(tuple(Modulus(p) for p in rl_vals))
        base_qlrl = RNSBase(base_ql.base + base_rl.base)
        if mul_tech == MulTech.hps:
            # t/Q: a = Ql limbs, b = Rl limbs
            sr = self._scale_round_tables(base_qlrl, t * base_rl.big_modulus,
                                          list(range(size_ql)),
                                          list(range(size_ql, size_ql + size_rl)))
        else:
            # t/Rl: a = Rl limbs, b = Ql limbs
            sr = self._scale_round_tables(base_qlrl, t * base_ql.big_modulus,
                                          list(range(size_ql, size_ql + size_rl)),
                                          list(range(size_ql)))
        var1 = dict(var1_scale=None, var1_scale_shoup=None, var1_matrix=None,
                    var1_matrix_diag=None, var1_q=None)
        if mul_tech in (MulTech.hps_overq, MulTech.hps_overq_leveled):
            # the lift's source base: all of Q when levels were dropped
            src = base_q if levels_dropped else base_ql
            p_big = base_rl.big_modulus
            scale = [(q - (p_big * hinv) % q) % q
                     for hinv, q in zip(src.q_hat_inv_mod_q, src.values)]
            var1["var1_scale"], var1["var1_scale_shoup"] = T.pair(scale, src.values)
            var1["var1_matrix"], var1["var1_matrix_diag"] = T.matrix(
                [[numth.invert_mod(q % r, r) for q in src.values] for r in rl_vals])
            var1["var1_q"] = T.col(src.values)
        qq_sr = expand = expand_shoup = None
        if levels_dropped:
            # Ql/Q scale and round over Q (a = dropped limbs, b = Ql limbs)
            qq_sr = self._scale_round_tables(base_q, base_ql.big_modulus,
                                             list(range(size_ql, size_q)), list(range(size_ql)))
            drop_big = math.prod(base_q.values[size_ql:])
            expand, expand_shoup = T.pair([drop_big % q for q in base_ql.values],
                                          base_ql.values)
        return HpsTables(
            levels_dropped=levels_dropped,
            size_ql=size_ql,
            qlrl_ntt=T.ntt(ctx.params.log_n, base_qlrl.values),
            qlrl_mod=T.mods(base_qlrl.base),
            ql_to_rl=self._hps_conv(base_ql, base_rl),
            rl_to_ql=self._hps_conv(base_rl, base_ql),
            sr=sr,
            qq_sr=qq_sr,
            expand_mod_ql=expand,
            expand_mod_ql_shoup=expand_shoup,
            **var1,
        )

    def find_levels_to_drop(self, mult_depth: int, is_keyswitch: bool,
                            is_asymmetric: bool) -> int:
        """The noise-model heuristic of hps_overq_leveled: how many data
        primes a multiply at this depth may drop."""
        ctx = self.context
        n = ctx.n
        level = ctx.level(1)
        size_q = len(level.base)
        size_p = ctx.params.special_modulus_size
        num_part_q = -(-size_q // size_p)         # keyswitch digit count beta
        dcrt_bits = max(v.bit_length() for v in level.base.values)

        sigma = 3.2
        assurance = 36.0
        p = float(self.t.value)
        b_key = 1.0
        b_err = sigma * math.sqrt(assurance)
        delta = 2.0 * math.sqrt(n)

        def vnorm():
            if is_asymmetric:
                return (1.0 + delta * b_key) / 2.0
            return b_err * (1.0 + 2.0 * delta * b_key)

        def noise_ks():
            return size_p * (num_part_q * delta * b_err + delta * b_key + 1.0) / 2.0

        c1 = delta * delta * p * b_key
        c2 = delta * delta * b_key * b_key / 2.0 + noise_ks()

        def logq_bfv():
            if mult_depth > 0:
                return (math.log(4 * p) + (mult_depth - 1) * math.log(c1)
                        + math.log(c1 * vnorm() + mult_depth * c2))
            return math.log(p * 4.0 * vnorm())

        logq_prev = 6.0 * math.log(10)
        logq = logq_bfv()
        while abs(logq - logq_prev) > math.log(1.001):
            logq_prev = logq
            logq = logq_bfv()

        loge = logq / math.log(2) - 2 - math.log2(p)
        log_extra = math.log2(noise_ks()) if is_keyswitch else math.log2(delta)
        levels = math.floor((loge - 2 * mult_depth - 16 - log_extra) / dcrt_bits)
        return max(0, min(levels, size_q - 1))

    # -- plaintext scaling (Delta * m + fix) -------------------------------
    def scale_plain_to_q(self, level: ContextLevel, m: torch.Tensor) -> torch.Tensor:
        """m (1, N) mod t -> (k, N) residues of round(m * Q / t) mod q_i:
        round(mQ/t) = m*floor(Q/t) + fix, fix = floor((m*(Q mod t) + t/2)/t),
        computed exactly as fix mod q = (x - [x]_t) * t^-1 mod q."""
        tab = self.level_tables(level.chain_index)
        mod = level.mod
        prod = mm.mul_mod_shoup(m, tab.coeff_div_plain, tab.coeff_div_plain_shoup, mod.q)
        # x = m * (Q mod t) + floor(t/2), a 128-bit quantity
        hi, lo = mm.mul_u64_full(m, torch.full_like(m, tab.q_mod_t))
        hi, lo = mm.add_u128(hi, lo, torch.zeros_like(lo), torch.full_like(lo, self.t.value >> 1))
        x_mod_q = mm.barrett_reduce_u128(hi, lo, mod.q, mod.ratio_lo, mod.ratio_hi)
        t = self.t_mod
        x_mod_t = mm.barrett_reduce_u128(hi, lo, t.q, t.ratio_lo, t.ratio_hi)
        # reduce x mod t into each q_i (t may exceed a small q_i)
        x_mod_t_q = mm.barrett_reduce_u64(x_mod_t, mod.q, mod.ratio_hi)
        fix = mm.mul_mod_shoup(mm.sub_mod(x_mod_q, x_mod_t_q, mod.q), tab.inv_t_mod_q,
                               tab.inv_t_mod_q_shoup, mod.q)
        return mm.add_mod(prod, fix, mod.q)

    def lift_plain_to_q(self, level: ContextLevel, m: torch.Tensor) -> torch.Tensor:
        """Centered lift m (1, N) mod t -> (k, N) mod q_i: coefficients
        from (t+1)/2 up map to q_i - (t - c)."""
        tab = self.level_tables(level.chain_index)
        mb = m.expand(level.size, m.shape[-1])
        return torch.where(mb >= tab.plain_upper_half_threshold,
                           mb + tab.plain_upper_half_increment, mb)

    # -- encryption ---------------------------------------------------------
    def encrypt_symmetric(self, sk: SecretKey, pt: Plaintext) -> Ciphertext:
        """Coefficient-form (Delta m + b, a) from a fresh encryption of zero
        (whose metadata the result keeps, as the reference's does)."""
        zero = sk.encrypt_zero_symmetric(pt.chain_index)
        return zero.with_data(self._finish_encrypt(self.context.level(pt.chain_index),
                                                   zero.data, pt.data))

    def encrypt_asymmetric(self, pk: PublicKey, pt: Plaintext,
                           gen: torch.Generator) -> Ciphertext:
        level = self.context.level(pt.chain_index)
        zero_pt = Plaintext(torch.zeros((level.size, self.context.n), dtype=torch.int64,
                                        device=self.context.device),
                            chain_index=pt.chain_index)
        zero = encrypt_asymmetric(self.context, pk, zero_pt, gen)
        return zero.with_data(self._finish_encrypt(level, zero.data, pt.data))

    def _finish_encrypt(self, level: ContextLevel, zero_ntt: torch.Tensor,
                        m: torch.Tensor) -> torch.Tensor:
        zero_coeff = inverse_ntt(zero_ntt, level.ntt)
        c0 = mm.add_mod(zero_coeff[0], self.scale_plain_to_q(level, m), level.mod.q)
        return torch.cat([c0[None], zero_coeff[1:]])

    # -- decryption ----------------------------------------------------------
    def decrypt(self, sk: SecretKey, ct: Ciphertext) -> Plaintext:
        level = self.context.level(ct.chain_index)
        x = self._dot_with_secret(level, ct.data, sk.s_ntt)
        return Plaintext(self.scale_and_round_to_t(level, x), chain_index=ct.chain_index,
                         is_ntt_form=False)

    def _dot_with_secret(self, level: ContextLevel, ct_data: torch.Tensor,
                         s_ntt: torch.Tensor) -> torch.Tensor:
        """x = [c0 + c1 s + c2 s^2 ...]_Q in coefficient form, (k, N)."""
        s = s_ntt[: level.size]
        c = forward_ntt(ct_data.contiguous(), level.ntt)
        acc = c[-1]
        for i in range(c.shape[0] - 2, -1, -1):
            acc = mm.add_mod(level.mod.mul(acc, s), c[i], level.mod.q)
        return inverse_ntt(acc, level.ntt)

    def scale_and_round_to_t(self, level: ContextLevel, x: torch.Tensor) -> torch.Tensor:
        """[round(t/Q * x)]_t via the BEHZ {t, gamma} correction: convert
        [gamma t x]_Q to the base {t, gamma} (one conversion), multiply by
        -Q^-1, then remove the gamma factor with a centered correction."""
        tab = self.level_tables(level.chain_index)
        q = level.mod.q
        g = tab.gamma.value
        t = self.t_mod
        y = mm.mul_mod_shoup(x, tab.gamma_t_mod_q, tab.gamma_t_mod_q_shoup, q)
        scaled = mm.mul_mod_shoup(y, tab.qhatinv_mod_q, tab.qhatinv_mod_q_shoup, q)
        conv = bconv_matmul(scaled.contiguous(), tab.qhat_mod_tg, tab.tg_mod.q,
                            tab.tg_mod.ratio_lo, tab.tg_mod.ratio_hi, tab.qhat_mod_tg_diag)
        temp = tab.tg_mod.mul(conv, tab.neg_inv_q_mod_tg)            # (..., 2, N)
        temp_t, temp_g = temp[..., 0:1, :], temp[..., 1:2, :]
        # the centered gamma correction, with (gamma - temp_g) and temp_g mod t
        g_minus_t = mm.barrett_reduce_u64(g - temp_g, t.q, t.ratio_hi)
        temp_g_t = mm.barrett_reduce_u64(temp_g, t.q, t.ratio_hi)
        corrected = torch.where(temp_g > (g >> 1), mm.add_mod(temp_t, g_minus_t, t.q),
                                mm.sub_mod(temp_t, temp_g_t, t.q))
        return t.mul(corrected, tab.inv_gamma_mod_t)

    # -- noise budget (host CRT compose; a debug metric) ---------------------
    def invariant_noise_budget(self, sk: SecretKey, ct: Ciphertext) -> int:
        """log2(Q / 2|v|) - 1, rounded down as bit lengths, where v =
        [t * (c0 + c1 s)]_Q centered: the bits of noise room left."""
        level = self.context.level(ct.chain_index)
        tab = self.level_tables(ct.chain_index)
        tx = mm.mul_mod_shoup(self._dot_with_secret(level, ct.data, sk.s_ntt), tab.t_mod_q,
                              tab.t_mod_q_shoup, level.mod.q)
        y = mm.mul_mod_shoup(tx, tab.qhatinv_mod_q, tab.qhatinv_mod_q_shoup, level.mod.q)
        return noise_budget_bits(level.base, y)


def _digit_rows(value: int, count: int) -> list[int]:
    return [(value >> (31 * d)) & mm.M31 for d in range(count)]


def noise_budget_bits(base: RNSBase, y: torch.Tensor) -> int:
    """bitlen(Q) - bitlen(max_j |X_j|) - 1 (at least 0) for the centered CRT
    values X_j = sum_i y_i * qhat_i - r_j Q of y (k, N), y_i = [x_i *
    qhat_i^-1]_{q_i}, on y's device.  The sum is formed in 31-bit digit
    columns; r_j = round(sum_i y_i / q_i) comes from the 128-bit fixed-point
    words of 1/q_i (ops/bconv.py frac_alpha).  That rounding can only err
    when X_j is within k 2^-120 Q of Q/2, where either choice has the bit
    length of Q/2 and the budget is 0 all the same."""
    big_q = base.big_modulus
    dev = y.device
    k = len(base)
    width = -(-big_q.bit_length() // 31) + 2
    qhat = torch.tensor([_digit_rows(v, width) for v in base.punctured_products],
                        dtype=torch.int64, device=dev)                       # (k, D)
    fix = [(1 << 128) // q for q in base.values]
    r = frac_alpha(y, *(mm.u64_tensor(np.asarray([[f >> 64 if w else f & ((1 << 64) - 1)]
                                                   for f in fix], dtype=np.uint64), dev)
                        for w in (1, 0)))                                    # (1, N)
    cols = torch.zeros((width + 2,) + tuple(y.shape[1:]), dtype=torch.int64, device=dev)
    for i in range(k):
        for shift, part in ((0, y[i] & mm.M31), (1, y[i] >> 31)):
            p = qhat[i][:, None] * part                                       # (D, N)
            cols[shift:shift + width] += p & mm.M31
            cols[shift + 1:shift + 1 + width] += p >> 31
    q_digits = torch.tensor(_digit_rows(big_q, width + 2), dtype=torch.int64, device=dev)
    cols -= q_digits[:, None] * r
    best = 1
    for sign in (1, -1):
        digits, carry = [], 0
        for c in sign * cols:
            c = c + carry
            digits.append(c & mm.M31)
            carry = c >> 31
        d = torch.stack(digits)                                               # (D + 2, N)
        top = torch.where(d != 0, torch.arange(d.shape[0], device=dev)[:, None], -1).amax(0)
        head = d.gather(0, top.clamp(min=0)[None])[0].to(torch.float64)
        bits = torch.where(top >= 0, 31 * top + torch.frexp(head).exponent, 0)
        bits = torch.where(carry == 0, bits, 0)        # this sign's value is negative
        best = max(best, int(bits.max()))
    return max(0, big_q.bit_length() - best - 1)


def _find_coprime_prime(bit_size: int, exclude: set[int]) -> int:
    """Largest prime below 2^bit_size not in `exclude` (no NTT constraint)."""
    v = (1 << bit_size) - 1
    while v > 1 << (bit_size - 1):
        if v not in exclude and numth.is_prime(v):
            return v
        v -= 2
    raise RuntimeError("no qualifying prime found")


def _find_ntt_primes(n: int, bit_size: int, count: int, exclude: set[int]) -> list[int]:
    """NTT-friendly primes (= 1 mod 2n) of `bit_size` bits avoiding
    `exclude`, by the descending walk of numth.get_primes."""
    factor = 2 * n
    value = (1 << bit_size) - factor + 1
    out: list[int] = []
    while len(out) < count and value > 1 << (bit_size - 1):
        if value not in exclude and numth.is_prime(value):
            out.append(value)
        value -= factor
    if len(out) < count:
        raise RuntimeError("failed to find enough auxiliary primes")
    return out
