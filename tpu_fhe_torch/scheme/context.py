"""FHE context: modulus chain and per-level tables on one device.

Port of ``tpu_fhe/scheme/context.py`` for CKKS.  Chain index 0 is the key
level (all of Q and P), index 1 the first data level (all of Q), and each
next level drops one data prime.  Every table is computed on the host with
exact integers and stored once on ``ctx.device``: per-limb constants are
(k, 1), twiddle tables are the key-level (K, N) tables seen through a limb
map (ops/ntt.py).

The word of every residue, table and Shoup companion follows the chain: a
context whose primes all have at most 30 bits is a q32 context
(``is_q32``, the reference's compact u32 regime) and keeps them as
``torch.int32`` with Shoup32 words floor(w * 2^32 / q); any other context
keeps ``torch.int64`` with 64-bit Shoup words.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from ..core import numth
from ..core.modulus import Q32_BIT_MAX, Modulus
from ..core.ntt_tables import make_ntt_tables
from ..core.params import EncryptionParameters, SchemeType
from ..core.rns import BaseConverter, KeySwitchDigits, RNSBase
from ..ops import modarith as mm
from ..ops.bconv import digit_matrix, digit_matrix32
from ..ops.modarith import u32_tensor, u64_tensor
from ..ops.ntt import DeviceNTTTables, build_device_ntt_tables


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _col(vals, device, q32: bool = False) -> torch.Tensor:
    """Per-limb constants as a (k, 1) tensor: int64, or int32 when `q32`."""
    arr = np.asarray([int(v) for v in vals], dtype=np.uint64).reshape(-1, 1)
    return (u32_tensor if q32 else u64_tensor)(arr, device)


def _pair(vals, qs, device, q32: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-limb multipliers and their Shoup words floor(v * 2^word / q)."""
    shift = 32 if q32 else 64
    shoup = [(int(v) << shift) // int(q) for v, q in zip(vals, qs)]
    return _col(vals, device, q32), _col(shoup, device, q32)


@dataclass(frozen=True)
class ModulusVec:
    """Per-limb modulus constants shaped (k, 1): q in the context's word,
    the Barrett words floor(2^128/q) (int64 bit patterns), and on a q32
    context the single-word constants of ``modarith.q32_mul_consts``
    ((5, k, 1) int64; None on the u64 plan)."""

    q: torch.Tensor
    ratio_lo: torch.Tensor
    ratio_hi: torch.Tensor
    fold: torch.Tensor | None = None

    @staticmethod
    def from_moduli(mods: tuple[Modulus, ...], device, q32: bool = False) -> "ModulusVec":
        qs = [m.value for m in mods]
        fold = None
        if q32:
            consts = mm.q32_mul_consts(qs).astype(np.int64)
            fold = torch.from_numpy(consts.reshape(5, -1, 1)).to(device)
        return ModulusVec(
            q=_col(qs, device, q32),
            ratio_lo=_col([m.const_ratio[0] for m in mods], device),
            ratio_hi=_col([m.const_ratio[1] for m in mods], device),
            fold=fold,
        )

    def rows(self, sl: slice) -> "ModulusVec":
        return ModulusVec(self.q[sl], self.ratio_lo[sl], self.ratio_hi[sl],
                          None if self.fold is None else self.fold[:, sl])

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Canonical a*b mod q: the single-word formula on a q32 context,
        the full product and Barrett reduction on the u64 plan."""
        if self.fold is not None:
            return mm.mul_mod_q32(a, b, self.q, self.fold)
        return mm.mul_mod(a, b, self.q, self.ratio_lo, self.ratio_hi)


@dataclass(frozen=True)
class DigitTables:
    """Tables for one modup digit (hybrid keyswitch digit decomposition)."""

    start: int                    # first Ql limb index of this digit
    end: int                      # one past last
    qhat_mod_p: torch.Tensor      # (comp_size, digit_size)
    # the table's digit matrix for the tensor-core kernel: K12's
    # (ops/bconv.py digit_matrix) on the u64 plan, K13's (digit_matrix32)
    # on a q32 context
    qhat_mod_p_diag: torch.Tensor
    comp_mod: ModulusVec          # complement base (Ql minus digit) + P
    comp_ntt: DeviceNTTTables     # twiddles for the complement limbs


@dataclass(frozen=True)
class KeySwitchTables:
    """Per-level hybrid keyswitch tables (modup, inner product, moddown)."""

    alpha: int
    beta: int
    # concat over digits of [part-Qhat^{-1} mod q_i] per Ql limb, (size_Ql, 1)
    part_qhatinv: torch.Tensor
    part_qhatinv_shoup: torch.Tensor
    digits: tuple[DigitTables, ...]
    # the extended basis QlP = Ql ++ P: its moduli and their constants
    # ((size_QlP, 1): q, the Barrett words K7 lands with, the fold rows K9
    # and the q32 multiply use), and the key rows of the inner product
    # (size_QlP,)
    qlp_mod: ModulusVec
    qlp_key_rows: torch.Tensor
    # moddown: P -> Ql conversion and P^{-1} scaling
    p_hatinv: torch.Tensor         # (size_P, 1) [ (P/p_j)^{-1} ]_{p_j}
    p_hatinv_shoup: torch.Tensor
    p_hat_mod_q: torch.Tensor      # (size_Ql, size_P)
    p_hat_mod_q_diag: torch.Tensor  # its digit matrix
    p_mod: ModulusVec
    p_ntt: DeviceNTTTables
    big_pinv_mod_q: torch.Tensor   # (size_Ql, 1)
    big_pinv_mod_q_shoup: torch.Tensor
    # keyswitch_ext / hoisting: [P]_{q_i} and its Shoup word, (size_Ql, 1)
    big_p_mod_q: torch.Tensor
    big_p_mod_q_shoup: torch.Tensor


@dataclass(frozen=True)
class ContextLevel:
    """One node of the modulus chain."""

    chain_index: int
    limb_indices: tuple[int, ...]   # indices into the key-level QP list
    base: RNSBase                   # the Ql (or QP for key level) base
    mod: ModulusVec
    ntt: DeviceNTTTables
    # rescale (divide by q_last): [q_last^{-1}]_{q_i} for remaining limbs
    inv_q_last_mod_q: torch.Tensor | None       # (size_Ql - 1, 1)
    inv_q_last_mod_q_shoup: torch.Tensor | None
    ks: KeySwitchTables | None      # None at key level

    @property
    def size(self) -> int:
        return len(self.limb_indices)


class FheContext:
    """Owns the modulus chain and every table, on ``self.device``."""

    def __init__(self, params: EncryptionParameters, device=None):
        if params.scheme != SchemeType.ckks:
            raise ValueError("the port supports CKKS only")
        self.device = resolve_device(device)
        self.params = params
        dev = self.device
        self.key_modulus = params.coeff_modulus
        size_Q, size_P = params.size_Q, params.size_P
        q32 = self.is_q32

        self.key_ntt = build_device_ntt_tables(
            [make_ntt_tables(params.log_n, m.value) for m in self.key_modulus], dev, q32)
        self.base_P = RNSBase(tuple(self.key_modulus[size_Q:]))
        self._composite_tables: dict = {}
        self._ntt_views: dict = {}

        key_base = RNSBase(tuple(self.key_modulus))
        self.chain: list[ContextLevel] = [ContextLevel(
            chain_index=0,
            limb_indices=tuple(range(params.size_QP)),
            base=key_base,
            mod=ModulusVec.from_moduli(key_base.base, dev, q32),
            ntt=self.key_ntt,
            inv_q_last_mod_q=None,
            inv_q_last_mod_q_shoup=None,
            ks=None,
        )]
        for drop in range(size_Q):
            size_Ql = size_Q - drop
            base_Ql = RNSBase(tuple(self.key_modulus[:size_Ql]))
            inv_q_last = inv_q_last_shoup = None
            if size_Ql > 1:
                q_last = base_Ql.values[-1]
                inv = [numth.invert_mod(q_last % q, q) for q in base_Ql.values[:-1]]
                inv_q_last, inv_q_last_shoup = _pair(inv, base_Ql.values[:-1], dev, q32)
            self.chain.append(ContextLevel(
                chain_index=1 + drop,
                limb_indices=tuple(range(size_Ql)),
                base=base_Ql,
                mod=ModulusVec.from_moduli(base_Ql.base, dev, q32),
                ntt=self.key_ntt.slice_limbs(list(range(size_Ql))),
                inv_q_last_mod_q=inv_q_last,
                inv_q_last_mod_q_shoup=inv_q_last_shoup,
                ks=self._build_keyswitch_tables(base_Ql),
            ))

    def _build_keyswitch_tables(self, base_Ql: RNSBase) -> KeySwitchTables:
        dev, q32 = self.device, self.is_q32
        size_Ql = len(base_Ql)
        size_Q, size_P = self.params.size_Q, self.params.size_P
        p_base = self.base_P
        digits = KeySwitchDigits(base_Ql, p_base, alpha=size_P)

        part_qhatinv = [0] * size_Ql
        for d, b in enumerate(digits.digit_bases):
            for j, i in enumerate(digits.digit_indices(d)):
                part_qhatinv[i] = b.q_hat_inv_mod_q[j]
        table = u32_tensor if q32 else u64_tensor

        diag = digit_matrix32 if q32 else digit_matrix

        digit_tables = []
        for d in range(digits.beta):
            rng = digits.digit_indices(d)
            # complement limbs in key-level numbering: the Ql limbs not in
            # this digit, then the P limbs
            comp_key_idx = [i for i in range(size_Ql) if i not in rng] + [
                size_Q + j for j in range(size_P)
            ]
            qhat_mod_p = table(np.array(digits.converters[d].q_hat_mod_p, dtype=np.uint64), dev)
            digit_tables.append(DigitTables(
                start=rng.start,
                end=rng.stop,
                qhat_mod_p=qhat_mod_p,
                qhat_mod_p_diag=diag(qhat_mod_p),
                comp_mod=ModulusVec.from_moduli(digits.complement_bases[d].base, dev, q32),
                comp_ntt=self.key_ntt.slice_limbs(comp_key_idx),
            ))

        p_to_q = BaseConverter(p_base, base_Ql)
        big_p = p_base.big_modulus
        big_pinv_mod_q = [numth.invert_mod(big_p % q, q) for q in base_Ql.values]
        part_qhatinv, part_qhatinv_shoup = _pair(part_qhatinv, base_Ql.values, dev, q32)
        p_hatinv, p_hatinv_shoup = _pair(p_base.q_hat_inv_mod_q, p_base.values, dev, q32)
        big_pinv, big_pinv_shoup = _pair(big_pinv_mod_q, base_Ql.values, dev, q32)
        big_p_mod_q, big_p_mod_q_shoup = _pair([big_p % q for q in base_Ql.values],
                                               base_Ql.values, dev, q32)
        p_hat_mod_q = table(np.array(p_to_q.q_hat_mod_p, dtype=np.uint64), dev)
        return KeySwitchTables(
            alpha=size_P,
            beta=digits.beta,
            part_qhatinv=part_qhatinv,
            part_qhatinv_shoup=part_qhatinv_shoup,
            digits=tuple(digit_tables),
            qlp_mod=ModulusVec.from_moduli(base_Ql.base + p_base.base, dev, q32),
            qlp_key_rows=torch.tensor(list(range(size_Ql)) + list(range(size_Q, size_Q + size_P)),
                                      dtype=torch.int64, device=dev),
            p_hatinv=p_hatinv,
            p_hatinv_shoup=p_hatinv_shoup,
            p_hat_mod_q=p_hat_mod_q,
            p_hat_mod_q_diag=diag(p_hat_mod_q),
            p_mod=ModulusVec.from_moduli(p_base.base, dev, q32),
            p_ntt=self.key_ntt.slice_limbs([size_Q + j for j in range(size_P)]),
            big_pinv_mod_q=big_pinv,
            big_pinv_mod_q_shoup=big_pinv_shoup,
            big_p_mod_q=big_p_mod_q,
            big_p_mod_q_shoup=big_p_mod_q_shoup,
        )

    # -- chain helpers --------------------------------------------------
    @cached_property
    def is_q32(self) -> bool:
        """Every prime has at most 30 bits: residues fit one word, stored as
        int32 (tpu_fhe/scheme/context.py:126-135)."""
        return all(m.value.bit_length() <= Q32_BIT_MAX for m in self.key_modulus)

    @property
    def dtype(self) -> torch.dtype:
        """The residue word of every tensor of this context."""
        return torch.int32 if self.is_q32 else torch.int64

    def composite_rescale_tables(self, chain_index: int, limbs: int):
        """For rescale_composite at `chain_index`, with Q2 the product of
        the last `limbs` primes: the NTT tables of those limbs, then for
        every remaining limb [Q2^{-1}]_{q_i}, its Shoup word and
        [floor(Q2 / 2)]_{q_i}, each (k, 1).  Built once per
        (chain_index, limbs)."""
        key = (chain_index, limbs)
        got = self._composite_tables.get(key)
        if got is None:
            size_Ql = self.level(chain_index).size
            keep = size_Ql - limbs
            rest = self.q_values[:keep]
            q2 = 1
            for v in self.q_values[keep:size_Ql]:
                q2 *= v
            inv = [numth.invert_mod(q2 % q, q) for q in rest]
            got = (self.level(chain_index).ntt.slice_limbs(list(range(keep, size_Ql))),
                   *_pair(inv, rest, self.device, self.is_q32),
                   _col([(q2 >> 1) % q for q in rest], self.device, self.is_q32))
            self._composite_tables[key] = got
        return got

    def ntt_view(self, tables: DeviceNTTTables, indices: tuple[int, ...]) -> DeviceNTTTables:
        """``tables.slice_limbs(indices)``, built once per (tables, indices):
        a later call copies nothing to the device, so it may run while a
        CUDA graph is captured."""
        key = (id(tables), tuple(indices))
        got = self._ntt_views.get(key)
        if got is None:
            # the entry holds `tables`, so its id is not reused while cached
            got = self._ntt_views[key] = (tables, tables.slice_limbs(list(indices)))
        return got[1]

    @property
    def key_level(self) -> ContextLevel:
        return self.chain[0]

    @property
    def first_data_level(self) -> ContextLevel:
        return self.chain[1]

    def level(self, chain_index: int) -> ContextLevel:
        return self.chain[chain_index]

    @property
    def n(self) -> int:
        return self.params.poly_modulus_degree

    @cached_property
    def q_values(self) -> list[int]:
        return [m.value for m in self.key_modulus[: self.params.size_Q]]
