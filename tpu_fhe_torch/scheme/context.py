"""FHE context: modulus chain and per-level tables on one device.

Port of ``tpu_fhe/scheme/context.py`` for CKKS on the u64 plan.  Chain index
0 is the key level (all of Q and P), index 1 the first data level (all of
Q), and each next level drops one data prime.  Every table is computed on
the host with exact integers and stored once on ``ctx.device`` as int64
tensors: per-limb constants are (k, 1), twiddle tables are the key-level
(K, N) tables seen through a limb map (ops/ntt.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from ..core import numth
from ..core.modulus import Modulus
from ..core.ntt_tables import compute_shoup, make_ntt_tables
from ..core.params import EncryptionParameters, SchemeType
from ..core.rns import BaseConverter, KeySwitchDigits, RNSBase
from ..ops.modarith import u64_tensor
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


def _col(vals, device) -> torch.Tensor:
    """Per-limb constants as a (k, 1) int64 tensor."""
    return u64_tensor(np.asarray([int(v) for v in vals], dtype=np.uint64).reshape(-1, 1),
                      device)


@dataclass(frozen=True)
class ModulusVec:
    """Per-limb modulus constants shaped (k, 1)."""

    q: torch.Tensor
    ratio_lo: torch.Tensor
    ratio_hi: torch.Tensor

    @staticmethod
    def from_moduli(mods: tuple[Modulus, ...], device) -> "ModulusVec":
        return ModulusVec(
            q=_col([m.value for m in mods], device),
            ratio_lo=_col([m.const_ratio[0] for m in mods], device),
            ratio_hi=_col([m.const_ratio[1] for m in mods], device),
        )


@dataclass(frozen=True)
class DigitTables:
    """Tables for one modup digit (hybrid keyswitch digit decomposition)."""

    start: int                    # first Ql limb index of this digit
    end: int                      # one past last
    qhat_mod_p: torch.Tensor      # (comp_size, digit_size)
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
    # inner product over QlP: moduli (size_QlP, 1) and key rows (size_QlP,)
    qlp_q: torch.Tensor
    qlp_key_rows: torch.Tensor
    # moddown: P -> Ql conversion and P^{-1} scaling
    p_hatinv: torch.Tensor         # (size_P, 1) [ (P/p_j)^{-1} ]_{p_j}
    p_hatinv_shoup: torch.Tensor
    p_hat_mod_q: torch.Tensor      # (size_Ql, size_P)
    p_mod: ModulusVec
    p_ntt: DeviceNTTTables
    big_pinv_mod_q: torch.Tensor   # (size_Ql, 1)
    big_pinv_mod_q_shoup: torch.Tensor


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

        self.key_ntt = build_device_ntt_tables(
            [make_ntt_tables(params.log_n, m.value) for m in self.key_modulus], dev)
        self.base_P = RNSBase(tuple(self.key_modulus[size_Q:]))

        key_base = RNSBase(tuple(self.key_modulus))
        self.chain: list[ContextLevel] = [ContextLevel(
            chain_index=0,
            limb_indices=tuple(range(params.size_QP)),
            base=key_base,
            mod=ModulusVec.from_moduli(key_base.base, dev),
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
                inv_q_last = _col(inv, dev)
                inv_q_last_shoup = _col(
                    [compute_shoup(v, q) for v, q in zip(inv, base_Ql.values[:-1])], dev)
            self.chain.append(ContextLevel(
                chain_index=1 + drop,
                limb_indices=tuple(range(size_Ql)),
                base=base_Ql,
                mod=ModulusVec.from_moduli(base_Ql.base, dev),
                ntt=self.key_ntt.slice_limbs(list(range(size_Ql))),
                inv_q_last_mod_q=inv_q_last,
                inv_q_last_mod_q_shoup=inv_q_last_shoup,
                ks=self._build_keyswitch_tables(base_Ql),
            ))

    def _build_keyswitch_tables(self, base_Ql: RNSBase) -> KeySwitchTables:
        dev = self.device
        size_Ql = len(base_Ql)
        size_Q, size_P = self.params.size_Q, self.params.size_P
        p_base = self.base_P
        digits = KeySwitchDigits(base_Ql, p_base, alpha=size_P)

        part_qhatinv = [0] * size_Ql
        part_qhatinv_shoup = [0] * size_Ql
        for d, b in enumerate(digits.digit_bases):
            for j, i in enumerate(digits.digit_indices(d)):
                part_qhatinv[i] = b.q_hat_inv_mod_q[j]
                part_qhatinv_shoup[i] = b.q_hat_inv_mod_q_shoup[j]

        digit_tables = []
        for d in range(digits.beta):
            rng = digits.digit_indices(d)
            # complement limbs in key-level numbering: the Ql limbs not in
            # this digit, then the P limbs
            comp_key_idx = [i for i in range(size_Ql) if i not in rng] + [
                size_Q + j for j in range(size_P)
            ]
            digit_tables.append(DigitTables(
                start=rng.start,
                end=rng.stop,
                qhat_mod_p=u64_tensor(np.array(digits.converters[d].q_hat_mod_p,
                                               dtype=np.uint64), dev),
                comp_mod=ModulusVec.from_moduli(digits.complement_bases[d].base, dev),
                comp_ntt=self.key_ntt.slice_limbs(comp_key_idx),
            ))

        p_to_q = BaseConverter(p_base, base_Ql)
        big_p = p_base.big_modulus
        big_pinv_mod_q = [numth.invert_mod(big_p % q, q) for q in base_Ql.values]
        qlp = list(base_Ql.values) + list(p_base.values)
        return KeySwitchTables(
            alpha=size_P,
            beta=digits.beta,
            part_qhatinv=_col(part_qhatinv, dev),
            part_qhatinv_shoup=_col(part_qhatinv_shoup, dev),
            digits=tuple(digit_tables),
            qlp_q=_col(qlp, dev),
            qlp_key_rows=torch.tensor(list(range(size_Ql)) + list(range(size_Q, size_Q + size_P)),
                                      dtype=torch.int64, device=dev),
            p_hatinv=_col(p_base.q_hat_inv_mod_q, dev),
            p_hatinv_shoup=_col(p_base.q_hat_inv_mod_q_shoup, dev),
            p_hat_mod_q=u64_tensor(np.array(p_to_q.q_hat_mod_p, dtype=np.uint64), dev),
            p_mod=ModulusVec.from_moduli(p_base.base, dev),
            p_ntt=self.key_ntt.slice_limbs([size_Q + j for j in range(size_P)]),
            big_pinv_mod_q=_col(big_pinv_mod_q, dev),
            big_pinv_mod_q_shoup=_col(
                [compute_shoup(v, q) for v, q in zip(big_pinv_mod_q, base_Ql.values)], dev),
        )

    # -- chain helpers --------------------------------------------------
    @property
    def key_level(self) -> ContextLevel:
        return self.chain[0]

    def level(self, chain_index: int) -> ContextLevel:
        return self.chain[chain_index]

    @property
    def n(self) -> int:
        return self.params.poly_modulus_degree

    @cached_property
    def q_values(self) -> list[int]:
        return [m.value for m in self.key_modulus[: self.params.size_Q]]
