"""RNS bases and base-converter precomputation (host side, exact ints).

The port's own copy of ``tpu_fhe/core/rns.py``: punctured products
q_hat_i = Q/q_i and their inverses mod q_i (with Shoup words), CRT
decompose/compose, the BEHZ cross-base table q_hat mod p and HPS's
alpha*Q mod p correction rows, and the hybrid-keyswitch digit
decomposition.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

from . import numth
from .modulus import Modulus
from .ntt_tables import compute_shoup


@dataclass(frozen=True)
class RNSBase:
    """An ordered RNS base {q_0, ..., q_{k-1}} of coprime word moduli."""

    base: tuple[Modulus, ...]

    def __post_init__(self):
        if not self.base:
            raise ValueError("RNS base cannot be empty")

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, i: int) -> Modulus:
        return self.base[i]

    @cached_property
    def values(self) -> tuple[int, ...]:
        return tuple(m.value for m in self.base)

    @cached_property
    def big_modulus(self) -> int:
        prod = 1
        for m in self.base:
            prod *= m.value
        return prod

    @cached_property
    def punctured_products(self) -> tuple[int, ...]:
        """q_hat_i = Q / q_i (exact big ints)."""
        q = self.big_modulus
        return tuple(q // m.value for m in self.base)

    @cached_property
    def q_hat_inv_mod_q(self) -> tuple[int, ...]:
        """[q_hat_i^{-1}]_{q_i}"""
        return tuple(
            numth.invert_mod(self.punctured_products[i] % m.value, m.value)
            for i, m in enumerate(self.base)
        )

    def extend(self, other: "Modulus | RNSBase") -> "RNSBase":
        """This base followed by `other` (one modulus or a base's moduli),
        each of which must be coprime to every one of this base's."""
        extra = (other,) if isinstance(other, Modulus) else other.base
        for m in extra:
            if any(numth.gcd(m.value, mine.value) != 1 for mine in self.base):
                raise ValueError("cannot extend by non-coprime modulus")
        return RNSBase(self.base + extra)

    def drop(self, count: int = 1) -> "RNSBase":
        """This base without its last `count` moduli."""
        if len(self.base) <= count:
            raise ValueError("cannot drop all moduli")
        return RNSBase(self.base[:-count])

    def decompose(self, value: int) -> list[int]:
        """Big int -> RNS residues."""
        return [value % m.value for m in self.base]

    def compose(self, residues: list[int]) -> int:
        """RNS residues -> the big int in [0, Q) by CRT."""
        acc = 0
        for i, m in enumerate(self.base):
            acc += (residues[i] * self.q_hat_inv_mod_q[i]) % m.value * self.punctured_products[i]
        return acc % self.big_modulus

    @cached_property
    def q_hat_inv_mod_q_shoup(self) -> tuple[int, ...]:
        return tuple(
            compute_shoup(v, m.value) for v, m in zip(self.q_hat_inv_mod_q, self.base)
        )


@dataclass(frozen=True)
class BaseConverter:
    """BEHZ fast basis conversion tables from ibase {q_i} to obase {p_j}:
    y_j = sum_i [x_i * q_hat_i^{-1}]_{q_i} * q_hat_i (mod p_j), which equals
    x + alpha*Q mod p_j for a small overshoot alpha < k."""

    ibase: RNSBase
    obase: RNSBase

    @cached_property
    def q_hat_mod_p(self) -> list[list[int]]:
        """[p_j][q_i]: q_hat_i mod p_j (row-major per output prime)."""
        return [
            [qh % p for qh in self.ibase.punctured_products]
            for p in self.obase.values
        ]

    @cached_property
    def alpha_q_mod_p(self) -> list[list[int]]:
        """[alpha][p_j]: (alpha * Q) mod p_j for alpha in 0..k (HPS's
        correction of the overshoot)."""
        q = self.ibase.big_modulus
        return [[(a * q) % p for p in self.obase.values] for a in range(len(self.ibase) + 1)]

    @cached_property
    def big_q_mod_p(self) -> list[int]:
        q = self.ibase.big_modulus
        return [q % p for p in self.obase.values]


@dataclass(frozen=True)
class KeySwitchDigits:
    """Digit decomposition of the current base Ql for hybrid key switching:
    Ql's limbs are partitioned into beta contiguous digits of up to alpha
    (= |P|) limbs each; digit d converts to the complement base
    (Ql minus digit d) + P."""

    base_Ql: RNSBase
    base_P: RNSBase
    alpha: int
    beta: int = field(init=False)

    def __post_init__(self):
        k = len(self.base_Ql)
        object.__setattr__(self, "beta", (k + self.alpha - 1) // self.alpha)

    def digit_indices(self, d: int) -> range:
        k = len(self.base_Ql)
        start = d * self.alpha
        return range(start, min(start + self.alpha, k))

    @cached_property
    def digit_bases(self) -> list[RNSBase]:
        return [
            RNSBase(tuple(self.base_Ql.base[i] for i in self.digit_indices(d)))
            for d in range(self.beta)
        ]

    @cached_property
    def complement_bases(self) -> list[RNSBase]:
        out = []
        for d in range(self.beta):
            idx = set(self.digit_indices(d))
            mods = tuple(
                m for i, m in enumerate(self.base_Ql.base) if i not in idx
            ) + self.base_P.base
            out.append(RNSBase(mods))
        return out

    @cached_property
    def converters(self) -> list[BaseConverter]:
        return [
            BaseConverter(self.digit_bases[d], self.complement_bases[d])
            for d in range(self.beta)
        ]
