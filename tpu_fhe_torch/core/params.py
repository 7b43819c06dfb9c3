"""Encryption parameters (scheme, ring degree, modulus chain).

The port's own copy of ``tpu_fhe/core/params.py`` for CKKS, with the
composite-scaling degree of the q32 regime.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from .modulus import Modulus, count_cap, he_std_parms


class SchemeType(enum.Enum):
    none = 0
    bfv = 1
    ckks = 2
    bgv = 3


@dataclass(frozen=True)
class EncryptionParameters:
    scheme: SchemeType
    poly_modulus_degree: int
    coeff_modulus: tuple[Modulus, ...]
    # Number of trailing special (key-switching) primes P; hybrid KS.
    special_modulus_size: int = 1
    # Composite scaling (CKKS, q32 regime): one logical level spans this
    # many RNS limbs, so a ~2^56 working scale is built from pairs of
    # ~28-30-bit primes.  1 = classic single-prime levels.
    composite_degree: int = 1
    # HomomorphicEncryption.org security level enforced at construction:
    # total logQP must not exceed the table bound for this N.  0 disables
    # the check, as does allow_insecure=True.
    sec_level: int = 128
    allow_insecure: bool = False

    def __post_init__(self):
        n = self.poly_modulus_degree
        if n & (n - 1) or n < 2:
            raise ValueError("poly_modulus_degree must be a power of two >= 2")
        if self.special_modulus_size < 1:
            raise ValueError("special_modulus_size must be >= 1 (hybrid KS)")
        if self.special_modulus_size >= len(self.coeff_modulus):
            raise ValueError("special_modulus_size must leave at least one data prime")
        values = [m.value for m in self.coeff_modulus]
        if len(set(values)) != len(values):
            raise ValueError("coeff modulus primes must be distinct")
        if len(values) > count_cap(v.bit_length() for v in values):
            raise ValueError("coeff modulus chain too long: > 64 primes is only supported "
                             "in the q32 regime (every prime < 2^30)")
        d = self.composite_degree
        if d < 1:
            raise ValueError("composite_degree must be >= 1")
        if d > 1:
            if self.scheme != SchemeType.ckks:
                raise ValueError("composite scaling is a CKKS regime")
            if self.size_Q % d:
                raise ValueError("composite scaling needs size_Q divisible by the degree "
                                 "(every logical level, including the anchor, is a full "
                                 "group of primes)")
            anchor = 1
            for v in values[:d]:
                anchor *= v
            if anchor.bit_length() > 62:
                raise ValueError("composite anchor product must fit 62 bits (exact u64 "
                                 "CRT compose during RaiseMod)")
        if self.sec_level and not self.allow_insecure:
            bound = he_std_parms(n, self.sec_level)
            total = sum(v.bit_length() for v in values)
            if bound and total > bound:
                raise ValueError(
                    f"total coeff modulus is {total} bits but the "
                    f"HomomorphicEncryption.org bound for N={n} at "
                    f"{self.sec_level}-bit security is {bound} bits; "
                    "pass allow_insecure=True (or sec_level=0) for "
                    "research parameter regimes"
                )

    @property
    def log_n(self) -> int:
        return self.poly_modulus_degree.bit_length() - 1

    @property
    def size_P(self) -> int:
        return self.special_modulus_size

    @property
    def size_QP(self) -> int:
        return len(self.coeff_modulus)

    @property
    def size_Q(self) -> int:
        return self.size_QP - self.size_P
