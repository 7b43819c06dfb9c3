"""Modulus and coefficient-modulus creation (host side, exact arithmetic).

The port's own copy of ``tpu_fhe/core/modulus.py`` for the u64 plan:
61-bit max NTT-friendly primes, Barrett const ratios (floor(2^128/q) as two
64-bit words + remainder), HomomorphicEncryption.org security tables.  The
composite-scaling chain builder belongs to the q32 slice and is not here.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import numth

MOD_BIT_COUNT_MAX = 61
USER_MOD_BIT_COUNT_MIN = 2
USER_MOD_BIT_COUNT_MAX = 60
POLY_MOD_DEGREE_MIN = 2
POLY_MOD_DEGREE_MAX = 131072
# 128-bit accumulators in base conversion hold <= 63 terms of < 2^122.
COEFF_MOD_COUNT_MAX = 64


@dataclass(frozen=True)
class Modulus:
    """A word-size modulus (< 2^61) with Barrett precomputation.

    const_ratio = (lo, hi, rem) where floor(2^128 / q) = hi*2^64 + lo and
    rem = 2^128 mod q.
    """

    value: int
    const_ratio: tuple[int, int, int] = field(init=False)
    bit_count: int = field(init=False)
    is_prime: bool = field(init=False)

    def __post_init__(self):
        v = self.value
        if v >> MOD_BIT_COUNT_MAX != 0 or v < 2:
            raise ValueError("modulus can be at most 61-bit and must be > 1")
        quotient, rem = divmod(1 << 128, v)
        object.__setattr__(
            self,
            "const_ratio",
            (quotient & 0xFFFFFFFFFFFFFFFF, (quotient >> 64) & 0xFFFFFFFFFFFFFFFF, rem),
        )
        object.__setattr__(self, "bit_count", v.bit_length())
        object.__setattr__(self, "is_prime", numth.is_prime(v))


# HomomorphicEncryption.org standard tables: max total log q bits for a given
# N at 128/192/256-bit security with ternary secret.  Unknown N -> 0.
_HE_STD_128_TC = {1024: 27, 2048: 54, 4096: 109, 8192: 218, 16384: 438,
                  32768: 881, 65536: 1777, 131072: 3576}
_HE_STD_192_TC = {1024: 19, 2048: 37, 4096: 75, 8192: 151, 16384: 304,
                  32768: 611, 65536: 1229, 131072: 2469}
_HE_STD_256_TC = {1024: 14, 2048: 29, 4096: 58, 8192: 118, 16384: 237,
                  32768: 476, 65536: 955, 131072: 1918}


def he_std_parms(poly_modulus_degree: int, sec_level: int = 128) -> int:
    table = {128: _HE_STD_128_TC, 192: _HE_STD_192_TC, 256: _HE_STD_256_TC}[sec_level]
    return table.get(poly_modulus_degree, 0)


class CoeffModulus:
    """Static factory for RNS coefficient-modulus chains."""

    @staticmethod
    def create(poly_modulus_degree: int, bit_sizes: list[int]) -> list[Modulus]:
        """Distinct NTT-friendly primes with the requested bit sizes: group
        the request by bit size, generate count-per-size primes by the
        deterministic descending search, then hand them back in request
        order (taking from the back of each per-size pool)."""
        n = poly_modulus_degree
        if n > POLY_MOD_DEGREE_MAX or n < POLY_MOD_DEGREE_MIN or n & (n - 1):
            raise ValueError("poly_modulus_degree is invalid")
        if len(bit_sizes) > COEFF_MOD_COUNT_MAX:
            raise ValueError("bit_sizes is invalid: at most 64 primes")
        if bit_sizes and (
            max(bit_sizes) > USER_MOD_BIT_COUNT_MAX or min(bit_sizes) < USER_MOD_BIT_COUNT_MIN
        ):
            raise ValueError("bit_sizes entries out of bounds")

        count_table: dict[int, int] = {}
        for size in bit_sizes:
            count_table[size] = count_table.get(size, 0) + 1
        prime_table = {
            size: numth.get_primes(n, size, count) for size, count in count_table.items()
        }
        return [Modulus(prime_table[size].pop()) for size in bit_sizes]
