"""Modulus and coefficient-modulus creation (host side, exact arithmetic).

The port's own copy of ``tpu_fhe/core/modulus.py``: 61-bit max
NTT-friendly primes, Barrett const ratios (floor(2^128/q) as two 64-bit
words + remainder), HomomorphicEncryption.org security tables, and the
composite-scaling chain of the q32 regime (every prime < 2^30), and
the batching plain modulus of BFV/BGV.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import numth

MOD_BIT_COUNT_MAX = 61
USER_MOD_BIT_COUNT_MIN = 2
USER_MOD_BIT_COUNT_MAX = 60
POLY_MOD_DEGREE_MIN = 2
POLY_MOD_DEGREE_MAX = 131072
# 128-bit accumulators in base conversion hold <= 63 terms of < 2^122, so
# the u64 plan caps a chain at 64 primes.  In the q32 regime (every prime of
# at most 30 bits) a product term is < 2^60 and the chain may hold 128.
COEFF_MOD_COUNT_MAX = 64
COEFF_MOD_COUNT_MAX_Q32 = 128
Q32_BIT_MAX = 30


def count_cap(bit_counts) -> int:
    """The longest chain allowed for primes of these bit counts."""
    bit_counts = list(bit_counts)
    if bit_counts and max(bit_counts) <= Q32_BIT_MAX:
        return COEFF_MOD_COUNT_MAX_Q32
    return COEFF_MOD_COUNT_MAX


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
        if len(bit_sizes) > count_cap(bit_sizes):
            raise ValueError("bit_sizes is invalid: > 64 primes is only supported in the "
                             "q32 regime (every bit size <= 30)")
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

    @staticmethod
    def create_composite(poly_modulus_degree: int, scale_bits: int, levels: int,
                         degree: int = 2, anchor_bits: int = 30, special_bits: int = 30,
                         special_count: int = 2) -> list[Modulus]:
        """Composite-scaling chain: an anchor group of `degree` primes of
        `anchor_bits`, `levels` data groups of `degree` primes whose product
        tracks the ladder target 2^scale_bits, and `special_count`
        key-switching primes.  Each group's target is sf_prev^2 / 2^scale_bits,
        so the per-level error never compounds; for pairs, the first prime is
        searched among the 24 candidates nearest 2^(scale_bits/2) so that the
        pair product lands close to its target.  Chain order: anchor, data
        groups (the last generated first), specials."""
        n = poly_modulus_degree
        if degree < 1:
            raise ValueError("degree must be >= 1")
        b = scale_bits // degree
        if not USER_MOD_BIT_COUNT_MIN <= b <= USER_MOD_BIT_COUNT_MAX:
            raise ValueError("scale_bits/degree out of prime-size bounds")
        used: set[int] = set()

        def take_near(target: float, bits_cap: int | None) -> int:
            p = numth.nearest_prime(n, target, used, bits_cap)
            used.add(p)
            return p

        anchor = [take_near(2.0 ** anchor_bits * (1 - 2e-3), anchor_bits)
                  for _ in range(degree)]
        specials = [take_near(2.0 ** special_bits * (1 - 2e-3), special_bits)
                    for _ in range(special_count)]
        target_sf = 2.0 ** scale_bits
        groups: list[list[int]] = []
        sf = None
        for _ in range(levels):
            tgt = target_sf if sf is None else sf * sf / target_sf
            if degree == 2:
                best = None
                for a in numth.nearest_primes(n, 2.0 ** b, used, 24):
                    partner = numth.nearest_prime(n, tgt / a, used | {a})
                    err = abs(a * partner - tgt) / tgt
                    if best is None or err < best[0]:
                        best = (err, a, partner)
                _, a, partner = best
                used.update((a, partner))
                group = [a, partner]
                partial = float(a) * float(partner)
            else:
                group, partial = [], 1.0
                for j in range(degree):
                    p = take_near(2.0 ** b if j < degree - 1 else tgt / partial, None)
                    group.append(p)
                    partial *= float(p)
            groups.append(group)
            sf = partial if sf is None else sf * sf / partial
        data = [p for g in reversed(groups) for p in g]
        return [Modulus(p) for p in anchor + data + specials]


class PlainModulus:
    @staticmethod
    def batching(poly_modulus_degree: int, bit_size: int) -> Modulus:
        """The largest prime t = 1 mod 2N of `bit_size` bits: t supports
        batching (N slots)."""
        return Modulus(numth.get_primes(poly_modulus_degree, bit_size, 1)[0])
