"""Number-theory helpers (host side, exact Python integers).

The port's own copy of ``tpu_fhe/core/numth.py``, limited to what the port
needs: primality testing, the NTT-friendly prime searches (by bit size,
below a bound, and nearest to a target), minimal primitive 2N-th roots of unity and
the non-adjacent form that decomposes a rotation step.  The reference's
ctypes fast path for the prime search is not ported; the pure-Python
search below is the same deterministic descending walk, so it yields the
same primes.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def reverse_bits(value: int, bit_count: int) -> int:
    """Bit-reverse `value` within `bit_count` bits."""
    result = 0
    for _ in range(bit_count):
        result = (result << 1) | (value & 1)
        value >>= 1
    return result


@lru_cache(maxsize=None)
def bit_reverse_perm(bit_count: int) -> np.ndarray:
    """Vectorized bit-reversal permutation of [0, 2^bit_count) (cached)."""
    arr = np.arange(1 << bit_count, dtype=np.int64)
    rev = np.zeros_like(arr)
    for b in range(bit_count):
        rev = (rev << 1) | ((arr >> b) & 1)
    return rev


def xgcd(a: int, b: int) -> tuple[int, int, int]:
    """Extended gcd: returns (g, x, y) with a*x + b*y = g."""
    old_r, r = a, b
    old_s, s = 1, 0
    old_t, t = 0, 1
    while r:
        q = old_r // r
        old_r, r = r, old_r - q * r
        old_s, s = s, old_s - q * s
        old_t, t = t, old_t - q * t
    return old_r, old_s, old_t


def invert_mod(a: int, m: int) -> int:
    g, x, _ = xgcd(a % m, m)
    if g != 1:
        raise ValueError(f"{a} is not invertible modulo {m}")
    return x % m


# Deterministic Miller-Rabin bases valid for all n < 3.3e24 (covers 64-bit).
_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in _MR_BASES:
        if n == p:
            return True
        if n % p == 0:
            return False
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_BASES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


def get_primes(ntt_size: int, bit_size: int, count: int) -> list[int]:
    """NTT-friendly primes q = 1 (mod 2*ntt_size), of exactly `bit_size` bits,
    found by a deterministic descending search from 2^bit_size - 2*ntt_size + 1
    in steps of 2*ntt_size."""
    factor = 2 * ntt_size
    value = (1 << bit_size) - factor + 1
    lower_bound = 1 << (bit_size - 1)
    out: list[int] = []
    while len(out) < count and value > lower_bound:
        if is_prime(value):
            out.append(value)
        value -= factor
    if len(out) < count:
        raise RuntimeError("failed to find enough qualifying primes")
    return out


def get_primes_below(ntt_size: int, upper_bound: int, count: int) -> list[int]:
    """NTT-friendly primes strictly below `upper_bound`, found by the same
    descending walk in steps of 2*ntt_size, of upper_bound's bit length
    (HPS's auxiliary base R)."""
    factor = 2 * ntt_size
    value = upper_bound - factor
    lower_bound = 1 << (upper_bound.bit_length() - 1)
    out: list[int] = []
    while len(out) < count and value > lower_bound:
        if is_prime(value):
            out.append(value)
        value -= factor
    if len(out) < count:
        raise RuntimeError("failed to find enough qualifying primes")
    return out


def nearest_primes(ntt_size: int, target: float, used=(), count: int = 1,
                   max_bits: int | None = None) -> list[int]:
    """The `count` NTT-friendly primes q = 1 (mod 2*ntt_size) nearest to
    `target`, skipping values in `used` (and values over `max_bits` bits if
    given), walking outward from the aligned start in both directions.  The
    composite-scaling chain builder pins each prime group's product with it."""
    factor = 2 * ntt_size
    base = (int(round(target)) // factor) * factor + 1
    used = set(used)
    out: list[int] = []
    for step in range(0, 1 << 22):
        for sign in ((1,) if step == 0 else (1, -1)):
            cand = base + sign * step * factor
            if cand <= 2 or cand in used:
                continue
            if max_bits is not None and cand.bit_length() > max_bits:
                continue
            if is_prime(cand):
                out.append(cand)
                if len(out) >= count:
                    return out
    raise RuntimeError("failed to find enough qualifying primes near target")


def nearest_prime(ntt_size: int, target: float, used=(),
                  max_bits: int | None = None) -> int:
    return nearest_primes(ntt_size, target, used, 1, max_bits)[0]


def is_primitive_root(root: int, degree: int, modulus: int) -> bool:
    """degree is a power of two; root is a primitive degree-th root of unity
    iff root^(degree/2) == -1 (mod modulus)."""
    if root == 0:
        return False
    return pow(root, degree >> 1, modulus) == modulus - 1


@lru_cache(maxsize=None)
def minimal_primitive_root(degree: int, modulus: int) -> int:
    """Smallest primitive degree-th root of unity mod `modulus`: find one
    root as g^((modulus-1)/degree), then minimize over its odd powers."""
    group_size = modulus - 1
    if group_size % degree != 0:
        raise ValueError("no primitive root of requested degree exists")
    quotient = group_size // degree
    root = None
    for g in range(2, modulus):
        cand = pow(g, quotient, modulus)
        if is_primitive_root(cand, degree, modulus):
            root = cand
            break
    if root is None:
        raise ValueError("failed to find primitive root")
    best = root
    gen_sq = (root * root) % modulus
    current = root
    for _ in range(degree // 2):
        if current < best:
            best = current
        current = (current * gen_sq) % modulus
    return best


def gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


def naf(value: int) -> list[int]:
    """Non-adjacent form of a (possibly negative) integer: signed powers of
    two, no two adjacent, whose sum is `value` (tpu_fhe/core/numth.py:227).
    A rotation by a step with no key composes its parts' rotations."""
    out = []
    sign = -1 if value < 0 else 1
    v = abs(value)
    i = 0
    while v:
        if v & 1:
            z = 2 - (v % 4)
            out.append(sign * z * (1 << i))
            v -= z
        v >>= 1
        i += 1
    return out
