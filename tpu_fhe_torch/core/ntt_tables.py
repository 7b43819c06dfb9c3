"""Host-side NTT twiddle tables and an exact golden negacyclic NTT.

The port's own copy of ``tpu_fhe/core/ntt_tables.py``: powers of the minimal
primitive 2N-th root psi stored in bit-reversed order (SEAL layout), with
Shoup companions floor(w * 2^64 / q), plus n^{-1} mod q.  The powers are
built by doubling over numpy object arrays instead of the reference's
ctypes runtime.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from . import numth
from .modulus import Modulus


def compute_shoup(operand: int, modulus: int) -> int:
    """floor(operand * 2^64 / modulus) — Shoup precomputation word."""
    return (operand << 64) // modulus


def shoup_np(vals: np.ndarray, q: int) -> np.ndarray:
    """Vectorized exact floor(w * 2^64 / q) as uint64."""
    obj = (np.asarray(vals, dtype=np.uint64).astype(object) << 64) // int(q)
    return obj.astype(np.uint64)


@dataclass(frozen=True)
class NTTTables:
    """Twiddle tables for one prime.

    root_powers[reverse_bits(i, logn)] = psi^i; inv_root_powers likewise for
    psi^{-1}; both uint64 arrays of length n.  n^{-1} is applied by the
    inverse transform as a separate multiply.
    """

    modulus: Modulus
    log_n: int
    root: int
    inv_root: int
    root_powers: np.ndarray
    inv_root_powers: np.ndarray
    inv_degree: int

    @property
    def n(self) -> int:
        return 1 << self.log_n


def _powers_bitrev(base: int, q: int, log_n: int) -> np.ndarray:
    n = 1 << log_n
    pw = np.empty(n, dtype=object)
    pw[0] = 1
    k, step = 1, base % q
    while k < n:
        pw[k:2 * k] = (pw[:k] * step) % q
        step = (step * step) % q
        k <<= 1
    out = np.empty(n, dtype=np.uint64)
    out[numth.bit_reverse_perm(log_n)] = pw.astype(np.uint64)
    return out


@lru_cache(maxsize=None)
def make_ntt_tables(log_n: int, modulus_value: int) -> NTTTables:
    n = 1 << log_n
    q = modulus_value
    psi = numth.minimal_primitive_root(2 * n, q)
    psi_inv = numth.invert_mod(psi, q)
    return NTTTables(
        modulus=Modulus(q),
        log_n=log_n,
        root=psi,
        inv_root=psi_inv,
        root_powers=_powers_bitrev(psi, q, log_n),
        inv_root_powers=_powers_bitrev(psi_inv, q, log_n),
        inv_degree=numth.invert_mod(n, q),
    )


def golden_forward_ntt(coeffs: list[int], tables: NTTTables) -> list[int]:
    """Exact Harvey-style forward negacyclic NTT (decimation in time).

    Index i of the output holds the evaluation of the input polynomial at
    psi^(2*reverse_bits(i, logn) + 1)."""
    q = tables.modulus.value
    n = tables.n
    x = [int(v) for v in coeffs]
    roots = tables.root_powers
    t = n
    m = 1
    while m < n:
        t >>= 1
        for i in range(m):
            w = int(roots[m + i])
            j1 = 2 * i * t
            for j in range(j1, j1 + t):
                u = x[j]
                v = (x[j + t] * w) % q
                x[j] = (u + v) % q
                x[j + t] = (u - v) % q
        m <<= 1
    return x
