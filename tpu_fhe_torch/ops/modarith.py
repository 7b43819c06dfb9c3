"""Modular arithmetic on u64 residues held in ``torch.int64`` tensors.

Port of the u64 operations of ``tpu_fhe/ops/modmath.py`` and
``tpu_fhe/ops/w64.py`` (``mul_mod`` w64.py:377, ``barrett_reduce_u64``
:369, ``barrett_reduce_u128`` :357, ``shoup_of`` :417) in plain torch.

Representation: a tensor of dtype int64 holds the bit pattern of a uint64.
Residues and moduli (q < 2^61) and Harvey-lazy values (< 4q < 2^63) are
non-negative there; Shoup words floor(w * 2^64 / q) and Barrett ratio words
may use all 64 bits and then read as negative int64.  torch has no CPU
uint64 arithmetic, and signed overflow is not relied on: wide products are
built from 31-bit digits, so every partial product is below 2^62 and every
column sum below 2^63.  Results of reductions are computed modulo 2^62,
which is exact whenever the true value lies in [0, 2q) with q < 2^61.

These functions are the plain versions the CUDA kernels are held against;
the kernels use native ``uint64_t`` and ``__umul64hi`` on the same memory.
Moduli and constants broadcast against the data (typically (L, 1) against
(..., L, N)).  Functions ending in ``_lazy`` return values in [0, 2q);
the others return canonical values in [0, q).

The q32 regime (every modulus < 2^30, ``tpu_fhe/ops/u32pair.py`` and
``w64.py:383-454``) keeps residues in ``torch.int32`` tensors: residues are
non-negative there, while Shoup32 words floor(w * 2^32 / q) use all 32 bits
and read as negative int32.  Its helpers compute in int64, where a product
of a residue and a 32-bit word fits: ``mul_mod_q32`` is the reference's
single-word formula, ``mul_mod_shoup32`` and ``shoup32_of`` exact.
``csub``, ``add_mod``, ``sub_mod`` and ``neg_mod`` serve both word sizes.
"""

from __future__ import annotations

import numpy as np
import torch

M31 = (1 << 31) - 1
M32 = (1 << 32) - 1
M62 = (1 << 62) - 1
SIGN = -(1 << 63)  # int64 pattern of 2^63


def u64_tensor(vals, device) -> torch.Tensor:
    """uint64 values (array or list of ints) -> int64 tensor of the same bits."""
    arr = np.ascontiguousarray(np.asarray(vals, dtype=np.uint64))
    return torch.from_numpy(arr.view(np.int64).copy()).to(device)


def _digits(x: torch.Tensor, nd: int = 3) -> list[torch.Tensor]:
    """The low `nd` base-2^31 digits of the u64 bit pattern x (nd <= 3)."""
    out = [x & M31, (x >> 31) & M31, (x >> 62) & 3]
    return out[:nd]


def _digits128(hi: torch.Tensor, lo: torch.Tensor) -> list[torch.Tensor]:
    """Base-2^31 digits of the 128-bit value hi*2^64 + lo (u64 patterns)."""
    return [
        lo & M31,
        (lo >> 31) & M31,
        ((lo >> 62) & 3) | ((hi & ((1 << 29) - 1)) << 2),
        (hi >> 29) & M31,
        (hi >> 60) & 15,
    ]


def _dmul(a: list, b: list) -> list:
    """Exact product of two digit vectors, normalized to 31-bit digits."""
    cols: list = [0] * (len(a) + len(b))
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            p = x * y                               # < 2^62
            cols[i + j] = cols[i + j] + (p & M31)
            cols[i + j + 1] = cols[i + j + 1] + (p >> 31)
    out = []
    carry = 0
    for c in cols:                                  # each column < 2^36
        c = c + carry
        out.append(c & M31)
        carry = c >> 31
    return out


def _extract(d: list, s: int) -> torch.Tensor:
    """Bits [s, s + 64) of a digit vector, as a u64 pattern."""
    acc = None
    for i, x in enumerate(d):
        lo = 31 * i
        if lo + 31 <= s or lo >= s + 64 or not isinstance(x, torch.Tensor):
            continue
        term = x << (lo - s) if lo >= s else x >> (s - lo)
        acc = term if acc is None else acc | term
    return acc


def _mullo62(a, b):
    """(a * b) mod 2^62 for non-negative int64 a, b (< 2^63)."""
    a0, b0 = a & M31, b & M31
    a1, b1 = (a >> 31) & M31, (b >> 31) & M31
    mid = ((a0 * b1) & M31) + ((a1 * b0) & M31)     # < 2^32
    return (a0 * b0 + ((mid & M31) << 31)) & M62


def _inc(x):
    """x + 1 on u64 patterns below 2^64 - 1, without signed overflow."""
    return ((x ^ SIGN) + 1) ^ SIGN


def mulhi(a, b):
    """High 64 bits of the 64x64 product."""
    return _extract(_dmul(_digits(a), _digits(b)), 64)


def csub(a, q):
    """Conditional subtract: [0, 2q) -> [0, q)."""
    return torch.where(a >= q, a - q, a)


def add_mod(a, b, q):
    return csub(a + b, q)


def sub_mod(a, b, q):
    return csub(a + q - b, q)


def neg_mod(a, q):
    return torch.where(a == 0, a, q - a)


def mul_mod_shoup_lazy(a, w, w_shoup, q):
    """a*w mod q in [0, 2q), with w_shoup = floor(w * 2^64 / q) and any
    0 <= a < 2^63."""
    hi = mulhi(a, w_shoup)
    return (_mullo62(a, w) - _mullo62(hi, q)) & M62


def mul_mod_shoup(a, w, w_shoup, q):
    return csub(mul_mod_shoup_lazy(a, w, w_shoup, q), q)


def _barrett_digits(x: list, x_lo62, q, ratio_lo, ratio_hi):
    """x mod q for a digit vector x < 2^128: quotient estimate
    floor(x * floor(2^128/q) / 2^128) is floor(x/q) or one less, so the
    remainder estimate is in [0, 2q) and one conditional subtract lands it."""
    est = _extract(_dmul(x, _digits128(ratio_hi, ratio_lo)), 128) & M62
    return csub((x_lo62 - _mullo62(est, q)) & M62, q)


def barrett_reduce_u128(x_hi, x_lo, q, ratio_lo, ratio_hi):
    """Reduce the 128-bit (hi, lo) value mod q (q < 2^61) with the two-word
    Barrett ratio floor(2^128/q) = ratio_hi:ratio_lo."""
    return _barrett_digits(_digits128(x_hi, x_lo), x_lo & M62, q, ratio_lo, ratio_hi)


def barrett_reduce_u64(x, q, ratio_hi):
    """Reduce a 64-bit value mod q using ratio_hi = floor(2^128/q) >> 64."""
    tmp = mulhi(x, ratio_hi) & M62
    return csub(((x & M62) - _mullo62(tmp, q)) & M62, q)


def mul_mod(a, b, q, ratio_lo, ratio_hi):
    """a*b mod q for canonical a, b (< q < 2^61): full product + Barrett."""
    x = _dmul(_digits(a, 2), _digits(b, 2))
    return _barrett_digits(x, _mullo62(a, b), q, ratio_lo, ratio_hi)


def shoup_of(w, q, ratio_lo, ratio_hi):
    """Exact floor(w * 2^64 / q) for 0 <= w < q: e = floor(w*r / 2^64) with
    r = floor(2^128/q) is the true word or one less; the remainder
    w*2^64 - e*q (in [0, 2q), computed mod 2^62) decides which."""
    e = _extract(_dmul(_digits(w, 2), _digits128(ratio_hi, ratio_lo)), 64)
    rem = (-_mullo62(e & M62, q)) & M62
    return torch.where(rem >= q, _inc(e), e)


# --------------------------------------------------------------------------
# q32 regime: single-word residues in int32 tensors
# --------------------------------------------------------------------------

def u32_tensor(vals, device) -> torch.Tensor:
    """uint32 values (array or list of ints < 2^32) -> int32 tensor of the
    same bits."""
    arr = np.ascontiguousarray(np.asarray(vals, dtype=np.uint64).astype(np.uint32))
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def i32_of_u32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor of the same 32 bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def u32_of_i32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned values as int64."""
    return x.to(torch.int64) & M32


def q32_mul_consts(q_vals) -> np.ndarray:
    """Single-word reduction constants per modulus q < 2^30, a (5, k)
    uint64 array: floor(2^32/q), 2^32 mod q and its Shoup32 word, 2^64 mod q
    and its Shoup32 word.  The first three are ``w64.q32_mul_consts``'s (the
    multiply's fold of a 64-bit product); the 2^64 pair folds the third
    word of base conversion's 96-bit sums (bconv_mxu_pallas.py:235-240)."""
    q = [int(v) for v in np.asarray(q_vals, dtype=np.uint64).reshape(-1)]
    c32 = [(1 << 32) % v for v in q]
    c64 = [(1 << 64) % v for v in q]
    return np.array([[(1 << 32) // v for v in q],
                     c32, [(c << 32) // v for c, v in zip(c32, q)],
                     c64, [(c << 32) // v for c, v in zip(c64, q)]], dtype=np.uint64)


def mul_mod_q32(a, b, q, consts):
    """a*b mod q for canonical int32 residues, q < 2^30 (int32, broadcast
    like the data) and consts = q32_mul_consts as int64 (5, ..., 1): the
    product's low word folds by plain Barrett, its high word by a Shoup32
    multiply with 2^32 mod q (w64.py:399-414).  Returns canonical int32."""
    p = a.to(torch.int64) * b.to(torch.int64)              # < 2^60
    lo, hi = p & M32, p >> 32
    s0 = lo - ((lo * consts[0]) >> 32) * q                 # [0, 2q)
    s1 = hi * consts[1] - ((hi * consts[2]) >> 32) * q     # [0, 2q)
    return csub(csub(s0 + s1, 2 * q), q).to(torch.int32)


def mul_mod_shoup32(a, w, ws, q):
    """a*w mod q in [0, q) (int32) for int32 0 <= a < 2^31, w < q < 2^30
    and ws = floor(w * 2^32 / q) as an int32 bit pattern: the Shoup
    remainder a*w - floor(a*ws / 2^32)*q lies in [0, 2q)
    (u32pair.py:143-152); a*ws < 2^63 keeps it exact in int64."""
    a = a.to(torch.int64)
    r = a * w - ((a * u32_of_i32(ws)) >> 32) * q
    return csub(r, q).to(torch.int32)


def shoup32_of(w, q):
    """Exact floor(w * 2^32 / q) as int32 bit patterns, for int32 residues
    w < q < 2^30 (q int32, broadcast like w).  The reference estimates it
    from the 96-bit ratio floor(2^96/q) and corrects (w64.py:435-454); here
    w * 2^32 < 2^62 and int64 floor division is exact."""
    return i32_of_u32(torch.div(w.to(torch.int64) << 32, q, rounding_mode="floor"))


def mul_shoup(a, w, ws, q):
    """Canonical a*w mod q with w's Shoup word in the residues' word:
    ``mul_mod_shoup32`` on int32 residues, ``mul_mod_shoup`` on int64."""
    if a.dtype == torch.int32:
        return mul_mod_shoup32(a, w, ws, q)
    return mul_mod_shoup(a, w, ws, q)
