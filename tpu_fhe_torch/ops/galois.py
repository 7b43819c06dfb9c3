"""Galois automorphisms (slot rotations and conjugation).

Port of the gather path of ``tpu_fhe/ops/galois.py``.  The automorphism
sigma_g: f(x) -> f(x^g) acts on NTT-form data as a pure index permutation
along the last axis: the NTT order places f(psi^(2*br(i)+1)) at index i, so
the permutation solves e_j = e_i * g (mod 2N).  It is computed once on the
host per (N, g) and kept as an int64 tensor per (N, g, device); applying it
is one ``index_select`` (the reference's XLA gather; no Pallas kernel).
On coefficient-form data sigma_g sends x^i to +-x^(i*g mod N).

Rotation steps use the 5^step group: slot j of the CKKS encoder holds the
evaluation at zeta^(5^j), so sigma_(5^r) rotates slots left by r and
sigma_(2N-1) conjugates.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..core import numth
from . import modarith as mm


def galois_elt_from_step(step: int, n: int) -> int:
    """Automorphism element for a slot rotation by `step` (left if > 0)."""
    if step == 0:
        return 1
    return pow(5, step % (n // 2), 2 * n)


def conj_elt(n: int) -> int:
    return 2 * n - 1


@lru_cache(maxsize=None)
def _ntt_permutation(n: int, elt: int) -> np.ndarray:
    """perm with new[i] = old[perm[i]] for the NTT-form automorphism."""
    e = 2 * numth.bit_reverse_perm(n.bit_length() - 1) + 1
    pos_of_e = np.zeros(2 * n, dtype=np.int64)
    pos_of_e[e] = np.arange(n)
    return pos_of_e[(e * elt) % (2 * n)]


@lru_cache(maxsize=None)
def _coeff_permutation(n: int, elt: int) -> tuple[np.ndarray, np.ndarray]:
    """Coefficient-form automorphism x^i -> x^(i*elt mod 2n) with sign:
    (source index, negate mask) with new[j] = +-old[src[j]]."""
    i = np.arange(n, dtype=np.int64)
    j = (i * elt) % (2 * n)
    src = np.zeros(n, dtype=np.int64)
    neg = np.zeros(n, dtype=bool)
    src[j % n] = i
    neg[j % n] = j >= n
    return src, neg


@lru_cache(maxsize=None)
def _ntt_permutation_on(n: int, elt: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_ntt_permutation(n, elt)).to(device)


@lru_cache(maxsize=None)
def _coeff_permutation_on(n: int, elt: int, device: torch.device) -> tuple:
    return tuple(torch.from_numpy(a).to(device) for a in _coeff_permutation(n, elt))


def apply_galois_ntt(x: torch.Tensor, elt: int, n: int) -> torch.Tensor:
    """Apply sigma_elt to NTT-form data (..., N); returns a new tensor."""
    return x.index_select(x.dim() - 1, _ntt_permutation_on(n, elt, x.device))


def apply_galois_coeff(x: torch.Tensor, elt: int, n: int, q: torch.Tensor) -> torch.Tensor:
    """Apply sigma_elt to coefficient-form data (..., L, N); q is (L, 1)."""
    src, neg = _coeff_permutation_on(n, elt, x.device)
    gathered = x.index_select(x.dim() - 1, src)
    return torch.where(neg, mm.neg_mod(gathered, q), gathered)
