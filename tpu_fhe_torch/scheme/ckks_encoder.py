"""CKKS encoder: canonical embedding over the 5^j rotation group.

Port of the default host path of ``tpu_fhe/scheme/ckks_encoder.py``: the
complex transform runs on the host in float64 through an FFT of size 2N;
the rounded coefficients are RNS-decomposed on the host and the forward
NTT runs on the context's device.  Plaintexts are in the context's word:
int32 on a q32 context (the reference's compact plaintexts,
``tpu_fhe/scheme/ckks_encoder.py:198-203``), int64 otherwise.  Decode is the inverse chain, with the
CRT composition in exact Python integers (seconds at N = 2^15 and 30 limbs).
Sparse packing (slots < N/2) replicates the slot vector across the full
slot set.
"""

from __future__ import annotations

import numpy as np

from ..core.rns import RNSBase
from ..ops.modarith import u32_tensor, u64_tensor
from ..ops.ntt import forward_ntt, inverse_ntt
from .ciphertext import Plaintext
from .context import FheContext


class CkksEncoder:
    def __init__(self, context: FheContext):
        self.context = context
        self.n = context.n
        self.slots = self.n // 2
        two_n = 2 * self.n
        # rotation-group exponents: e_j = 5^j mod 2N for j in [0, N/2)
        e = np.empty(self.slots, dtype=np.int64)
        cur = 1
        for j in range(self.slots):
            e[j] = cur
            cur = (cur * 5) % two_n
        self.rot_group = e

    def _embed_inverse(self, values: np.ndarray) -> np.ndarray:
        """slots (complex, len N/2) -> real coefficient vector (len N):
        m_t = (2/N) Re(sum_j z_j zeta^{-e_j t}), one FFT of size 2N."""
        n, two_n = self.n, 2 * self.n
        spec = np.zeros(two_n, dtype=np.complex128)
        np.add.at(spec, self.rot_group % two_n, values)
        return (2.0 / n) * np.fft.fft(spec)[:n].real

    def _embed_forward(self, coeffs: np.ndarray) -> np.ndarray:
        """real coefficients (len N) -> slot values (complex, len N/2)."""
        two_n = 2 * self.n
        padded = np.zeros(two_n, dtype=np.complex128)
        padded[: self.n] = coeffs
        evals = np.fft.ifft(padded) * two_n
        return evals[self.rot_group % two_n]

    def encode(self, values, scale: float, chain_index: int = 1,
               slots: int | None = None) -> Plaintext:
        """Encode complex/real values (len <= N/2) at the given scale/level."""
        level = self.context.level(chain_index)
        values = np.asarray(values, dtype=np.complex128).ravel()
        slots = slots if slots is not None else len(values)
        if len(values) < slots:
            values = np.pad(values, (0, slots - len(values)))
        if slots & (slots - 1):
            raise ValueError("slot count must be a power of two")
        if slots > self.slots:
            raise ValueError("too many values for ring degree")
        reps = self.slots // max(slots, 1)
        coeffs = self._embed_inverse(np.tile(values, reps)) * scale
        amax = float(np.max(np.abs(coeffs))) if coeffs.size else 0.0
        if int(amax).bit_length() + 2 >= level.base.big_modulus.bit_length():
            raise ValueError("encoded values are too large for the modulus")
        word = u32_tensor if self.context.is_q32 else u64_tensor
        data = word(_round_decompose(coeffs, level.base), self.context.device)
        return Plaintext(data=forward_ntt(data, level.ntt), chain_index=chain_index,
                         scale=scale)

    def decode(self, pt: Plaintext, slots: int | None = None) -> np.ndarray:
        level = self.context.level(pt.chain_index)
        data = pt.data.contiguous()
        if pt.is_ntt_form:
            data = inverse_ntt(data, level.ntt)
        residues = data.cpu().numpy().astype(np.int64).view(np.uint64)
        coeffs = _compose_signed(residues, level.base)
        vals = self._embed_forward(np.asarray(coeffs, dtype=np.float64) / pt.scale)
        return vals if slots is None else vals[:slots]


def _round_decompose(coeffs: np.ndarray, base: RNSBase) -> np.ndarray:
    """round(float64 coeffs) -> (L, N) uint64 residue planes.  A float64's
    integer value is exact, so for |c| < 2^62 the round lands exactly in
    int64; larger coefficients take exact Python integers."""
    amax = float(np.max(np.abs(coeffs))) if coeffs.size else 0.0
    out = np.empty((len(base), len(coeffs)), dtype=np.uint64)
    if amax < float(1 << 62):
        ri = np.rint(coeffs).astype(np.int64)
        for i, q in enumerate(base.values):
            out[i] = (ri % np.int64(q)).astype(np.uint64)
        return out
    rounded = np.array([int(round(float(c))) for c in coeffs], dtype=object)
    for i, q in enumerate(base.values):
        out[i] = (rounded % q).astype(np.uint64)
    return out


def _compose_signed(residues: np.ndarray, base: RNSBase) -> list[int]:
    """(L, N) residues -> centered big ints (Python integers)."""
    big_q = base.big_modulus
    half = big_q // 2
    acc = np.zeros(residues.shape[1], dtype=object)
    for i in range(len(base)):
        mult = (base.q_hat_inv_mod_q[i] * base.punctured_products[i]) % big_q
        acc = (acc + residues[i].astype(object) * mult) % big_q
    return [int(v) - big_q if v > half else int(v) for v in acc]
