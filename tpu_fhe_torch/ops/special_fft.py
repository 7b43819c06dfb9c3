"""CKKS "special FFT" over the 5^j rotation group, on the context's device.

Port of ``tpu_fhe/ops/special_fft.py``'s ``DeviceEmbedding``: the same
rotation group, bit-reversal permutation, per-stage twiddle rows,
Cooley-Tukey forward and Gentleman-Sande inverse with the exact 1/n scale,
stage for stage.  For n slots (ring degree N = 2n, M = 4n):

  inverse (encode direction), slots w -> packed coefficients:
    for length = n, n/2, ..., 2, over blocks of `length`:
        u = a[i + j] + a[i + j + length/2]
        v = (a[i + j] - a[i + j + length/2]) * ksi[(4 length - 5^j mod 4 length) M / (4 length)]
    bit-reverse, scale by 1/n (exact: n is a power of two)
    coefficients = [Re(a); Im(a)]  (length 2n = N)

  forward (decode direction): bit-reverse, then for length = 2, 4, ..., n
  the Cooley-Tukey butterflies with ksi[(5^j mod 4 length) M / (4 length)].

The reference carries every value as a double-double of float32 because
the TPU has no fast float64; the H100 has native float64, so this port
computes in complex128 torch ops.  The double-double helpers
(``to_dd``/``from_dd``, ``embed_inverse_dd``/``embed_forward_dd``), the
ahead-of-time compile with XLA's fusion pass disabled (``_compiled``) and
its fallback self-check (``_check_fallback_accuracy``) exist only for
XLA's producer duplication, which breaks error-free double-double
arithmetic; torch runs each op once, so none of them is ported.

This is glue, not a kernel: the reference computes it in plain XLA outside
any ``pl.pallas_call``.  Each stage is a reshape to (..., n / length,
length) and a few elementwise launches over the whole batch, so leading
batch axes go through in one pass.
"""

from __future__ import annotations

import numpy as np
import torch


def _bit_reverse_perm(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


class DeviceEmbedding:
    """The special FFT of one slot count ``n`` (ring degree 2n) on
    ``device``: twiddle rows built once on the host in float64 and moved to
    the device once; both transforms take (..., n) / (..., 2n) torch
    tensors (numpy arrays are accepted) and return tensors on the device."""

    def __init__(self, n: int, device):
        if n & (n - 1) or n < 2:
            raise ValueError("slot count must be a power of two >= 2")
        self.n = n
        self.device = torch.device(device)
        m = 4 * n  # = 2N
        rot = np.empty(n, dtype=np.int64)
        cur = 1
        for j in range(n):
            rot[j] = cur
            cur = (cur * 5) % m
        self._perm = torch.from_numpy(_bit_reverse_perm(n)).to(self.device)
        fwd, inv = [], []
        length = 2
        while length <= n:
            lenh, lenq = length >> 1, length << 2
            idx_f = (rot[:lenh] % lenq) * (m // lenq) % m
            idx_i = (lenq - (rot[:lenh] % lenq)) * (m // lenq) % m
            ang = 2.0 * np.pi / m
            fwd.append(torch.from_numpy(np.exp(1j * ang * idx_f)).to(self.device))
            inv.append(torch.from_numpy(np.exp(1j * ang * idx_i)).to(self.device))
            length <<= 1
        self._tw_fwd = fwd   # index s: stage length = 2^(s+1)
        self._tw_inv = inv

    def _tensor(self, x, dtype) -> torch.Tensor:
        x = torch.as_tensor(x)
        return x.to(device=self.device, dtype=dtype)

    def embed_inverse(self, values) -> torch.Tensor:
        """complex slots (..., n) -> real coefficients (..., 2n) float64:
        [Re(w); Im(w)] with w = specialIFFT(values), the full-pack
        canonical embedding of the encoder's host path."""
        n = self.n
        x = self._tensor(values, torch.complex128)
        lead = x.shape[:-1]
        length = n
        while length >= 2:
            lenh = length >> 1
            x = x.reshape(lead + (n // length, length))
            u, v = x[..., :lenh], x[..., lenh:]
            x = torch.cat([u + v, (u - v) * self._tw_inv[length.bit_length() - 2]], dim=-1)
            length >>= 1
        x = x.reshape(lead + (n,))[..., self._perm]
        return torch.cat([x.real, x.imag], dim=-1) * (1.0 / n)

    def embed_forward(self, coeffs) -> torch.Tensor:
        """real coefficients (..., 2n) -> complex slots (..., n) complex128."""
        n = self.n
        c = self._tensor(coeffs, torch.float64)
        x = torch.complex(c[..., :n], c[..., n:])[..., self._perm]
        lead = x.shape[:-1]
        length, s = 2, 0
        while length <= n:
            lenh = length >> 1
            x = x.reshape(lead + (n // length, length))
            u, vt = x[..., :lenh], x[..., lenh:] * self._tw_fwd[s]
            x = torch.cat([u + vt, u - vt], dim=-1)
            length <<= 1
            s += 1
        return x.reshape(lead + (n,))
