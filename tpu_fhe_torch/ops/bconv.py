"""RNS fast base conversion (BEHZ), port of ``tpu_fhe/ops/bconv.py::bconv_matmul``.

    y[..., j, n] = (sum_i s[..., i, n] * qhat_mod_p[j, i]) mod p_j

with s[i] = [x_i * qhat_i^{-1}]_{q_i} already applied by the caller.  The
result keeps the BEHZ alpha*Q overshoot exactly, as the reference does.
The CUDA kernel (``csrc/bconv.cu``) accumulates 128-bit products in chunks
of 63 terms (the reference's ``_ACC_CHUNK``: terms are < 2^122, so 63 fit)
with one Barrett landing per chunk; the plain version reduces each product
and sums mod p, which is the same function.

``bconv_matmul32`` is the q32 form (port of
``tpu_fhe/ops/bconv_mxu_pallas.py::bconv_matmul_mxu_pallas32``, K13): int32
residues, tables and moduli below 2^30, one exact 96-bit row sum per output
coefficient (``csrc/bconv.cu`` tfhe_bconv32); its plain version sums
canonical int64 products mod p.
"""

from __future__ import annotations

import torch

from . import modarith as ma
from ._build import INT, PTR, CudaKernel, ptr

BCONV = CudaKernel(
    "bconv", "bconv.cu", "tfhe_bconv", [PTR] * 6 + [INT] * 4,
    "tpu_fhe/ops/bconv_pallas.py:39 _kernel (K11); "
    "tpu_fhe/ops/bconv_mxu_pallas.py:82 _kernel (K12)")
BCONV32 = CudaKernel(
    "bconv32", "bconv.cu", "tfhe_bconv32", [PTR] * 5 + [INT] * 4,
    "tpu_fhe/ops/bconv_mxu_pallas.py:179 _kernel32 (K13)")


def bconv_matmul_plain(scaled, qhat_mod_p, p, p_ratio_lo, p_ratio_hi) -> torch.Tensor:
    m, k = qhat_mod_p.shape
    p, rlo, rhi = (v.reshape(m, 1) for v in (p, p_ratio_lo, p_ratio_hi))
    out = None
    for i in range(k):
        term = ma.mul_mod(scaled[..., i:i + 1, :], qhat_mod_p[:, i:i + 1], p, rlo, rhi)
        out = term if out is None else ma.add_mod(out, term, p)
    return out


def bconv_matmul(scaled: torch.Tensor, qhat_mod_p: torch.Tensor, p: torch.Tensor,
                 p_ratio_lo: torch.Tensor, p_ratio_hi: torch.Tensor) -> torch.Tensor:
    """scaled (..., k, N) canonical residues of the input base; qhat_mod_p
    (m, k) table [p_j][q_i]; p and its Barrett words (m, 1).  Returns
    (..., m, N) residues of the output base."""
    m, k = qhat_mod_p.shape
    if scaled.dtype != torch.int64 or scaled.dim() < 2 or scaled.shape[-2] != k:
        raise ValueError(f"bconv_matmul: expected (..., {k}, N) int64, got "
                         f"{tuple(scaled.shape)} {scaled.dtype}")
    if not scaled.is_contiguous():
        raise ValueError("bconv_matmul: input must be contiguous")
    consts = [c.reshape(-1).contiguous() for c in (qhat_mod_p, p, p_ratio_lo, p_ratio_hi)]
    if any(c.device != scaled.device or c.dtype != torch.int64 for c in consts):
        raise ValueError("bconv_matmul: tables must be int64 on the data's device")
    if scaled.is_cuda:
        n = scaled.shape[-1]
        batch = scaled.numel() // (k * n)
        if batch > 65535 or m > 65535:
            raise ValueError("bconv_matmul: batch and output base must be <= 65535")
        out = torch.empty(scaled.shape[:-2] + (m, n), dtype=torch.int64,
                          device=scaled.device)
        BCONV(ptr(scaled), ptr(out), *(ptr(c) for c in consts), batch, k, m, n)
        return out
    if scaled.device.type != "cpu":
        raise ValueError(f"bconv_matmul: unsupported device {scaled.device}")
    return bconv_matmul_plain(scaled, qhat_mod_p, p, p_ratio_lo, p_ratio_hi)


def bconv_matmul32_plain(scaled, qhat_mod_p, p, fold=None) -> torch.Tensor:
    """K13's function in int64: each product is below 2^60, and the running
    sum is reduced mod p after every term.  Takes bconv_matmul32's
    arguments; `fold` is not needed here."""
    m, k = qhat_mod_p.shape
    p64 = p.reshape(m, 1).to(torch.int64)
    tab = qhat_mod_p.to(torch.int64)
    out = None
    for i in range(k):
        term = scaled[..., i:i + 1, :].to(torch.int64) * tab[:, i:i + 1]
        out = torch.remainder(term if out is None else out + term, p64)
    return out.to(torch.int32)


def bconv_matmul32(scaled: torch.Tensor, qhat_mod_p: torch.Tensor, p: torch.Tensor,
                   fold: torch.Tensor) -> torch.Tensor:
    """q32 base conversion: scaled (..., k, N) int32 residues of the input
    base; qhat_mod_p (m, k) int32 table [p_j][q_i]; p (m, 1) int32 output
    moduli (< 2^30); fold (5, m, 1) int64 constants of
    ``modarith.q32_mul_consts``.  Returns (..., m, N) int32, exact for any k."""
    m, k = qhat_mod_p.shape
    if scaled.dtype != torch.int32 or scaled.dim() < 2 or scaled.shape[-2] != k:
        raise ValueError(f"bconv_matmul32: expected (..., {k}, N) int32, got "
                         f"{tuple(scaled.shape)} {scaled.dtype}")
    if not scaled.is_contiguous():
        raise ValueError("bconv_matmul32: input must be contiguous")
    table, pv = qhat_mod_p.contiguous(), p.reshape(-1).contiguous()
    if any(c.device != scaled.device or c.dtype != torch.int32 for c in (table, pv)) \
            or pv.numel() != m or fold.shape != (5, m, 1) or fold.dtype != torch.int64 \
            or fold.device != scaled.device:
        raise ValueError("bconv_matmul32: table and moduli must be int32, fold (5, m, 1) "
                         "int64, all on the data's device")
    if scaled.is_cuda:
        n = scaled.shape[-1]
        batch = scaled.numel() // (k * n)
        if batch > 65535:
            raise ValueError("bconv_matmul32: batch must be <= 65535")
        out = torch.empty(scaled.shape[:-2] + (m, n), dtype=torch.int32, device=scaled.device)
        BCONV32(ptr(scaled), ptr(out), ptr(table), ptr(pv), ptr(fold.contiguous()), batch, k,
                m, n)
        return out
    if scaled.device.type != "cpu":
        raise ValueError(f"bconv_matmul32: unsupported device {scaled.device}")
    return bconv_matmul32_plain(scaled, qhat_mod_p, p)
