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
residues, tables and moduli below 2^30.  Its kernel (``csrc/bconv.cu``
tfhe_bconv32) forms the sum as the reference does, through balanced int8
digit planes on the tensor cores: 4 planes of each residue and of each
table entry, the s8 x s8 -> s32 product over the 7 byte diagonals (of whose
blocks the kernel runs the 16 nonzero ones), a 96-bit reassembly and one
word-fold landing.  The table's side of that product,
the digit matrix, is built once per table on the host
(``digit_matrix32``, kept beside the table by the context) in the order the
kernel's MMA fragments read it.  ``bconv_matmul32_plain`` sums canonical
int64 products mod p; ``bconv_matmul32_digits_plain`` repeats the kernel's
digit-plane arithmetic from the digit matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from . import modarith as ma
from ._build import INT, PTR, CudaKernel, ptr

BCONV = CudaKernel(
    "bconv", "bconv.cu", "tfhe_bconv", [PTR] * 6 + [INT] * 4,
    "tpu_fhe/ops/bconv_pallas.py:39 _kernel (K11); "
    "tpu_fhe/ops/bconv_mxu_pallas.py:82 _kernel (K12)")
BCONV32 = CudaKernel(
    "bconv32", "bconv.cu", "tfhe_bconv32", [PTR] * 5 + [INT] * 8,
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


# --------------------------------------------------------------------------
# the q32 form: balanced int8 digit planes (K13)
# --------------------------------------------------------------------------

N_PLANES = 8            # balanced base-256 digits of a value below 2^61
N_PLANES_32 = 4         # ... of a value below 2^30
N_DIAG_32 = 2 * N_PLANES_32 - 1
K_CHUNK = 512           # inputs per launch; longer sums add launches mod p


def balanced_digits(m) -> np.ndarray:
    """(...) uint64 values below 2^61 -> (8, ...) int8 balanced base-256
    digits d_i in [-128, 127], sum d_i 256^i = m (a copy of
    ``tpu_fhe/ops/bconv_mxu.py::_balanced_digits_host``)."""
    v = np.asarray(m, dtype=np.uint64)
    digits = np.empty((N_PLANES,) + v.shape, dtype=np.int8)
    carry = np.zeros(v.shape, dtype=np.int64)
    for i in range(N_PLANES):
        b = ((v >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(np.int64) + carry
        carry = (b >= 128).astype(np.int64)
        digits[i] = (b - (carry << 8)).astype(np.int8)
    if carry.any():
        raise ValueError("matrix entries must be < 2^61 for 8 balanced digits")
    return digits


def diag_matrix_jk32(table, m_pad: int) -> np.ndarray:
    """A[(s, j_pad), (plane, i)] = Tdig_{s - plane}[j, i] (int8), the
    reference's digit matrix over 4 planes and 7 diagonals (a copy of
    ``tpu_fhe/ops/bconv_mxu_pallas.py::_diag_matrix_jk32``); table (m, k)
    of values below 2^30, rows padded to m_pad."""
    t = np.asarray(table, dtype=np.uint64)
    m, k = t.shape
    tdig = balanced_digits(t)[:N_PLANES_32]          # planes 4..7 are zero
    a = np.zeros((N_DIAG_32, m_pad, N_PLANES_32, k), dtype=np.int8)
    for s in range(N_DIAG_32):
        for j in range(N_PLANES_32):
            i = s - j
            if 0 <= i < N_PLANES_32:
                a[s, :m, j, :] = tdig[i]
    return a.reshape(N_DIAG_32 * m_pad, N_PLANES_32 * k)


def digit_matrix32(table: torch.Tensor) -> torch.Tensor:
    """The kernel's digit matrix of a q32 table (m, k), on the table's
    device: int32 words (ceil(m/16), 4, ceil(k/32), 32, 4).

    Block (s, p) of ``diag_matrix_jk32`` (diagonal s, input plane p) is
    the table's digit plane s - p, or zero; the kernel keeps the 4 planes
    and runs only the 16 nonzero blocks.  Each plane is stored in the order
    of the mma.m16n8k32 s8 A operand: entry [t, a, c, lane, reg] is the
    word (4 consecutive inputs' digits) lane 4g + h holds in register reg
    for limbs 16t .. 16t + 15, plane a and K step c (inputs 32c .. 32c +
    31): limb row g (reg 0, 2) or g + 8 (reg 1, 3), inputs 32c + 4h (reg
    0, 1) or 32c + 16 + 4h (reg 2, 3).  Padding limbs and inputs are zero."""
    tab = ma.u32_of_i32(table.detach().cpu()).numpy().astype(np.uint64)
    m, k = tab.shape
    mg, kcs = -(-m // 16), -(-k // 32)
    diag = diag_matrix_jk32(tab, m).reshape(N_DIAG_32, m, N_PLANES_32, k)
    a = np.zeros((16 * mg, N_PLANES_32, 32 * kcs), dtype=np.int8)
    a[:m, :, :k] = diag[:N_PLANES_32, :, 0, :].transpose(1, 0, 2)   # block (s=a, p=0)
    words = a.view(np.int32).reshape(mg, 2, 8, N_PLANES_32, kcs, 2, 4)  # [t, rh, g, a, c, ch, h]
    frag = words.transpose(0, 3, 4, 2, 6, 5, 1).reshape(mg, N_PLANES_32, kcs, 32, 4)
    return torch.from_numpy(np.ascontiguousarray(frag)).to(table.device)


def _unfragment32(frag: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """digit_matrix32's words back to the table's int8 planes (4, m, k)."""
    mg, _, kcs = frag.shape[:3]
    words = frag.cpu().numpy().reshape(mg, N_PLANES_32, kcs, 8, 4, 2, 2)  # [t, a, c, g, h, ch, rh]
    a = words.transpose(0, 6, 3, 1, 2, 5, 4).reshape(16 * mg, N_PLANES_32, 8 * kcs)
    a = np.ascontiguousarray(a).view(np.int8)[:m, :, :k]
    return torch.from_numpy(a.transpose(1, 0, 2).copy())


def digit_planes32(x: torch.Tensor) -> torch.Tensor:
    """(...) residues below 2^30 -> (..., 4) int32 balanced digits: the
    bytes of x + 0x80808080 are the digits plus 128 (no byte carries out,
    since x < 2^30), the kernel's two-instruction extraction."""
    v = x.to(torch.int64) + 0x80808080
    return torch.stack([((v >> (8 * p)) & 0xFF) - 128 for p in range(N_PLANES_32)],
                       dim=-1).to(torch.int32)


def bconv_matmul32_digits_plain(scaled, qhat_mod_p, p, fold, diag) -> torch.Tensor:
    """K13's kernel arithmetic on the CPU, from the digit matrix `diag`
    (``digit_matrix32``): the s32 diagonal sums D_s[j] = sum over a + p = s
    and i of Tdig_a[j, i] * digit_p(s_i), then the 96-bit value
    sum_s D_s 2^(8s) formed as G0 + 2^32 G1 (diagonals 0-3 and 4-6),
    landed mod p_j with the fold rows' 2^32 and 2^64 residues.  Takes
    bconv_matmul32's arguments; `qhat_mod_p` gives the shape only."""
    m, k = qhat_mod_p.shape
    planes = _unfragment32(diag, m, k).to(torch.int32)          # (4, m, k)
    x = digit_planes32(scaled.cpu())                            # (..., k, N, 4)
    prod = None
    for i in range(k):
        # (4, m, 1, 1) * (..., 1, 1, N, 4): every plane pair (a, p)
        term = planes[:, :, i, None, None] * x[..., None, None, i, :, :]
        prod = term if prod is None else prod + term            # (..., 4, m, N, 4)
    d = [sum(prod[..., a, :, :, s - a] for a in range(max(0, s - 3), min(s, 3) + 1))
         .to(torch.int64) for s in range(N_DIAG_32)]
    g0 = sum(d[r] << (8 * r) for r in range(4))
    g1 = sum(d[4 + r] << (8 * r) for r in range(3))
    q = p.reshape(m, 1).cpu().to(torch.int64)
    c32, c64 = fold[1].cpu(), fold[3].cpu()                     # 2^32, 2^64 mod p
    # g0 + 2^32 g1 = w0 + 2^32 w1 + 2^64 w2 with unsigned words
    w0 = g0 & 0xFFFFFFFF
    hi = (g0 >> 32) + g1                                        # signed, exact
    w1, w2 = hi & 0xFFFFFFFF, hi >> 32
    if bool((w2 < 0).any()):
        raise AssertionError("a row sum came out negative")
    out = (torch.remainder(w0, q) + torch.remainder(w1, q) * c32 % q
           + torch.remainder(w2, q) * c64 % q) % q
    return out.to(torch.int32).to(scaled.device)


def bconv_matmul32_plain(scaled, qhat_mod_p, p, fold=None, diag=None) -> torch.Tensor:
    """K13's function in int64: each product is below 2^60, and the running
    sum is reduced mod p after every term.  Takes bconv_matmul32's
    arguments; `fold` and `diag` are not needed here."""
    m, k = qhat_mod_p.shape
    p64 = p.reshape(m, 1).to(torch.int64)
    tab = qhat_mod_p.to(torch.int64)
    out = None
    for i in range(k):
        term = scaled[..., i:i + 1, :].to(torch.int64) * tab[:, i:i + 1]
        out = torch.remainder(term if out is None else out + term, p64)
    return out.to(torch.int32)


def bconv_matmul32(scaled: torch.Tensor, qhat_mod_p: torch.Tensor, p: torch.Tensor,
                   fold: torch.Tensor, diag: torch.Tensor | None = None) -> torch.Tensor:
    """q32 base conversion: scaled (..., k, N) int32 residues of the input
    base; qhat_mod_p (m, k) int32 table [p_j][q_i]; p (m, 1) int32 output
    moduli (< 2^30); fold (5, m, 1) int64 constants of
    ``modarith.q32_mul_consts``; diag the table's ``digit_matrix32``
    (needed by the kernel, built once per table).  Returns (..., m, N)
    int32, exact for any k: the kernel sums K_CHUNK inputs per launch and
    adds each further chunk's sum mod p in its landing."""
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
        shape = (-(-m // 16), N_PLANES_32, -(-k // 32), 32, 4)
        if diag is None or diag.shape != shape or diag.dtype != torch.int32 \
                or diag.device != scaled.device or not diag.is_contiguous():
            raise ValueError(f"bconv_matmul32: the kernel needs the table's digit matrix "
                             f"{shape} int32 on the data's device (digit_matrix32)")
        n = scaled.shape[-1]
        batch = scaled.numel() // (k * n)
        if batch > 65535:
            raise ValueError("bconv_matmul32: batch must be <= 65535")
        out = torch.empty(scaled.shape[:-2] + (m, n), dtype=torch.int32, device=scaled.device)
        for k0 in range(0, k, K_CHUNK):
            BCONV32(ptr(scaled), ptr(out), ptr(diag), ptr(pv), ptr(fold.contiguous()), batch,
                    k, m, n, k0, min(K_CHUNK, k - k0), shape[2], int(k0 > 0))
        return out
    if scaled.device.type != "cpu":
        raise ValueError(f"bconv_matmul32: unsupported device {scaled.device}")
    return bconv_matmul32_plain(scaled, qhat_mod_p, p)
