"""RNS fast base conversion (BEHZ), port of ``tpu_fhe/ops/bconv.py::bconv_matmul``.

    y[..., j, n] = (sum_i s[..., i, n] * qhat_mod_p[j, i]) mod p_j

with s[i] = [x_i * qhat_i^{-1}]_{q_i} already applied by the caller.  The
result keeps the BEHZ alpha*Q overshoot exactly, as the reference does.

``bconv_matmul`` is the u64 form.  On the card it takes the reference's
rule (``tpu_fhe/ops/bconv.py:91-101``): for k < 64 inputs K12's form
(port of ``tpu_fhe/ops/bconv_mxu_pallas.py::bconv_matmul_mxu_pallas``,
kernel ``tfhe_bconv_mxu``), the sum through balanced int8 digit planes on
the tensor cores -- 8 planes of each residue and of each table entry, s8
x s8 -> s32 products into the 15 byte diagonals, a wrapping 128-bit
reassembly and one Barrett landing -- and for k >= 64 K11's kernel
(``tfhe_bconv``), which accumulates 128-bit products in chunks of 63
terms (the reference's ``_ACC_CHUNK``: terms are < 2^122, so 63 fit) with
one Barrett landing per chunk.  The plain version reduces each product
and sums mod p, which is the same function; ``bconv_matmul_digits_plain``
repeats K12's digit-plane arithmetic from the digit matrix.

``bconv_matmul32`` is the q32 form (port of
``tpu_fhe/ops/bconv_mxu_pallas.py::bconv_matmul_mxu_pallas32``, K13): int32
residues, tables and moduli below 2^30, through 4 digit planes of each
residue and table entry, the 7 byte diagonals (of whose blocks the kernel
runs the 16 nonzero ones), a 96-bit reassembly and one word-fold landing.
``bconv_matmul32_plain`` sums canonical int64 products mod p;
``bconv_matmul32_digits_plain`` repeats the kernel's arithmetic.

``bconv_behz``, ``bconv_hps``, ``frac_alpha`` and ``scale_and_round_hps``
are BFV's conversions (BEHZ's and HPS's, the latter with its fixed-point
rounding correction) built on ``bconv_matmul``; their glue is plain torch.

Both digit forms take the table's side of the product, its digit matrix,
built once per table on the host (``digit_matrix``, ``digit_matrix32``,
kept beside the table by the context) in the order the kernel's MMA
fragments read it; on a CUDA tensor they raise without it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import modarith as ma
from ._build import INT, PTR, CudaKernel, ptr

BCONV = CudaKernel(
    "bconv", "bconv.cu", "tfhe_bconv", [PTR] * 6 + [INT] * 4,
    "tpu_fhe/ops/bconv_pallas.py:39 _kernel (K11)")
BCONV_MXU = CudaKernel(
    "bconv_mxu", "bconv.cu", "tfhe_bconv_mxu", [PTR] * 6 + [INT] * 4,
    "tpu_fhe/ops/bconv_mxu_pallas.py:82 _kernel (K12)")
BCONV32 = CudaKernel(
    "bconv32", "bconv.cu", "tfhe_bconv32", [PTR] * 5 + [INT] * 8,
    "tpu_fhe/ops/bconv_mxu_pallas.py:179 _kernel32 (K13)")


N_PLANES = 8            # balanced base-256 digits of a value below 2^61
N_DIAG = 2 * N_PLANES - 1
N_LAGS = N_PLANES + 1   # K12's table fragments [plane d | plane d - 1], d = 0 .. 8
MXU_MAX_K = 63          # K12's 128-bit row sum is exact for k < 64 inputs


def bconv_matmul_plain(scaled, qhat_mod_p, p, p_ratio_lo, p_ratio_hi, diag=None) -> torch.Tensor:
    """The function, one reduced product at a time.  Takes bconv_matmul's
    arguments; `diag` is not needed here."""
    m, k = qhat_mod_p.shape
    p, rlo, rhi = (v.reshape(m, 1) for v in (p, p_ratio_lo, p_ratio_hi))
    out = None
    for i in range(k):
        term = ma.mul_mod(scaled[..., i:i + 1, :], qhat_mod_p[:, i:i + 1], p, rlo, rhi)
        out = term if out is None else ma.add_mod(out, term, p)
    return out


def bconv_matmul(scaled: torch.Tensor, qhat_mod_p: torch.Tensor, p: torch.Tensor,
                 p_ratio_lo: torch.Tensor, p_ratio_hi: torch.Tensor,
                 diag: torch.Tensor | None = None) -> torch.Tensor:
    """scaled (..., k, N) canonical residues of the input base; qhat_mod_p
    (m, k) table [p_j][q_i]; p and its Barrett words (m, 1); diag the
    table's ``digit_matrix`` (needed by K12's kernel, k < 64; built once
    per table).  Returns (..., m, N) residues of the output base."""
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
        if k > MXU_MAX_K:
            BCONV(ptr(scaled), ptr(out), *(ptr(c) for c in consts), batch, k, m, n)
            return out
        shape = digit_matrix_shape(m, k)
        if diag is None or diag.shape != shape or diag.dtype != torch.int32 \
                or diag.device != scaled.device or not diag.is_contiguous():
            raise ValueError(f"bconv_matmul: K12's kernel needs the table's digit matrix "
                             f"{shape} int32 on the data's device (digit_matrix)")
        BCONV_MXU(ptr(scaled), ptr(out), ptr(diag), *(ptr(c) for c in consts[1:]),
                  batch, k, m, n)
        return out
    if scaled.device.type != "cpu":
        raise ValueError(f"bconv_matmul: unsupported device {scaled.device}")
    return bconv_matmul_plain(scaled, qhat_mod_p, p, p_ratio_lo, p_ratio_hi)


# --------------------------------------------------------------------------
# the digit-plane form of u64 residues (K12)
# --------------------------------------------------------------------------

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


def diag_matrix_jk(table, m_pad: int, planes: int = N_PLANES) -> np.ndarray:
    """A[(s, j_pad), (plane, i)] = Tdig_{s - plane}[j, i] (int8) over
    `planes` digit planes and 2 planes - 1 diagonals: the reference's digit
    matrix (a copy of ``tpu_fhe/ops/bconv_mxu_pallas.py::_diag_matrix_jk``,
    and with 4 planes of ``_diag_matrix_jk32``); table (m, k) of values
    below 2^61 (2^30 for 4 planes), rows padded to m_pad."""
    t = np.asarray(table, dtype=np.uint64)
    m, k = t.shape
    n_diag = 2 * planes - 1
    tdig = balanced_digits(t)[:planes]
    a = np.zeros((n_diag, m_pad, planes, k), dtype=np.int8)
    for s in range(n_diag):
        for j in range(planes):
            i = s - j
            if 0 <= i < planes:
                a[s, :m, j, :] = tdig[i]
    return a.reshape(n_diag * m_pad, planes * k)


def digit_matrix_shape(m: int, k: int) -> tuple:
    return (-(-m // 16), N_LAGS, -(-k // 16), 32, 4)


def digit_matrix(table: torch.Tensor) -> torch.Tensor:
    """K12's digit matrix of a u64 table (m, k) of values below 2^61, on
    the table's device: int32 words (ceil(m/16), 9, ceil(k/16), 32, 4).

    A K step of the kernel's MMA takes 16 inputs in two input digit planes
    (K = 32: planes 2e and 2e + 1), so its table fragment for lag d is
    A_d = [plane d | plane d - 1] of the table's balanced digits (planes
    -1 and 8 are zero), and A_d times input pair e is the diagonal
    d + 2e.  Entry [t, d, c, lane, reg] is the word (4 consecutive inputs'
    digits) lane 4g + h holds in mma.m16n8k32's s8 A register reg, for
    limbs 16t .. 16t + 15 and inputs 16c .. 16c + 15: limb row g (reg 0,
    2) or g + 8 (reg 1, 3), plane d (reg 0, 1) or d - 1 (reg 2, 3), inputs
    16c + 4h .. 16c + 4h + 3.  Padding limbs and inputs are zero."""
    tab = table.detach().cpu().numpy().view(np.uint64)
    m, k = tab.shape
    mg, _, ch = digit_matrix_shape(m, k)[:3]
    planes = np.zeros((N_PLANES + 2, 16 * mg, 16 * ch), dtype=np.int8)   # [a + 1], a = -1 .. 8
    planes[1:N_PLANES + 1, :m, :k] = balanced_digits(tab)
    words = planes.view(np.int32).reshape(N_PLANES + 2, mg, 2, 8, ch, 4)   # [a+1, t, rh, g, c, h]
    frag = np.empty((mg, N_LAGS, ch, 8, 4, 4), dtype=np.int32)             # [t, d, c, g, h, reg]
    for reg in range(4):
        lag, rh = reg >> 1, reg & 1
        # plane a = d - lag for d = 0 .. 8: rows a + 1 = 1 - lag .. 9 - lag
        frag[..., reg] = words[1 - lag:N_LAGS + 1 - lag, :, rh].transpose(1, 0, 3, 2, 4)
    return torch.from_numpy(frag.reshape(digit_matrix_shape(m, k))).to(table.device)


def fragment_blocks(frag: torch.Tensor) -> torch.Tensor:
    """digit_matrix's words back to the MMA's A operands: (9, 16 ceil(m/16),
    32 ceil(k/16)) int8, row = limb, column 32c + kk = input 16c + kk of
    plane d (kk < 16) or of plane d - 1 (kk >= 16)."""
    mg, lags, ch = frag.shape[:3]
    w = frag.cpu().numpy().reshape(mg, lags, ch, 8, 4, 2, 2)        # [t, d, c, g, h, kh, rh]
    a = np.ascontiguousarray(w.transpose(1, 0, 6, 3, 2, 5, 4))      # [d, t, rh, g, c, kh, h]
    return torch.from_numpy(a.reshape(lags, 16 * mg, 8 * ch).view(np.int8).copy())


def digit_planes(x: torch.Tensor) -> torch.Tensor:
    """(...) int64 residues below 2^61 -> (..., 8) int64 balanced digits:
    the bytes of x + 0x8080808080808080 are the digits plus 128 (no byte
    carries out, since x < 2^61), the kernel's two-instruction
    extraction.  The constant is added as its int64 pattern, which wraps
    as the kernel's u64 add does."""
    v = x + (0x8080808080808080 - (1 << 64))
    return torch.stack([((v >> (8 * p)) & 0xFF) - 128 for p in range(N_PLANES)], dim=-1)


def _u64_of_words(w_lo: torch.Tensor, w_hi: torch.Tensor) -> torch.Tensor:
    """The u64 pattern w_lo + 2^32 w_hi (32-bit words in int64) as int64,
    without signed overflow."""
    return w_lo | ((w_hi & ma.M31) << 32) | ((w_hi >> 31) * ma.SIGN)


def bconv_matmul_digits_plain(scaled, qhat_mod_p, p, p_ratio_lo, p_ratio_hi,
                              diag) -> torch.Tensor:
    """K12's kernel arithmetic on the CPU, from the digit matrix `diag`
    (``digit_matrix``): per 16 inputs the s32 products A_d @ [plane 2e;
    plane 2e + 1] of the inputs' digits into diagonal d + 2e, the four
    signed 64-bit groups G_w = sum_r D_{4w + r} 2^(8r), their sum
    sum_w G_w 2^(32w) mod 2^128 (the row sum itself, below k 2^122), and
    the Barrett landing with floor(2^128/p).  Takes bconv_matmul's
    arguments; `qhat_mod_p` gives the shape only."""
    m, k = qhat_mod_p.shape
    a = fragment_blocks(diag).to(torch.int64)                    # (9, 16 mg, 32 ch)
    ch = a.shape[-1] // 32
    x = scaled.cpu()
    x = torch.cat([x, x.new_zeros(x.shape[:-2] + (16 * ch - k, x.shape[-1]))], dim=-2)
    dig = digit_planes(x)                                        # (..., 16 ch, N, 8)
    lead, n = x.shape[:-2], x.shape[-1]
    # pair e of chunk c: rows 32c + kk = input 16c + kk of plane 2e + (kk >= 16)
    b = dig.reshape(lead + (ch, 16, n, 4, 2)).movedim(-2, 0).movedim(-1, -3)  # (4, ..., ch, 2, 16, N)
    b = b.reshape((4,) + lead + (32 * ch, n))
    d = [None] * N_DIAG
    for lag in range(N_LAGS):
        for e in range(4):
            prod = a[lag] @ b[e]                                 # (..., 16 mg, N)
            s = lag + 2 * e
            d[s] = prod if d[s] is None else d[s] + prod
    if max(int(v.abs().max()) for v in d) >= 1 << 31:
        raise AssertionError("a diagonal left the s32 range")
    g = [sum(d[s] * (1 << (8 * (s - 4 * w))) for s in range(4 * w, min(4 * w + 4, N_DIAG)))
         for w in range(4)]
    # sum_w G_w 2^(32w) mod 2^128 in 32-bit words, carries by arithmetic shift
    words, carry = [], 0
    for w in range(4):
        t = g[w] + carry
        words.append(t & ma.M32)
        carry = t >> 32
    lo, hi = _u64_of_words(words[0], words[1]), _u64_of_words(words[2], words[3])
    q, rlo, rhi = (v.reshape(m, 1).cpu() for v in (p, p_ratio_lo, p_ratio_hi))
    out = ma.barrett_reduce_u128(hi[..., :m, :], lo[..., :m, :], q, rlo, rhi)
    return out.to(scaled.device)


# --------------------------------------------------------------------------
# the q32 form: balanced int8 digit planes (K13)
# --------------------------------------------------------------------------

N_PLANES_32 = 4         # balanced base-256 digits of a value below 2^30
N_DIAG_32 = 2 * N_PLANES_32 - 1
K_CHUNK = 512           # inputs per launch; longer sums add launches mod p


def diag_matrix_jk32(table, m_pad: int) -> np.ndarray:
    """The reference's digit matrix over 4 planes and 7 diagonals (a copy of
    ``tpu_fhe/ops/bconv_mxu_pallas.py::_diag_matrix_jk32``); table (m, k)
    of values below 2^30, rows padded to m_pad."""
    return diag_matrix_jk(table, m_pad, N_PLANES_32)


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


# --------------------------------------------------------------------------
# BEHZ and HPS conversions of BFV (tpu_fhe/ops/bconv.py:123-253)
# --------------------------------------------------------------------------

def bconv_behz(x, qhatinv, qhatinv_shoup, q, qhat_mod_p, p, p_ratio_lo, p_ratio_hi,
               diag=None) -> torch.Tensor:
    """Full BEHZ fast conversion ibase -> obase: scale each input limb by
    qhat_i^-1, then bconv_matmul (`diag` the table's digit matrix)."""
    s = ma.mul_mod_shoup(x, qhatinv, qhatinv_shoup, q).contiguous()
    return bconv_matmul(s, qhat_mod_p, p, p_ratio_lo, p_ratio_hi, diag)


def frac_alpha(s: torch.Tensor, frac_hi: torch.Tensor, frac_lo: torch.Tensor) -> torch.Tensor:
    """alpha = round(sum_i s_i * frac_i), (..., 1, N) u64 patterns, for s
    (..., k, N) residues and frac_i given as 128-bit fixed point: the (k, 1)
    words of floor(frac_i * 2^128).  The result is floor((V + 2^127) /
    2^128) mod 2^64 of the exact V = sum_i s_i * frac_i * 2^128, which is
    what the reference's two-word accumulation computes
    (tpu_fhe/ops/bconv.py:130-180).

    The reference needs chunks of 7 terms because its 64x64 products of a
    61-bit residue and a fraction's low word are up to 2^125 and its
    accumulator 128 bits wide.  Here every partial product is of 31-bit
    digits (below 2^62) and enters two digit columns as 31-bit halves
    (modarith.dot_columns): a column grows by less than 2^33 per term, so
    one pass holds any k below 2^28 exactly and needs no chunking."""
    cols = ma.dot_columns(ma.digits(s, 2), ma.digits128(frac_hi, frac_lo))
    cols[4] = cols[4] + (1 << 3)                     # + 2^127 = 2^(4*31 + 3)
    return ma.bits_at(ma.carry_digits(cols), 128)


def bconv_hps(x, qhatinv, qhatinv_shoup, q, qinv_hi, qinv_lo, qhat_mod_p, alpha_q_mod_p,
              p, p_ratio_lo, p_ratio_hi, diag=None) -> torch.Tensor:
    """Exact (centered) conversion ibase -> obase: the BEHZ conversion less
    its overshoot alpha*Q, alpha = round(sum_i s_i / q_i) from the
    fixed-point words of 1/q_i (qinv_hi, qinv_lo (k, 1)); alpha_q_mod_p
    (k + 1, m) holds [v * Q]_{p_j} for v = 0 .. k."""
    s = ma.mul_mod_shoup(x, qhatinv, qhatinv_shoup, q).contiguous()
    y = bconv_matmul(s, qhat_mod_p, p, p_ratio_lo, p_ratio_hi, diag)
    alpha = frac_alpha(s, qinv_hi, qinv_lo)                       # (..., 1, N) in [0, k]
    corr = alpha_q_mod_p.index_select(0, alpha.reshape(-1))       # (B N, m)
    corr = corr.reshape(alpha.shape[:-2] + (alpha.shape[-1], -1)).movedim(-1, -2)
    return ma.sub_mod(y, corr, p)


def sr_table(cross: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
    """The table scale_and_round_hps converts with: [cross | diag(diag)]
    (m, k + m) when k + m < 64, so that the diagonal term rides the same
    conversion (K12's kernel), else cross (m, k) alone."""
    m, k = cross.shape
    if k + m <= MXU_MAX_K:
        return torch.cat([cross, torch.diag(diag.reshape(-1))], dim=1)
    return cross


def scale_and_round_hps(x_a, x_b, table, diag, frac_hi, frac_lo, p, p_ratio_lo, p_ratio_hi,
                        table_diag=None) -> torch.Tensor:
    """out_j = [sum_i x_a[i]*cross[j,i] + x_b[j]*diag[j] + alpha]_{p_j},
    alpha = round(sum_i x_a[i] * frac_i) -- the shared shape of HPS's
    scale-and-round (tpu_fhe/ops/bconv.py:198-253).  x_a (..., k, N) the
    scaled source limbs; x_b (..., m, N) the resident limbs of the output
    base; `table` is sr_table(cross, diag) for cross (m, k) and diag (m, 1),
    and `table_diag` its digit matrix (needed by K12 on a CUDA tensor when
    the table has fewer than 64 columns); p (m, 1); frac over x_a.  When
    k + m < 64 the conversion takes [x_a; x_b] through [cross | diag(diag)];
    otherwise cross alone takes x_a and the diagonal term is one multiply
    mod p.  Either way the sum is the same value mod p as the reference's
    128-bit chunks."""
    k, m = x_a.shape[-2], x_b.shape[-2]
    if table.shape[1] == k + m:
        out = bconv_matmul(torch.cat([x_a, x_b], dim=-2), table, p, p_ratio_lo, p_ratio_hi,
                           table_diag)
    else:
        out = ma.add_mod(bconv_matmul(x_a.contiguous(), table, p, p_ratio_lo, p_ratio_hi,
                                      table_diag),
                         ma.mul_mod(x_b, diag, p, p_ratio_lo, p_ratio_hi), p)
    alpha = ma.barrett_reduce_u64(frac_alpha(x_a, frac_hi, frac_lo), p, p_ratio_hi)
    return ma.add_mod(out, alpha, p)
