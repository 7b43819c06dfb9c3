"""Negacyclic NTT / inverse NTT over RNS limbs.

Port of ``tpu_fhe/ops/ntt.py``.  Each transform has a plain torch version
(the stage loop of the JAX package's XLA path, canonical butterflies) and a
CUDA kernel (``csrc/ntt.cu``, Harvey-lazy butterflies): the forward and
inverse transforms of both words (K1, K2, K4, K5) and the forward landings
(K3, K6) in one launch per limb, held in the shared memory of a
thread-block cluster.  The kernels read their inputs in 16-byte runs (the
inverse its data, the landings their ``sub``), so the wrappers raise on a
tensor that is not 16-byte aligned.  The wrappers take the plain version
for CPU tensors only; for a CUDA tensor they launch the kernel or raise.

Two word sizes, chosen by the tables as the reference chooses its plan
(``tpu_fhe/ops/ntt.py:206-211``): int64 tables and residues on the u64 plan
(kernels K1-K3), and, when every modulus is below 2^30, int32 tables with
Shoup32 words floor(w * 2^32 / q) and int32 residues (the q32 plan, kernels
K4-K6).  The two compute the same function.

Twiddle tables are kept once, at the key level, in SEAL's bit-reversed
layout (stage m reads entries [m, 2m)); a ``DeviceNTTTables`` is a view of
them through ``limb_map``, so every chain level and digit complement shares
one table.  Outputs equal ``core/ntt_tables.golden_forward_ntt`` bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..core.modulus import Q32_BIT_MAX
from ..core.ntt_tables import NTTTables, shoup_np
from . import modarith as ma
from ._build import INT, PTR, CudaKernel, ptr
from .modarith import u32_tensor, u64_tensor

NTT_FWD = CudaKernel(
    "ntt_fwd", "ntt.cu", "tfhe_ntt_fwd", [PTR] * 6 + [INT] * 3,
    "tpu_fhe/ops/ntt_pallas.py:362 _fwd_kernel (K1)")
NTT_FWD_LANDING = CudaKernel(
    "ntt_fwd_landing", "ntt.cu", "tfhe_ntt_fwd_landing", [PTR] * 11 + [INT] * 3,
    "tpu_fhe/ops/ntt_pallas.py:401 _fwd_sub_scale_kernel (K3)")
NTT_INV = CudaKernel(
    "ntt_inv", "ntt.cu", "tfhe_ntt_inv", [PTR] * 10 + [INT] * 3,
    "tpu_fhe/ops/ntt_pallas.py:449 _inv_kernel (K2)")
NTT_FWD32 = CudaKernel(
    "ntt_fwd32", "ntt.cu", "tfhe_ntt_fwd32", [PTR] * 6 + [INT] * 3,
    "tpu_fhe/ops/ntt_pallas.py:801 _fwd_kernel32 (K4)")
NTT_FWD_LANDING32 = CudaKernel(
    "ntt_fwd_landing32", "ntt.cu", "tfhe_ntt_fwd_landing32", [PTR] * 11 + [INT] * 3,
    "tpu_fhe/ops/ntt_pallas.py:810 _fwd_sub_scale_kernel32 (K6)")
NTT_INV32 = CudaKernel(
    "ntt_inv32", "ntt.cu", "tfhe_ntt_inv32", [PTR] * 10 + [INT] * 3,
    "tpu_fhe/ops/ntt_pallas.py:823 _inv_kernel32 (K5)")

MIN_LOG_N, MAX_LOG_N = 10, 17   # ring sizes the kernels take


@dataclass(frozen=True)
class DeviceNTTTables:
    """A view of the key-level twiddle tables.

    q: (L, 1) moduli of this view; limb_map: (L,) int64 rows of the
    key-level tables.  key_q,
    roots*, inv_roots*: key-level (K,) and (K, N) tables, shared by every
    view; inv_degree*: (K,) n^{-1} mod q and its Shoup word.  All int64 on
    the u64 plan; all int32 (Shoup32 words) on the q32 plan."""

    q: torch.Tensor
    limb_map: torch.Tensor
    key_q: torch.Tensor
    roots: torch.Tensor
    roots_shoup: torch.Tensor
    inv_roots: torch.Tensor
    inv_roots_shoup: torch.Tensor
    inv_degree: torch.Tensor
    inv_degree_shoup: torch.Tensor

    @property
    def n(self) -> int:
        return self.roots.shape[-1]

    @property
    def num_limbs(self) -> int:
        return self.limb_map.shape[0]

    @property
    def is_q32(self) -> bool:
        return self.q.dtype == torch.int32

    def slice_limbs(self, indices: list[int]) -> "DeviceNTTTables":
        idx = torch.as_tensor(indices, dtype=torch.int64, device=self.q.device)
        return replace(self, q=self.q[idx], limb_map=self.limb_map[idx])


def shoup32_np(vals, q: int) -> np.ndarray:
    """Exact floor(w * 2^32 / q) as uint64 for w < q < 2^30."""
    return (np.asarray(vals, dtype=np.uint64) << np.uint64(32)) // np.uint64(q)


def build_device_ntt_tables(tables: list[NTTTables], device,
                            q32: bool | None = None) -> DeviceNTTTables:
    """Pack host twiddle tables (one per key-level RNS limb) on `device`:
    int32 with Shoup32 words when `q32` (default: every modulus < 2^30),
    else int64 with 64-bit Shoup words."""
    qs = [t.modulus.value for t in tables]
    fits = max(qs).bit_length() <= Q32_BIT_MAX
    if q32 is None:
        q32 = fits
    if q32 and not fits:
        raise ValueError("the q32 plan needs every modulus below 2^30")
    word, shoup = (u32_tensor, shoup32_np) if q32 else (u64_tensor, shoup_np)
    roots = np.stack([t.root_powers for t in tables])
    inv_roots = np.stack([t.inv_root_powers for t in tables])
    inv_degree = np.array([t.inv_degree for t in tables], dtype=np.uint64)

    return DeviceNTTTables(
        q=word(np.asarray(qs, dtype=np.uint64).reshape(-1, 1), device),
        limb_map=torch.arange(len(tables), dtype=torch.int64, device=device),
        key_q=word(qs, device),
        roots=word(roots, device),
        roots_shoup=word(np.stack([shoup(r, q) for r, q in zip(roots, qs)]), device),
        inv_roots=word(inv_roots, device),
        inv_roots_shoup=word(np.stack([shoup(r, q) for r, q in zip(inv_roots, qs)]), device),
        inv_degree=word(inv_degree, device),
        inv_degree_shoup=word(
            np.concatenate([shoup(inv_degree[i:i + 1], q) for i, q in enumerate(qs)]), device),
    )


# --------------------------------------------------------------------------
# argument checks shared by the plain versions and the kernels
# --------------------------------------------------------------------------

def _check(x: torch.Tensor, t: DeviceNTTTables, name: str) -> None:
    if x.dtype != t.q.dtype:
        raise TypeError(f"{name}: residues must be {t.q.dtype} like the tables, got {x.dtype}")
    if x.dim() < 2 or x.shape[-2] != t.num_limbs or x.shape[-1] != t.n:
        raise ValueError(
            f"{name}: expected (..., {t.num_limbs}, {t.n}), got {tuple(x.shape)}")
    if x.device != t.roots.device:
        raise ValueError(f"{name}: data on {x.device}, tables on {t.roots.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: data must be contiguous")


def _scale_vec(s: torch.Tensor | None, t: DeviceNTTTables, name: str):
    """A per-limb constant ((L,) or (L, 1)) as a contiguous (L,) tensor."""
    if s is None:
        return None
    s = s.reshape(-1)
    if s.numel() != t.num_limbs or s.dtype != t.q.dtype or s.device != t.roots.device:
        raise ValueError(f"{name}: per-limb constants must be ({t.num_limbs},) {t.q.dtype} "
                         f"on {t.roots.device}")
    return s.contiguous()


def _launch_dims(x: torch.Tensor, t: DeviceNTTTables, name: str):
    log_n = t.n.bit_length() - 1
    if not MIN_LOG_N <= log_n <= MAX_LOG_N:
        raise ValueError(f"{name}: the kernel takes 2^{MIN_LOG_N} <= N <= 2^{MAX_LOG_N}")
    rows = x.numel() // t.n
    if rows > 65535:
        raise ValueError(f"{name}: at most 65535 polynomial rows per launch")
    return rows, t.num_limbs, log_n


def _on_cpu(x: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (plain version), False for CUDA (kernel)."""
    if x.is_cuda:
        return False
    if x.device.type == "cpu":
        return True
    raise ValueError(f"{name}: unsupported device {x.device}")


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _rows(tab: torch.Tensor, t: DeviceNTTTables) -> torch.Tensor:
    return tab.index_select(0, t.limb_map)


def forward_ntt_plain(x: torch.Tensor, t: DeviceNTTTables) -> torch.Tensor:
    n, L = t.n, t.num_limbs
    lead = x.shape[:-1]
    roots, roots_shoup = _rows(t.roots, t), _rows(t.roots_shoup, t)
    qb = t.q.reshape(L, 1, 1)
    m, tt = 1, n
    while m < n:
        tt >>= 1
        w = roots[:, m:2 * m].reshape(L, m, 1)
        ws = roots_shoup[:, m:2 * m].reshape(L, m, 1)
        xr = x.reshape(lead + (m, 2, tt))
        a, b = xr[..., 0, :], xr[..., 1, :]
        v = ma.mul_shoup(b, w, ws, qb)
        x = torch.stack([ma.add_mod(a, v, qb), ma.sub_mod(a, v, qb)], dim=-2)
        x = x.reshape(lead + (n,))
        m <<= 1
    return x


def inverse_ntt_plain(x: torch.Tensor, t: DeviceNTTTables, scale=None,
                      scale_shoup=None) -> torch.Tensor:
    n, L = t.n, t.num_limbs
    lead = x.shape[:-1]
    inv_roots, inv_roots_shoup = _rows(t.inv_roots, t), _rows(t.inv_roots_shoup, t)
    qb = t.q.reshape(L, 1, 1)
    m, tt = n, 1
    while m > 1:
        h = m >> 1
        w = inv_roots[:, h:m].reshape(L, h, 1)
        ws = inv_roots_shoup[:, h:m].reshape(L, h, 1)
        xr = x.reshape(lead + (h, 2, tt))
        a, b = xr[..., 0, :], xr[..., 1, :]
        u = ma.add_mod(a, b, qb)
        v = ma.mul_shoup(ma.sub_mod(a, b, qb), w, ws, qb)
        x = torch.stack([u, v], dim=-2).reshape(lead + (n,))
        tt <<= 1
        m = h
    inv_n = _rows(t.inv_degree, t).reshape(L, 1)
    inv_n_shoup = _rows(t.inv_degree_shoup, t).reshape(L, 1)
    x = ma.mul_shoup(x, inv_n, inv_n_shoup, t.q)
    if scale is not None:
        x = ma.mul_shoup(x, scale.reshape(L, 1), scale_shoup.reshape(L, 1), t.q)
    return x


def forward_ntt_sub_scale_plain(x, sub, t: DeviceNTTTables, scale, scale_shoup,
                                pre=None, pre_shoup=None) -> torch.Tensor:
    L = t.num_limbs
    y = forward_ntt_plain(x, t)
    if pre is not None:
        y = ma.mul_shoup(y, pre.reshape(L, 1), pre_shoup.reshape(L, 1), t.q)
    d = ma.sub_mod(sub, y, t.q)
    return ma.mul_shoup(d, scale.reshape(L, 1), scale_shoup.reshape(L, 1), t.q)


# --------------------------------------------------------------------------
# wrappers: plain version for CPU tensors, kernel for CUDA tensors
# --------------------------------------------------------------------------

def forward_ntt(x: torch.Tensor, t: DeviceNTTTables) -> torch.Tensor:
    """Forward negacyclic NTT over the last axis of (..., L, N) residues in
    [0, q); output order of the golden transform (evaluation at
    psi^(2*br(i)+1))."""
    _check(x, t, "forward_ntt")
    if _on_cpu(x, "forward_ntt"):
        return forward_ntt_plain(x, t)
    rows, L, log_n = _launch_dims(x, t, "forward_ntt")
    out = torch.empty_like(x)
    (NTT_FWD32 if t.is_q32 else NTT_FWD)(ptr(x), ptr(out), ptr(t.roots), ptr(t.roots_shoup),
                                         ptr(t.key_q), ptr(t.limb_map), rows, L, log_n)
    return out


def inverse_ntt_scaled(x: torch.Tensor, t: DeviceNTTTables, scale: torch.Tensor | None,
                       scale_shoup: torch.Tensor | None) -> torch.Tensor:
    """Inverse NTT (with the 1/n scale) followed by a per-limb Shoup scale
    ((L, 1) in the tables' word; None for none).  The kernel applies both
    multiplies in its last pass, n^-1 first."""
    _check(x, t, "inverse_ntt")
    s = _scale_vec(scale, t, "inverse_ntt_scaled")
    ss = _scale_vec(scale_shoup, t, "inverse_ntt_scaled")
    if (s is None) != (ss is None):
        raise ValueError("inverse_ntt_scaled: scale and scale_shoup go together")
    if _on_cpu(x, "inverse_ntt"):
        return inverse_ntt_plain(x, t, s, ss)
    rows, L, log_n = _launch_dims(x, t, "inverse_ntt")
    if x.data_ptr() % 16:
        raise ValueError("inverse_ntt: the kernel reads 16-byte aligned data")
    out = torch.empty_like(x)
    (NTT_INV32 if t.is_q32 else NTT_INV)(
        ptr(x), ptr(out), ptr(t.inv_roots), ptr(t.inv_roots_shoup), ptr(t.key_q),
        ptr(t.limb_map), ptr(t.inv_degree), ptr(t.inv_degree_shoup), ptr(s), ptr(ss),
        rows, L, log_n)
    return out


def inverse_ntt(x: torch.Tensor, t: DeviceNTTTables) -> torch.Tensor:
    """Inverse negacyclic NTT over the last axis (includes the 1/n scale)."""
    return inverse_ntt_scaled(x, t, None, None)


def forward_ntt_sub_scale(x: torch.Tensor, sub: torch.Tensor, t: DeviceNTTTables,
                          scale: torch.Tensor, scale_shoup: torch.Tensor,
                          pre: torch.Tensor | None = None,
                          pre_shoup: torch.Tensor | None = None) -> torch.Tensor:
    """(sub - pre * NTT(x)) * scale mod q per limb: the landing of moddown
    and rescale, fused into the forward transform's last pass."""
    _check(x, t, "forward_ntt_sub_scale")
    _check(sub, t, "forward_ntt_sub_scale")
    if sub.shape != x.shape:
        raise ValueError("forward_ntt_sub_scale: x and sub shapes differ")
    post, post_s = (_scale_vec(v, t, "forward_ntt_sub_scale") for v in (scale, scale_shoup))
    pre_v, pre_s = (_scale_vec(v, t, "forward_ntt_sub_scale") for v in (pre, pre_shoup))
    if post is None or post_s is None or (pre_v is None) != (pre_s is None):
        raise ValueError("forward_ntt_sub_scale: scale pairs are incomplete")
    if _on_cpu(x, "forward_ntt_sub_scale"):
        return forward_ntt_sub_scale_plain(x, sub, t, post, post_s, pre_v, pre_s)
    rows, L, log_n = _launch_dims(x, t, "forward_ntt_sub_scale")
    if sub.data_ptr() % 16:
        raise ValueError("forward_ntt_sub_scale: the kernel reads 16-byte aligned sub")
    out = torch.empty_like(x)
    (NTT_FWD_LANDING32 if t.is_q32 else NTT_FWD_LANDING)(
        ptr(x), ptr(sub), ptr(out), ptr(t.roots), ptr(t.roots_shoup), ptr(t.key_q),
        ptr(t.limb_map), ptr(post), ptr(post_s), ptr(pre_v), ptr(pre_s), rows, L, log_n)
    return out
