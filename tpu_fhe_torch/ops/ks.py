"""Hybrid-keyswitch inner product with a Shoup-form key.

Port of ``tpu_fhe/ops/ks_pallas.py::key_inner_prod_shoup_pallas`` (K8) and,
for int32 operands of the q32 plan, ``key_inner_prod_shoup_pallas32`` (K10):

    out[c, l, n] = sum_{d < beta} t[d, l, n] * evk[d, c, limb_map[l], n] mod q_l

The key's rows are picked through ``limb_map`` (the Ql rows, then the P
rows of the key level), never concatenated.  The CUDA kernels are
``csrc/ks.cu`` (one template, two words); the plain version sums canonical
Shoup products mod q, which is the same function.  Shoup words are
floor(evk * 2^64 / q) on int64 keys and floor(evk * 2^32 / q) on int32 keys.
"""

from __future__ import annotations

import torch

from . import modarith as ma
from ._build import INT, PTR, CudaKernel, ptr

KS_SHOUP = CudaKernel(
    "key_inner_prod_shoup", "ks.cu", "tfhe_ks_shoup", [PTR] * 6 + [INT] * 4,
    "tpu_fhe/ops/ks_pallas.py:116 _kernel_shoup (K8)")
KS_SHOUP32 = CudaKernel(
    "key_inner_prod_shoup32", "ks.cu", "tfhe_ks_shoup32", [PTR] * 6 + [INT] * 4,
    "tpu_fhe/ops/ks_pallas.py:147 _kernel32_shoup (K10)")


def key_inner_prod_shoup_plain(t, evk, evk_shoup, limb_map, q) -> torch.Tensor:
    beta, L, _ = t.shape
    qc = q.reshape(L, 1)
    out = None
    for d in range(beta):
        k = evk[d].index_select(1, limb_map)
        ks = evk_shoup[d].index_select(1, limb_map)
        mul = ma.mul_mod_shoup32 if t.dtype == torch.int32 else ma.mul_mod_shoup
        v = mul(t[d][None], k, ks, qc)
        out = v if out is None else ma.add_mod(out, v, qc)
    return out


def key_inner_prod_shoup(t: torch.Tensor, evk: torch.Tensor, evk_shoup: torch.Tensor,
                         limb_map: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """t: (beta, L, N) digits of the modup; evk, evk_shoup: (dnum >= beta,
    2, key_rows, N); limb_map: (L,) int64 key rows; q: (L, 1) moduli of QlP.
    All int64 (u64 plan) or all but limb_map int32 (q32 plan).  Returns
    (2, L, N)."""
    beta, L, n = t.shape
    if evk.shape != evk_shoup.shape or evk.dim() != 4 or evk.shape[0] < beta \
            or evk.shape[1] != 2 or evk.shape[3] != n:
        raise ValueError(f"key_inner_prod_shoup: key shape {tuple(evk.shape)} does not "
                         f"fit t {tuple(t.shape)}")
    if limb_map.shape != (L,) or q.numel() != L:
        raise ValueError("key_inner_prod_shoup: limb_map and q need one entry per limb")
    if t.dtype not in (torch.int32, torch.int64) or limb_map.dtype != torch.int64 \
            or any(a.dtype != t.dtype for a in (evk, evk_shoup, q)) \
            or any(a.device != t.device for a in (evk, evk_shoup, limb_map, q)):
        raise ValueError("key_inner_prod_shoup: operands must share one word (int64, or "
                         "int32 on the q32 plan) and one device; limb_map is int64")
    if not (t.is_contiguous() and evk.is_contiguous() and evk_shoup.is_contiguous()):
        raise ValueError("key_inner_prod_shoup: operands must be contiguous")
    if t.is_cuda:
        out = torch.empty((2, L, n), dtype=t.dtype, device=t.device)
        (KS_SHOUP32 if t.dtype == torch.int32 else KS_SHOUP)(
            ptr(t), ptr(evk), ptr(evk_shoup), ptr(limb_map.contiguous()),
            ptr(q.reshape(-1).contiguous()), ptr(out), beta, L, evk.shape[2], n)
        return out
    if t.device.type != "cpu":
        raise ValueError(f"key_inner_prod_shoup: unsupported device {t.device}")
    return key_inner_prod_shoup_plain(t, evk, evk_shoup, limb_map, q)
