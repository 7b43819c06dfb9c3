"""Hybrid-keyswitch inner product with a Shoup-form key.

Port of ``tpu_fhe/ops/ks_pallas.py::key_inner_prod_shoup_pallas`` (K8):

    out[c, l, n] = sum_{d < beta} t[d, l, n] * evk[d, c, limb_map[l], n] mod q_l

The key's rows are picked through ``limb_map`` (the Ql rows, then the P
rows of the key level), never concatenated.  The CUDA kernel is
``csrc/ks.cu``; the plain version sums canonical Shoup products mod q,
which is the same function.
"""

from __future__ import annotations

import torch

from . import modarith as ma
from ._build import INT, PTR, CudaKernel, ptr

KS_SHOUP = CudaKernel(
    "key_inner_prod_shoup", "ks.cu", "tfhe_ks_shoup", [PTR] * 6 + [INT] * 4,
    "tpu_fhe/ops/ks_pallas.py:116 _kernel_shoup (K8)")


def key_inner_prod_shoup_plain(t, evk, evk_shoup, limb_map, q) -> torch.Tensor:
    beta, L, _ = t.shape
    qc = q.reshape(L, 1)
    out = None
    for d in range(beta):
        k = evk[d].index_select(1, limb_map)
        ks = evk_shoup[d].index_select(1, limb_map)
        v = ma.mul_mod_shoup(t[d][None], k, ks, qc)
        out = v if out is None else ma.add_mod(out, v, qc)
    return out


def key_inner_prod_shoup(t: torch.Tensor, evk: torch.Tensor, evk_shoup: torch.Tensor,
                         limb_map: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """t: (beta, L, N) digits of the modup; evk, evk_shoup: (dnum >= beta,
    2, key_rows, N); limb_map: (L,) int64 key rows; q: (L, 1) moduli of QlP.
    Returns (2, L, N)."""
    beta, L, n = t.shape
    if evk.shape != evk_shoup.shape or evk.dim() != 4 or evk.shape[0] < beta \
            or evk.shape[1] != 2 or evk.shape[3] != n:
        raise ValueError(f"key_inner_prod_shoup: key shape {tuple(evk.shape)} does not "
                         f"fit t {tuple(t.shape)}")
    if limb_map.shape != (L,) or q.numel() != L:
        raise ValueError("key_inner_prod_shoup: limb_map and q need one entry per limb")
    args = (t, evk, evk_shoup, limb_map, q)
    if any(a.dtype != torch.int64 or a.device != t.device for a in args):
        raise ValueError("key_inner_prod_shoup: all operands must be int64 on one device")
    if not (t.is_contiguous() and evk.is_contiguous() and evk_shoup.is_contiguous()):
        raise ValueError("key_inner_prod_shoup: operands must be contiguous")
    if t.is_cuda:
        out = torch.empty((2, L, n), dtype=torch.int64, device=t.device)
        KS_SHOUP(ptr(t), ptr(evk), ptr(evk_shoup), ptr(limb_map.contiguous()),
                 ptr(q.reshape(-1).contiguous()), ptr(out), beta, L, evk.shape[2], n)
        return out
    if t.device.type != "cpu":
        raise ValueError(f"key_inner_prod_shoup: unsupported device {t.device}")
    return key_inner_prod_shoup_plain(t, evk, evk_shoup, limb_map, q)
