"""Hybrid-keyswitch inner product, port of ``tpu_fhe/ops/ks_pallas.py``:

    out[..., c, l, n] = sum_{d < beta} t[..., d, l, n] * evk[d, c, limb_map[l], n] mod q_l

over a batch of digit sets t (B, beta, L, N) that shares one key, or one
set (beta, L, N); every form serves a batch in one launch.

The key's rows are picked through ``limb_map`` (the Ql rows, then the P
rows of the key level), never concatenated.  Four CUDA kernels
(``csrc/ks.cu``), one per key form and word:

  * ``key_inner_prod`` (K7, ``key_inner_prod_pallas``): int64 operands, a
    key without Shoup words (the Galois keys' default); 128-bit digit sum,
    one Barrett landing with floor(2^128/q);
  * ``key_inner_prod32`` (K9, ``key_inner_prod_pallas32``): int32 operands
    of the q32 plan; 96-bit digit sum, one word-fold landing with the
    moduli's ``fold`` rows (``modarith.q32_mul_consts``);
  * ``key_inner_prod_shoup`` (K8 on int64, K10 on int32 operands,
    ``key_inner_prod_shoup_pallas(32)``): a key with Shoup words,
    floor(evk * 2^64 / q) on int64 keys and floor(evk * 2^32 / q) on int32.

Every form computes the same canonical sum.  The plain versions reduce each
digit product and add mod q; on a batch they equal a loop of the one-set
version over it.  All four are bound by bytes.  K7, K8 and K10 give each
thread its coefficient in 1, 2 or, from a batch of 3 on, 4 ciphertexts of
the batch (``tfhe_ks_per_thread``), so each key word is read once for
them.  K9 is a stream: a thread owns 4 consecutive coefficients of one
limb, loads their key words once and walks the whole batch with 16-byte
loads and streaming stores, so a launch reads the key once; it needs N a
multiple of 4 and 16-byte aligned t and key, and raises otherwise.
"""

from __future__ import annotations

import torch

from . import modarith as ma
from ._build import INT, PTR, CudaKernel, ptr

KS = CudaKernel(
    "key_inner_prod", "ks.cu", "tfhe_ks", [PTR] * 7 + [INT] * 5,
    "tpu_fhe/ops/ks_pallas.py:54 _kernel (K7)")
KS32 = CudaKernel(
    "key_inner_prod32", "ks.cu", "tfhe_ks32", [PTR] * 6 + [INT] * 5,
    "tpu_fhe/ops/ks_pallas.py:96 _kernel32 (K9)")
KS_SHOUP = CudaKernel(
    "key_inner_prod_shoup", "ks.cu", "tfhe_ks_shoup", [PTR] * 6 + [INT] * 5,
    "tpu_fhe/ops/ks_pallas.py:116 _kernel_shoup (K8)")
KS_SHOUP32 = CudaKernel(
    "key_inner_prod_shoup32", "ks.cu", "tfhe_ks_shoup32", [PTR] * 6 + [INT] * 5,
    "tpu_fhe/ops/ks_pallas.py:147 _kernel32_shoup (K10)")

MAX_BETA = 64      # K7: beta * q^2 < 2^128 for q < 2^61
MAX_BATCH = 4 * 65535   # grid.z of the kernels' per-thread batches of 4


def _batch(t: torch.Tensor) -> int:
    return t.shape[0] if t.dim() == 4 else 1


def _out(t: torch.Tensor) -> torch.Tensor:
    """The output of a batch (B, 2, L, N), or of one set (2, L, N)."""
    return torch.empty(t.shape[:-3] + (2,) + t.shape[-2:], dtype=t.dtype, device=t.device)


def _check(name: str, t: torch.Tensor, keys: tuple, limb_map: torch.Tensor,
           q: torch.Tensor, dtypes: tuple) -> bool:
    """The checks every form shares; True when the kernel is to launch (a
    CUDA tensor), False for the plain version (a CPU tensor)."""
    if t.dim() not in (3, 4) or not 1 <= _batch(t) <= MAX_BATCH:
        raise ValueError(f"{name}: t must be (beta, L, N) or (B <= {MAX_BATCH}, beta, L, N), "
                         f"got {tuple(t.shape)}")
    beta, L, n = t.shape[-3:]
    evk = keys[0]
    if any(k.shape != evk.shape for k in keys) or evk.dim() != 4 or evk.shape[0] < beta \
            or evk.shape[1] != 2 or evk.shape[3] != n:
        raise ValueError(f"{name}: key shape {tuple(evk.shape)} does not fit t "
                         f"{tuple(t.shape)}")
    if limb_map.shape != (L,) or q.numel() != L:
        raise ValueError(f"{name}: limb_map and q need one entry per limb")
    if t.dtype not in dtypes or limb_map.dtype != torch.int64 \
            or any(a.dtype != t.dtype for a in (*keys, q)) \
            or any(a.device != t.device for a in (*keys, limb_map, q)):
        raise ValueError(f"{name}: operands must share one word ({', '.join(map(str, dtypes))})"
                         " and one device; limb_map is int64")
    if not (t.is_contiguous() and all(k.is_contiguous() for k in keys)):
        raise ValueError(f"{name}: operands must be contiguous")
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return False


def _key_rows(evk: torch.Tensor, d: int, limb_map: torch.Tensor) -> torch.Tensor:
    return evk[d].index_select(1, limb_map)


# --------------------------------------------------------------------------
# K7 and K9: keys without Shoup words
# --------------------------------------------------------------------------

def key_inner_prod_plain(t, evk, limb_map, q, ratio_lo, ratio_hi) -> torch.Tensor:
    beta, L, _ = t.shape[-3:]
    q, rlo, rhi = (v.reshape(L, 1) for v in (q, ratio_lo, ratio_hi))
    out = None
    for d in range(beta):
        v = ma.mul_mod(t[..., d, None, :, :], _key_rows(evk, d, limb_map), q, rlo, rhi)
        out = v if out is None else ma.add_mod(out, v, q)
    return out


def key_inner_prod(t: torch.Tensor, evk: torch.Tensor, limb_map: torch.Tensor,
                   q: torch.Tensor, ratio_lo: torch.Tensor,
                   ratio_hi: torch.Tensor) -> torch.Tensor:
    """u64 plan, a key without Shoup words.  t: (beta <= 64, L, N) digits
    of the modup, or a batch (B, beta, L, N) of them; evk: (dnum >= beta, 2,
    key_rows, N); limb_map: (L,) int64 key rows; q, ratio_lo, ratio_hi:
    (L, 1) moduli of QlP and their Barrett words.  All int64 but limb_map.
    Returns (2, L, N), or (B, 2, L, N)."""
    beta, L, n = t.shape[-3:]
    if beta > MAX_BETA:
        raise ValueError(f"key_inner_prod: beta = {beta} > {MAX_BETA} overflows the 128-bit sum")
    if ratio_lo.numel() != L or ratio_hi.numel() != L \
            or any(r.dtype != torch.int64 or r.device != t.device for r in (ratio_lo, ratio_hi)):
        raise ValueError("key_inner_prod: ratio_lo and ratio_hi need one int64 entry per limb "
                         "on the data's device")
    if not _check("key_inner_prod", t, (evk,), limb_map, q, (torch.int64,)):
        return key_inner_prod_plain(t, evk, limb_map, q, ratio_lo, ratio_hi)
    out = _out(t)
    consts = [c.reshape(-1).contiguous() for c in (q, ratio_lo, ratio_hi)]
    KS(ptr(t), ptr(evk), ptr(limb_map.contiguous()), *(ptr(c) for c in consts), ptr(out),
       beta, L, evk.shape[2], n, _batch(t))
    return out


def key_inner_prod32_plain(t, evk, limb_map, q, fold=None) -> torch.Tensor:
    """K9's function in int64: each product is below 2^60, and the running
    sum is reduced mod q after every digit.  `fold` is not needed here."""
    beta, L, _ = t.shape[-3:]
    q64 = q.reshape(L, 1).to(torch.int64)
    out = None
    for d in range(beta):
        term = t[..., d, None, :, :].to(torch.int64) * _key_rows(evk, d, limb_map).to(torch.int64)
        out = torch.remainder(term if out is None else out + term, q64)
    return out.to(torch.int32)


def key_inner_prod32(t: torch.Tensor, evk: torch.Tensor, limb_map: torch.Tensor,
                     q: torch.Tensor, fold: torch.Tensor) -> torch.Tensor:
    """q32 plan, a key without Shoup words: t, evk and q (moduli < 2^30) as
    int32, as key_inner_prod; fold (5, L, 1) int64 constants of the QlP
    moduli.  Exact for any beta.  On the card N must be a multiple of 4 and
    t and evk 16-byte aligned.  Returns (2, L, N), or (B, 2, L, N) for a
    batch, int32."""
    beta, L, n = t.shape[-3:]
    if fold.shape != (5, L, 1) or fold.dtype != torch.int64 or fold.device != t.device:
        raise ValueError(f"key_inner_prod32: fold must be (5, {L}, 1) int64 on the data's "
                         "device")
    if not _check("key_inner_prod32", t, (evk,), limb_map, q, (torch.int32,)):
        return key_inner_prod32_plain(t, evk, limb_map, q)
    if n % 4 or t.data_ptr() % 16 or evk.data_ptr() % 16:
        raise ValueError("key_inner_prod32: the kernel takes 4 coefficients a thread: N must be "
                         "a multiple of 4 and t and the key 16-byte aligned")
    out = _out(t)
    KS32(ptr(t), ptr(evk), ptr(limb_map.contiguous()), ptr(q.reshape(-1).contiguous()),
         ptr(fold.contiguous()), ptr(out), beta, L, evk.shape[2], n, _batch(t))
    return out


# --------------------------------------------------------------------------
# K8 and K10: keys with Shoup words
# --------------------------------------------------------------------------

def key_inner_prod_shoup_plain(t, evk, evk_shoup, limb_map, q) -> torch.Tensor:
    beta, L, _ = t.shape[-3:]
    qc = q.reshape(L, 1)
    out = None
    for d in range(beta):
        k, ks = _key_rows(evk, d, limb_map), _key_rows(evk_shoup, d, limb_map)
        v = ma.mul_shoup(t[..., d, None, :, :], k, ks, qc)
        out = v if out is None else ma.add_mod(out, v, qc)
    return out


def key_inner_prod_shoup(t: torch.Tensor, evk: torch.Tensor, evk_shoup: torch.Tensor,
                         limb_map: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """t: (beta, L, N) digits of the modup, or a batch (B, beta, L, N);
    evk, evk_shoup: (dnum >= beta, 2, key_rows, N); limb_map: (L,) int64
    key rows; q: (L, 1) moduli of QlP.  All int64 (u64 plan) or all but
    limb_map int32 (q32 plan).  Returns (2, L, N), or (B, 2, L, N)."""
    beta, L, n = t.shape[-3:]
    if not _check("key_inner_prod_shoup", t, (evk, evk_shoup), limb_map, q,
                  (torch.int32, torch.int64)):
        return key_inner_prod_shoup_plain(t, evk, evk_shoup, limb_map, q)
    out = _out(t)
    (KS_SHOUP32 if t.dtype == torch.int32 else KS_SHOUP)(
        ptr(t), ptr(evk), ptr(evk_shoup), ptr(limb_map.contiguous()),
        ptr(q.reshape(-1).contiguous()), ptr(out), beta, L, evk.shape[2], n, _batch(t))
    return out
