"""Carry state between the JAX package's numpy form and the port's tensors.

The JAX package hands its state over as numpy arrays: ``uint64`` from its
``W64.to_np()`` (the secret key in NTT form (QP, N), switching-key data
(dnum, 2, QP, N) and its Shoup words, ciphertexts (size, L, N) and
plaintexts (L, N)), and, on a q32 context, its compact state as bare
``uint32`` (switching keys and their Shoup32 words, ``tpu_fhe/scheme/keys.py``
:165-192).  These helpers turn such arrays into the port's tensors of the
same values in the context's word (int64, or int32 on a q32 context) on its
device, and back.  BFV/BGV state crosses the same way: coefficient-form
ciphertexts with their correction factor and flags, mod-t plaintexts (one
(1, N) row) and BGV keys, which have the CKKS shapes.  They take plain numpy, so the port never imports the
JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.modarith import u32_tensor, u64_tensor as to_tensor
from ..scheme.ciphertext import Ciphertext, Plaintext
from ..scheme.context import FheContext
from ..scheme.keys import GaloisKey, RelinKey, SecretKey


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> uint64 numpy array of the same bits; int32 tensor ->
    uint32 numpy array of the same bits."""
    arr = t.detach().cpu().contiguous().numpy()
    return arr.view(np.uint32 if arr.dtype == np.int32 else np.uint64)


def word_tensor(ctx: FheContext, arr: np.ndarray) -> torch.Tensor:
    """Residues or Shoup words (uint32 or uint64 numpy) as a tensor in the
    context's word on its device; on a q32 context every value must be
    below 2^32."""
    if ctx.is_q32:
        if np.asarray(arr).dtype != np.uint32 and np.any(np.asarray(arr) >> np.uint64(32)):
            raise ValueError("a q32 context takes values below 2^32 only")
        return u32_tensor(arr, ctx.device)
    return to_tensor(arr, ctx.device)


def secret_key_from_np(ctx: FheContext, s_ntt: np.ndarray,
                       seed: int | torch.Generator = 0) -> SecretKey:
    """The port's secret key for the reference's s_ntt (QP, N); `seed`
    seeds the generator of any later sampling."""
    return SecretKey(ctx, seed=seed, s_ntt=word_tensor(ctx, s_ntt))


def relin_key_from_np(ctx: FheContext, data: np.ndarray,
                      shoup: np.ndarray | None = None) -> RelinKey:
    """A switching key and its Shoup words (floor(data * 2^64 / q), or
    floor(data * 2^32 / q) on a q32 context), or None for a key without."""
    return RelinKey(word_tensor(ctx, data), None if shoup is None else word_tensor(ctx, shoup))


def relin_key_to_np(key: RelinKey) -> tuple[np.ndarray, np.ndarray | None]:
    return to_numpy(key.data), None if key.shoup is None else to_numpy(key.shoup)


def galois_key_from_np(ctx: FheContext, keys: dict) -> GaloisKey:
    """A Galois key set from {automorphism element: (data, shoup or None)}."""
    return GaloisKey({int(elt): relin_key_from_np(ctx, data, shoup)
                      for elt, (data, shoup) in keys.items()})


def galois_key_to_np(gk: GaloisKey) -> dict:
    """{automorphism element: (data, shoup or None)} as numpy."""
    return {elt: relin_key_to_np(key) for elt, key in gk.keys.items()}


def ciphertext_from_np(ctx: FheContext, data: np.ndarray, chain_index: int,
                       scale: float = 1.0, noise_scale_deg: int = 1,
                       correction_factor: int = 1, is_ntt_form: bool = True,
                       is_asymmetric: bool = False) -> Ciphertext:
    """A ciphertext (size, L, N) at `chain_index` with the given metadata
    (NTT form unless is_ntt_form is False, as BFV's are)."""
    if data.shape[1] != ctx.level(chain_index).size:
        raise ValueError("ciphertext limb count does not match its chain index")
    return Ciphertext(word_tensor(ctx, data), chain_index=chain_index, scale=scale,
                      noise_scale_deg=noise_scale_deg, correction_factor=correction_factor,
                      is_ntt_form=is_ntt_form, is_asymmetric=is_asymmetric)


def plaintext_from_np(ctx: FheContext, data: np.ndarray, chain_index: int,
                      scale: float = 1.0, is_ntt_form: bool = True) -> Plaintext:
    """An RNS plaintext (L, N) at `chain_index`, or, on a BFV/BGV context,
    a mod-t plaintext (1, N) in coefficient form."""
    mod_t = ctx.params.plain_modulus is not None and data.shape[0] == 1 and not is_ntt_form
    if data.shape[0] != ctx.level(chain_index).size and not mod_t:
        raise ValueError("plaintext limb count does not match its chain index")
    return Plaintext(word_tensor(ctx, data), chain_index=chain_index, scale=scale,
                     is_ntt_form=is_ntt_form)
