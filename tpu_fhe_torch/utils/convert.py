"""Carry state between the JAX package's numpy form and the port's tensors.

The JAX package hands its state over as numpy ``uint64`` arrays (its
``W64.to_np()``): the secret key in NTT form (QP, N), switching-key data
(dnum, 2, QP, N) and its Shoup words, ciphertexts (size, L, N) and
plaintexts (L, N).  These helpers turn such arrays into the port's int64
tensors of the same bits on a device, and back.  They take plain numpy, so
the port never imports the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.modarith import u64_tensor as to_tensor
from ..scheme.ciphertext import Ciphertext, Plaintext
from ..scheme.context import FheContext
from ..scheme.keys import RelinKey, SecretKey


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> uint64 numpy array of the same bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def secret_key_from_np(ctx: FheContext, s_ntt: np.ndarray,
                       seed: int | torch.Generator = 0) -> SecretKey:
    """The port's secret key for the reference's s_ntt (QP, N); `seed`
    seeds the generator of any later sampling."""
    return SecretKey(ctx, seed=seed, s_ntt=to_tensor(s_ntt, ctx.device))


def relin_key_from_np(ctx: FheContext, data: np.ndarray,
                      shoup: np.ndarray | None = None) -> RelinKey:
    return RelinKey(to_tensor(data, ctx.device),
                    None if shoup is None else to_tensor(shoup, ctx.device))


def relin_key_to_np(key: RelinKey) -> tuple[np.ndarray, np.ndarray | None]:
    return to_numpy(key.data), None if key.shoup is None else to_numpy(key.shoup)


def ciphertext_from_np(ctx: FheContext, data: np.ndarray, chain_index: int,
                       scale: float = 1.0, noise_scale_deg: int = 1) -> Ciphertext:
    """An NTT-form ciphertext (size, L, N) at `chain_index`."""
    if data.shape[1] != ctx.level(chain_index).size:
        raise ValueError("ciphertext limb count does not match its chain index")
    return Ciphertext(to_tensor(data, ctx.device), chain_index=chain_index, scale=scale,
                      noise_scale_deg=noise_scale_deg)


def plaintext_from_np(ctx: FheContext, data: np.ndarray, chain_index: int,
                      scale: float = 1.0, is_ntt_form: bool = True) -> Plaintext:
    if data.shape[0] != ctx.level(chain_index).size:
        raise ValueError("plaintext limb count does not match its chain index")
    return Plaintext(to_tensor(data, ctx.device), chain_index=chain_index, scale=scale,
                     is_ntt_form=is_ntt_form)
