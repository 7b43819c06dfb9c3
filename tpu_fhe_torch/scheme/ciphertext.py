"""Ciphertext / plaintext containers.

Port of ``tpu_fhe/scheme/ciphertext.py`` (metadata: chain index, CKKS
scale, FLEXIBLEAUTO noise-scale degree, BGV's correction factor, the form
of the data and whether a public key encrypted it), without pytree
registration: ``data`` is a tensor of canonical residues and operations
return new objects.  CKKS and BGV ciphertexts are in NTT form, BFV's in
coefficient form; a BFV/BGV plaintext is one (1, N) coefficient-form row
mod t.
``stack_cts`` / ``unstack_cts`` gather same-metadata ciphertexts into one
whose data has a leading batch axis, so that one torch op serves every
channel of a DNN layer.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class Ciphertext:
    data: torch.Tensor          # (size, L, N) residues
    chain_index: int            # index into the context chain (1 = fresh)
    scale: float = 1.0          # CKKS scaling factor
    noise_scale_deg: int = 1    # FLEXIBLEAUTO degree of the scaling factor
    correction_factor: int = 1  # BGV's multiplicative correction (mod t)
    is_ntt_form: bool = True
    is_asymmetric: bool = False  # encrypted with the public key

    @property
    def size(self) -> int:
        return self.data.shape[0]

    def with_data(self, data: torch.Tensor) -> "Ciphertext":
        return replace(self, data=data)


def _meta(ct: Ciphertext) -> tuple:
    return (ct.chain_index, ct.scale, ct.noise_scale_deg, ct.correction_factor,
            ct.is_ntt_form, ct.is_asymmetric)


def stack_cts(cts: list[Ciphertext]) -> Ciphertext:
    """One ciphertext whose data is (B, size, L, N), from B ciphertexts of
    equal metadata (every field but the data), which the batch shares;
    raises ValueError on mismatched metadata."""
    first = cts[0]
    for c in cts[1:]:
        if _meta(c) != _meta(first):
            raise ValueError(f"stack_cts: mismatched ciphertext metadata "
                             f"({_meta(c)} != {_meta(first)})")
    return first.with_data(torch.stack([c.data for c in cts]))


def unstack_cts(ct: Ciphertext, batch: int) -> list[Ciphertext]:
    """The inverse of stack_cts: the first `batch` entries of the leading
    axis as ciphertexts of the shared metadata."""
    return [ct.with_data(ct.data[i]) for i in range(batch)]


@dataclass(frozen=True)
class Plaintext:
    data: torch.Tensor          # (L, N) residues, or (1, N) mod t (BFV/BGV)
    chain_index: int
    scale: float = 1.0
    noise_scale_deg: int = 1
    is_ntt_form: bool = True
