"""Ciphertext / plaintext containers.

Port of ``tpu_fhe/scheme/ciphertext.py`` (CKKS metadata: chain index,
scale, FLEXIBLEAUTO noise-scale degree), without pytree registration:
``data`` is an int64 tensor of canonical residues and operations return
new objects.  Ciphertexts are always in NTT form in this slice.
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

    @property
    def size(self) -> int:
        return self.data.shape[0]

    def with_data(self, data: torch.Tensor) -> "Ciphertext":
        return replace(self, data=data)


@dataclass(frozen=True)
class Plaintext:
    data: torch.Tensor          # (L, N) residues
    chain_index: int
    scale: float = 1.0
    noise_scale_deg: int = 1
    is_ntt_form: bool = True
