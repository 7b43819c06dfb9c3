"""Samplers for RLWE, drawn from a caller-seeded ``torch.Generator``.

Port of ``tpu_fhe/scheme/prng.py`` with the same distributions:
  * uniform residues mod q_i (per-limb uniform == uniform over R_Q by CRT),
  * ternary secret in {-1, 0, 1},
  * centered binomial error, popcount of 21 bits minus popcount of 21 bits
    (sigma ~= 3.24).
The generator is torch's, not JAX's threefry, so the bits differ from the
reference's for the same seed; tests hand both packages the same samples.
Every output is (L, n) int64 with -x represented as q_i - x.
"""

from __future__ import annotations

import torch


def sample_uniform(gen: torch.Generator, q: torch.Tensor, n: int) -> torch.Tensor:
    """(L, n) with row i uniform in [0, q_i); q: (L, 1) on the generator's device."""
    rows = [
        torch.randint(0, int(qi), (n,), generator=gen, dtype=torch.int64, device=q.device)
        for qi in q.reshape(-1).tolist()
    ]
    return torch.stack(rows)


def _lift_signed(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Small signed (1, n) values -> (L, n) residues mod every q_i."""
    return torch.where(v < 0, q + v, v.expand(q.shape[0], -1))


def sample_ternary(gen: torch.Generator, q: torch.Tensor, n: int) -> torch.Tensor:
    """One length-n vector in {-1, 0, 1} lifted to every limb of q (L, 1)."""
    r = torch.randint(0, 3, (1, n), generator=gen, dtype=torch.int64, device=q.device)
    return _lift_signed(r - 1, q)


def sample_cbd_error(gen: torch.Generator, q: torch.Tensor, n: int) -> torch.Tensor:
    """Centered binomial popcount(21 bits) - popcount(21 bits), lifted to
    every limb of q (L, 1)."""
    bits = torch.randint(0, 2, (2, 21, n), generator=gen, dtype=torch.int64, device=q.device)
    pop = bits.sum(dim=1)
    return _lift_signed((pop[0] - pop[1]).reshape(1, n), q)
