"""The negacyclic NTT with the ring dimension sharded: the 4-step form.

Port of ``tpu_fhe/parallel/ntt4step.py``.  Viewing a degree-N polynomial as
an N1 x N2 matrix (coefficient i * N2 + j at row i, column j), the stages
m < N1 pair elements across rows with twiddles that depend on the row
block alone (local when the columns are sharded), and the stages m >= N1
pair elements within a row (local when the rows are sharded).  One
``all_to_all_single`` over the mesh's 'coeff' axis between the two phases
distributes the transform, in each direction.  The stages are those of
``ops/ntt.py``'s plain version (the same bit-reversed twiddle slices, Shoup
butterflies landing in [0, q)), so the output equals ``forward_ntt`` bit
for bit.  The reference computes these stages as XLA ops, outside any
Pallas kernel; here they are torch ops on the port's plain modular
arithmetic (``ops/modarith.py``: the 64-bit Shoup multiply, or the
single-word one on int32 tables), on either word.

Layouts of a rank's shard, with c ranks on 'coeff' at index r:

  * columns (``cols_shard``): columns r*N2/c .. of every row, (..., L,
    N1 * N2/c) -- the input of the forward transform and the output of
    the inverse;
  * rows (``rows_shard``): rows r*N1/c .. whole, (..., L, N/c), the
    contiguous r-th chunk of the N axis -- the output of the forward
    transform and the input of the inverse.
"""

from __future__ import annotations

import torch

from ..ops import modarith as ma
from ..ops.ntt import DeviceNTTTables
from . import collectives as coll
from .sharding import Mesh

AXIS = "coeff"


def split_n(n: int, n1: int | None) -> tuple[int, int]:
    if n1 is None:
        log_n = n.bit_length() - 1
        n1 = 1 << (log_n // 2)
    n2 = n // n1
    if n1 * n2 != n or n1 < 2 or n2 < 2:
        raise ValueError(f"invalid N1 x N2 split {n1} x {n2} for N={n}")
    return n1, n2


def _dims(t: DeviceNTTTables, mesh: Mesh, n1: int | None):
    n1, n2 = split_n(t.n, n1)
    c = mesh.size(AXIS)
    if n1 % c or n2 % c:
        raise ValueError(f"a {n1} x {n2} split does not cut over {c} ranks")
    return n1, n2, c, mesh.index(AXIS)


def _rows_of(tab: torch.Tensor, t: DeviceNTTTables) -> torch.Tensor:
    return tab.index_select(0, t.limb_map)


def _butterfly(a, b, w, ws, q):
    v = ma.mul_shoup(b, w, ws, q)
    return ma.add_mod(a, v, q), ma.sub_mod(a, v, q)


def _inv_butterfly(a, b, w, ws, q):
    return ma.add_mod(a, b, q), ma.mul_shoup(ma.sub_mod(a, b, q), w, ws, q)


def forward_ntt_4step(x: torch.Tensor, t: DeviceNTTTables, mesh: Mesh,
                      n1: int | None = None) -> torch.Tensor:
    """Columns shard (..., L, N/c) in [0, q) -> rows shard of the NTT form,
    bit-identical to the rank's chunk of ``ops.ntt.forward_ntt``: one
    all-to-all."""
    n1, n2, c, r = _dims(t, mesh, n1)
    n, L, lead = t.n, t.num_limbs, x.shape[:-2]
    w2, h1 = n2 // c, n1 // c
    roots, roots_shoup = _rows_of(t.roots, t), _rows_of(t.roots_shoup, t)
    qb = t.q.reshape(L, 1, 1, 1)
    x3 = x.reshape(lead + (L, n1, w2))
    m = 1
    while m < n1:                      # column stages: pairs across rows
        ttr = n1 // (2 * m)
        xr = x3.reshape(lead + (L, m, 2, ttr, w2))
        w = roots[:, m:2 * m].reshape(L, m, 1, 1)
        ws = roots_shoup[:, m:2 * m].reshape(L, m, 1, 1)
        a2, b2 = _butterfly(xr[..., 0, :, :], xr[..., 1, :, :], w, ws, qb)
        x3 = torch.stack([a2, b2], dim=-3).reshape(lead + (L, n1, w2))
        m <<= 1
    # columns -> rows: block s holds rows s*h1 .. of this rank's columns
    blocks = torch.movedim(x3.reshape(lead + (L, c, h1, w2)), -3, 0).contiguous()
    recv = coll.all_to_all_single(blocks, mesh, AXIS)        # [s]: rank s's columns
    x3 = torch.movedim(recv, 0, -2).reshape(lead + (L, h1, n2))
    rows = slice(r * h1, (r + 1) * h1)
    while m < n:                       # row stages: pairs within rows
        m2 = m // n1
        tt = n2 // (2 * m2)
        xr = x3.reshape(lead + (L, h1, m2, 2, tt))
        w = roots[:, m:2 * m].reshape(L, n1, m2, 1)[:, rows]
        ws = roots_shoup[:, m:2 * m].reshape(L, n1, m2, 1)[:, rows]
        a2, b2 = _butterfly(xr[..., 0, :], xr[..., 1, :], w, ws, qb)
        x3 = torch.stack([a2, b2], dim=-2).reshape(lead + (L, h1, n2))
        m <<= 1
    return x3.reshape(lead + (L, h1 * n2))


def inverse_ntt_4step(x: torch.Tensor, t: DeviceNTTTables, mesh: Mesh,
                      n1: int | None = None) -> torch.Tensor:
    """Rows shard of the NTT form -> columns shard (with the 1/n scale),
    bit-identical to ``ops.ntt.inverse_ntt``: one all-to-all."""
    n1, n2, c, r = _dims(t, mesh, n1)
    n, L, lead = t.n, t.num_limbs, x.shape[:-2]
    w2, h1 = n2 // c, n1 // c
    inv_roots, inv_shoup = _rows_of(t.inv_roots, t), _rows_of(t.inv_roots_shoup, t)
    qb = t.q.reshape(L, 1, 1, 1)
    x3 = x.reshape(lead + (L, h1, n2))
    rows = slice(r * h1, (r + 1) * h1)
    m, tt = n, 1
    while m > n1:                      # row stages first
        h = m >> 1
        h2 = h // n1
        xr = x3.reshape(lead + (L, h1, h2, 2, tt))
        w = inv_roots[:, h:m].reshape(L, n1, h2, 1)[:, rows]
        ws = inv_shoup[:, h:m].reshape(L, n1, h2, 1)[:, rows]
        u, v = _inv_butterfly(xr[..., 0, :], xr[..., 1, :], w, ws, qb)
        x3 = torch.stack([u, v], dim=-2).reshape(lead + (L, h1, n2))
        tt <<= 1
        m = h
    # rows -> columns: block s holds columns s*w2 .. of this rank's rows
    blocks = torch.movedim(x3.reshape(lead + (L, h1, c, w2)), -2, 0).contiguous()
    recv = coll.all_to_all_single(blocks, mesh, AXIS)        # [s]: rank s's rows
    x3 = torch.movedim(recv, 0, -3).reshape(lead + (L, n1, w2))
    while m > 1:                       # column stages
        h = m >> 1
        ttr = n1 // m
        xr = x3.reshape(lead + (L, h, 2, ttr, w2))
        w = inv_roots[:, h:m].reshape(L, h, 1, 1)
        ws = inv_shoup[:, h:m].reshape(L, h, 1, 1)
        u, v = _inv_butterfly(xr[..., 0, :, :], xr[..., 1, :, :], w, ws, qb)
        x3 = torch.stack([u, v], dim=-3).reshape(lead + (L, n1, w2))
        m = h
    out = x3.reshape(lead + (L, n1 * w2))
    inv_n = _rows_of(t.inv_degree, t).reshape(L, 1)
    inv_n_shoup = _rows_of(t.inv_degree_shoup, t).reshape(L, 1)
    return ma.mul_shoup(out, inv_n, inv_n_shoup, t.q)


# --------------------------------------------------------------------------
# whole <-> shard in either layout
# --------------------------------------------------------------------------

def rows_shard(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous chunk of the N axis of (..., N)."""
    c, r = mesh.size(AXIS), mesh.index(AXIS)
    w = x.shape[-1] // c
    return x[..., r * w:(r + 1) * w].contiguous()


def cols_shard(x: torch.Tensor, mesh: Mesh, n1: int | None = None) -> torch.Tensor:
    """This rank's columns of (..., N) seen as N1 x N2: (..., N1 * N2/c)."""
    n1, n2 = split_n(x.shape[-1], n1)
    c, r = mesh.size(AXIS), mesh.index(AXIS)
    w2 = n2 // c
    x3 = x.reshape(x.shape[:-1] + (n1, n2))[..., r * w2:(r + 1) * w2]
    return x3.reshape(x.shape[:-1] + (n1 * w2,)).contiguous()


def gather_rows_layout(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole (..., N) from every rank's rows shard (one all-gather)."""
    parts = coll.all_gather(x, mesh, AXIS)                    # (c, ..., N/c)
    return torch.movedim(parts, 0, -2).reshape(x.shape[:-1] + (-1,))


def gather_cols_layout(x: torch.Tensor, mesh: Mesh, n1: int | None = None) -> torch.Tensor:
    """The whole (..., N) from every rank's columns shard (one all-gather)."""
    c = mesh.size(AXIS)
    n = x.shape[-1] * c
    n1, n2 = split_n(n, n1)
    parts = coll.all_gather(x.reshape(x.shape[:-1] + (n1, n2 // c)), mesh, AXIS)
    return torch.movedim(parts, 0, -2).reshape(x.shape[:-1] + (n,))
