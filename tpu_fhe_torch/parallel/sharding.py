"""Process meshes and the sharding of ciphertexts and keys over them.

Port of ``tpu_fhe/parallel/sharding.py`` as explicit SPMD over
``torch.distributed``: each rank of a process group holds its shard and
calls the collectives itself (``collectives.py``), where the reference's
partitioner inserts them.

A ``Mesh`` names its axes, their sizes, this rank's coordinate on each and
one process group per axis (``dist.new_group``).  ``make_mesh(n_batch,
n_limb)`` builds a ``('batch', 'limb')`` mesh, ``coeff_mesh(n_limb,
n_coeff)`` a ``('limb', 'coeff')`` one; rank r sits at (r // size1, r %
size1), and ranks past the mesh get None.

Row ownership (the limb axis).  The Q limbs and the P limbs of a context
are cut separately: a rank owns a contiguous block of bq = ceil(size_Q /
n_limb) Q rows and one of bp = ceil(size_P / n_limb) P rows, fixed
against the top of the chain.  A shard holds its block in full at every
level: the rows past the level's last limb (and past size_Q or size_P)
are zero pad rows (the reference's ``_pad_limb_axis``).  So a shard's
shape never changes along the chain; dropping a limb turns one of its
owner's rows into a pad row.  A ciphertext's shard is (..., size, bq, N);
a tensor at the extended basis QlP (hoisting's sums, their plaintexts)
holds [its Q block | its P block], (..., bq + bp, N).

Keys.  A switching key is cut by the same rule, on its key-level rows:
rank r keeps Q rows r*bq .. and P rows r*bp .., (dnum, 2, bq + bp, N).
Since the ownership of a Q row does not change with the level, the key's
shard serves every level's QlP rows in place (the inner product's key rows
are 0 .. bq + bp - 1 at every level), and no collective moves key rows.
The reference cuts the key on its size_QP axis and pays for a lower
level's rows with a gather its partitioner inserts.

Every rank must hold the same whole state before it cuts its shard: the
callers draw secrets, keys and ciphertexts once, on one rank, and
``broadcast_state``, ``broadcast_ciphertext``, ``broadcast_relin_key`` and
``broadcast_galois_key`` send them to the others.  ``run_ranks`` spawns the ranks of a world on one
host and returns what each rank's function returns.
"""

from __future__ import annotations

import multiprocessing
import os
import queue as queue_mod
import time
import traceback
from dataclasses import dataclass, replace
from datetime import timedelta

import torch
import torch.distributed as dist

from ..scheme.ciphertext import Ciphertext, Plaintext
from ..scheme.keys import GaloisKey, RelinKey
from . import collectives as coll


@dataclass(frozen=True)
class Mesh:
    """A rank's place in a 2-D process mesh: the axes, their sizes, its
    coordinate on each and its process group (and the group's global
    ranks) along each."""

    axis_names: tuple[str, ...]
    shape: dict                 # axis -> size
    coords: dict                # axis -> this rank's index along it
    groups: dict                # axis -> this rank's process group along it
    group_ranks: dict           # axis -> the global ranks of that group, in order
    backend: str

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]


def _grid_mesh(names: tuple[str, str], sizes: tuple[int, int]) -> Mesh | None:
    """A 2-D mesh over ranks 0 .. s0*s1 - 1, rank = i0 * s1 + i1.  Every
    rank of the world calls it (group creation is collective)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    s0, s1 = sizes
    if s0 < 1 or s1 < 1:
        raise ValueError(f"mesh sizes must be positive, got {s0} x {s1}")
    if s0 * s1 > world:
        raise ValueError(f"mesh {s0}x{s1} needs {s0 * s1} ranks, have {world}")
    groups, members = {}, {}
    for i0 in range(s0):                     # groups along axis 1
        ranks = [i0 * s1 + i1 for i1 in range(s1)]
        g = dist.new_group(ranks)
        if rank in ranks:
            groups[names[1]], members[names[1]] = g, ranks
    for i1 in range(s1):                     # groups along axis 0
        ranks = [i0 * s1 + i1 for i0 in range(s0)]
        g = dist.new_group(ranks)
        if rank in ranks:
            groups[names[0]], members[names[0]] = g, ranks
    if rank >= s0 * s1:
        return None
    return Mesh(axis_names=names, shape={names[0]: s0, names[1]: s1},
                coords={names[0]: rank // s1, names[1]: rank % s1}, groups=groups,
                group_ranks=members, backend=dist.get_backend())


def make_mesh(n_batch: int, n_limb: int) -> Mesh | None:
    """A ('batch', 'limb') mesh of the first n_batch * n_limb ranks."""
    return _grid_mesh(("batch", "limb"), (n_batch, n_limb))


def coeff_mesh(n_limb: int = 1, n_coeff: int | None = None) -> Mesh | None:
    """A ('limb', 'coeff') mesh; n_coeff defaults to the world over n_limb."""
    if n_coeff is None:
        n_coeff = dist.get_world_size() // n_limb
    return _grid_mesh(("limb", "coeff"), (n_limb, n_coeff))


# --------------------------------------------------------------------------
# row ownership on the limb axis
# --------------------------------------------------------------------------

def block(rows: int, n: int) -> int:
    return -(-rows // n)


def owned(rows_top: int, rows_now: int, mesh: Mesh) -> list[int | None]:
    """The rows this rank's block holds, by slot: the global row index, or
    None for a pad slot (past rows_now, the rows at the current level)."""
    b = block(rows_top, mesh.size("limb"))
    first = mesh.index("limb") * b
    return [g if g < rows_now else None for g in range(first, first + b)]


def shard_rows(x: torch.Tensor, rows_top: int, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the row axis (-2) of `x` (rows_now rows), with
    zero pad rows: (..., ceil(rows_top / n_limb), N)."""
    slots = owned(rows_top, x.shape[-2], mesh)
    out = x.new_zeros(x.shape[:-2] + (len(slots), x.shape[-1]))
    real = [s for s, g in enumerate(slots) if g is not None]
    if real:
        out[..., real[0]:real[-1] + 1, :] = x[..., slots[real[0]]:slots[real[-1]] + 1, :]
    return out


def gather_rows(x: torch.Tensor, rows_now: int, mesh: Mesh) -> torch.Tensor:
    """The whole row axis from every rank's block (one all-gather over
    'limb'): the blocks in rank order, cut to the rows_now real rows, which
    precede every pad row."""
    parts = coll.all_gather(x, mesh, "limb")                  # (n, ..., b, N)
    whole = torch.movedim(parts, 0, -3)                       # (..., n, b, N)
    whole = whole.reshape(x.shape[:-2] + (-1, x.shape[-1]))
    return whole[..., :rows_now, :].contiguous()


def _batch_slice(ct_data: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's part of a stacked batch (B, size, L, N), split evenly
    over the 'batch' axis."""
    nb = mesh.size("batch")
    if ct_data.shape[0] % nb:
        raise ValueError(f"a batch of {ct_data.shape[0]} does not split over {nb} ranks")
    per = ct_data.shape[0] // nb
    i = mesh.index("batch")
    return ct_data[i * per:(i + 1) * per]


def shard_ciphertext(ctx, ct: Ciphertext, mesh: Mesh, batched: bool = False) -> Ciphertext:
    """This rank's shard of `ct` (..., size, L, N): its block of Q rows;
    with `batched`, its part of the leading batch axis first."""
    data = _batch_slice(ct.data, mesh) if batched else ct.data
    return ct.with_data(shard_rows(data, ctx.params.size_Q, mesh).contiguous())


def shard_ext(ctx, x: torch.Tensor, size_ql: int, mesh: Mesh) -> torch.Tensor:
    """This rank's [Q block | P block] of a tensor at QlP (..., size_Ql +
    size_P, N)."""
    p = ctx.params
    return torch.cat([shard_rows(x[..., :size_ql, :], p.size_Q, mesh),
                      shard_rows(x[..., size_ql:, :], p.size_P, mesh)], dim=-2).contiguous()


def shard_ext_plaintext(ctx, pt: Plaintext | None, mesh: Mesh) -> Plaintext | None:
    """A plaintext encoded at QlP (encode_ext), cut like shard_ext."""
    if pt is None:
        return None
    size_ql = ctx.level(pt.chain_index).size
    return replace(pt, data=shard_ext(ctx, pt.data, size_ql, mesh))


def shard_relin_key(ctx, key: RelinKey, mesh: Mesh) -> RelinKey:
    """This rank's rows of a switching key (dnum, 2, size_QP, N): its Q
    block, then its P block, (dnum, 2, bq + bp, N); see the module's
    docstring for why no level needs other rows."""
    size_q = ctx.params.size_Q

    def cut(x):
        return None if x is None else shard_ext(ctx, x, size_q, mesh)
    return RelinKey(cut(key.data), cut(key.shoup))


def gather_relin_key(ctx, key: RelinKey, mesh: Mesh) -> RelinKey:
    """The whole switching key from every rank's rows (two all-gathers
    each of data and Shoup words: the Q blocks and the P blocks)."""
    p = ctx.params
    bq = block(p.size_Q, mesh.size("limb"))

    def whole(x):
        if x is None:
            return None
        return torch.cat([gather_rows(x[..., :bq, :], p.size_Q, mesh),
                          gather_rows(x[..., bq:, :], p.size_P, mesh)], dim=-2)
    return RelinKey(whole(key.data), whole(key.shoup))


def gather(ctx, ct: Ciphertext, mesh: Mesh, batched: bool = False) -> Ciphertext:
    """The whole ciphertext from every rank's shard, on every rank: one
    all-gather over 'limb' and, with `batched`, one over 'batch'."""
    data = gather_rows(ct.data, ctx.level(ct.chain_index).size, mesh)
    if batched:
        parts = coll.all_gather(data, mesh, "batch")
        data = parts.reshape((-1,) + parts.shape[2:])
    return ct.with_data(data)


def broadcast_state(x: torch.Tensor | None, shape, dtype, device, src: int = 0) -> torch.Tensor:
    """Rank `src`'s `x` on every rank of the world: state drawn once that
    every rank must hold the same.  The other ranks pass None and the
    shape, dtype and device of what they receive."""
    buf = x if x is not None else torch.empty(shape, dtype=dtype, device=device)
    return coll.broadcast(buf, None, None, src)


def _head(obj, src: int):
    """Rank `src`'s small Python object (shapes, metadata) on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def broadcast_ciphertext(ct: Ciphertext | None, device, src: int = 0) -> Ciphertext:
    """Rank `src`'s ciphertext (data and metadata) on every rank; the
    others pass None."""
    mine = dist.get_rank() == src
    shape, dtype, meta = _head((tuple(ct.data.shape), ct.data.dtype, replace(ct, data=None))
                               if mine else None, src)
    return replace(meta, data=broadcast_state(ct.data if mine else None, shape, dtype, device,
                                              src))


def broadcast_relin_key(key: RelinKey | None, device, src: int = 0) -> RelinKey:
    """Rank `src`'s switching key (and its Shoup words) on every rank."""
    mine = dist.get_rank() == src
    shape, dtype, shoup = _head((tuple(key.data.shape), key.data.dtype, key.shoup is not None)
                                if mine else None, src)
    data = broadcast_state(key.data if mine else None, shape, dtype, device, src)
    words = broadcast_state(key.shoup if mine else None, shape, dtype, device, src) \
        if shoup else None
    return RelinKey(data, words)


def broadcast_galois_key(gk: GaloisKey | None, device, src: int = 0) -> GaloisKey:
    """Rank `src`'s Galois keys on every rank, element by element."""
    elts = _head(sorted(gk.keys) if dist.get_rank() == src else None, src)
    return GaloisKey({elt: broadcast_relin_key(gk.keys[elt] if dist.get_rank() == src
                                               else None, device, src) for elt in elts})


# --------------------------------------------------------------------------
# spawning the ranks
# --------------------------------------------------------------------------

def _rank_main(rank, world, init_file, backend, timeout_s, fn, args, results):
    if backend == "gloo":
        # the ranks share one host: gloo's transport on the loopback device
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world, *args)
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise
    else:
        results.put((rank, "ok", out))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, args: tuple = (), *, init_file: str, backend: str = "gloo",
              timeout_s: float = 300.0) -> list:
    """Run fn(rank, world, *args) in `world` new processes (spawned), joined
    in one process group of `backend` through the rendezvous file
    `init_file` (a path that does not exist yet, on a file system every
    rank sees); collectives time out after timeout_s.  Returns each rank's
    return value (picklable: numpy and Python values), in rank order.
    Raises, after stopping every rank, when a rank fails (at its first
    failure) or the world does not finish within twice timeout_s."""
    mp = multiprocessing.get_context("spawn")
    results = mp.Queue()
    procs = [mp.Process(target=_rank_main, daemon=True,
                        args=(r, world, init_file, backend, timeout_s, fn, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, []
    deadline = time.monotonic() + 2 * timeout_s
    try:
        while len(got) + len(errors) < world:
            try:
                rank, status, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    errors.append(f"rank(s) {[procs.index(p) for p in dead]} exited with "
                                  f"{[p.exitcode for p in dead]} and no result")
                    break
                if time.monotonic() > deadline:
                    errors.append(f"the world did not finish within {2 * timeout_s:.0f} s")
                    break
                continue
            if status != "ok":
                errors.append(f"rank {rank}:\n{value}")
                break       # the other ranks may wait in a collective: stop them
            got[rank] = value
    finally:
        for p in procs:
            p.join(timeout=None if not errors else 5)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    if errors:
        raise RuntimeError("run_ranks: " + "\n".join(errors))
    return [got[r] for r in range(world)]
