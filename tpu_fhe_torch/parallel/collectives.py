"""The collectives of the sharded paths, each call counted by kind and bytes.

The reference gets its collectives from XLA's partitioner and counts them
in the compiled HLO (``tpu_fhe/parallel/boot_sharded.py`` ``collective_stats``).
The port calls them itself, through the three functions here, and counts
every call in this process: ``counts()`` gives, per kind, the calls and the
bytes this rank put in (its shard for an all-gather and an all-to-all, the
tensor for a broadcast; the bytes a rank receives are the group size times
that for an all-gather).  ``reset_counts()`` sets them to 0.

Every function works on one axis of a ``sharding.Mesh`` (the process group
of this rank along that axis).  Under the ``gloo`` backend every CUDA
tensor goes through host memory: it is copied to the host, the collective
runs there, and the result is copied back to the tensor's device.  gloo's
CUDA support differs by collective and build (it has no all-to-all on CUDA
tensors), so the rule is the same for all three kinds, fixed by the
backend alone.  Under ``nccl`` the tensors stay on the device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

KINDS = ("all_gather", "all_to_all", "broadcast")
_COUNTS = {kind: {"calls": 0, "bytes": 0} for kind in KINDS}


def reset_counts() -> None:
    for entry in _COUNTS.values():
        entry.update(calls=0, bytes=0)


def counts() -> dict:
    """{kind: {"calls": n, "bytes": b}} for every kind called at least once."""
    return {kind: dict(e) for kind, e in _COUNTS.items() if e["calls"]}


def diff(after: dict, before: dict) -> dict:
    """The calls and bytes between two ``counts()`` snapshots."""
    out = {}
    for kind, e in after.items():
        b = before.get(kind, {"calls": 0, "bytes": 0})
        if e["calls"] != b["calls"]:
            out[kind] = {"calls": e["calls"] - b["calls"], "bytes": e["bytes"] - b["bytes"]}
    return out


def _count(kind: str, x: torch.Tensor) -> None:
    _COUNTS[kind]["calls"] += 1
    _COUNTS[kind]["bytes"] += x.numel() * x.element_size()


def _staged(mesh, x: torch.Tensor) -> torch.Tensor:
    """The tensor the backend is given: a contiguous host copy of a CUDA
    tensor under gloo, else `x` itself (contiguous)."""
    if mesh.backend == "gloo" and x.is_cuda:
        return x.detach().to("cpu").contiguous()
    return x.contiguous()


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank's `x` along `axis`, stacked in the axis' order:
    (size, *x.shape) on x's device."""
    _count("all_gather", x)
    src = _staged(mesh, x)
    out = [torch.empty_like(src) for _ in range(mesh.size(axis))]
    dist.all_gather(out, src, group=mesh.groups[axis])
    return torch.stack(out).to(x.device)


def all_to_all_single(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """x (size, ...) with block j sent to the j-th rank along `axis`;
    returns (size, ...) with block j received from the j-th rank."""
    if x.shape[0] != mesh.size(axis):
        raise ValueError(f"all_to_all_single: {x.shape[0]} blocks for an axis of "
                         f"{mesh.size(axis)}")
    _count("all_to_all", x)
    src = _staged(mesh, x)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.groups[axis])
    return out.to(x.device)


def broadcast(x: torch.Tensor, mesh, axis: str | None, src_index: int) -> torch.Tensor:
    """The `src_index`-th rank's `x` along `axis` on every rank of it (the
    others pass a tensor of the same shape and dtype, whose values are not
    read).  With mesh and axis None, over the whole world from rank
    src_index."""
    _count("broadcast", x)
    gloo = (mesh.backend if mesh is not None else dist.get_backend()) == "gloo"
    buf = x.detach().to("cpu").contiguous() if gloo and x.is_cuda else x.clone()
    if mesh is None:
        dist.broadcast(buf, src=src_index)
    else:
        dist.broadcast(buf, src=mesh.group_ranks[axis][src_index], group=mesh.groups[axis])
    return buf.to(x.device)
