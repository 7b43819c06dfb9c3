"""Accumulating named timers.

Port of the accumulators of ``tpu_fhe/utils/timer.py`` (the reference's
Timer namespace of cudaEvent buckets): ``section(name)`` adds the host-clock
seconds of its block to the bucket `name`, after synchronizing the CUDA
device when one is in use, so that a bucket owns the device work enqueued
inside it.  ResNet-20's inference fills the buckets Convolution, BatchNorm,
Relu, Bootstrap and PoolFC.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

_ACC: dict[str, float] = defaultdict(float)
_COUNT: dict[str, int] = defaultdict(int)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def section(name: str):
    """Add the seconds of the block to bucket `name` (one more count)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        _ACC[name] += time.perf_counter() - t0
        _COUNT[name] += 1


def accumulated() -> dict[str, float]:
    """Seconds by bucket."""
    return dict(_ACC)


def counts() -> dict[str, int]:
    """Sections entered by bucket."""
    return dict(_COUNT)


def add_accumulated(name: str, seconds: float):
    """Add seconds recorded elsewhere to bucket `name` (a checkpoint's
    buckets, restored on resume)."""
    _ACC[name] += seconds


def print_accumulated(out=print):
    """Every bucket, the largest first: ms and the sections entered."""
    width = max((len(k) for k in _ACC), default=4)
    for name, total in sorted(_ACC.items(), key=lambda kv: -kv[1]):
        out(f"  {name:<{width}}  {total * 1e3:10.2f} ms  (x{_COUNT[name]})")


def clear():
    _ACC.clear()
    _COUNT.clear()
