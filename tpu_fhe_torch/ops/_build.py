"""Build and load the port's CUDA kernels (``tpu_fhe_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface and loaded with ``ctypes``.  Libraries go under
``build/tpu_fhe_torch/`` beside the package, in a directory keyed by a hash
of the sources and flags, at first use; ``build_all`` compiles every source
at once, one ``nvcc`` each, all started together.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``CudaKernel.__call__`` raises when that is not 0
and otherwise adds one to the kernel's launch counter.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "tpu_fhe_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return str(path)


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all(sources: list[str] | None = None) -> dict[str, str]:
    """Compile every named source (default: all of csrc/*.cu) that is not
    built yet, in parallel.  Returns each source's compiler output (the
    ``-Xptxas -v`` register and shared-memory report); raises on failure."""
    sources = sources or sorted(p.name for p in CSRC.glob("*.cu"))
    d = _build_dir()
    d.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        out = d / f"lib{Path(src).stem}.so"
        if not out.exists():
            # build under a private name, then rename: a concurrent loader
            # never sees a half-written library
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            procs[src] = (proc, tmp, out)
    logs = {}
    failed = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[src] = log
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one csrc source, built on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            path = _build_dir() / f"lib{Path(source).stem}.so"
            if not path.exists():
                build_all([source])
            lib = _libs[source] = ctypes.CDLL(str(path))
        return lib


PTR = ctypes.c_void_p
INT = ctypes.c_int


class CudaKernel:
    """One C entry point of a csrc library, with its launch counter.

    ``launches`` counts successful launches made through this wrapper and
    nothing else; callers may reset it to 0."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list,
                 replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = [*self.argtypes, PTR]
            fn.restype = INT
            self._fn = fn
        rc = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: launch failed with CUDA error {rc}")
        self.launches += 1


def ptr(t) -> int | None:
    """Device pointer of a tensor (None passes a null pointer)."""
    return None if t is None else t.data_ptr()
