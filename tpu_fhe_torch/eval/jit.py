"""Evaluator facade that replays one CUDA graph per operation and level.

Port of ``tpu_fhe/eval/jit.py``.  The reference compiles one program per
(op, chain index, ciphertext size, scale); here each method keeps one
``torch.cuda.CUDAGraph`` per (op, metadata of every operand, key, Galois
element), where an operand's metadata is its type, chain index, shape,
word, scale and noise-scale degree.  The first call of a signature runs
the op once eagerly on a side stream (this builds the kernels and fills
the context's table caches, so nothing is copied from the host during
capture), then captures it on static copies of its inputs.  Every call
copies its inputs into those buffers, replays the graph and returns clones
of the outputs, so a result never aliases a later replay.  All graphs of
one Evaluator share one memory pool and replay in turn on the current
stream: their static inputs and outputs stay referenced, and their
intermediates live only within a replay.

If a capture or a replay fails, the method raises; it never falls back to
the eager op.  On a CPU context (the caller asked for the CPU, as the tests
do) every method calls the module function eagerly.

The kernels' launch counters count in Python, so they see the one capture
of a graph and not its replays.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..ops.galois import conj_elt, galois_elt_from_step
from ..scheme.ciphertext import Ciphertext, Plaintext
from ..scheme.context import FheContext
from ..scheme.keys import GaloisKey, RelinKey
from . import evaluator as ev


@dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    inputs: list[torch.Tensor]     # static input buffers, in operand order
    output: Ciphertext             # data in the graph's pool
    keys: tuple                    # keys the graph reads in place, kept alive


def _meta(x: Ciphertext | Plaintext) -> tuple:
    return (type(x).__name__, x.chain_index, tuple(x.data.shape), x.data.dtype, x.scale,
            x.noise_scale_deg)


class Evaluator:
    def __init__(self, ctx: FheContext):
        self.ctx = ctx
        self._graphs: dict[tuple, _Graph] = {}
        self._pool = torch.cuda.graph_pool_handle() if ctx.device.type == "cuda" else None

    @property
    def num_graphs(self) -> int:
        return len(self._graphs)

    def _run(self, op: str, fn, operands: tuple, keys: tuple = (), static: tuple = ()):
        """fn(*operands, *keys): eagerly on a CPU context, else by the graph
        of this signature (captured on first use)."""
        if self._pool is None:
            return fn(*operands, *keys)
        sig = (op, static, tuple(_meta(x) for x in operands), tuple(id(k) for k in keys))
        entry = self._graphs.get(sig)
        if entry is None:
            entry = self._graphs[sig] = self._capture(op, fn, operands, keys)
        for buf, x in zip(entry.inputs, operands):
            buf.copy_(x.data)
        try:
            entry.graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"Evaluator.{op}: CUDA graph replay failed") from e
        return replace(entry.output, data=entry.output.data.clone())

    def _capture(self, op: str, fn, operands: tuple, keys: tuple) -> _Graph:
        static = [replace(x, data=x.data.clone()) for x in operands]
        side = torch.cuda.Stream(device=self.ctx.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*static, *keys)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                out = fn(*static, *keys)
        except RuntimeError as e:
            raise RuntimeError(f"Evaluator.{op}: CUDA graph capture failed") from e
        return _Graph(graph, [x.data for x in static], out, keys)

    # arithmetic ---------------------------------------------------------
    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._run("add", lambda x, y: ev.add(self.ctx, x, y), (a, b))

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._run("sub", lambda x, y: ev.sub(self.ctx, x, y), (a, b))

    def negate(self, a: Ciphertext) -> Ciphertext:
        return self._run("negate", lambda x: ev.negate(self.ctx, x), (a,))

    def add_plain(self, a: Ciphertext, p: Plaintext) -> Ciphertext:
        return self._run("add_plain", lambda x, y: ev.add_plain(self.ctx, x, y), (a, p))

    def sub_plain(self, a: Ciphertext, p: Plaintext) -> Ciphertext:
        return self._run("sub_plain", lambda x, y: ev.sub_plain(self.ctx, x, y), (a, p))

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._run("multiply", lambda x, y: ev.multiply(self.ctx, x, y), (a, b))

    def multiply_plain(self, a: Ciphertext, p: Plaintext) -> Ciphertext:
        return self._run("multiply_plain", lambda x, y: ev.multiply_plain(self.ctx, x, y),
                         (a, p))

    def square(self, a: Ciphertext) -> Ciphertext:
        return self._run("square", lambda x: ev.square(self.ctx, x), (a,))

    def relinearize(self, a: Ciphertext, rlk: RelinKey) -> Ciphertext:
        return self._run("relinearize", lambda x, k: ev.relinearize(self.ctx, x, k), (a,),
                         (rlk,))

    def multiply_relin(self, a: Ciphertext, b: Ciphertext, rlk: RelinKey) -> Ciphertext:
        return self._run(
            "multiply_relin",
            lambda x, y, k: ev.relinearize(self.ctx, ev.multiply(self.ctx, x, y), k),
            (a, b), (rlk,))

    def square_relin(self, a: Ciphertext, rlk: RelinKey) -> Ciphertext:
        return self._run(
            "square_relin", lambda x, k: ev.relinearize(self.ctx, ev.square(self.ctx, x), k),
            (a,), (rlk,))

    def rescale(self, a: Ciphertext) -> Ciphertext:
        return self._run("rescale", lambda x: ev.rescale_to_next(self.ctx, x), (a,))

    def mod_drop(self, a: Ciphertext) -> Ciphertext:
        return self._run("mod_drop", lambda x: ev.mod_drop_to_next(self.ctx, x), (a,))

    # rotations ----------------------------------------------------------
    def _apply_galois(self, a: Ciphertext, elt: int, gk: GaloisKey) -> Ciphertext:
        return self._run(
            "apply_galois", lambda x, k: ev.apply_galois_with_key(self.ctx, x, elt, k), (a,),
            (gk.key_for_elt(elt),), (elt,))

    def rotate(self, a: Ciphertext, step: int, gk: GaloisKey) -> Ciphertext:
        elt = galois_elt_from_step(step, self.ctx.n)
        if elt == 1:
            return a
        return self._apply_galois(a, elt, gk)

    def conjugate(self, a: Ciphertext, gk: GaloisKey) -> Ciphertext:
        return self._apply_galois(a, conj_elt(self.ctx.n), gk)
