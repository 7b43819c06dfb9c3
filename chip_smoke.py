#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's CKKS, BFV and BGV slices on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure (nothing is caught and
turned into a pass, and nothing runs on the CPU when there is no card):

 1. device: the card's name and power limit (nvidia-smi);
 2. build: every kernel of tpu_fhe_torch/csrc, one nvcc each, in parallel.

Then, for each plan in turn -- the u64 plan (bench.py's primary
configuration: N = 2^15, 30 + 15 primes of 50/60 bits, scale 2^50) and the
q32 plan of composite scaling (N = 2^15, CoeffModulus.create_composite with
29 data pairs: 60 + 30 primes of 29-30 bits, scale 2^58) --

 3. kernels: each kernel of the plan against its plain torch version on
    the card, at the plan's full-width keyswitch shapes, integer-exact,
    with its device time (CUDA events around a CUDA-graph replay of 20
    launches), the plain version's time and the least time the card could
    take (bytes at 3.35 TB/s against IMADs at 64 per SM and clock plus
    int8 tensor-core operations at 1,979 TOP/s; base conversion counted
    in its digit-plane form); the one-cluster-launch NTTs also at 2^16
    and 2^17, the ring sizes where the cluster shape changes: on the u64
    plan K1 and K2 (scaled) on 30 limbs of 50/60 bits, on the q32 plan K4
    and K5 (scaled) on 59 limbs of 30 bits and K6 on 2 rows of them; a
    profile of 10 calls of each cluster NTT on the path at 2^15 that must
    see that one device kernel alone (u64: K1 at (30, 2^15) fwd_cluster,
    K2 at (30, 2^15) scaled inv_cluster, K3 at (2, 30, 2^15) fwd_cluster
    with the Landing epilogue; q32: K5 at (59, 2^15) scaled inv_cluster,
    K6 at (2, 59, 2^15) fwd_cluster with the Landing epilogue; a profile
    that lost events is taken again, up to 3 in all); on the u64
    plan K11 (the SIMT kernel, off the path since K12 takes k < 64) at 64
    -> 30 and, called directly, at 15 -> 30; on the q32 plan also K4 and
    K5 against K1 and K2 on the same 30-bit moduli, and torch._int_mm on
    bconv32's int8 operands as a yardstick of its product part; and, once
    phases 3 to 6 of both plans are done (after every one-launch profile),
    every kernel of the flagship bootstrap (phase 10) at its widest
    keyswitch, on phase 10's context at chain index 1 (N = 2^16; u64 26 +
    13 limbs: K1 on a digit's 26 complement limbs, K2 scaled on (26) and
    (2, 13), K3 on (2, 26), K12 13 -> 26 on 1 and 2 rows, K8 and K7 on t
    (2, 39) with keys of 2 digits; q32 52 + 26 limbs: K4 on 52, K5 scaled
    on (52) and (2, 26), K6 on (2, 52), K13 26 -> 52 on 1 and 2 rows, K10
    and K9 on t (2, 78));
 4. requests: keys, then 4 requests of encode -> encrypt (symmetric and
    asymmetric) -> multiply -> relinearize -> rescale (rescale_composite by
    a prime pair on the q32 plan) -> decrypt -> decode, each within 1e-6 of
    the cleartext product; every kernel of the path must have been
    launched during the requests (its counter is set to 0 just before),
    with the launches split by step; one relinearize is held bit-exact
    against the plain versions;
 5. timing: keyswitch ms/op and keyswitch/s (relinearize of a random
    size-3 ciphertext, bench.py's median-of-pairs marginal), launches per
    relinearize, and a device-only torch.profiler window of 10
    relinearizes: kernel time by name and the device's busy share (no
    two-phase NTT kernel may appear on either plan);
 6. rotations: Galois keys for steps 1, 2, 4, -1 and conjugation (no
    Shoup words, so the inner product is K7 on the u64 plan and K9 on the
    q32 plan), then 2 requests of encode -> encrypt -> rotate by 1, 2, -1
    and by 3 (no key: -1 then +4) -> conjugate -> hoisted rotation sum over
    steps 0, 1, 2, 4 -> decrypt -> decode, each within 1e-6 of np.roll /
    conj / the sum of rolls (results are mod-dropped to a few limbs before
    decryption); every kernel of the path launched (counters set to 0
    first); one rotate and one hoisted sum held bit-exact against the plain
    versions; rotate ms/op and rotations/s (median-of-pairs marginal),
    launches per rotate, a profiler window of 10 rotates, and a hoisted sum
    over 4 steps against 4 separate rotates and 3 adds;
 7. graphs: every method of the graph-replaying Evaluator (eval/jit.py)
    through its CUDA graph bit-identical to the eager op at chain index 1,
    a replay on new inputs leaving an earlier result as it was, then eager
    against graph ms/op for relinearize, multiply_relin and rotate (a
    graph's launches are its eager launches once per replay: the counters
    count in Python and see the capture, not the replays), a profile of
    each op's replays and the peak device memory;
 8. EvalMod, the bootstrap's sine stage (Chebyshev series -> mod_reduce ->
    double angles, on eval/chebyshev.py and eval/auto.py): the sparse set
    K = 28, r = 3, degree 44 on the u64 plan and the default K = 512, r = 6,
    degree 88 on the q32 plan, on N/2 real slots uniform in [-1, 1] at chain
    index 1, within 1e-5 of the float64 cleartext, every kernel of the path
    launched (counters set to 0 first), bit-exact against the plain
    versions, ms per EvalMod and a profile;
 9. raise_mod from the anchor level (the last level on the u64 plan, the
    anchor pair by Garner on the q32 plan) to chain index 1: the NTT
    kernels launched, bit-exact against the plain versions, and the
    raised decryption equal to the anchor's plus exact multiples of the
    anchor's product.

Phases 7 to 9 run for both plans after phases 3 to 6 of both (the graphs,
then raise_mod, then EvalMod): their profile windows hold many events, and
a profiler window late in a process can lose some.  The N = 2^15 contexts
are then freed, and for each plan in turn (the first plan's keys and
plaintexts freed before the second's are made):

10. the flagship bootstrap, examples/bootstrap_ckks.py --logn 16 (u64:
    [60] + [59] * 25 + [60] * 13; --q32: create_composite(2^16, 58, 25,
    degree=2, anchor_bits=30, special_bits=30, special_count=26)), full
    packing (32768 slots uniform in [-0.8, 0.8]), level budget (4, 4), dim1
    (8, 8), K = 512, r = 6, degree 88, the input mod-dropped to 2 (u64) or
    4 (q32) limbs, through the entry points (context, secret key, encoder,
    CkksBootstrapper setup/keygen/eval_bootstrap, decrypt, decode):
    setup and keygen seconds, the keys and their form, peak memory, ms
    per bootstrap and per stage (CUDA events, after a warm-up; the events
    recorded around each stage method of the bootstrapper while
    eval_bootstrap runs), a profile window of one bootstrap (device busy
    and idle share, the port's kernels against the glue, the lost-events
    check below), precision bits, levels after and the launches of each
    kernel in one bootstrap (counters set to 0 just before); fails below
    the reference's precision less half a bit (14.1 u64, 12.9 q32) or at
    other than 4 levels after;
11. at N = 2^12 (level budget (2, 2), the default sine set, three levels
    after), a two-iteration dense Meta-BTS (whose first iteration is the
    dense bootstrap) and the sparse bootstrap (64 slots) through the
    kernels, each bit-identical to the same through the plain versions and
    decoding to more than 10 bits.

Then, the bootstrap contexts freed, the PPML layer library and ResNet-20
(tpu_fhe_torch/models/dnn.py, resnet20.py):

12. per plan, at N = 2^10 (width 4, 1-2 channels, the sparse sine set,
    level budget (2, 2), 9 levels after the bootstrap): conv at stride 1
    and 2 on the device-encode path and at stride 1 on the host-encode
    path, batch_norm, add, relu, sign, softmax, relu_composite of one
    channel (three bootstraps) and avg_pool_full_con, every kernel of the
    plan but K11 launched (counters set to 0 first) and each layer
    bit-identical, with the same chain index, scale and noise-scale
    degree, to the same through the plain versions; relu_composite within
    1e-3 of its float64 composite;
13. encrypted ResNet-20 at full width on the q32 plan
    (examples/resnet20_infer.py --q32: N = 2^16, a 32 x 32 x 3 image,
    planes 16/32/64 from random_weights(default_rng(17)), 11 levels after
    the bootstrap, K = 512, r = 6, degree 88, 1024 slots), its stem and
    layer 1's first block (resnet20_infer(layers=1, blocks=1): 144
    bootstraps of one channel), through the entry points: the decrypted
    32 x 32 x 16 activations within 1e-2 of the float64 shadow that applies
    the same sign composite, with context, setup and keygen seconds, key
    bytes, peak memory, ms per stage, the timer buckets, ms per channel
    bootstrap, the launches of each kernel (counters set to 0 first) and a
    profile of one channel's relu_composite; then every kernel of the
    inference against its plain version at every distinct shape the
    inference gave its wrapper, on the inference's own arguments and the
    context's tables (recorded while it ran; the recorded calls must equal
    the launches), each kernel's widest shape timed and bounded.

Every bootstrap profile (phases 10 and 13) compares its count of each port
kernel with the launches the wrappers counted in the same run; a window
that falls short lost events and is taken again, up to 3 in all, and is
printed as undercounted if the last still falls short.

Then BFV and BGV (tpu_fhe_torch/scheme/bfv.py, bgv.py, batch_encoder.py,
eval/bfv_eval.py, bgv_eval.py), the ResNet-20 context freed:

14. at N = 2^16 on benchmarks/bfv_bench.py's recipe widened to the
    HomomorphicEncryption.org bound ([60] + [54] * 30 + [60], 1740 bits,
    the bound enforced; t the 20-bit batching prime, one special prime):
    five contexts (BFV on BEHZ and on each HPS form -- hps, hps_overq,
    hps_overq_leveled -- sharing one key set, and BGV with its own), the
    host seconds of each context, its BEHZ or HPS tables and keygen, the
    key bytes; one pass of each context's traffic through the entry points
    (BFV: bfv_bench.py's ops, public-key encryption, rotate_columns and
    add_plain; BGV: bgv_bench.py's ops, a depth-2 chain with
    mod_switch_to_next and a rotation of a switched ciphertext, which must
    keep its correction factor), every decryption equal to the numpy
    cleartext result mod t slot for slot and BFV's noise budget printed
    and above 0 after each op; the launches of each kernel in that pass
    (counters set to 0 first, every wrapper call recorded); ms per op (CUDA
    events, median of 5 after a warm-up) and the launches of one multiply
    and one relinearize per context; a profile of one BEHZ multiply and
    relinearize (the port's kernels against the glue, the lost-events
    check); every kernel against its plain version at every distinct shape
    of the pass (K3 with its `pre` operand, K12 at k = 63 and K1/K2 on the
    Bsk and QlRl tables must be among them), each kernel's widest timed and
    bounded; peak memory; then at N = 2^12 on 8 primes one pass of the same
    traffic, keygen included, through the kernels equal to the same
    through the plain versions, bit for bit, metadata included.

Each phase's seconds, then the kernels line (every kernel of both plans,
its launches summed over the requests, rotations, EvalMod, raise_mod, the
flagship bootstrap, the DNN layers, the ResNet-20 inference and phase 14, its
headline numbers and under "checks" each shape it was held at with that
shape's ms, plain ms and bound) and the line {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import re
import subprocess
import sys
import time

import numpy as np

N = 1 << 15
BITS = [60] + [50] * 29 + [60] * 15      # bench.py primary config
SPECIAL = 15
SCALE = 2.0 ** 50
# the q32 plan: examples/bootstrap_ckks.py's and benchmarks/mult_q32_check.py's
# builder at bench.py's q32 keyswitch limb counts (60 Q + 30 P limbs)
COMPOSITE = dict(scale_bits=58, levels=29, degree=2, anchor_bits=30, special_bits=30,
                 special_count=30)
SCALE32 = 2.0 ** 58
REQUESTS = 4
ROT_REQUESTS = 2
ROT_STEPS = [1, 2, 4, -1]                # Galois keys (and conjugation)
HOIST_STEPS = (0, 1, 2, 4)
TOL = 1e-6
# The two-phase NTT kernels of earlier designs: a profile of either plan
# that shows one fails the run (every transform is one cluster launch)
TWO_PHASE = ("fwd_cols", "fwd_rows", "inv_rows", "inv_cols")
HBM_BYTES_PER_S = 3.35e12                # H100 SXM device memory
# 32-bit integer multiply-add rate: Hopper issues 64 IMAD per SM and clock
# (against 128 FFMA; NVIDIA's arithmetic-instruction throughput table for
# compute capability 9.0): 132 SMs x 64 x 1.98 GHz.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
INT8_TC_OPS_PER_S = 1979e12              # int8 tensor cores, dense
IMAD_PER_MUL64 = 4                       # one 64x64 product (lo or hi) in 32-bit IMADs
IMAD_PER_MUL32 = 1                       # one 32x32 product (lo or hi)
IMAD_PER_WIDE32 = 2                      # one 32x32 -> 64 product (IMAD.WIDE)
# Base conversion's bound is that of its cheapest known form, the balanced
# int8 digit planes of tpu_fhe/ops/bconv_mxu*.py: the int8 products of every
# table plane with every input plane (the nonzero blocks of the diagonal
# matrix), then per output a reassembly of the diagonals and one landing,
# in IMADs: q32 (4 planes, 7 diagonals) six shifted 64-bit adds (12), the
# 96-bit combine (3) and reduce96's 8 products; u64 (8 planes, 15
# diagonals) four 64-bit groups of shifted adds (32), the 128-bit combine
# (12), barrett128's six 64-bit products (24) and its carries (2).
BCONV_FORMS = {4: (4, 23), 8: (8, 70)}   # word: digit planes, IMADs per output


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int, samples: int = 5, graph: bool = False) -> float:
    """Median over `samples` of the mean time of `reps` back-to-back calls
    (CUDA events, after a warm-up call).  With `graph`, the reps are
    captured once in a CUDA graph and replayed, so the time is the
    device's alone and not the host's enqueue of each call."""
    import torch

    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
    out = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return float(np.median(out))


def bound_ms(nbytes: float, imads: float, int8_ops: float = 0.0) -> tuple[float, str]:
    """The larger of the bytes' time and the operations' time (IMADs plus
    int8 tensor-core operations, each at its own rate)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (imads / INT32_OPS_PER_S + int8_ops / INT8_TC_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bconv_cost(word: int, batch: int, k: int, m: int, n: int = N) -> dict:
    """Bytes, IMADs and int8 operations of one base conversion of `batch`
    rows, k -> m limbs of n coefficients, in its digit-plane form."""
    planes, epi = BCONV_FORMS[word]
    return dict(nbytes=word * n * batch * (k + m), imads=batch * m * n * epi,
                int8_ops=2 * batch * (planes * m) * (planes * k) * n)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    try:
        from tpu_fhe_torch.ops import _build
    except ImportError as e:
        fail(f"the port is not importable ({e}); run from the repository root")

    # -- 1. device -------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"[device] torch.cuda.get_device_name: {kind}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # -- 2. build --------------------------------------------------------
    t0 = time.time()
    logs = _build.build_all()
    build_s = time.time() - t0
    log(f"[build] {len(logs)} sources compiled in {time.time() - t0:.1f} s "
        f"(0 = already built)")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()}")

    seconds = {"2": build_s}
    t0 = time.time()
    plans = [u64_slice(card), q32_slice(card)]
    seconds["3-6"] = time.time() - t0
    # -- 3., continued: every kernel of the flagship bootstrap at its widest
    # keyswitch (N = 2^16), after the one-launch profiles of both plans:
    # each of these checks captures and replays a CUDA graph, and a
    # profiler window that comes later in a process can lose events
    t0 = time.time()
    for plan in plans:
        boot_path_checks(plan["tag"], plan["ck"])
    seconds["3 (2^16)"] = time.time() - t0
    # -- 7.-9. on both plans, after phases 3-6 of both: these phases' profiles
    # hold many events, and a profiler window late in a process can lose
    # some, so they come after every one-launch check, EvalMod's last
    t0 = time.time()
    for plan in plans:
        graph_phase(plan["tag"], plan["ctx"], plan["ck"], plan["rlk"], plan.pop("gk"), card)
    seconds["7"] = time.time() - t0
    t0 = time.time()
    for plan in plans:
        plan["raised"] = raise_mod_phase(plan["tag"], plan["ctx"], plan["ck"], plan["sk"])
    seconds["9"] = time.time() - t0
    t0 = time.time()
    for plan in plans:
        plan["emod"] = eval_mod_phase(plan["tag"], plan["ctx"], plan["ck"], plan["sk"],
                                      plan["rlk"], plan["sine"], plan["off_path"], card)
        # the N = 2^15 context and keys are done with: free them for phase 10
        for name in ("ctx", "sk", "rlk"):
            del plan[name]
    seconds["8"] = time.time() - t0
    gc.collect()
    torch.cuda.empty_cache()
    # -- 10. the flagship bootstrap, one plan after the other (the first plan's
    # keys and plaintexts are freed before the second's are made)
    t0 = time.time()
    for plan in plans:
        plan["boot"] = flagship_phase(plan["tag"], plan["ck"], card)
        gc.collect()
        torch.cuda.empty_cache()
    seconds["10"] = time.time() - t0
    # -- 11. the bootstrap through the kernels == through the plain versions
    t0 = time.time()
    for plan in plans:
        bootstrap_plain_phase(plan["tag"], plan["ck"])
        gc.collect()
        torch.cuda.empty_cache()
    seconds["11"] = time.time() - t0
    # -- 12. every DNN layer through the kernels == through the plain versions
    t0 = time.time()
    for plan in plans:
        plan["dnn"] = dnn_plain_phase(plan["tag"], plan["ck"])
        gc.collect()
        torch.cuda.empty_cache()
    seconds["12"] = time.time() - t0
    # -- 13. encrypted ResNet-20 at full width on the q32 plan
    t0 = time.time()
    q32 = plans[1]
    q32["resnet"] = resnet_phase(q32["ck"], card)
    plans[0]["resnet"] = dict.fromkeys(plans[0]["launches"], 0)
    gc.collect()
    torch.cuda.empty_cache()
    seconds["13"] = time.time() - t0
    # -- 14. BFV and BGV at N = 2^16 (their keys freed at the phase's end)
    t0 = time.time()
    plans[0]["bfv"] = bfv_bgv_phase(plans[0]["ck"], card)
    plans[1]["bfv"] = dict.fromkeys(plans[1]["launches"], 0)
    gc.collect()
    torch.cuda.empty_cache()
    seconds["14"] = time.time() - t0
    log("[time] seconds by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    line = []
    for plan in plans:
        line += plan["ck"].line({name: count + plan["emod"][name] + plan["raised"][name]
                                 + plan["boot"][name] + plan["dnn"][name]
                                 + plan["resnet"][name] + plan["bfv"][name]
                                 for name, count in plan["launches"].items()})
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


class Checker:
    """Holds kernels against their plain versions and keeps each kernel's
    report (shapes checked, headline times and bound)."""

    def __init__(self, kernels):
        self.kernels = {k.name: k for k in kernels}
        self.report = {name: {"checks": []} for name in self.kernels}

    def check(self, name, shape, kernel_fn, plain_fn, nbytes, imads, int8_ops=0.0,
              headline=False):
        import torch

        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"{name} {shape}: kernel {tuple(got.shape)} {got.dtype} != plain "
                 f"{tuple(want.shape)} {want.dtype}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
        if err != 0:
            fail(f"{name} {shape}: kernel differs from its plain version (max |diff| {err})")
        ms = cuda_ms(kernel_fn, reps=20, graph=True)
        called = cuda_ms(kernel_fn, reps=20)
        plain = cuda_ms(plain_fn, reps=1, samples=3)
        bms, by = bound_ms(nbytes, imads, int8_ops)
        log(f"[kernel] {name} {shape}: max|diff|=0  {ms:.4f} ms (graph replay; "
            f"{called:.4f} ms called from Python)  plain {plain:.3f} ms  "
            f"bound {bms:.4f} ms ({by})")
        entry = self.report[name]
        entry["checks"].append(dict(shape=shape, ms=ms, plain_ms=plain, bound_ms=bms,
                                    bound_by=by))
        if headline or "ms" not in entry:
            entry.update(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)

    def reset(self):
        for k in self.kernels.values():
            k.launches = 0

    def launches(self) -> dict:
        return {name: k.launches for name, k in self.kernels.items()}

    def require_launched(self, tag: str, launches: dict, off_path: tuple) -> None:
        """Fail unless every kernel but those `off_path` was launched."""
        for name, count in launches.items():
            if name not in off_path and count <= 0:
                fail(f"kernel {name} was not launched on the {tag} path")

    def line(self, launches: dict) -> list:
        out = []
        for name, k in self.kernels.items():
            e = self.report[name]
            file_line, _, _ = k.replaces.partition(" ")
            out.append({
                "name": name, "route": "cuda", "source": f"tpu_fhe_torch/csrc/{k.source}",
                "replaces": file_line, "launches": launches[name], "max_abs_err": 0,
                "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                "bound_by": e["bound_by"], "library_ms": None, "checks": e["checks"],
                "path_shapes": e.get("path_shapes", {}),
            })
        return out


def residue_maker(dev, n: int, seed: int):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)

    def residues(q: torch.Tensor, *lead: int) -> torch.Tensor:
        """Uniform residues (*lead, L, N) for moduli q (L, 1), in q's word."""
        x = torch.randint(0, 1 << 62, lead + (q.shape[0], n), generator=gen,
                          dtype=torch.int64, device=dev)
        return (x % q.to(torch.int64)).to(q.dtype)
    return residues


def ntt_cost(word: int, rows: int, limbs: int, extra_muls: int = 0, tables: int = 2,
             n: int = N):
    """Bytes (data in and out, `tables` twiddle planes per limb) and IMADs
    (log2 n butterfly stages of one Shoup multiply, 3 products each, plus
    `extra_muls` Shoup multiplies per element) of a transform of size n."""
    per_mul = IMAD_PER_MUL64 if word == 8 else IMAD_PER_MUL32
    nbytes = word * n * (2 * rows + tables * limbs)
    imads = (rows * (n // 2) * (n.bit_length() - 1) + extra_muls * rows * n) * 3 * per_mul
    return nbytes, imads


def simt_bconv(s, table, p, ratio_lo, ratio_hi):
    """K11's kernel at any k, called directly (the wrapper takes K12 for
    k < 64): s (k, N) int64 residues, the table (m, k) and p and its Barrett
    words (m, 1), all on the card."""
    import torch

    from tpu_fhe_torch.ops import bconv
    from tpu_fhe_torch.ops._build import ptr

    (k, n), m = s.shape, table.shape[0]
    out = torch.empty((m, n), dtype=torch.int64, device=s.device)
    bconv.BCONV(ptr(s), ptr(out), *(ptr(c.contiguous()) for c in (table, p, ratio_lo, ratio_hi)),
                1, k, m, n)
    return out


def int_mm_yardstick(k: int, m: int, card: str) -> None:
    """Time torch._int_mm on the operands of bconv32's int8 product at
    k -> m: (7 m_pad, 4 k) @ (4 k, N), m_pad = m rounded up to 8.  Only a
    yardstick of the product part (not the same function: no digit
    extraction, reassembly or landing); the port never calls it."""
    import torch

    m_pad = -(-m // 8) * 8
    g = torch.Generator(device="cuda").manual_seed(3)
    a = torch.randint(-128, 128, (7 * m_pad, 4 * k), generator=g, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-128, 128, (4 * k, N), generator=g, device="cuda", dtype=torch.int8)
    try:
        ms = cuda_ms(lambda: torch._int_mm(a, b), reps=20)
    except RuntimeError as e:
        log(f"[kernel] torch._int_mm ({7 * m_pad}, {4 * k}) @ ({4 * k}, 2^15): refused ({e})")
        return
    log(f"[kernel] torch._int_mm ({7 * m_pad}, {4 * k}) @ ({4 * k}, 2^15) int8 -> int32, "
        f"the product part of bconv32 {k} -> {m} alone: {ms:.4f} ms on {card}")


# --------------------------------------------------------------------------
# the u64 plan
# --------------------------------------------------------------------------

def u64_slice(card: str) -> dict:
    import torch

    from tpu_fhe_torch.core.modulus import CoeffModulus
    from tpu_fhe_torch.core.ntt_tables import make_ntt_tables, shoup_np
    from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
    from tpu_fhe_torch.eval import evaluator as ev
    from tpu_fhe_torch.ops import bconv, ks, modarith as mm, ntt
    from tpu_fhe_torch.scheme.ciphertext import Ciphertext
    from tpu_fhe_torch.scheme.context import FheContext

    # -- context (the slice's tables, also the kernels' full-width inputs)
    t0 = time.time()
    params = EncryptionParameters(SchemeType.ckks, N, tuple(CoeffModulus.create(N, BITS)),
                                  special_modulus_size=SPECIAL, allow_insecure=True)
    ctx = FheContext(params)
    torch.cuda.synchronize()
    log(f"[context] N={N} limbs={len(BITS)} on {ctx.device}: {time.time() - t0:.1f} s")
    level = ctx.level(1)
    kst = level.ks
    residues = residue_maker(ctx.device, N, 2024)

    # -- 3. kernels against their plain versions ---------------------------
    ck = Checker([ntt.NTT_FWD, ntt.NTT_FWD_LANDING, ntt.NTT_INV, bconv.BCONV_MXU, bconv.BCONV,
                  ks.KS_SHOUP, ks.KS])
    L = level.size                                      # 30
    P = kst.p_ntt.num_limbs                             # 15
    dig = kst.digits[0]
    comp = dig.comp_ntt                                 # 30 complement limbs

    x = residues(level.mod.q)
    ck.check("ntt_fwd", "(30, 2^15)", lambda: ntt.forward_ntt(x, level.ntt),
             lambda: ntt.forward_ntt_plain(x, level.ntt), *ntt_cost(8, L, L), headline=True)
    x2 = residues(comp.q, 2)
    ck.check("ntt_fwd", "(2, 30, 2^15)", lambda: ntt.forward_ntt(x2, comp),
             lambda: ntt.forward_ntt_plain(x2, comp), *ntt_cost(8, 2 * L, L))
    one_launch("ntt_fwd (30, 2^15)", lambda: ntt.forward_ntt(x, level.ntt), ("fwd_cluster",))
    # K1 and K2 at the larger rings (clusters of 8 blocks of 64 and 128 KB),
    # K2 with a per-limb scale
    for log_n in (16, 17):
        n = 1 << log_n
        tabs = ntt.build_device_ntt_tables(
            [make_ntt_tables(log_n, m.value) for m in CoeffModulus.create(n, BITS[:L])],
            ctx.device)
        xn = residue_maker(ctx.device, n, 2020 + log_n)(tabs.q)
        ck.check("ntt_fwd", f"({L}, 2^{log_n})", lambda: ntt.forward_ntt(xn, tabs),
                 lambda: ntt.forward_ntt_plain(xn, tabs), *ntt_cost(8, L, L, n=n))
        sv = residue_maker(ctx.device, 1, 2030 + log_n)(tabs.q).reshape(-1)
        sn = (sv, mm.u64_tensor(np.concatenate([shoup_np([v], m) for v, m in
                                                zip(sv.tolist(), tabs.q.reshape(-1).tolist())]),
                                ctx.device))
        ck.check("ntt_inv", f"({L}, 2^{log_n}) scaled",
                 lambda: ntt.inverse_ntt_scaled(xn, tabs, *sn),
                 lambda: ntt.inverse_ntt_plain(xn, tabs, *sn),
                 *ntt_cost(8, L, L, extra_muls=2, n=n))
        del tabs, xn, sv, sn
    sub = residues(level.mod.q, 2)
    xs = residues(level.mod.q, 2)
    args = (kst.big_pinv_mod_q, kst.big_pinv_mod_q_shoup)
    ck.check("ntt_fwd_landing", "(2, 30, 2^15)",
             lambda: ntt.forward_ntt_sub_scale(xs, sub, level.ntt, *args),
             lambda: ntt.forward_ntt_sub_scale_plain(xs, sub, level.ntt, *args),
             8 * N * (3 * 2 * L + 2 * L), ntt_cost(8, 2 * L, L, extra_muls=1)[1],
             headline=True)
    one_launch("ntt_fwd_landing (2, 30, 2^15)",
               lambda: ntt.forward_ntt_sub_scale(xs, sub, level.ntt, *args),
               ("fwd_cluster", "Landing"))
    scale = (kst.part_qhatinv, kst.part_qhatinv_shoup)
    ck.check("ntt_inv", "(30, 2^15) scaled",
             lambda: ntt.inverse_ntt_scaled(x, level.ntt, *scale),
             lambda: ntt.inverse_ntt_plain(x, level.ntt, *scale),
             *ntt_cost(8, L, L, extra_muls=2), headline=True)
    one_launch("ntt_inv (30, 2^15) scaled",
               lambda: ntt.inverse_ntt_scaled(x, level.ntt, *scale), ("inv_cluster",))
    xp = residues(kst.p_mod.q, 2)
    pscale = (kst.p_hatinv, kst.p_hatinv_shoup)
    ck.check("ntt_inv", "(2, 15, 2^15) scaled",
             lambda: ntt.inverse_ntt_scaled(xp, kst.p_ntt, *pscale),
             lambda: ntt.inverse_ntt_plain(xp, kst.p_ntt, *pscale),
             *ntt_cost(8, 2 * P, P, extra_muls=2))
    s = residues(level.mod.q[dig.start:dig.end])
    btab = (dig.qhat_mod_p, dig.comp_mod.q, dig.comp_mod.ratio_lo, dig.comp_mod.ratio_hi,
            dig.qhat_mod_p_diag)
    k_in, m_out = dig.end - dig.start, dig.comp_mod.q.shape[0]
    ck.check("bconv_mxu", "15 -> 30, (15, 2^15)", lambda: bconv.bconv_matmul(s, *btab),
             lambda: bconv.bconv_matmul_plain(s, *btab), **bconv_cost(8, 1, k_in, m_out),
             headline=True)
    s2 = residues(kst.p_mod.q, 2)
    mtab = (kst.p_hat_mod_q, level.mod.q, level.mod.ratio_lo, level.mod.ratio_hi,
            kst.p_hat_mod_q_diag)
    ck.check("bconv_mxu", "15 -> 30, (2, 15, 2^15)", lambda: bconv.bconv_matmul(s2, *mtab),
             lambda: bconv.bconv_matmul_plain(s2, *mtab), **bconv_cost(8, 2, P, L))
    # K11, the SIMT kernel: the wrapper's choice from k = 64 inputs on (the
    # key level's 45 moduli and 19 of them again, into the level's 30),
    # and at the path's 15 -> 30 through a direct call
    s64 = residues(torch.cat([ctx.key_level.mod.q] * 2)[:64])
    gen = torch.Generator(device=ctx.device).manual_seed(64)
    wide = torch.randint(0, 1 << 62, (L, 64), generator=gen, dtype=torch.int64,
                         device=ctx.device) % level.mod.q
    wtab = (wide, level.mod.q, level.mod.ratio_lo, level.mod.ratio_hi)
    ck.check("bconv", "64 -> 30, (64, 2^15)", lambda: bconv.bconv_matmul(s64, *wtab),
             lambda: bconv.bconv_matmul_plain(s64, *wtab), **bconv_cost(8, 1, 64, L))
    ck.check("bconv", "15 -> 30, (15, 2^15), direct call",
             lambda: simt_bconv(s, *btab[:4]), lambda: bconv.bconv_matmul_plain(s, *btab),
             **bconv_cost(8, 1, k_in, m_out), headline=True)
    beta = kst.beta
    qlp = kst.qlp_mod
    t = residues(qlp.q, beta)
    kq = ctx.key_level.mod
    evk = residues(kq.q, 3, 2)
    evk_s = mm.shoup_of(evk, kq.q, kq.ratio_lo, kq.ratio_hi)
    rows = kst.qlp_key_rows
    ck.check("key_inner_prod_shoup", "(2, 45, 2^15)",
             lambda: ks.key_inner_prod_shoup(t, evk, evk_s, rows, qlp.q),
             lambda: ks.key_inner_prod_shoup_plain(t, evk, evk_s, rows, qlp.q),
             8 * N * (beta * (L + P) + 2 * 2 * beta * (L + P) + 2 * (L + P)),
             3 * 2 * beta * (L + P) * N * IMAD_PER_MUL64, headline=True)
    # K7: a Galois key without Shoup words, dnum = beta = 2 digits; per
    # output word beta 64x64 -> 128 products and one Barrett landing (6
    # 64-bit products)
    gkey = residues(kq.q, beta, 2)
    kargs = (rows, qlp.q, qlp.ratio_lo, qlp.ratio_hi)
    ck.check("key_inner_prod", "(2, 45, 2^15)",
             lambda: ks.key_inner_prod(t, gkey, *kargs),
             lambda: ks.key_inner_prod_plain(t, gkey, *kargs),
             8 * N * (beta * (L + P) + 2 * beta * (L + P) + 2 * (L + P)),
             2 * (L + P) * N * (2 * beta + 6) * IMAD_PER_MUL64, headline=True)
    del x, x2, sub, xs, xp, s, s2, s64, wide, t, evk, evk_s, gkey

    # -- 4. the slice: keys, then REQUESTS requests ---------------------
    launches, products, rlk, sk = run_requests("u64", ctx, ck, SCALE,
                                               lambda c: ev.rescale_to_next(ctx, c),
                                               off_path=("key_inner_prod", "bconv"))
    same_as_plain("u64", "relinearize", ck, lambda: [ev.relinearize(ctx, products[0], rlk)])

    # -- 5. keyswitch timing ----------------------------------------------
    ct3 = Ciphertext(torch.stack([residues(level.mod.q) for _ in range(3)]), chain_index=1,
                     scale=SCALE)
    keyswitch_timing("u64", "chain index 1, 30 + 15 limbs", ctx, ct3, rlk, ck, card)
    del ct3, products

    # -- 6. rotations -----------------------------------------------------
    rot, gk = rotation_phase("u64", ctx, ck, sk, SCALE, keep=2,
                             off_path=("key_inner_prod_shoup", "bconv"), card=card)
    return dict(tag="u64", ctx=ctx, ck=ck, sk=sk, rlk=rlk, gk=gk, sine=SPARSE_SINE,
                off_path=("key_inner_prod", "bconv"),
                launches={name: launches[name] + rot[name] for name in launches})


# --------------------------------------------------------------------------
# the q32 plan of composite scaling
# --------------------------------------------------------------------------

def q32_slice(card: str) -> dict:
    import torch

    from tpu_fhe_torch.core.modulus import CoeffModulus
    from tpu_fhe_torch.core.ntt_tables import make_ntt_tables
    from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
    from tpu_fhe_torch.eval import evaluator as ev
    from tpu_fhe_torch.ops import bconv, ks, modarith as mm, ntt
    from tpu_fhe_torch.scheme.ciphertext import Ciphertext
    from tpu_fhe_torch.scheme.context import FheContext

    t0 = time.time()
    mods = CoeffModulus.create_composite(N, **COMPOSITE)
    params = EncryptionParameters(SchemeType.ckks, N, tuple(mods),
                                  special_modulus_size=COMPOSITE["special_count"],
                                  composite_degree=2, allow_insecure=True)
    ctx = FheContext(params)
    torch.cuda.synchronize()
    if not ctx.is_q32:
        fail("the composite chain is not a q32 chain")
    log(f"[q32 context] N={N} limbs={len(mods)} ({params.size_Q} Q + {params.size_P} P, "
        f"{min(m.value for m in mods).bit_length()}-{max(m.value for m in mods).bit_length()}"
        f" bits) on {ctx.device}: {time.time() - t0:.1f} s")
    residues = residue_maker(ctx.device, N, 2032)

    # -- 3. kernels at the keyswitch shapes of the 59-limb level ------------
    ck = Checker([ntt.NTT_FWD32, ntt.NTT_FWD_LANDING32, ntt.NTT_INV32, bconv.BCONV32,
                  ks.KS_SHOUP32, ks.KS32])
    level = ctx.level(2)                                # 59 Q limbs
    kst = level.ks
    L, P = level.size, kst.p_ntt.num_limbs              # 59, 30
    if (L, P, kst.beta) != (59, 30, 2):
        fail(f"unexpected q32 keyswitch shape L={L} P={P} beta={kst.beta}")
    for dt in kst.digits:                               # 30 -> 59 and 29 -> 60
        comp = dt.comp_ntt
        m = comp.num_limbs
        x = residues(comp.q)
        ck.check("ntt_fwd32", f"({m}, 2^15)", lambda: ntt.forward_ntt(x, comp),
                 lambda: ntt.forward_ntt_plain(x, comp), *ntt_cost(4, m, m),
                 headline=m == L)
    x = residues(level.mod.q)
    scale = (kst.part_qhatinv, kst.part_qhatinv_shoup)
    ck.check("ntt_inv32", "(59, 2^15) scaled",
             lambda: ntt.inverse_ntt_scaled(x, level.ntt, *scale),
             lambda: ntt.inverse_ntt_plain(x, level.ntt, *scale),
             *ntt_cost(4, L, L, extra_muls=2), headline=True)
    one_launch("ntt_inv32 (59, 2^15) scaled",
               lambda: ntt.inverse_ntt_scaled(x, level.ntt, *scale), ("inv_cluster",))
    xp = residues(kst.p_mod.q, 2)
    pscale = (kst.p_hatinv, kst.p_hatinv_shoup)
    ck.check("ntt_inv32", "(2, 30, 2^15) scaled",
             lambda: ntt.inverse_ntt_scaled(xp, kst.p_ntt, *pscale),
             lambda: ntt.inverse_ntt_plain(xp, kst.p_ntt, *pscale),
             *ntt_cost(4, 2 * P, P, extra_muls=2))
    sub, xs = residues(level.mod.q, 2), residues(level.mod.q, 2)
    post = (kst.big_pinv_mod_q, kst.big_pinv_mod_q_shoup)
    ck.check("ntt_fwd_landing32", "(2, 59, 2^15)",
             lambda: ntt.forward_ntt_sub_scale(xs, sub, level.ntt, *post),
             lambda: ntt.forward_ntt_sub_scale_plain(xs, sub, level.ntt, *post),
             4 * N * (3 * 2 * L + 2 * L), ntt_cost(4, 2 * L, L, extra_muls=1)[1],
             headline=True)
    one_launch("ntt_fwd_landing32 (2, 59, 2^15)",
               lambda: ntt.forward_ntt_sub_scale(xs, sub, level.ntt, *post),
               ("fwd_cluster", "Landing"))
    for dt in kst.digits:
        k_in, m_out = dt.end - dt.start, dt.comp_mod.q.shape[0]
        s = residues(level.mod.q[dt.start:dt.end])
        tab = (dt.qhat_mod_p, dt.comp_mod.q, dt.comp_mod.fold, dt.qhat_mod_p_diag)
        ck.check("bconv32", f"{k_in} -> {m_out}, ({k_in}, 2^15)",
                 lambda: bconv.bconv_matmul32(s, *tab),
                 lambda: bconv.bconv_matmul32_plain(s, *tab), **bconv_cost(4, 1, k_in, m_out),
                 headline=k_in == 30)
        if k_in == 30:
            int_mm_yardstick(k_in, m_out, card)
    s2 = residues(kst.p_mod.q, 2)
    tab = (kst.p_hat_mod_q, level.mod.q, level.mod.fold, kst.p_hat_mod_q_diag)
    ck.check("bconv32", "30 -> 59, (2, 30, 2^15)", lambda: bconv.bconv_matmul32(s2, *tab),
             lambda: bconv.bconv_matmul32_plain(s2, *tab), **bconv_cost(4, 2, P, L))
    qlp, rows = kst.qlp_mod, kst.qlp_key_rows
    t = residues(qlp.q, kst.beta)
    kq = ctx.key_level.mod
    evk = residues(kq.q, 2, 2)
    evk_s = mm.shoup32_of(evk, kq.q)
    ck.check("key_inner_prod_shoup32", "t (2, 89, 2^15), key (2, 2, 90, 2^15)",
             lambda: ks.key_inner_prod_shoup(t, evk, evk_s, rows, qlp.q),
             lambda: ks.key_inner_prod_shoup_plain(t, evk, evk_s, rows, qlp.q),
             4 * N * (2 * (L + P) + 2 * 2 * 2 * (L + P) + 2 * (L + P)),
             3 * 2 * 2 * (L + P) * N * IMAD_PER_MUL32, headline=True)
    # K9: the same key rows without Shoup words; per output word beta
    # 32x32 -> 64 products and the word fold (7 32-bit products)
    ck.check("key_inner_prod32", "t (2, 89, 2^15), key (2, 2, 90, 2^15)",
             lambda: ks.key_inner_prod32(t, evk, rows, qlp.q, qlp.fold),
             lambda: ks.key_inner_prod32_plain(t, evk, rows, qlp.q, qlp.fold),
             4 * N * (2 * (L + P) + 2 * 2 * (L + P) + 2 * (L + P)),
             2 * (L + P) * N * (2 * IMAD_PER_WIDE32 + 7 * IMAD_PER_MUL32), headline=True)
    # K4 and K5 compute K1's and K2's function: the same 30-bit moduli
    # through int64 tables, bit for bit
    wide = ntt.build_device_ntt_tables(
        [make_ntt_tables(params.log_n, v) for v in level.base.values], ctx.device, q32=False)
    x64 = x.to(torch.int64)
    for name, fn in (("forward", ntt.forward_ntt), ("inverse", ntt.inverse_ntt)):
        if not torch.equal(fn(x, level.ntt).to(torch.int64), fn(x64, wide)):
            fail(f"q32 {name} NTT (K4/K5) differs from the u64 one (K1/K2) on 30-bit moduli")
    log("[kernel] ntt_fwd32 == ntt_fwd and ntt_inv32 == ntt_inv on the 59 30-bit moduli "
        "of (59, 2^15), bit for bit")
    del x, xp, sub, xs, s, s2, t, evk, evk_s, wide, x64
    # K4, K5 and K6 at the larger rings (clusters of 4 and 8 blocks), 59
    # limbs of 30-bit primes each, K5 with a per-limb scale, K6 on 2 rows
    # with moddown's post multiply alone
    for log_n in (16, 17):
        n = 1 << log_n
        tabs = ntt.build_device_ntt_tables(
            [make_ntt_tables(log_n, m.value) for m in CoeffModulus.create(n, [30] * L)],
            ctx.device, q32=True)
        xn = residue_maker(ctx.device, n, 2040 + log_n)(tabs.q)
        ck.check("ntt_fwd32", f"({L}, 2^{log_n})", lambda: ntt.forward_ntt(xn, tabs),
                 lambda: ntt.forward_ntt_plain(xn, tabs), *ntt_cost(4, L, L, n=n))
        sv = residue_maker(ctx.device, 1, 2050 + log_n)(tabs.q).reshape(-1)
        sn = (sv, mm.shoup32_of(sv, tabs.q.reshape(-1)))
        ck.check("ntt_inv32", f"({L}, 2^{log_n}) scaled",
                 lambda: ntt.inverse_ntt_scaled(xn, tabs, *sn),
                 lambda: ntt.inverse_ntt_plain(xn, tabs, *sn),
                 *ntt_cost(4, L, L, extra_muls=2, n=n))
        xn2, subn = (residue_maker(ctx.device, n, s)(tabs.q, 2) for s in (2060 + log_n,
                                                                          2070 + log_n))
        ck.check("ntt_fwd_landing32", f"(2, {L}, 2^{log_n})",
                 lambda: ntt.forward_ntt_sub_scale(xn2, subn, tabs, *sn),
                 lambda: ntt.forward_ntt_sub_scale_plain(xn2, subn, tabs, *sn),
                 4 * n * (3 * 2 * L + 2 * L), ntt_cost(4, 2 * L, L, extra_muls=1, n=n)[1])
        del tabs, xn, sv, sn, xn2, subn

    # -- 4. the q32 requests ------------------------------------------------
    launches, products, rlk, sk = run_requests("q32", ctx, ck, SCALE32,
                                               lambda c: ev.rescale_composite(ctx, c),
                                               off_path=("key_inner_prod32",))
    same_as_plain("q32", "relinearize", ck, lambda: [ev.relinearize(ctx, products[0], rlk)])

    # -- 5. keyswitch timing: the 59-limb level, then bench.py's level(1) ---
    for ci in (2, 1):
        lv = ctx.level(ci)
        ct3 = Ciphertext(torch.stack([residues(lv.mod.q) for _ in range(3)]), chain_index=ci,
                         scale=SCALE32)
        keyswitch_timing("q32", f"chain index {ci}, {lv.size} + {P} limbs", ctx, ct3, rlk,
                         ck, card, profile=ci == 2)
    del ct3, products

    # -- 6. rotations -----------------------------------------------------
    rot, gk = rotation_phase("q32", ctx, ck, sk, SCALE32, keep=4,
                             off_path=("key_inner_prod_shoup32",), card=card)
    return dict(tag="q32", ctx=ctx, ck=ck, sk=sk, rlk=rlk, gk=gk, sine=UNIFORM_SINE,
                off_path=("key_inner_prod32",),
                launches={name: launches[name] + rot[name] for name in launches})


# --------------------------------------------------------------------------
# shared phases
# --------------------------------------------------------------------------

def run_requests(tag: str, ctx, ck: Checker, scale: float, rescale, off_path: tuple):
    """Keys, then REQUESTS requests at chain index 1; returns the launch
    counts of the requests, the products, the relin key and the secret
    key.  Every kernel but those `off_path` must have been launched."""
    import torch

    from tpu_fhe_torch.eval import evaluator as ev
    from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder
    from tpu_fhe_torch.scheme.keys import SecretKey, encrypt_asymmetric

    t0 = time.time()
    sk = SecretKey(ctx, seed=5)
    pk = sk.public_key()
    rlk = sk.relin_key()
    torch.cuda.synchronize()
    log(f"[{tag} keygen] secret, public, relin (with Shoup words), {rlk.data.dtype}: "
        f"{time.time() - t0:.1f} s")
    enc = CkksEncoder(ctx)
    rng = np.random.default_rng(7)
    enc_gen = torch.Generator(device=ctx.device).manual_seed(11)

    ck.reset()
    steps = StepLaunches(ck)
    products = []
    for r in range(REQUESTS):
        x_v, y_v = rng.standard_normal(N // 2), rng.standard_normal(N // 2)
        t0 = time.time()
        ct_x = sk.encrypt_symmetric(enc.encode(x_v, scale))
        ct_y = encrypt_asymmetric(ctx, pk, enc.encode(y_v, scale), enc_gen)
        steps.add("encode+encrypt")
        torch.cuda.synchronize()
        t1 = time.time()
        prod = ev.multiply(ctx, ct_x, ct_y)
        relin = ev.relinearize(ctx, prod, rlk)
        steps.add("multiply+relinearize")
        out = rescale(relin)
        steps.add("rescale")
        torch.cuda.synchronize()
        t2 = time.time()
        got = enc.decode(sk.decrypt(out)).real
        steps.add("decrypt+decode")
        t3 = time.time()
        if got.shape != (N // 2,) or not np.all(np.isfinite(got)):
            fail(f"{tag} request {r}: decoded {got.shape} with non-finite values")
        err = float(np.max(np.abs(got - x_v * y_v)))
        log(f"[{tag} request {r}] encode+encrypt {t1 - t0:.3f} s, "
            f"multiply+relinearize+rescale {(t2 - t1) * 1e3:.2f} ms, decrypt+decode "
            f"{t3 - t2:.2f} s, max err {err:.3e}, chain index {out.chain_index}, "
            f"{out.data.dtype}")
        if not err <= TOL:
            fail(f"{tag} request {r}: max error {err} > {TOL}")
        products.append(prod)
    launches = ck.launches()
    log(f"[{tag} slice] launches over {REQUESTS} requests: {launches}")
    steps.log(f"[{tag} slice]", f"{REQUESTS} requests")
    ck.require_launched(f"{tag} relinearize", launches, off_path)
    return launches, products, rlk, sk


class StepLaunches:
    """Launches per kernel split by step: add(step) books the launches
    since the last add (or since creation) under `step`."""

    def __init__(self, ck: Checker):
        self.ck, self.seen, self.by_step = ck, ck.launches(), {}

    def add(self, step: str) -> None:
        now = self.ck.launches()
        row = self.by_step.setdefault(step, dict.fromkeys(now, 0))
        for name, count in now.items():
            row[name] += count - self.seen[name]
        self.seen = now

    def log(self, prefix: str, over: str) -> None:
        for step, row in self.by_step.items():
            log(f"{prefix} launches in {step} over {over}: "
                f"{ {k: v for k, v in row.items() if v} }")


def marginal_ms(tag: str, fn, iters: int = 50) -> tuple[float, float, int]:
    """bench.py's median-of-pairs marginal time of `fn` (CUDA events over
    2 and 2 + iters calls, 5 pairs): (ms per call, spread, pairs kept)."""
    import torch

    def timed(reps: int) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    timed(2)
    samples = []
    for _ in range(5):
        short, long_ = timed(2), timed(2 + iters)
        if long_ > short:
            samples.append((long_ - short) / iters)
    if not samples:
        fail(f"{tag} timing gave no positive marginal")
    samples.sort()
    ms = samples[len(samples) // 2]
    return ms, (samples[-1] - samples[0]) / ms, len(samples)


def keyswitch_timing(tag: str, where: str, ctx, ct3, rlk, ck: Checker, card: str,
                     profile: bool = True) -> None:
    """bench.py's median-of-pairs marginal keyswitch time, launches per
    relinearize and (with `profile`) a device-only profiler window."""
    from tpu_fhe_torch.eval import evaluator as ev

    def relin():
        return ev.relinearize(ctx, ct3, rlk)

    ks_ms, spread, pairs = marginal_ms(f"{tag} keyswitch", relin)
    log(f"[{tag} keyswitch] {where}: {ks_ms:.4f} ms/op, {1e3 / ks_ms:.2f} keyswitch/s "
        f"(median of {pairs} marginal pairs, spread {spread * 100:.0f}%) on {card}")
    ck.reset()
    relin()
    log(f"[{tag} keyswitch] launches per relinearize: {ck.launches()}")
    if profile:
        profile_ops(tag, relin, "relinearize")


def device_kernels(run) -> list:
    """torch.profiler's device kernels (key_averages) over `run()`, device
    activity only, so that host tracing does not stretch the window.  A
    profiler window after the first in a process can miss its first device
    kernel (seen on the H100: 9 of 10 launches of one kernel), so a fill of
    one byte and a synchronize lead the window; the fill is not counted (no
    profiled operation fills memory).  Later windows of a long process can
    still lose events (whole operations, seen on the H100), which
    profile_ops flags."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(1, dtype=torch.int8, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        marker.fill_(1)
        torch.cuda.synchronize()
        run()
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "FillFunctor" not in e.key]


def profile_ops(tag: str, fn, what: str, reps: int = 10) -> None:
    """Device time by kernel over `reps` calls of `fn` and the device's busy
    share of the window timed with CUDA events.  Every call runs the same
    kernels, so a count that is not a multiple of `reps` means the profiler
    lost events, and the line says so."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def run():
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()

    device = device_kernels(run)
    window_ms = start.elapsed_time(end)
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    if busy_ms <= 0:
        log(f"[{tag} profile] the profiler saw no device time: busy share not measured")
        return
    lost = any(e.count % reps for e in device)
    log(f"[{tag} profile] {reps} {what}s: window {window_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / window_ms:.1f}%), idle "
        f"{100 * (1 - busy_ms / window_ms):.1f}%"
        + ("; the profiler lost events, busy undercounted" if lost else ""))
    for e in sorted(device, key=lambda e: -e.self_device_time_total):
        log(f"[{tag} profile]   {e.self_device_time_total / 1e3 / reps:.4f} ms/{what}  "
            f"{e.count / reps:g} calls  {e.key[:90]}")
    ran = sorted({k for e in device for k in TWO_PHASE if k in e.key})
    if ran:
        fail(f"{tag} {what}: two-phase NTT kernels ran ({', '.join(ran)}); every "
             "transform is one cluster launch")


def one_launch(what: str, fn, names: tuple, reps: int = 10, windows: int = 3) -> None:
    """A profile of `reps` calls of `fn` sees exactly one device kernel,
    whose name holds every one of `names`, `reps` times: the
    one-cluster-launch transform, not the two-phase pair.  The profiler can
    drop events in a long process (seen on the H100: 9 of 10 launches of one
    kernel, and a window with no event at all), so a window that sees that
    kernel alone but fewer times, or nothing, is taken again, up to
    `windows` in all; a window that sees any other kernel, or more
    launches, fails at once."""
    import torch

    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    for window in range(1, windows + 1):
        seen = [(e.key, e.count) for e in device_kernels(run)]
        alone = len(seen) == 1 and all(k in seen[0][0] for k in names)
        if seen and (not alone or seen[0][1] > reps):
            fail(f"{what}: expected {reps} launches of {' '.join(names)} alone, the "
                 f"profile saw {seen}")
        if seen and seen[0][1] == reps:
            break
        log(f"[one launch] {what}: window {window} saw {seen[0][1] if seen else 0} of "
            f"{reps} launches (the profiler lost events)")
    else:
        fail(f"{what}: expected {reps} launches of {' '.join(names)}; {windows} profiles "
             f"each lost events, the last saw {seen}")
    log(f"[one launch] {what}: {' '.join(names)}, {reps} calls, {reps} launches")


def path_wrappers() -> dict:
    """The kernel wrappers that the evaluator (and hoisting, which calls its
    keyswitch stages), auto (and Chebyshev, which calls it), the DNN layers'
    mask transforms and the encoder call, by the names they call them: each
    launches one kernel per call.  -> name: (its plain version, the number
    of leading data arguments; the rest are the context's tables and
    keys)."""
    from tpu_fhe_torch.ops import bconv, ks, ntt

    return dict(
        forward_ntt=(ntt.forward_ntt_plain, 1), inverse_ntt=(ntt.inverse_ntt_plain, 1),
        inverse_ntt_scaled=(ntt.inverse_ntt_plain, 1),
        forward_ntt_sub_scale=(ntt.forward_ntt_sub_scale_plain, 2),
        bconv_matmul=(bconv.bconv_matmul_plain, 1), bconv_matmul32=(bconv.bconv_matmul32_plain, 1),
        key_inner_prod=(ks.key_inner_prod_plain, 1), key_inner_prod32=(ks.key_inner_prod32_plain, 1),
        key_inner_prod_shoup=(ks.key_inner_prod_shoup_plain, 1))


@contextlib.contextmanager
def swapped_wrappers(make):
    """Within this block the modules that call the path's wrappers
    (path_wrappers) call make(name, wrapper) in their place: the CKKS
    evaluator, auto, the DNN layers, both encoders, BFV's and BGV's schemes
    and evaluators, the keys, and ops/bconv.py's BEHZ/HPS conversions, which
    call bconv_matmul."""
    from tpu_fhe_torch.eval import auto, bfv_eval, bgv_eval, evaluator as ev
    from tpu_fhe_torch.models import dnn
    from tpu_fhe_torch.ops import bconv
    from tpu_fhe_torch.scheme import batch_encoder, bfv, bgv, ckks_encoder, keys

    saved = [(mod, name, getattr(mod, name))
             for mod in (ev, auto, dnn, ckks_encoder, bfv_eval, bgv_eval, bfv, bgv,
                         batch_encoder, keys, bconv)
             for name in path_wrappers() if hasattr(mod, name)]
    for mod, name, fn in saved:
        setattr(mod, name, make(name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def plain_versions():
    """Within this block the path computes through the kernels' plain torch
    versions, on the same CUDA tensors."""
    plain = path_wrappers()
    return swapped_wrappers(lambda name, fn: plain[name][0])


def _arg_key(a):
    import torch

    if isinstance(a, torch.Tensor):
        return tuple(a.shape), str(a.dtype)
    return None if a is None else type(a).__name__


def recorded_calls(calls: dict):
    """Within this block every call of the path's wrappers counts one in
    calls["count"], and the first call of each distinct wrapper and shapes
    of its arguments keeps them in calls["args"] (the data arguments
    cloned, the context's tables and keys by reference) for path_checks."""
    data = {name: lead for name, (_, lead) in path_wrappers().items()}
    calls.update(count=0, args={})

    def make(name, fn):
        def call(*args, **kw):
            key = (name, tuple(_arg_key(a) for a in args),
                   tuple((k, _arg_key(v)) for k, v in sorted(kw.items())))
            if key not in calls["args"]:
                calls["args"][key] = (name, fn, tuple(a.clone() if i < data[name] else a
                                                      for i, a in enumerate(args)), kw)
            calls["count"] += 1
            return fn(*args, **kw)
        return call
    return swapped_wrappers(make)


def wrapper_cost(name: str, args: tuple, kw: dict) -> dict:
    """Bytes and operations of one call of a path wrapper on `args` (the
    forms of ntt_cost and bconv_cost; the inner products as in
    boot_path_checks)."""
    x = args[0]
    word, n = x.element_size(), x.shape[-1]
    per_mul = IMAD_PER_MUL32 if word == 4 else IMAD_PER_MUL64
    if name.startswith("bconv"):
        k = x.shape[-2]
        return bconv_cost(word, x.numel() // (k * n), k, args[1].shape[0], n)
    if name.startswith("key_inner_prod"):
        beta, L, _ = x.shape
        if name == "key_inner_prod_shoup":
            return dict(nbytes=word * n * (beta * L + 2 * 2 * beta * L + 2 * L),
                        imads=3 * 2 * beta * L * n * per_mul)
        nbytes = word * n * (beta * L + 2 * beta * L + 2 * L)
        if word == 4:
            return dict(nbytes=nbytes, imads=2 * L * n * (beta * IMAD_PER_WIDE32
                                                          + 7 * IMAD_PER_MUL32))
        return dict(nbytes=nbytes, imads=2 * L * n * (2 * beta + 6) * IMAD_PER_MUL64)
    L, rows = x.shape[-2], x.numel() // n
    if name == "forward_ntt_sub_scale":
        pre = kw.get("pre", args[5] if len(args) > 5 else None)
        return dict(nbytes=word * n * (3 * rows + 2 * L),
                    imads=ntt_cost(word, rows, L, extra_muls=1 + (pre is not None), n=n)[1])
    if name == "forward_ntt":
        extra = 0
    elif name == "inverse_ntt_scaled" and kw.get("scale", args[2] if len(args) > 2 else None) \
            is not None:
        extra = 2
    else:
        extra = 1
    nbytes, imads = ntt_cost(word, rows, L, extra_muls=extra, n=n)
    return dict(nbytes=nbytes, imads=imads)


def path_checks(tag: str, what: str, ck: Checker, calls: dict, launches: dict) -> None:
    """Every kernel of a run recorded by recorded_calls against its plain
    version at every distinct shape the run gave its wrapper, on the run's
    own arguments and tables: bit-exact, and each kernel's widest shape
    also timed and bounded (Checker.check, listed under "checks").  The
    recorded calls must equal the run's launches (`launches`), and every
    kernel the run launched must have been held."""
    import torch

    plain = {name: fn for name, (fn, _) in path_wrappers().items()}
    if calls["count"] != sum(launches.values()):
        fail(f"{tag} {what}: {calls['count']} wrapper calls recorded against "
             f"{sum(launches.values())} launches")
    t0 = time.time()
    held: dict = {}
    for name, fn, args, kw in calls["args"].values():
        ck.reset()
        got = fn(*args, **kw)
        kernel = [k for k, v in ck.launches().items() if v]
        want = plain[name](*args, **kw)
        torch.cuda.synchronize()
        if len(kernel) != 1:
            fail(f"{tag} {what}: one call of {name} launched {kernel}")
        if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
            fail(f"{tag} {what}: {kernel[0]} ({name}) at {tuple(args[0].shape)} differs from "
                 "its plain version")
        held.setdefault(kernel[0], []).append((name, fn, args, kw))
    missing = [k for k, v in launches.items() if v and k not in held]
    if missing:
        fail(f"{tag} {what}: launched but never held against the plain version: {missing}")
    for kernel, entries in held.items():
        name, fn, args, kw = max(entries, key=lambda e: e[2][0].numel())
        dims = ", ".join(f"2^{d.bit_length() - 1}" if i == args[0].dim() - 1 else str(d)
                         for i, d in enumerate(args[0].shape))
        ck.check(kernel, f"({dims}), the widest of {len(entries)} shapes of the {what}",
                 lambda: fn(*args, **kw), lambda: plain[name](*args, **kw),
                 **wrapper_cost(name, args, kw))
        ck.report[kernel].setdefault("path_shapes", {})[f"{tag} {what}"] = len(entries)
    log(f"[{tag} kernels] the {what}: every kernel at every distinct shape of its "
        f"{calls['count']} wrapper calls == plain versions, bit for bit ("
        + ", ".join(f"{k} {len(v)}" for k, v in held.items())
        + f" shapes) in {time.time() - t0:.1f} s")


def _meta(c) -> tuple:
    """A ciphertext's or plaintext's metadata: every field but the data."""
    return (c.chain_index, c.scale, c.noise_scale_deg, getattr(c, "correction_factor", None),
            c.is_ntt_form, getattr(c, "is_asymmetric", None))


def plain_matches(tag: str, what: str, ck: Checker, run, got: list) -> None:
    """`run()` (a list of ciphertexts) through the plain versions equals
    `got`, the same run through the kernels: every limb, the chain index,
    the scale and the noise-scale degree.  The plain run launches
    nothing."""
    import torch

    ck.reset()
    with plain_versions():
        want = run()
    torch.cuda.synchronize()
    if any(ck.launches().values()):
        fail(f"{tag} {what}: the run through the plain versions launched kernels")
    if len(got) != len(want) or not all(torch.equal(g.data, w.data) and _meta(g) == _meta(w)
                                        for g, w in zip(got, want)):
        fail(f"{tag} {what} through the kernels differs from the plain versions")
    log(f"[{tag} slice] {what}: kernels == plain versions, bit for bit")


def same_as_plain(tag: str, what: str, ck: Checker, run) -> list:
    """`run()` (a list of ciphertexts) through the kernels equals the same
    through the plain versions (plain_matches).  Returns the kernels' run."""
    outs = run()
    plain_matches(tag, what, ck, run, outs)
    return outs


def rotation_phase(tag: str, ctx, ck: Checker, sk, scale: float, keep: int, off_path: tuple,
                   card: str) -> tuple[dict, object]:
    """Phase 6: Galois keys, ROT_REQUESTS rotation requests at chain index
    1 (results mod-dropped to `keep` limbs before decryption), the launch
    and bit-exact checks, and the rotation timings.  Returns the launch
    counts of the requests and the Galois keys."""
    import torch

    from tpu_fhe_torch.eval import evaluator as ev, hoisting as ho
    from tpu_fhe_torch.scheme.ciphertext import Ciphertext
    from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder

    t0 = time.time()
    gk = sk.galois_key(ROT_STEPS, include_conj=True)
    torch.cuda.synchronize()
    key = next(iter(gk.keys.values()))
    log(f"[{tag} keygen] galois_key({ROT_STEPS}, include_conj=True): {len(gk.keys)} keys "
        f"{tuple(key.data.shape)} {key.data.dtype}, Shoup words: {key.shoup is not None}: "
        f"{time.time() - t0:.1f} s")
    enc = CkksEncoder(ctx)
    rng = np.random.default_rng(9)

    def decoded(ct):
        while ctx.level(ct.chain_index).size > keep:
            ct = ev.mod_drop_to_next(ctx, ct)
        return enc.decode(sk.decrypt(ct))

    ck.reset()
    steps = StepLaunches(ck)
    cts = []
    for r in range(ROT_REQUESTS):
        x = rng.standard_normal(N // 2) + 1j * rng.standard_normal(N // 2)
        t0 = time.time()
        ct = sk.encrypt_symmetric(enc.encode(x, scale))
        steps.add("encode+encrypt")
        torch.cuda.synchronize()
        t1 = time.time()
        outs = {f"rotate {s}": (ev.rotate(ctx, ct, s, gk), np.roll(x, -s)) for s in (1, 2, -1, 3)}
        outs["conjugate"] = (ev.conjugate(ctx, ct, gk), np.conj(x))
        outs[f"hoisted sum {HOIST_STEPS}"] = (ho.hoisted_rotation_sum(ctx, ct, HOIST_STEPS, gk),
                                              sum(np.roll(x, -s) for s in HOIST_STEPS))
        steps.add("6 operations")
        torch.cuda.synchronize()
        t2 = time.time()
        errs = {}
        for name, (out, want) in outs.items():
            got = decoded(out)
            if got.shape != (N // 2,) or not np.all(np.isfinite(got)):
                fail(f"{tag} rotation request {r}, {name}: decoded {got.shape} with "
                     "non-finite values")
            errs[name] = float(np.max(np.abs(got - want)))
        steps.add("drop+decrypt+decode")
        t3 = time.time()
        log(f"[{tag} rotation request {r}] encode+encrypt {t1 - t0:.3f} s, 6 operations "
            f"{(t2 - t1) * 1e3:.2f} ms, drop to {keep} limbs+decrypt+decode {t3 - t2:.2f} s; "
            "max err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        for name, err in errs.items():
            if not err <= TOL:
                fail(f"{tag} rotation request {r}, {name}: max error {err} > {TOL}")
        cts.append(ct)
    launches = ck.launches()
    log(f"[{tag} rotations] launches over {ROT_REQUESTS} requests: {launches}")
    steps.log(f"[{tag} rotations]", f"{ROT_REQUESTS} requests")
    ck.require_launched(f"{tag} rotation", launches, off_path)

    ct = cts[0]
    same_as_plain(tag, "rotate and hoisted_rotation_sum", ck,
                  lambda: [ev.rotate(ctx, ct, 1, gk),
                           ho.hoisted_rotation_sum(ctx, ct, HOIST_STEPS, gk)])

    def rotate():
        return ev.rotate(ctx, ct, 1, gk)

    rot_ms, spread, pairs = marginal_ms(f"{tag} rotate", rotate)
    log(f"[{tag} rotate] chain index 1, {ctx.level(1).size} + {ctx.params.size_P} limbs: "
        f"{rot_ms:.4f} ms/op, {1e3 / rot_ms:.2f} rotations/s (median of {pairs} marginal "
        f"pairs, spread {spread * 100:.0f}%) on {card}")
    ck.reset()
    rotate()
    log(f"[{tag} rotate] launches per rotate: {ck.launches()}")
    profile_ops(tag, rotate, "rotate")

    steps = tuple(ROT_STEPS)

    def separate() -> Ciphertext:
        acc = ev.rotate(ctx, ct, steps[0], gk)
        for s in steps[1:]:
            acc = ev.add(ctx, acc, ev.rotate(ctx, ct, s, gk))
        return acc

    def hoisted() -> Ciphertext:
        return ho.hoisted_rotation_sum(ctx, ct, steps, gk)

    hoist_ms, hoist_spread, _ = marginal_ms(f"{tag} hoisted", hoisted, iters=20)
    sep_ms, sep_spread, _ = marginal_ms(f"{tag} separate", separate, iters=20)
    log(f"[{tag} hoisting] sum of rotations by {steps}: hoisted_rotation_sum {hoist_ms:.4f} "
        f"ms (spread {hoist_spread * 100:.0f}%), {len(steps)} rotates + {len(steps) - 1} adds "
        f"{sep_ms:.4f} ms (spread {sep_spread * 100:.0f}%): {sep_ms / hoist_ms:.2f}x on {card}")
    profile_ops(tag, hoisted, "hoisted sum", reps=5)
    return launches, gk


# --------------------------------------------------------------------------
# the evaluation layer: the graph Evaluator, EvalMod, raise_mod
# --------------------------------------------------------------------------

def graph_phase(tag: str, ctx, ck: Checker, rlk, gk, card: str) -> None:
    """Phase 7: every method of the graph-replaying Evaluator (eval/jit.py)
    through its graph (the first call captures and replays, the second
    replays) bit-identical to the eager module function on the same inputs
    at chain index 1; a replay on new inputs leaves an earlier result as it
    was; then eager and graph ms/op (median-of-pairs marginal, turns eager,
    graph, graph, eager) for relinearize, multiply_relin and rotate, with a
    profile window of each op's replays, and the peak device memory.  The
    launch counters count in Python, so a graph's launches are its eager
    launches once per replay; they are logged per method."""
    import torch

    from tpu_fhe_torch.eval import auto, evaluator as ev
    from tpu_fhe_torch.eval.jit import Evaluator
    from tpu_fhe_torch.ops.galois import galois_elt_from_step
    from tpu_fhe_torch.scheme.ciphertext import Ciphertext, Plaintext

    level = ctx.level(1)
    residues = residue_maker(ctx.device, N, 2100)
    scale = auto.default_scale(ctx)
    a, b, c3, c3b = (Ciphertext(residues(level.mod.q, s), 1, scale) for s in (2, 2, 3, 3))
    pt = Plaintext(residues(level.mod.q), 1, scale)
    elt = galois_elt_from_step(1, N)
    calls = {
        "add": (lambda E: E.add(a, b), lambda: ev.add(ctx, a, b)),
        "sub": (lambda E: E.sub(a, b), lambda: ev.sub(ctx, a, b)),
        "negate": (lambda E: E.negate(a), lambda: ev.negate(ctx, a)),
        "add_plain": (lambda E: E.add_plain(a, pt), lambda: ev.add_plain(ctx, a, pt)),
        "sub_plain": (lambda E: E.sub_plain(a, pt), lambda: ev.sub_plain(ctx, a, pt)),
        "multiply": (lambda E: E.multiply(a, b), lambda: ev.multiply(ctx, a, b)),
        "multiply_plain": (lambda E: E.multiply_plain(a, pt),
                           lambda: ev.multiply_plain(ctx, a, pt)),
        "square": (lambda E: E.square(a), lambda: ev.square(ctx, a)),
        "relinearize": (lambda E: E.relinearize(c3, rlk), lambda: ev.relinearize(ctx, c3, rlk)),
        "multiply_relin": (lambda E: E.multiply_relin(a, b, rlk),
                           lambda: ev.relinearize(ctx, ev.multiply(ctx, a, b), rlk)),
        "square_relin": (lambda E: E.square_relin(a, rlk),
                         lambda: ev.relinearize(ctx, ev.square(ctx, a), rlk)),
        "rescale": (lambda E: E.rescale(a), lambda: ev.rescale_to_next(ctx, a)),
        "mod_drop": (lambda E: E.mod_drop(a), lambda: ev.mod_drop_to_next(ctx, a)),
        "rotate": (lambda E: E.rotate(a, 1, gk),
                   lambda: ev.apply_galois_with_key(ctx, a, elt, gk.key_for_elt(elt))),
        "conjugate": (lambda E: E.conjugate(a, gk), lambda: ev.conjugate(ctx, a, gk)),
    }

    def meta(c):
        return c.chain_index, c.scale, c.noise_scale_deg, tuple(c.data.shape), c.data.dtype

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    E = Evaluator(ctx)
    for name, (via, direct) in calls.items():
        ck.reset()
        want = direct()
        eager = {k: v for k, v in ck.launches().items() if v}
        first, again = via(E), via(E)
        torch.cuda.synchronize()
        for got in (first, again):
            if meta(got) != meta(want) or not torch.equal(got.data, want.data):
                fail(f"{tag} Evaluator.{name}: the graph replay differs from the eager op")
        log(f"[{tag} graph] Evaluator.{name}: capture and 2 replays == eager, bit for bit; "
            f"launches per replay (as eager) {eager}")
    first = E.relinearize(c3, rlk)
    kept = first.data.clone()
    second = E.relinearize(c3b, rlk)
    torch.cuda.synchronize()
    if not torch.equal(first.data, kept) or torch.equal(first.data, second.data) or \
            not torch.equal(second.data, ev.relinearize(ctx, c3b, rlk).data):
        fail(f"{tag} Evaluator: a replay on new inputs changed an earlier result")
    log(f"[{tag} graph] a replay on new inputs leaves the earlier result as it was "
        f"(results are clones)")
    log(f"[{tag} graph] {E.num_graphs} graphs in one pool; peak device memory since the "
        f"phase began {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    timed = {"relinearize": calls["relinearize"], "multiply_relin": calls["multiply_relin"],
             "rotate": calls["rotate"]}
    for name, (via, direct) in timed.items():
        def graph():
            return via(E)
        turns = [marginal_ms(f"{tag} {turn} {name}", fn)
                 for turn, fn in (("eager", direct), ("graph", graph), ("graph", graph),
                                  ("eager", direct))]
        ms = [t[0] for t in turns]
        log(f"[{tag} graph] {name} at chain index 1, ms/op (median of marginal pairs; turns "
            f"eager, graph, graph, eager): " + ", ".join(
                f"{m:.4f} (spread {t[1] * 100:.0f}%)" for m, t in zip(ms, turns))
            + f"; eager/graph {(ms[0] + ms[3]) / (ms[1] + ms[2]):.2f}x on {card}")
        profile_ops(f"{tag} graph", graph, name)


# bootstrap.py's sine stage (EvalMod): (K, r, degree) of the sine's
# Chebyshev approximation, K the bound of the integer part, r the number of
# double angles (tpu_fhe/boot/bootstrap.py:33-35, 71-72, 81-87)
SPARSE_SINE = (28, 3, 44)                # the sparse-secret set
UNIFORM_SINE = (512, 6, 88)              # the default, uniform ternary secret
EVALMOD_TOL = 1e-5


def eval_mod_clear(x: np.ndarray, coeffs: list[float], r: int) -> np.ndarray:
    """The same polynomial and recurrence in float64 (the c0/2 convention
    of eval/chebyshev.py)."""
    from tpu_fhe_torch.boot.bootstrap import double_angle_constant

    c = np.array(coeffs, dtype=np.float64)
    c[0] /= 2
    y = np.polynomial.chebyshev.chebval(x, c)
    for j in range(1, r + 1):
        y = 2 * y * y + double_angle_constant(j, r)
    return y


def eval_mod_phase(tag: str, ctx, ck: Checker, sk, rlk, sine: tuple, off_path: tuple,
                   card: str) -> dict:
    """Phase 8: EvalMod on N/2 real slots uniform in [-1, 1], encrypted at
    chain index 1 at the ladder's scale: decoded within EVALMOD_TOL of the
    cleartext, every kernel of the path launched (counters set to 0 just
    before, split by stage), bit-identical to the same through the plain
    versions, ms per EvalMod (CUDA events) and a profile window.  Returns
    the launch counts of the counted run."""
    import torch

    from tpu_fhe_torch.boot.bootstrap import eval_mod, gen_sine_coefficients
    from tpu_fhe_torch.eval import auto
    from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder

    k, r, degree = sine
    coeffs = gen_sine_coefficients(k, r, degree)
    enc = CkksEncoder(ctx)
    x = np.random.default_rng(12).uniform(-1.0, 1.0, N // 2)
    ct = sk.encrypt_symmetric(enc.encode(x, auto.default_scale(ctx)))
    torch.cuda.synchronize()
    ck.reset()
    steps = StepLaunches(ck)
    t0 = time.time()
    out = eval_mod(ctx, ct, rlk, coeffs, r, steps.add)
    torch.cuda.synchronize()
    host_ms = (time.time() - t0) * 1e3
    launches = ck.launches()
    got = enc.decode(sk.decrypt(out)).real
    if got.shape != (N // 2,) or not np.all(np.isfinite(got)):
        fail(f"{tag} EvalMod: decoded {got.shape} with non-finite values")
    err = float(np.max(np.abs(got - eval_mod_clear(x, coeffs, r))))
    log(f"[{tag} EvalMod] K={k}, r={r}, degree {degree}: chain index 1 -> {out.chain_index} "
        f"(noise-scale degree {out.noise_scale_deg}), first run {host_ms:.1f} ms (host clock), "
        f"max err {err:.3e} against the float64 cleartext")
    if not err <= EVALMOD_TOL:
        fail(f"{tag} EvalMod: max error {err} > {EVALMOD_TOL}")
    log(f"[{tag} EvalMod] launches in one EvalMod: {launches}")
    steps.log(f"[{tag} EvalMod]", "one EvalMod")
    ck.require_launched(f"{tag} EvalMod", launches, off_path)
    same_as_plain(tag, "EvalMod", ck, lambda: [eval_mod(ctx, ct, rlk, coeffs, r)])

    def run():
        return eval_mod(ctx, ct, rlk, coeffs, r)

    ms = cuda_ms(run, reps=3, samples=3)
    log(f"[{tag} EvalMod] {ms:.3f} ms per EvalMod (CUDA events, mean of 3, median of 3) "
        f"on {card}")
    profile_ops(f"{tag} EvalMod", run, "EvalMod", reps=2)
    return launches


def raise_mod_phase(tag: str, ctx, ck: Checker, sk) -> dict:
    """Phase 9: raise_mod of a ciphertext at the anchor level (the last
    level on the u64 plan; the anchor pair, by Garner, on the q32 plan)
    back to chain index 1: the forward and inverse NTT kernels launched,
    bit-identical to the plain versions, and the raised decryption's
    composed coefficients minus the anchor level's all multiples of the
    anchor's product Qa, some not zero.  Returns the launch counts."""
    import torch

    from tpu_fhe_torch.eval import auto
    from tpu_fhe_torch.ops.ntt import inverse_ntt
    from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder, _compose_signed

    d = auto.composite_degree(ctx)
    anchor = len(ctx.chain) - d
    enc = CkksEncoder(ctx)
    x = 0.1 * np.random.default_rng(13).standard_normal(N // 2)
    ct = sk.encrypt_symmetric(enc.encode(x, 2.0 ** 40, chain_index=anchor))
    torch.cuda.synchronize()
    ck.reset()
    raised = auto.raise_mod(ctx, ct)
    torch.cuda.synchronize()
    launches = ck.launches()
    log(f"[{tag} raise_mod] chain index {anchor} ({d} limb{'s' * (d > 1)}) -> "
        f"{raised.chain_index} ({ctx.level(raised.chain_index).size} limbs); launches "
        f"{launches}")
    ck.require_launched(f"{tag} raise_mod", launches,
                        tuple(n for n in launches if "landing" in n or
                              not n.startswith(("ntt_fwd", "ntt_inv"))))
    same_as_plain(tag, "raise_mod", ck, lambda: [auto.raise_mod(ctx, ct)])

    def coeffs(c):
        level = ctx.level(c.chain_index)
        data = inverse_ntt(sk.decrypt(c).data, level.ntt).to(torch.int64)
        return _compose_signed(data.cpu().numpy().view(np.uint64), level.base)

    qa = 1
    for q in ctx.q_values[:d]:
        qa *= q
    residual = [b - s for b, s in zip(coeffs(raised), coeffs(ct))]
    wraps = sum(r_ != 0 for r_ in residual)
    if any(r_ % qa for r_ in residual) or not wraps:
        fail(f"{tag} raise_mod: the raised decryption is not the anchor's plus multiples "
             f"of Qa ({wraps} nonzero)")
    log(f"[{tag} raise_mod] composed coefficients: raised - anchor level are multiples of "
        f"Qa ({qa.bit_length()} bits), {wraps} of {N} nonzero")
    return launches


# --------------------------------------------------------------------------
# the bootstrap: the flagship at N = 2^16, and the kernels against the plain
# versions at N = 2^12
# --------------------------------------------------------------------------

BOOT_N = 1 << 16
BOOT_BUDGET, BOOT_DIM1 = (4, 4), (8, 8)
# the reference's precision at this configuration (measurements/r03/
# boot16_60bit.log:7, boot16_q32_s58d.log:8) less half a bit, and its levels
# after the bootstrap
BOOT_MIN_BITS = {"u64": 14.1, "q32": 12.9}
BOOT_LEVELS_AFTER = 4
BOOT_DROP_TO = {"u64": 2, "q32": 4}      # input limbs (examples/bootstrap_ckks.py:173-178)
SMALL_N, SMALL_SLOTS = 1 << 12, 64
BOOT11_MIN_BITS = 10.0                   # examples/bootstrap_ckks.py:203's assertion
META_PRECISION = 12


def boot_context(plan: str, n: int, sine: tuple, budget: tuple, levels_after: int):
    """examples/bootstrap_ckks.py's context for `plan` (u64, or --q32) at ring
    size n: depth = levels_after + the sine's depth + sum(budget) + 2
    (:114-117); u64 [60] + [59] * depth + [60] * P with P = ceil((depth + 1)
    / 2); q32 create_composite(n, 58, depth, degree=2, anchor_bits=30,
    special_bits=30, special_count=depth + 1)."""
    from tpu_fhe_torch.boot.bootstrap import gen_sine_coefficients
    from tpu_fhe_torch.core.modulus import CoeffModulus
    from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
    from tpu_fhe_torch.eval import chebyshev as cheb
    from tpu_fhe_torch.scheme.context import FheContext

    approx = cheb.get_mult_depth_by_coeff_vector(gen_sine_coefficients(*sine),
                                                 normalized=False) + sine[1]
    depth = levels_after + approx + sum(budget) + 2
    if plan == "q32":
        size_p = depth + 1
        params = EncryptionParameters(
            SchemeType.ckks, n, tuple(CoeffModulus.create_composite(
                n, 58, depth, degree=2, anchor_bits=30, special_bits=30, special_count=size_p)),
            special_modulus_size=size_p, composite_degree=2, allow_insecure=True)
    else:
        size_p = max(2, -(-(depth + 1) // 2))
        params = EncryptionParameters(
            SchemeType.ckks, n, tuple(CoeffModulus.create(n, [60] + [59] * depth + [60] * size_p)),
            special_modulus_size=size_p, allow_insecure=True)
    return FheContext(params)


def boot_path_checks(tag: str, ck: Checker) -> None:
    """Phase 3 at the flagship bootstrap's widest keyswitch: phase 10's
    context at chain index 1 (u64 26 + 13 limbs, q32 52 + 26, dnum 2, N =
    2^16), on that context's own tables.  Each kernel of the bootstrap's path
    against its plain version at the shapes the path launches it: modup's
    forward NTT of a digit's complement and base conversion of a digit,
    the level's and P's scaled inverse NTTs, moddown's base conversion of
    P and its landing, and the inner products with a key of dnum digits,
    with Shoup words (the relin key; the Galois keys too on the q32 plan
    when keygen picks them) and without (the u64 plan's Galois keys)."""
    from tpu_fhe_torch.ops import bconv, ks, modarith as mm, ntt

    t0 = time.time()
    ctx = boot_context(tag, BOOT_N, UNIFORM_SINE, BOOT_BUDGET, levels_after=1)
    q32 = ctx.is_q32
    n, word, sfx = BOOT_N, 4 if q32 else 8, f"2^{BOOT_N.bit_length() - 1}"
    per_mul = IMAD_PER_MUL32 if q32 else IMAD_PER_MUL64
    suffix = "32" if q32 else ""
    level = ctx.level(1)
    kst = level.ks
    L, P, beta = level.size, kst.p_ntt.num_limbs, kst.beta
    qlp_n = L + P
    dnum = -(-ctx.params.size_Q // ctx.params.size_P)
    log(f"[{tag} kernels] the flagship bootstrap's chain index 1 (N={sfx}, {L} + {P} limbs, "
        f"dnum {dnum}): context {time.time() - t0:.1f} s")
    residues = residue_maker(ctx.device, n, 2090)
    dig = kst.digits[0]
    comp, m, k_in = dig.comp_ntt, dig.comp_mod.q.shape[0], dig.end - dig.start
    x = residues(comp.q)
    ck.check(f"ntt_fwd{suffix}", f"({m}, {sfx}) digit complement",
             lambda: ntt.forward_ntt(x, comp), lambda: ntt.forward_ntt_plain(x, comp),
             *ntt_cost(word, m, m, n=n))
    xl = residues(level.mod.q)
    scale = (kst.part_qhatinv, kst.part_qhatinv_shoup)
    ck.check(f"ntt_inv{suffix}", f"({L}, {sfx}) scaled",
             lambda: ntt.inverse_ntt_scaled(xl, level.ntt, *scale),
             lambda: ntt.inverse_ntt_plain(xl, level.ntt, *scale),
             *ntt_cost(word, L, L, extra_muls=2, n=n))
    xp = residues(kst.p_mod.q, 2)
    pscale = (kst.p_hatinv, kst.p_hatinv_shoup)
    ck.check(f"ntt_inv{suffix}", f"(2, {P}, {sfx}) scaled",
             lambda: ntt.inverse_ntt_scaled(xp, kst.p_ntt, *pscale),
             lambda: ntt.inverse_ntt_plain(xp, kst.p_ntt, *pscale),
             *ntt_cost(word, 2 * P, P, extra_muls=2, n=n))
    xs, sub = residues(level.mod.q, 2), residues(level.mod.q, 2)
    post = (kst.big_pinv_mod_q, kst.big_pinv_mod_q_shoup)
    ck.check(f"ntt_fwd_landing{suffix}", f"(2, {L}, {sfx})",
             lambda: ntt.forward_ntt_sub_scale(xs, sub, level.ntt, *post),
             lambda: ntt.forward_ntt_sub_scale_plain(xs, sub, level.ntt, *post),
             word * n * (3 * 2 * L + 2 * L), ntt_cost(word, 2 * L, L, extra_muls=1, n=n)[1])
    if q32:
        conv, conv_plain = bconv.bconv_matmul32, bconv.bconv_matmul32_plain
        dtab = (dig.qhat_mod_p, dig.comp_mod.q, dig.comp_mod.fold, dig.qhat_mod_p_diag)
        ptab = (kst.p_hat_mod_q, level.mod.q, level.mod.fold, kst.p_hat_mod_q_diag)
    else:
        conv, conv_plain = bconv.bconv_matmul, bconv.bconv_matmul_plain
        dtab = (dig.qhat_mod_p, dig.comp_mod.q, dig.comp_mod.ratio_lo, dig.comp_mod.ratio_hi,
                dig.qhat_mod_p_diag)
        ptab = (kst.p_hat_mod_q, level.mod.q, level.mod.ratio_lo, level.mod.ratio_hi,
                kst.p_hat_mod_q_diag)
    name = "bconv32" if q32 else "bconv_mxu"
    s = residues(level.mod.q[dig.start:dig.end])
    ck.check(name, f"{k_in} -> {m}, ({k_in}, {sfx})", lambda: conv(s, *dtab),
             lambda: conv_plain(s, *dtab), **bconv_cost(word, 1, k_in, m, n))
    s2 = residues(kst.p_mod.q, 2)
    ck.check(name, f"{P} -> {L}, (2, {P}, {sfx})", lambda: conv(s2, *ptab),
             lambda: conv_plain(s2, *ptab), **bconv_cost(word, 2, P, L, n))
    qlp, rows, kq = kst.qlp_mod, kst.qlp_key_rows, ctx.key_level.mod
    t = residues(qlp.q, beta)
    evk = residues(kq.q, dnum, 2)
    evk_s = mm.shoup32_of(evk, kq.q) if q32 else mm.shoup_of(evk, kq.q, kq.ratio_lo,
                                                              kq.ratio_hi)
    shape = f"t ({beta}, {qlp_n}, {sfx}), key ({dnum}, 2, {kq.q.shape[0]}, {sfx})"
    ck.check(f"key_inner_prod_shoup{suffix}", shape,
             lambda: ks.key_inner_prod_shoup(t, evk, evk_s, rows, qlp.q),
             lambda: ks.key_inner_prod_shoup_plain(t, evk, evk_s, rows, qlp.q),
             word * n * (beta * qlp_n + 2 * 2 * beta * qlp_n + 2 * qlp_n),
             3 * 2 * beta * qlp_n * n * per_mul)
    # without Shoup words: per output word beta products into the wide
    # accumulator and one landing (u64: 64x64 -> 128 products and Barrett's
    # 6; q32: 32x32 -> 64 products and the word fold's 7)
    if q32:
        kip, kip_plain, kargs = ks.key_inner_prod32, ks.key_inner_prod32_plain, (rows, qlp.q,
                                                                                 qlp.fold)
        imads = 2 * qlp_n * n * (beta * IMAD_PER_WIDE32 + 7 * IMAD_PER_MUL32)
    else:
        kip, kip_plain = ks.key_inner_prod, ks.key_inner_prod_plain
        kargs = (rows, qlp.q, qlp.ratio_lo, qlp.ratio_hi)
        imads = 2 * qlp_n * n * (2 * beta + 6) * IMAD_PER_MUL64
    ck.check(f"key_inner_prod{suffix}", shape, lambda: kip(t, evk, *kargs),
             lambda: kip_plain(t, evk, *kargs),
             word * n * (beta * qlp_n + 2 * beta * qlp_n + 2 * qlp_n), imads)
    del x, xl, xp, xs, sub, s, s2, t, evk, evk_s, ctx
    log(f"[{tag} kernels] the flagship's shapes checked in {time.time() - t0:.1f} s")


def boot_input(tag: str, ctx, enc, sk, slots: int, seed: int = 0):
    """`slots` values uniform in [-0.8, 0.8] from np.random.default_rng(seed),
    encrypted at the ladder's first scale and mod-dropped to the plan's input
    limbs."""
    from tpu_fhe_torch.eval import auto, evaluator as ev

    x = np.random.default_rng(seed).uniform(-0.8, 0.8, slots)
    ct = sk.encrypt_symmetric(enc.encode(x, auto.default_scale(ctx), slots=slots))
    while ctx.level(ct.chain_index).size > BOOT_DROP_TO[tag]:
        ct = ev.mod_drop_to_next(ctx, ct)
    return x, ct


DENSE_STAGES = ("prelude", "coeffs_to_slots", "conj_split", "eval_mod", "recombine",
                "slots_to_coeffs", "correct")


def stage_ms(boot, run) -> dict:
    """Run `run()`, a dense bootstrap through `boot`, with a CUDA event pair
    around each call of a stage method of `boot` (DENSE_STAGES, the methods
    eval_bootstrap calls on the dense path) and each part of EvalMod.
    Returns ms by stage in the order the stages ended; EvalMod's first call
    is the real part's, its second the imaginary part's."""
    import torch

    events = []

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def timed(name, fn):
        def call(*args):
            start = event()
            out = fn(*args)
            events.append((name, start, event()))
            return out
        return call

    def eval_mod(fn):
        calls = []

        def call(ct):
            branch = ("re", "im")[len(calls)]
            calls.append(branch)
            marks = [("start", event())]
            out = fn(ct, lambda part: marks.append((part, event())))
            for (_, a), (part, b) in zip(marks, marks[1:]):
                events.append((f"  eval_mod ({branch}) {part}", a, b))
            events.append((f"eval_mod ({branch})", marks[0][1], event()))
            return out
        return call

    for name in DENSE_STAGES:
        fn = getattr(boot, name)
        setattr(boot, name, eval_mod(fn) if name == "eval_mod" else timed(name, fn))
    try:
        run()
    finally:
        for name in DENSE_STAGES:
            delattr(boot, name)
    torch.cuda.synchronize()
    return {name: a.elapsed_time(b) for name, a, b in events}


# Each wrapper launches one device kernel per call; the kernel's name in a
# profile says which wrapper launched it (the plan's word aside).
WRAPPER_GROUP = {"ntt_fwd": "fwd_cluster", "ntt_fwd32": "fwd_cluster",
                 "ntt_fwd_landing": "fwd_cluster Landing",
                 "ntt_fwd_landing32": "fwd_cluster Landing",
                 "ntt_inv": "inv_cluster", "ntt_inv32": "inv_cluster",
                 "bconv": "bconv_kernel", "bconv_mxu": "bconv_mxu_kernel",
                 "bconv32": "bconv32_kernel", "key_inner_prod": "ks_kernel",
                 "key_inner_prod32": "ks32_kernel", "key_inner_prod_shoup": "ks_shoup_kernel",
                 "key_inner_prod_shoup32": "ks_shoup_kernel"}


def port_group(key: str) -> str | None:
    """The wrapper group of a profiled device kernel, None for glue."""
    for name in ("fwd_cluster", "inv_cluster", "bconv_mxu_kernel", "bconv32_kernel",
                 "bconv_kernel", "ks_shoup_kernel", "ks32_kernel", "ks_kernel"):
        if re.search(r"(?<!\w)" + name, key):
            return name + " Landing" if name == "fwd_cluster" and "Landing" in key else name
    return None


def profile_window(tag: str, what: str, run, ms: float, ck: Checker, windows: int = 3) -> None:
    """A device-only profile of one `run()`: the window (CUDA events), the
    device's busy time and idle share, the port's kernels against the glue,
    and the kernels with the most device time.  The profile's count of
    each port kernel must equal the launches its wrapper counted in the same
    run: a window that falls short lost events and is taken again, up to
    `windows` in all; the last is printed as undercounted if it still falls
    short, and a count above the wrapper's fails.  Tracing slows the host's
    enqueue, so the window is longer than an untraced run (`ms`); the idle
    share against `ms` is printed beside it."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def window():
        start.record()
        run()
        end.record()
        end.synchronize()

    for attempt in range(1, windows + 1):
        ck.reset()
        device = device_kernels(window)
        want: dict = {}
        for name, count in ck.launches().items():
            if count:
                want[WRAPPER_GROUP[name]] = want.get(WRAPPER_GROUP[name], 0) + count
        seen: dict = {}
        for e in device:
            group = port_group(e.key)
            if group is not None:
                seen[group] = seen.get(group, 0) + e.count
        if any(seen.get(g, 0) > n for g, n in want.items()) or set(seen) - set(want):
            fail(f"{tag} {what} profile: port kernels {seen} beyond the wrappers' launches "
                 f"{want}")
        if seen == want:
            break
        log(f"[{tag} profile] {what}: window {attempt} saw port kernels {seen} of the "
            f"wrappers' {want} (the profiler lost events)")
    lost = seen != want
    window_ms = start.elapsed_time(end)
    busy = sum(e.self_device_time_total for e in device) / 1e3
    ours = sum(e.self_device_time_total for e in device if port_group(e.key)) / 1e3
    if busy <= 0:
        log(f"[{tag} profile] {what}: the profiler saw no device time: idle share not "
            "measured")
        return
    log(f"[{tag} profile] {what}: window {window_ms:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / window_ms:.1f}%), idle "
        f"{100 * (1 - busy / window_ms):.1f}% (against the untraced {ms:.3f} ms: "
        f"{100 * (1 - busy / ms):.1f}%); the port's kernels {ours:.3f} ms, glue "
        f"{busy - ours:.3f} ms in {sum(e.count for e in device)} device kernels; "
        + (f"undercounted: {windows} windows lost events" if lost else
           f"every port launch seen (window {attempt})"))
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:14]:
        log(f"[{tag} profile]   {e.self_device_time_total / 1e3:.3f} ms  "
            f"{e.count} calls  {e.key[:90]}")


def flagship_phase(tag: str, ck: Checker, card: str) -> dict:
    """Phase 10: the flagship bootstrap at N = 2^16, full packing (32768
    slots), level budget (4, 4), dim1 (8, 8), the default sine set K = 512,
    r = 6, degree 88, through the entry points: context, secret key,
    encoder, CkksBootstrapper setup/keygen/eval_bootstrap, decrypt, decode.
    Prints setup and keygen seconds, the keys and their form, peak memory,
    ms per bootstrap and per stage (CUDA events, after one warm-up call),
    the idle share of a profile window, precision bits, levels after and
    the launches of each kernel in one bootstrap; fails below the
    reference's precision less half a bit or at other than 4 levels after.
    Returns the launch counts of the counted run."""
    import torch

    from tpu_fhe_torch.boot.bootstrap import CkksBootstrapper, precision_bits
    from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder
    from tpu_fhe_torch.scheme.keys import SecretKey

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    ctx = boot_context(tag, BOOT_N, UNIFORM_SINE, BOOT_BUDGET, levels_after=1)
    sk, enc = SecretKey(ctx, seed=2024), CkksEncoder(ctx)
    boot = CkksBootstrapper(ctx, enc)
    boot.set_sine_params(*UNIFORM_SINE)
    slots = BOOT_N // 2
    torch.cuda.synchronize()
    t1 = time.time()
    boot.setup(level_budget=BOOT_BUDGET, dim1=BOOT_DIM1, slots=slots)
    torch.cuda.synchronize()
    t2 = time.time()
    boot.keygen(sk, slots)
    torch.cuda.synchronize()
    t3 = time.time()
    pre = boot.precom[slots]
    n_pts = sum(pt is not None for table in (pre.a_c2s, pre.a_s2c) for row in table for pt in row)
    key = next(iter(boot.galois_keys.keys.values()))
    kernel = ("K10 (key_inner_prod_shoup32)" if boot.key_shoup else "K9 (key_inner_prod32)") \
        if ctx.is_q32 else "K7 (key_inner_prod)"
    log(f"[{tag} bootstrap] N=2^{BOOT_N.bit_length() - 1}, {ctx.params.size_Q} + "
        f"{ctx.params.size_P} limbs, {slots} slots, budget {BOOT_BUDGET}, dim1 {BOOT_DIM1}, "
        f"sine {UNIFORM_SINE}: context "
        f"{t1 - t0:.1f} s, setup {t2 - t1:.1f} s ({n_pts} plaintexts), keygen {t3 - t2:.1f} s")
    log(f"[{tag} bootstrap] {len(boot.galois_keys.keys)} Galois keys {tuple(key.data.shape)} "
        f"{key.data.dtype}, Shoup words: {boot.key_shoup} (their inner product: {kernel}), "
        f"memory budget {boot.memory_budget() / 2**30:.1f} GiB; peak device memory after "
        f"setup and keygen {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    x, ct = boot_input(tag, ctx, enc, sk, slots)
    torch.cuda.synchronize()
    ck.reset()
    t0 = time.time()
    out = boot.eval_bootstrap(ct, slots)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = ck.launches()
    got = enc.decode(sk.decrypt(out), slots=slots).real
    if got.shape != (slots,) or not np.all(np.isfinite(got)):
        fail(f"{tag} bootstrap: decoded {got.shape} with non-finite values")
    bits = precision_bits(got, x)
    levels = (len(ctx.chain) - 1 - out.chain_index) // ctx.params.composite_degree
    log(f"[{tag} bootstrap] first call {first_s:.2f} s (host clock); precision {bits:.3f} bits "
        f"(limit {BOOT_MIN_BITS[tag]}), levels after {levels}, chain index {ct.chain_index} -> "
        f"{out.chain_index}; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB")
    if not bits >= BOOT_MIN_BITS[tag]:
        fail(f"{tag} bootstrap: precision {bits:.3f} bits < {BOOT_MIN_BITS[tag]}")
    if levels != BOOT_LEVELS_AFTER:
        fail(f"{tag} bootstrap: {levels} levels after, not {BOOT_LEVELS_AFTER}")
    log(f"[{tag} bootstrap] launches in one bootstrap: {launches}")
    # K11 serves k >= 64 only; with Shoup-form Galois keys K10 serves every
    # inner product of the q32 plan
    off_path = ("bconv", "key_inner_prod32") if boot.key_shoup else ("bconv",)
    ck.require_launched(f"{tag} bootstrap", launches, off_path)

    def run():
        return boot.eval_bootstrap(ct, slots)

    ms = cuda_ms(run, reps=1, samples=3)
    log(f"[{tag} bootstrap] {ms:.3f} ms per bootstrap (CUDA events, median of 3 after a "
        f"warm-up) on {card}")
    stages = stage_ms(boot, run)
    log(f"[{tag} bootstrap] ms per stage (CUDA events around each stage method in one "
        f"eval_bootstrap): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    profile_window(f"{tag} bootstrap", "one bootstrap", run, ms, ck)
    log(f"[{tag} bootstrap] peak device memory after one bootstrap "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    return launches


def bootstrap_plain_phase(tag: str, ck: Checker) -> None:
    """Phase 11: at N = 2^12 (examples/bootstrap_ckks.py --logn 12 --levels-after
    3: level budget (2, 2), the default sine set K = 512, r = 6, degree 88),
    a two-iteration dense Meta-BTS (its first iteration is the dense
    bootstrap, which no longer runs alone: phase 14 took its time) and the
    sparse bootstrap (64 slots) through the kernels, each bit-identical to the
    same through the plain versions, each decoding to at least
    BOOT11_MIN_BITS, and the Meta-BTS not returning its input.  The example takes the sparse set
    K = 28, r = 3, degree 44 up to 2^13, but with a uniform ternary secret
    the integer part of the raised plaintext passes K from 2^11 on and the
    sine's Chebyshev series is evaluated outside [-1, 1]: the output does not
    decode.  Three levels after leave Meta-BTS levels to work with."""
    import torch

    from tpu_fhe_torch.boot.bootstrap import CkksBootstrapper, precision_bits
    from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder
    from tpu_fhe_torch.scheme.keys import SecretKey

    t0 = time.time()
    ctx = boot_context(tag, SMALL_N, UNIFORM_SINE, (2, 2), levels_after=3)
    sk, enc = SecretKey(ctx, seed=2025), CkksEncoder(ctx)
    for slots, runs in ((SMALL_N // 2, (2,)), (SMALL_SLOTS, (1,))):
        boot = CkksBootstrapper(ctx, enc)
        boot.setup(level_budget=(2, 2), slots=slots)
        boot.keygen(sk, slots)
        for iterations in runs:
            x, ct = boot_input(tag, ctx, enc, sk, slots, seed=slots + iterations)
            precision = META_PRECISION if iterations > 1 else 0
            what = (f"N=2^12 bootstrap, {slots} slots" +
                    (f", Meta-BTS {iterations} iterations" if iterations > 1 else ""))
            out, = same_as_plain(tag, what, ck, lambda: [
                boot.eval_bootstrap(ct, slots, iterations, precision)])
            if out is ct:
                fail(f"{tag} {what}: returned its input")
            bits = precision_bits(enc.decode(sk.decrypt(out), slots=slots).real, x)
            log(f"[{tag} bootstrap] {what}: precision {bits:.3f} bits, chain index "
                f"{ct.chain_index} -> {out.chain_index}")
            if not bits >= BOOT11_MIN_BITS:
                fail(f"{tag} {what}: precision {bits:.3f} bits < {BOOT11_MIN_BITS}")
    torch.cuda.synchronize()
    log(f"[{tag} bootstrap] phase 11 in {time.time() - t0:.1f} s")



# --------------------------------------------------------------------------
# PPML: the DNN layers against the plain versions at N = 2^10, and encrypted
# ResNet-20 at full width (N = 2^16, q32)
# --------------------------------------------------------------------------

DNN_N, DNN_WIDTH = 1 << 10, 4
DNN_LEVELS_AFTER = 9                     # the least ResNet-20 needs (tools/dnn_golden.py)
DNN_MAX_ERR = 1e-3                       # relu_composite against its float64 composite
RESNET_N, RESNET_WIDTH, RESNET_PLANES = 1 << 16, 32, (16, 32, 64)
RESNET_LEVELS_AFTER = 11                 # examples/resnet20_infer.py:104
RESNET_SLOTS = RESNET_WIDTH ** 2
RESNET_MAX_ERR = 1e-2


def dnn_context(plan: str, n: int, sine: tuple, budget: tuple, levels_after: int,
                special: int):
    """examples/resnet20_infer.py's context for `plan` (u64, or --q32) at ring
    size n: depth = levels_after + the bootstrap's depth (the sine's depth +
    r + sum(budget), :119-126); u64 [60] + [59] * depth + [60] * special
    (:116, :149-156); q32 create_composite(n, 58, depth, degree=2,
    anchor_bits=30, special_bits=30, special_count=depth + 1) (:131-147)."""
    from tpu_fhe_torch.boot.bootstrap import gen_sine_coefficients
    from tpu_fhe_torch.core.modulus import CoeffModulus
    from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
    from tpu_fhe_torch.eval import chebyshev as cheb
    from tpu_fhe_torch.scheme.context import FheContext

    depth = levels_after + cheb.get_mult_depth_by_coeff_vector(
        gen_sine_coefficients(*sine), normalized=False) + sine[1] + sum(budget)
    if plan == "q32":
        params = EncryptionParameters(
            SchemeType.ckks, n, tuple(CoeffModulus.create_composite(
                n, 58, depth, degree=2, anchor_bits=30, special_bits=30,
                special_count=depth + 1)),
            special_modulus_size=depth + 1, composite_degree=2, allow_insecure=True)
    else:
        params = EncryptionParameters(
            SchemeType.ckks, n, tuple(CoeffModulus.create(n, [60] + [59] * depth
                                                          + [60] * special)),
            special_modulus_size=special, allow_insecure=True)
    return FheContext(params)


def dnn_plain_phase(tag: str, ck: Checker) -> dict:
    """Phase 12: every DNN layer through the kernels equal to the same
    through the plain versions, at N = 2^10 (the smallest ring the kernels
    take), width 4, 1-2 channels, the sparse sine set K = 28, r = 3, degree
    44 (it decodes up to 2^10), level budget (2, 2): conv at stride 1 and 2
    on the device-encode path and at stride 1 on the host-encode path,
    batch_norm, add, relu, sign(., 0), softmax, relu_composite of one
    channel (three bootstraps at 16 slots) and avg_pool_full_con.  Every
    kernel of the plan but K11 must launch (counters set to 0 first), and
    relu_composite must decode within DNN_MAX_ERR of its float64 composite.
    Returns the launch counts of the layers' run."""
    import torch

    from tpu_fhe_torch.boot.bootstrap import CkksBootstrapper
    from tpu_fhe_torch.models.dnn import DNN, relu_composite_clear
    from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder
    from tpu_fhe_torch.scheme.keys import SecretKey

    t0 = time.time()
    ctx = dnn_context(tag, DNN_N, SPARSE_SINE, (2, 2), DNN_LEVELS_AFTER, special=3)
    sk, enc = SecretKey(ctx, seed=2026), CkksEncoder(ctx)
    model = DNN(ctx, enc)
    model.build_galois_key(sk, DNN.conv_rotation_indices(DNN_WIDTH, 3, 0)
                           + DNN.conv_rotation_indices(DNN_WIDTH // 2, 3, 1)
                           + DNN.avgpool_rotation_indices(DNN_WIDTH, 0))
    slots = DNN_WIDTH ** 2
    boot = CkksBootstrapper(ctx, enc)
    boot.set_sine_params(*SPARSE_SINE)
    boot.setup(level_budget=(2, 2), slots=slots)
    boot.keygen(sk, slots)
    model.mul_key = boot.mul_key
    rng = np.random.default_rng(31)
    images = {name: rng.uniform(-0.5, 0.5, (DNN_WIDTH, DNN_WIDTH, ch))
              for name, ch in (("x2", 2), ("y2", 2), ("x1", 1))}
    x2, y2, x1 = (model.enc_tensor(images[name], sk=sk) for name in ("x2", "y2", "x1"))
    w = rng.normal(0.0, 0.3, (3, 3, 2, 2))
    bn = (rng.uniform(0.7, 1.3, 2), rng.uniform(-0.1, 0.1, 2), rng.uniform(-0.1, 0.1, 2),
          rng.uniform(0.8, 1.2, 2))
    fc = (rng.normal(0.0, 0.5, (3, 2)), rng.normal(0.0, 0.1, 3))
    cases = [
        ("conv stride 1, device encode", lambda: model.conv(x2, w, 1)),
        ("conv stride 2, device encode", lambda: model.conv(x2, w, 2)),
        ("conv stride 1, host encode", lambda: model.conv(x2, w, 1, device_encode=False)),
        ("batch_norm", lambda: model.batch_norm(x2, *bn)),
        ("add", lambda: model.add(model.batch_norm(x2, *bn), y2)),
        ("relu", lambda: model.relu(x2, -1.0, 1.0, 15)),
        ("sign(., 0)", lambda: model.sign(x2, 0)),
        ("softmax", lambda: model.softmax(x2)),
        ("relu_composite of one channel", lambda: model.relu_composite(x1, boot)),
        ("avg_pool_full_con", lambda: model.avg_pool_full_con(x2, *fc)),
    ]
    torch.cuda.synchronize()
    ck.reset()
    outs = [fn() for _, fn in cases]
    torch.cuda.synchronize()
    launches = ck.launches()
    log(f"[{tag} dnn] N=2^{DNN_N.bit_length() - 1}, {ctx.params.size_Q} + "
        f"{ctx.params.size_P} limbs, width {DNN_WIDTH}, sine {SPARSE_SINE}: launches in "
        f"the {len(cases)} layers: {launches}")
    ck.require_launched(f"{tag} DNN layers", launches, ("bconv",))
    for (what, fn), got in zip(cases, outs):
        plain_matches(tag, f"DNN {what}", ck, lambda fn=fn: fn().cts, got.cts)
    err = float(np.max(np.abs(model.dec_tensor(outs[8], sk)
                              - relu_composite_clear(images["x1"]))))
    log(f"[{tag} dnn] relu_composite: max err {err:.3e} against its float64 composite "
        f"(limit {DNN_MAX_ERR}); phase 12 in {time.time() - t0:.1f} s")
    if not err <= DNN_MAX_ERR:
        fail(f"{tag} relu_composite: max error {err} > {DNN_MAX_ERR}")
    return launches


def resnet_phase(ck: Checker, card: str) -> dict:
    """Phase 13: encrypted ResNet-20 at full width on the q32 plan,
    examples/resnet20_infer.py --q32's recipe (:99-175): N = 2^16, width 32,
    planes 16/32/64 from random_weights(default_rng(17)) and the image
    uniform in [-0.5, 0.5) from the same generator, create_composite(2^16,
    58, depth, ...) with depth = 11 + the bootstrap's depth at level budget
    (2, 2), the sine set K = 512, r = 6, degree 88, 1024 slots; through the
    entry points (FheContext, SecretKey, CkksEncoder, DNN,
    prepare_resnet20, CkksBootstrapper setup/keygen, enc_tensor,
    resnet20_infer(layers=1, blocks=1): the stem and layer 1's first block,
    144 bootstraps of one channel, dec_tensor).  The decrypted 32 x 32 x 16
    activations must be within RESNET_MAX_ERR of the float64 shadow that
    applies the same sign composite; the distance to the exact-ReLU shadow
    is printed beside it.  Prints context, setup and keygen seconds, the
    keys and their form, peak memory, ms per stage (CUDA events), the timer
    buckets, ms per channel bootstrap, the launches of each kernel in the
    inference (counters set to 0 just before) and a profile of one
    channel's relu_composite, then holds every kernel of the inference
    against its plain version at each shape the inference launched it at
    (path_checks; the wrapper calls are recorded while the inference
    runs).  Returns the launch counts."""
    import torch

    from tpu_fhe_torch.boot.bootstrap import CkksBootstrapper
    from tpu_fhe_torch.eval import auto
    from tpu_fhe_torch.models import resnet20 as rn
    from tpu_fhe_torch.models.dnn import DNN, TensorCT, relu_composite_clear
    from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder
    from tpu_fhe_torch.scheme.keys import SecretKey
    from tpu_fhe_torch.utils import timer

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    ctx = dnn_context("q32", RESNET_N, UNIFORM_SINE, (2, 2), RESNET_LEVELS_AFTER, special=15)
    sk, enc = SecretKey(ctx, seed=2027), CkksEncoder(ctx)
    model = DNN(ctx, enc, scale=auto.scaling_factors(ctx)[0][0])
    torch.cuda.synchronize()
    t1 = time.time()
    boot = CkksBootstrapper(ctx, enc)
    boot.set_sine_params(*UNIFORM_SINE)
    boot.setup(level_budget=(2, 2), slots=RESNET_SLOTS)
    torch.cuda.synchronize()
    t2 = time.time()
    rn.prepare_resnet20(model, sk, width=RESNET_WIDTH, layers=1)
    boot.keygen(sk, slots=RESNET_SLOTS)
    model.mul_key = boot.mul_key
    torch.cuda.synchronize()
    t3 = time.time()

    def key_bytes(keys) -> int:
        return sum(k.data.numel() * k.data.element_size()
                   + (0 if k.shoup is None else k.shoup.numel() * k.shoup.element_size())
                   for k in keys)

    dnn_key = next(iter(model.gk.keys.values()))
    log(f"[q32 resnet] N=2^{RESNET_N.bit_length() - 1}, {ctx.params.size_Q} + "
        f"{ctx.params.size_P} limbs, width {RESNET_WIDTH}, planes {RESNET_PLANES}, "
        f"{RESNET_SLOTS} slots, sine {UNIFORM_SINE}, budget (2, 2): context {t1 - t0:.1f} s, "
        f"bootstrap setup {t2 - t1:.1f} s, keygen {t3 - t2:.1f} s")
    log(f"[q32 resnet] keys: {len(model.gk.keys)} conv Galois keys {tuple(dnn_key.data.shape)} "
        f"{dnn_key.data.dtype} without Shoup words (K9) "
        f"{key_bytes(model.gk.keys.values()) / 2**30:.2f} GiB; {len(boot.galois_keys.keys)} "
        f"bootstrap Galois keys, Shoup words: {boot.key_shoup} "
        f"{key_bytes(boot.galois_keys.keys.values()) / 2**30:.2f} GiB; relin key "
        f"{key_bytes([boot.mul_key]) / 2**30:.2f} GiB; peak device memory after setup and "
        f"keygen {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    rng = np.random.default_rng(17)
    weights = rn.random_weights(rng, planes=RESNET_PLANES)
    image = rng.uniform(-0.5, 0.5, (RESNET_WIDTH, RESNET_WIDTH, 3))
    x = model.enc_tensor(image, sk=sk)
    events = []

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    calls: dict = {}
    torch.cuda.synchronize()
    timer.clear()
    ck.reset()
    events.append(("start", event()))
    t0 = time.time()
    with recorded_calls(calls):
        out = rn.resnet20_infer(x, model, boot, weights, log=lambda m: log(f"[q32 resnet] {m}"),
                                blocks=1, layers=1,
                                on_stage_done=lambda name, t: events.append((name, event())))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = ck.launches()
    acts = model.dec_tensor(out, sk)
    shadow = rn.resnet20_infer_clear(image, weights, relu=relu_composite_clear, blocks=1,
                                     layers=1)
    exact = rn.resnet20_infer_clear(image, weights, blocks=1, layers=1)
    if acts.shape != shadow.shape or not np.all(np.isfinite(acts)):
        fail(f"q32 resnet: decoded {acts.shape} (want {shadow.shape}) or non-finite values")
    err = float(np.max(np.abs(acts - shadow)))
    buckets = timer.accumulated()
    boots = timer.counts().get("Bootstrap", 0)
    log(f"[q32 resnet] inference (stem + l1b0) {wall:.2f} s (host clock); ms per stage "
        f"(CUDA events): " + ", ".join(f"{b[0]} {a[1].elapsed_time(b[1]):.1f}"
                                       for a, b in zip(events, events[1:])))
    log(f"[q32 resnet] timer buckets (s, sections): " + ", ".join(
        f"{k} {v:.3f} ({timer.counts()[k]})" for k, v in sorted(buckets.items(),
                                                              key=lambda kv: -kv[1])))
    log(f"[q32 resnet] {boots} channel bootstraps at {RESNET_SLOTS} slots, "
        f"{1e3 * buckets.get('Bootstrap', 0.0) / max(boots, 1):.1f} ms each (Bootstrap bucket, "
        f"synchronized host clock)")
    log(f"[q32 resnet] activations {acts.shape}: max err {err:.3e} against the float64 "
        f"sign-composite shadow (limit {RESNET_MAX_ERR}); max distance "
        f"{float(np.max(np.abs(acts - exact))):.3e} to the exact-ReLU shadow (not gated); "
        f"chain index {out.cts[0].chain_index}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[q32 resnet] launches in the inference: {launches}")
    if not err <= RESNET_MAX_ERR:
        fail(f"q32 resnet: max error {err} > {RESNET_MAX_ERR}")
    ck.require_launched("q32 resnet", launches, ("bconv",))

    one = TensorCT(out.cts[:1], out.width, out.slotstr)
    ct = out.cts[0]
    ms = cuda_ms(lambda: boot.eval_bootstrap(ct, RESNET_SLOTS), reps=1, samples=3)
    log(f"[q32 resnet] {ms:.3f} ms per channel bootstrap at {RESNET_SLOTS} slots (CUDA events, "
        f"median of 3 after a warm-up) on {card}")

    def relu_one():
        return model.relu_composite(one, boot)

    relu_ms = cuda_ms(relu_one, reps=1, samples=3)
    log(f"[q32 resnet] {relu_ms:.3f} ms per relu_composite of one channel (three bootstraps; "
        f"CUDA events, median of 3) on {card}")
    profile_window("q32 resnet", "relu_composite of one channel", relu_one, relu_ms, ck)
    log(f"[q32 resnet] peak device memory after the inference "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    # after the profile: each timed check captures and replays a CUDA graph
    path_checks("q32", "ResNet-20 inference", ck, calls, launches)
    return launches


# --------------------------------------------------------------------------
# BFV and BGV at N = 2^16 (phase 14)
# --------------------------------------------------------------------------

BFV_N = 1 << 16
# benchmarks/bfv_bench.py's recipe (:37-46) at --n 65536 --num-data 31
# --data-bits 54 --t-bits 20: [60] + [54] * 30 + [60] (31 data limbs, one
# special), 1740 bits, within the HomomorphicEncryption.org bound for 2^16
# (1777 bits), which the context enforces; the same chain serves BGV
# (benchmarks/bgv_bench.py:37-45)
BFV_BITS = [60] + [54] * 30 + [60]
BFV_T_BITS = 20
BFV_FORMS = ("behz", "hps", "hps_overq", "hps_overq_leveled")
BFV_PLAIN_N = 1 << 12                    # the pass against the plain versions
BFV_PLAIN_BITS = [60] + [54] * 6 + [60]
BFV_STEP = 1
OP_SAMPLES = 5


def fhe_context(scheme: str, n: int, bits: list, tech: str = "behz", secure: bool = True):
    """A BFV or BGV context on the card with t the BFV_T_BITS batching prime
    and one special prime; the security bound is enforced when `secure`."""
    from tpu_fhe_torch.core.modulus import CoeffModulus, PlainModulus
    from tpu_fhe_torch.core.params import EncryptionParameters, MulTech, SchemeType
    from tpu_fhe_torch.scheme.context import FheContext

    return FheContext(EncryptionParameters(
        getattr(SchemeType, scheme), n, tuple(CoeffModulus.create(n, bits)),
        special_modulus_size=1, plain_modulus=PlainModulus.batching(n, BFV_T_BITS),
        mul_tech=getattr(MulTech, tech), allow_insecure=not secure))


def bfv_bgv_ops(scheme: str, tools, enc, sk, keys: dict, vals: list, seed: int) -> dict:
    """The traffic of one context: name -> (fn, the slots its decryption
    must equal, or None for a non-ciphertext result).  BFV: the ops of
    benchmarks/bfv_bench.py's table (:60-70) plus public-key encryption,
    rotate_columns and add_plain; BGV: benchmarks/bgv_bench.py's ops plus a
    depth-2 chain with mod_switch_to_next and a rotation of a switched
    ciphertext, which keeps its correction factor.  Encodes and encrypts
    its operands when called; every fn is deterministic."""
    import torch

    from tpu_fhe_torch.eval import bfv_eval as bv, bgv_eval as bg

    ctx = tools.context
    t = tools.t.value
    a, b, m = (v.astype(object) for v in vals)
    half = ctx.n // 2
    pa, pb, pm = enc.encode(vals[0]), enc.encode(vals[1]), enc.encode(vals[2])
    ca = tools.encrypt_symmetric(sk, pa)
    cb = tools.encrypt_asymmetric(keys["pk"], pb,
                                  torch.Generator(device=ctx.device).manual_seed(seed))
    rows = a.reshape(2, half)
    rot = np.roll(rows, -BFV_STEP, axis=1).reshape(-1)
    ops = {
        "encode": (lambda: enc.encode(vals[0]), None),
        "encrypt_sym": (lambda: tools.encrypt_symmetric(sk, pa), a),
        "encrypt_asym": (lambda: tools.encrypt_asymmetric(
            keys["pk"], pb, torch.Generator(device=ctx.device).manual_seed(seed)), b),
        "decrypt": (lambda: tools.decrypt(sk, ca), None),
    }
    if scheme == "bfv":
        prod = bv.multiply(tools, ca, cb)
        ops.update({
            "add": (lambda: bv.add(ctx, ca, cb), (a + b) % t),
            "multiply": (lambda: bv.multiply(tools, ca, cb), a * b % t),
            "relinearize": (lambda: bv.relinearize(tools, prod, keys["rlk"]), a * b % t),
            "multiply_plain": (lambda: bv.multiply_plain(tools, ca, pm), a * m % t),
            "add_plain": (lambda: bv.add_plain(tools, ca, pm), (a + m) % t),
            "rotate_rows": (lambda: bv.rotate_rows(tools, ca, BFV_STEP, keys["gk"]), rot),
            "rotate_columns": (lambda: bv.rotate_columns(tools, ca, keys["gk"]),
                               rows[::-1].reshape(-1)),
            "mod_switch": (lambda: bv.mod_switch_to_next(tools, ca), a),
        })
        return ops
    prod = bg.multiply(tools, ca, cb)
    ms_a = bg.mod_switch_to_next(tools, ca)
    sq = bg.mod_switch_to_next(tools, bg.relinearize(ctx, bg.multiply(tools, ca, ca),
                                                     keys["rlk"]))
    ops.update({
        "add": (lambda: bg.add(tools, ca, cb), (a + b) % t),
        "multiply": (lambda: bg.multiply(tools, ca, cb), a * b % t),
        "relinearize": (lambda: bg.relinearize(ctx, prod, keys["rlk"]), a * b % t),
        "multiply_plain": (lambda: bg.multiply_plain(tools, ca, pm), a * m % t),
        "rotate": (lambda: bg.rotate(ctx, ca, BFV_STEP, keys["gk"]), rot),
        "mod_switch": (lambda: bg.mod_switch_to_next(tools, ca), a),
        "rotate_switched": (lambda: bg.rotate(ctx, ms_a, BFV_STEP, keys["gk"]), rot),
        "square_switch": (lambda: bg.mod_switch_to_next(tools, bg.relinearize(
            ctx, bg.multiply(tools, ca, ca), keys["rlk"])), a * a % t),
        "depth2_switch": (lambda: bg.mod_switch_to_next(tools, bg.relinearize(
            ctx, bg.multiply(tools, sq, sq), keys["rlk"])), a ** 4 % t),
    })
    return ops


def bfv_bgv_keys(scheme: str, ctx, seed: int) -> tuple:
    """The secret key and the keys of the traffic: public, relin (with
    Shoup words) and Galois keys for BFV_STEP and the row swap (without)."""
    from tpu_fhe_torch.scheme.keys import SecretKey

    sk = SecretKey(ctx, seed=seed)
    return sk, dict(pk=sk.public_key(), rlk=sk.relin_key(),
                    gk=sk.galois_key([BFV_STEP], include_conj=True))


def bfv_bgv_run(forms: list, n: int, check: bool) -> list:
    """One pass of every context's traffic; with `check`, each decryption
    equals its cleartext slots (and each ciphertext's correction factor is
    its input's after a rotation), BFV's noise budget is printed and must
    stay above 0.  Returns every result: ciphertexts and plaintexts."""
    rng = np.random.default_rng(n)
    outs = []
    for form in forms:
        scheme, tools, enc, sk, keys = (form[k] for k in ("scheme", "tools", "enc", "sk",
                                                            "keys"))
        t = tools.t.value
        vals = [rng.integers(0, t, size=n, dtype=np.uint64) for _ in range(3)]
        ops = bfv_bgv_ops(scheme, tools, enc, sk, keys, vals, seed=n + 1)
        budgets = {}
        for name, (fn, want) in ops.items():
            got = fn()
            outs.append(got)
            if not check:
                continue
            if name == "encode":
                dec = enc.decode(got)
                want = vals[0]
            elif name == "decrypt":
                dec, want = enc.decode(got), vals[0]
            else:
                dec = enc.decode(tools.decrypt(sk, got))
                if scheme == "bfv":
                    budgets[name] = tools.invariant_noise_budget(sk, got)
            if not np.array_equal(dec.astype(object), np.asarray(want, dtype=object)):
                fail(f"{form['tag']} {name}: the decryption differs from the cleartext "
                     "result mod t")
        if check and scheme == "bgv":
            rot, ms = ops["rotate_switched"][0](), ops["mod_switch"][0]()
            if rot.correction_factor != ms.correction_factor or ms.correction_factor == 1:
                fail(f"{form['tag']}: the rotation changed the correction factor "
                     f"{ms.correction_factor} -> {rot.correction_factor}")
        if check:
            log(f"[{form['tag']}] N=2^{n.bit_length() - 1}: every decryption == the "
                f"cleartext result mod t, slot for slot ({len(ops)} ops)"
                + (f"; noise budget (bits) after each op: {budgets}" if budgets else ""))
            if budgets and min(budgets.values()) <= 0:
                fail(f"{form['tag']}: noise budget exhausted: {budgets}")
    return outs


def bfv_bgv_forms(n: int, bits: list, secure: bool, seed: int, log_setup: bool) -> list:
    """The contexts of phase 14: BFV on BEHZ and on each HPS form, then BGV,
    each with its tools, encoder and keys (BFV's shared by the four BFV
    contexts, whose chains are the same)."""
    import torch

    from tpu_fhe_torch.scheme.batch_encoder import BatchEncoder
    from tpu_fhe_torch.scheme.bfv import BfvTools
    from tpu_fhe_torch.scheme.bgv import BgvTools
    from tpu_fhe_torch.scheme.keys import SecretKey

    forms, keys = [], {}
    for scheme, tech in [("bfv", f) for f in BFV_FORMS] + [("bgv", "behz")]:
        t0 = time.time()
        ctx = fhe_context(scheme, n, bits, tech, secure)
        torch.cuda.synchronize()
        t1 = time.time()
        tools = (BfvTools if scheme == "bfv" else BgvTools)(ctx)
        tools.level_tables(1)
        if scheme == "bfv" and tech == "behz":
            tools.behz(1)
        elif scheme == "bfv":
            tools.hps(1, 0)
        torch.cuda.synchronize()
        t2 = time.time()
        if scheme not in keys:
            keys[scheme] = bfv_bgv_keys(scheme, ctx, seed)
            torch.cuda.synchronize()
        sk0, kset = keys[scheme]
        sk = SecretKey(ctx, seed=seed + 1, s_ntt=sk0.s_ntt)
        t3 = time.time()
        tag = f"u64 {scheme}" + (f" {tech}" if scheme == "bfv" else "")
        if log_setup:
            log(f"[{tag}] N=2^{n.bit_length() - 1}, {ctx.params.size_Q} + "
                f"{ctx.params.size_P} limbs ({sum(bits)} bits), t = {tools.t.value}: "
                f"context {t1 - t0:.2f} s, tables {t2 - t1:.2f} s, keygen {t3 - t2:.2f} s "
                "(host clock, synchronized)")
        forms.append(dict(tag=tag, scheme=scheme, tech=tech, ctx=ctx, tools=tools,
                          enc=BatchEncoder(ctx), sk=sk, keys=kset))
    return forms


def bfv_bgv_phase(ck: Checker, card: str) -> dict:
    """Phase 14: BFV (BEHZ and the three HPS forms) and BGV at N = 2^16,
    [60] + [54] * 30 + [60] with the security bound enforced, t the 20-bit
    batching prime, through the entry points (FheContext, BfvTools or
    BgvTools, BatchEncoder, SecretKey, eval/bfv_eval.py and
    eval/bgv_eval.py): host seconds of the contexts, tables and keygen, key
    bytes, one pass of every context's traffic (bfv_bgv_ops) with every
    decryption equal to its cleartext slots and BFV's noise budget above 0,
    the launches of each kernel in that pass (counters set to 0 just before;
    every wrapper call recorded), ms per op (CUDA events, median of
    OP_SAMPLES after a warm-up), a profile of one BEHZ multiply and
    relinearize, then every kernel against its plain version at every
    distinct shape of the pass (K3 with its `pre` operand, K12 at k = 63,
    K1 and K2 on the Bsk and QlRl tables among them) and peak memory.  Then
    at N = 2^12 one pass of the same traffic (keygen included) through the
    kernels equal to the same through the plain versions, bit for bit,
    metadata included.  Returns the launches of the 2^16 pass."""
    import torch

    t_phase = time.time()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    forms = bfv_bgv_forms(BFV_N, BFV_BITS, True, 2028, log_setup=True)

    def key_bytes(keys) -> int:
        return sum(k.data.numel() * k.data.element_size()
                   + (0 if k.shoup is None else k.shoup.numel() * k.shoup.element_size())
                   for k in keys)

    for form in forms[:1] + forms[-1:]:
        kset = form["keys"]
        log(f"[{form['tag']}] keys: relin {tuple(kset['rlk'].data.shape)} with Shoup words "
            f"{key_bytes([kset['rlk']]) / 2**30:.2f} GiB; {len(kset['gk'].keys)} Galois keys "
            f"without {key_bytes(kset['gk'].keys.values()) / 2**30:.2f} GiB"
            + ("; shared by the four BFV contexts" if form["scheme"] == "bfv" else ""))
    calls: dict = {}
    torch.cuda.synchronize()
    ck.reset()
    t0 = time.time()
    with recorded_calls(calls):
        bfv_bgv_run(forms, BFV_N, True)
    torch.cuda.synchronize()
    launches = ck.launches()
    log(f"[u64 bfv/bgv] one pass of the traffic of {len(forms)} contexts in "
        f"{time.time() - t0:.1f} s (host clock, decryption checks and noise budgets "
        f"included); launches: {launches}")
    ck.require_launched("u64 BFV/BGV", launches, ("bconv",))

    # ms per op, after the pass (every operand and table exists)
    rng = np.random.default_rng(1)
    for form in forms:
        vals = [rng.integers(0, form["tools"].t.value, size=BFV_N, dtype=np.uint64)
                for _ in range(3)]
        ops = bfv_bgv_ops(form["scheme"], form["tools"], form["enc"], form["sk"],
                          form["keys"], vals, seed=5)
        ms = {name: cuda_ms(fn, reps=1, samples=OP_SAMPLES) for name, (fn, _) in ops.items()}
        for op in ("multiply", "relinearize"):
            ck.reset()
            ops[op][0]()
            log(f"[{form['tag']}] launches in one {op}: "
                f"{ {k: v for k, v in ck.launches().items() if v} }")
        log(f"[{form['tag']}] ms per op (CUDA events, median of {OP_SAMPLES} after a "
            f"warm-up) on {card}: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
        if form["tech"] == "behz" and form["scheme"] == "bfv":
            from tpu_fhe_torch.eval import bfv_eval as bv

            tools, (ca, cb) = form["tools"], [
                form["tools"].encrypt_symmetric(form["sk"], form["enc"].encode(v))
                for v in vals[:2]]

            def mul_relin():
                return bv.relinearize(tools, bv.multiply(tools, ca, cb), form["keys"]["rlk"])

            mr_ms = cuda_ms(mul_relin, reps=1, samples=OP_SAMPLES)
            log(f"[{form['tag']}] one BEHZ multiply + relinearize: {mr_ms:.3f} ms (CUDA "
                f"events, median of {OP_SAMPLES}) on {card}")
            profile_window(form["tag"], "one BEHZ multiply + relinearize", mul_relin, mr_ms,
                           ck)
    log(f"[u64 bfv/bgv] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB on {card}")
    bsk = forms[0]["tools"].behz(1).bsk_ntt
    qlrl = forms[1]["tools"].hps(1, 0).qlrl_ntt
    wanted = {"K3 with pre": lambda name, a, kw: name == "forward_ntt_sub_scale"
              and kw.get("pre") is not None,
              "K12 at k = 63": lambda name, a, kw: name == "bconv_matmul"
              and a[0].shape[-2] == 63,
              "K1 and K2 on Bsk": lambda name, a, kw: name in ("forward_ntt", "inverse_ntt")
              and a[1] is bsk,
              "K1 and K2 on QlRl": lambda name, a, kw: name in ("forward_ntt", "inverse_ntt")
              and a[1] is qlrl}
    for what, test in wanted.items():
        hits = [f"{name} {tuple(a[0].shape)}" for name, _, a, kw in calls["args"].values()
                if test(name, a, kw)]
        if not hits:
            fail(f"u64 BFV/BGV: the traffic never called {what}")
        log(f"[u64 bfv/bgv] recorded {what}: {hits}")
    del bsk, qlrl
    path_checks("u64", "BFV/BGV traffic at 2^16", ck, calls, launches)
    del calls, forms
    gc.collect()
    torch.cuda.empty_cache()

    # -- the whole traffic through the kernels == through the plain versions
    t0 = time.time()

    def small_pass() -> list:
        return bfv_bgv_run(bfv_bgv_forms(BFV_PLAIN_N, BFV_PLAIN_BITS, False, 2029, False),
                           BFV_PLAIN_N, False)

    outs = small_pass()
    ck.reset()
    with plain_versions():
        want = small_pass()
    torch.cuda.synchronize()
    if any(ck.launches().values()):
        fail("u64 BFV/BGV: the pass through the plain versions launched kernels")
    if len(outs) != len(want) or not all(torch.equal(g.data, w.data) and _meta(g) == _meta(w)
                                         for g, w in zip(outs, want)):
        fail("u64 BFV/BGV: the N=2^12 pass through the kernels differs from the plain versions")
    log(f"[u64 slice] BFV/BGV at N=2^12 ({len(BFV_PLAIN_BITS)} limbs), keygen, encode, "
        f"encryption and every op of the 5 contexts ({len(outs)} results): kernels == plain "
        f"versions, bit for bit, metadata included, in {time.time() - t0:.1f} s")
    log(f"[u64 bfv/bgv] phase 14 in {time.time() - t_phase:.1f} s")
    return launches


if __name__ == "__main__":
    sys.exit(main())
