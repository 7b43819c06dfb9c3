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
    plan K11 (K12's tensor-core form in chunks of 64 inputs, off the path
    since K12 takes k < 64) through the wrapper at 64 -> 30 and called
    directly at 15 -> 30; on the q32 plan also K4 and
    K5 against K1 and K2 on the same 30-bit moduli, and torch._int_mm on
    bconv32's int8 operands as a yardstick of its product part; and, once
    phases 3 to 6 of both plans are done (after every one-launch profile),
    every kernel of the flagship bootstrap (phase 10) at its widest
    keyswitch, on phase 10's context at chain index 1 (N = 2^16; u64 26 +
    13 limbs: K1 on a digit's 26 complement limbs, K2 scaled on (26) and
    (2, 13), K3 on (2, 26), K12 13 -> 26 on 1 and 2 rows, K8 and K7 on t
    (2, 39) with keys of 2 digits; q32 52 + 26 limbs: K4 on 52, K5 scaled
    on (52) and (2, 26), K6 on (2, 52), K13 26 -> 52 on 1 and 2 rows, K10
    and K9 on t (2, 78)); then K7-K10 over a batch in one launch, the key's
    bytes counted once in the bound: K8 and K7 on t (4, 2, 39) of the
    flagship's tables, K10 and K9 on t (16, 2, 90) of the ResNet-20
    inference's (phase 13's context), with the per-thread batch and
    ptxas's registers and spills of each instantiation; and K9 at the
    other shapes its paths record on that context: t (2, 90) (a ResNet
    convolution's rotation), (16, 2, 89) (a packed convolution's chunk at
    chain index 2) and (17, 2, 90) (a batch that is not a multiple of 2);
    and K11 through the wrapper at 2^16 at (2, 127) -> 32 and 190 -> 63;
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
    dense bootstrap) with every distinct kernel call held against its plain
    version as it comes, and the sparse bootstrap (64 slots) held the same
    way, each decoding to more than 10 bits; then two channels stacked into one
    (2, 2, L, N) ciphertext and bootstrapped at once, every distinct kernel
    call held against its plain version as it comes, bit-identical to each
    channel's own bootstrap, metadata included, with the launches of one
    channel's bootstrap.

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
    1e-3 of its float64 composite; then the channel-packed convolution
    (models/conv_packed.py) 5 -> 3 at 6 x 6 and the diagonal FC layer at
    rows 4, cols 16 with a bias, with their Galois keys, each bit-identical
    to the same through the plain versions and within 1e-3 (conv) and
    1e-4 (FC) of numpy;
13. encrypted ResNet-20 at full width on the q32 plan
    (examples/resnet20_infer.py --q32: N = 2^16, a 32 x 32 x 3 image,
    planes 16/32/64 from random_weights(default_rng(17)), 11 levels after
    the bootstrap, K = 512, r = 6, degree 88, 1024 slots), its stem and
    layer 1's first block (resnet20_infer(layers=1, blocks=1): 144 channel
    bootstraps), through the entry points, the channels in chunks of the
    DNN's channel batch (16 on an 80 GB card: one bootstrap, sign stage and
    add per chunk): the decrypted 32 x 32 x 16 activations within 1e-2 of
    the float64 shadow that applies the same sign composite, with context,
    setup and keygen seconds, the channel batch and chunks, key bytes,
    peak memory, ms per stage, the timer buckets (the Bootstrap bucket's
    sections and ms per channel), the launches of each kernel (counters
    set to 0 first) beside the per-channel inference's, ms per bootstrap
    of one channel and of a chunk, and a profile of a chunk's
    relu_composite (also per channel); a chunk of 2 channels'
    relu_composite batched equal to the same channels one at a time, bit
    for bit; the output through save_tensor_ct / load_tensor_ct in a
    temporary directory, exact; then
    the inference again with every distinct wrapper call held against its
    plain version as it comes, on the inference's own arguments and the
    context's tables, its output equal to the first's and its recorded
    calls equal to the launches, and each kernel's widest shape timed and
    bounded; then the pool and FC at full width, the one stage kind the
    truncated inference does not reach: the shadow's l3b2 output (64
    channels at width 8, slot stride 2) encrypted and mod-dropped to the
    chain index, scale and degree of the inference's l1b0 output
    (resnet20.enc_stage_output), its 6 pool Galois keys, and
    avg_pool_full_con with the FC's bias, every distinct wrapper call held
    against its plain version as it comes, the launches (counters set to
    0 first) and its ms, peak memory and logits (decrypted at the fewest
    limbs that hold them) within 1e-2 of the shadow's.

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

Then, the BFV/BGV keys freed, the channel-packed convolution and the
diagonal FC layer (tpu_fhe_torch/models/conv_packed.py):

15. ResNet-20's layer shapes, packed, at full width on the q32 plan
    (phase 13's context: N = 2^16, 60 + 30 limbs, dnum 2; mask scale 2^40,
    56 Galois keys without Shoup words): the 3 x 3 convolutions 16 -> 16
    at 32 x 32, 32 -> 32 at 16 x 16 and 64 -> 64 at 8 x 8 (one input and
    one output ciphertext each, the output channels in chunks of 16, so
    the collapse rotations run K9 over a batch) and the FC layer 64 -> 10
    (rows padded to 16) with a bias, on seeded inputs, every mask embedded
    on the card (CkksEncoder(ctx, device_embed=True)): first DeviceEmbedding
    on the card against the host's float64 embedding within 1e-10
    (inverse; forward within 1e-9) at (16, 2^15) and at the DNN's sparse
    1024 slots, with each transform's ms; then each layer within 1e-3
    (conv) or 1e-4 (FC) of numpy float64, K9 launched once per rotate
    call; per layer its ms (CUDA events), rotate calls, launches of each
    kernel (counters set to 0 first), seconds of mask encoding (CUDA
    events around each encode) and peak memory; every distinct wrapper
    call of a first pass held against its plain version as it came, the
    timed pass equal to it, and each kernel's widest call timed and
    bounded; then the 16 -> 16 convolution once more through the host
    embedding, its ms and mask seconds beside the device run's and its
    decoded output within 1e-6 of the device run's.

Then:

16. examples/torch_ckks_basics.py and examples/torch_ckks_chebyshev.py at
    their default sizes (N = 2048 and 512, the u64 plan), each to its
    final OK with every gate passed, and their launches.

Then the sharded paths (tpu_fhe_torch/parallel/):

17. 4 ranks spawned on the one card (cuda:0), joined by gloo through a
    file rendezvous, every CUDA tensor of a collective through host
    memory (so it shows the paths right on the card and measures no
    scaling): multiply -> relinearize -> rescale on a 1 x 4 limb mesh at
    the u64 plan's N = 2^15 configuration and at the q32 plan's
    (rescale_composite), the same over a stacked batch of 4 on 2 x 2, the
    4-step NTT (forward and inverse), relinearize and rotate on a 1 x 4
    coeff mesh, and the flagship bootstrap's first C2S BSGS level (phase
    10's contexts, N = 2^16) limb-sharded on both plans.  State is drawn
    once on rank 0 and broadcast.  Each result is gathered and held on
    rank 0 against the one-process path through the kernels, bit for bit
    with its metadata; every distinct wrapper call of every rank is held
    against its plain version as it comes.  Per path: the collectives of
    each rank by kind and bytes, ms per op in each rank beside the
    one-process ms (host clock), the launches summed over the ranks
    (every kernel of the path must launch), and each rank's peak memory.

Each phase's seconds, then the kernels line (every kernel of both plans,
its launches summed over the requests, rotations, EvalMod, raise_mod, the
flagship bootstrap, the DNN layers, the ResNet-20 inference, phase 14,
the packed layers, the examples and the ranks of phase 17, its
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
from pathlib import Path

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
# K7-K10 over a batch (phase 3): u64 on the flagship's tables, q32 on the
# ResNet-20 inference's (phase 13's context), each at the batch its path gives
KS_BATCH = {"u64": 4, "q32": 16}
BUILD_LOGS: dict = {}                    # nvcc's output by source (phase 2)
# the fills that lead every profiler window (device_kernels), by dtype and
# by the name of the dtype in the fill kernel's name, and a tally of them
MARKER_DTYPES = ("int8", "int16", "int32", "int64", "uint8", "float16", "bfloat16", "float32")
MARKER_NAMES = ("signed char", "short", "int", "long", "unsigned char", "c10::Half",
                "c10::BFloat16", "float")
MARKERS: dict = {"windows": 0, **{f"lost {name}": 0 for name in MARKER_NAMES}}


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int, samples: int = 5, graph: bool = False, warm_up: bool = True) -> float:
    """Median over `samples` of the mean time of `reps` back-to-back calls
    (CUDA events, after a warm-up call unless `warm_up` is False: the run
    before already warmed it).  With `graph`, the reps are captured once in
    a CUDA graph and replayed, so the time is the device's alone and not
    the host's enqueue of each call."""
    import torch

    if warm_up:
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


def ks_cost(shoup: bool, word: int, batch: int, beta: int, L: int, n: int = N) -> dict:
    """Bytes and IMADs of one key inner product over a batch of `batch` digit
    sets (beta, L, n): the digits and outputs of every set, the key's words
    (two parts, with Shoup words four) once.  Per output word, with Shoup
    words beta lazy Shoup multiplies (3 products each); without, beta
    products into the wide accumulator and one landing (u64: 64x64 -> 128
    products and Barrett's 6; q32: 32x32 -> 64 products and the word
    fold's 7)."""
    nbytes = word * n * (batch * beta * L + (4 if shoup else 2) * beta * L + batch * 2 * L)
    if shoup:
        per_mul = IMAD_PER_MUL32 if word == 4 else IMAD_PER_MUL64
        imads = 3 * 2 * beta * L * n * per_mul
    elif word == 4:
        imads = 2 * L * n * (beta * IMAD_PER_WIDE32 + 7 * IMAD_PER_MUL32)
    else:
        imads = 2 * L * n * (2 * beta + 6) * IMAD_PER_MUL64
    return dict(nbytes=nbytes, imads=batch * imads)


def ks_ptxas(log_text: str) -> list[str]:
    """ptxas's registers and spills of each K7-K10 instantiation (K7, K8,
    K10 per per-thread batch BT; K9 per unrolled beta, 0 the runtime loop),
    from nvcc's -Xptxas -v output of ks.cu."""
    out, name = [], None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(ks32_kernel|ks_shoup_kernel|ks_kernel)I(j|y)?Li(\d+)E", m.group(1))
            name = None if k is None else (
                f"{k.group(1)}<{dict(j='u32, ', y='u64, ').get(k.group(2), '')}"
                f"{'BETA' if k.group(1) == 'ks32_kernel' else 'BT'}={k.group(3)}>")
        elif name and "spill" in line:
            out.append(f"{name}: {line.strip()}")
        elif name and "registers" in line:
            out[-1] += "; " + line.split(":", 1)[-1].strip()
            name = None
    return out


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
    BUILD_LOGS.update(logs)
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
    k11_wide_checks(plans[0]["ck"])
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
    # -- 15. ResNet-20's layer shapes, packed, at full width on the q32 plan
    t0 = time.time()
    plans[1]["packed"] = packed_phase(plans[1]["ck"], card)
    plans[0]["packed"] = dict.fromkeys(plans[0]["launches"], 0)
    gc.collect()
    torch.cuda.empty_cache()
    seconds["15"] = time.time() - t0
    # -- 16. the CKKS examples at their default sizes
    t0 = time.time()
    plans[0]["examples"] = examples_phase(plans[0]["ck"], card)
    plans[1]["examples"] = dict.fromkeys(plans[1]["launches"], 0)
    seconds["16"] = time.time() - t0
    # -- 17. the sharded paths in 4 ranks on the card (gloo)
    t0 = time.time()
    par = parallel_phase(card, [plan["ck"] for plan in plans])
    for plan in plans:
        plan["parallel"] = {name: par.get(name, 0) for name in plan["launches"]}
    seconds["17"] = time.time() - t0
    log("[time] seconds by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    log(f"[profile] the fills leading each window: {MARKERS}")
    line = []
    for plan in plans:
        line += plan["ck"].line({name: count + plan["emod"][name] + plan["raised"][name]
                                 + plan["boot"][name] + plan["dnn"][name]
                                 + plan["resnet"][name] + plan["bfv"][name]
                                 + plan["packed"][name] + plan["examples"][name]
                                 + plan["parallel"][name]
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


def direct_bconv(s, table, p, ratio_lo, ratio_hi, diag):
    """K11's kernel at any k, called directly (the wrapper takes K12 for
    k < 64): s (k, N) int64 residues, the table (m, k), p and its Barrett
    words (m, 1) and the table's digit matrix, all on the card."""
    import torch

    from tpu_fhe_torch.ops import bconv
    from tpu_fhe_torch.ops._build import ptr

    (k, n), m = s.shape, table.shape[0]
    out = torch.empty((m, n), dtype=torch.int64, device=s.device)
    bconv.BCONV(ptr(s), ptr(out), ptr(diag), *(ptr(c.contiguous()) for c in (p, ratio_lo,
                                                                           ratio_hi)),
                1, k, m, n, 0, k, 0)
    return out


def k11_wide_checks(ck: "Checker") -> None:
    """K11 through the wrapper at 2^16 on sums of more than one 64-input
    chunk: (2, 127) -> 32 and 190 -> 63, on 59-bit input residues (32
    primes repeated: a chain holds at most 64 primes above 30 bits) and
    60-bit output primes.  Like every 2^16 check, it runs after the
    one-launch profiles of both plans."""
    import torch

    from tpu_fhe_torch.core.modulus import CoeffModulus
    from tpu_fhe_torch.ops import bconv, modarith as mm

    n, dev = 1 << 16, torch.device("cuda")
    residues = residue_maker(dev, n, 2127)
    gen = torch.Generator(device=dev).manual_seed(127)
    q_in = mm.u64_tensor(np.array([[m.value] for m in CoeffModulus.create(n, [59] * 32)],
                                  dtype=np.uint64), dev).repeat(6, 1)
    for lead, k, m in (((2,), 127, 32), ((), 190, 63)):
        mods = CoeffModulus.create(n, [60] * m)
        p, rlo, rhi = (mm.u64_tensor(np.array([[f(mo)] for mo in mods], dtype=np.uint64), dev)
                       for f in (lambda mo: mo.value, lambda mo: mo.const_ratio[0],
                                 lambda mo: mo.const_ratio[1]))
        table = torch.randint(0, 1 << 62, (m, k), generator=gen, dtype=torch.int64,
                              device=dev) % p
        tab = (table, p, rlo, rhi, bconv.digit_matrix(table))
        x = residues(q_in[:k], *lead)
        rows = lead[0] if lead else 1
        ck.check("bconv", f"{k} -> {m}, ({', '.join(map(str, lead + (k,)))}, 2^16)",
                 lambda: bconv.bconv_matmul(x, *tab), lambda: bconv.bconv_matmul_plain(x, *tab),
                 **bconv_cost(8, rows, k, m, n))
        del x, table, tab


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
    # K11: the wrapper's choice from k = 64 inputs on (the key level's 45
    # moduli and 19 of them again, into the level's 30), and at the path's
    # 15 -> 30 through a direct call
    s64 = residues(torch.cat([ctx.key_level.mod.q] * 2)[:64])
    gen = torch.Generator(device=ctx.device).manual_seed(64)
    wide = torch.randint(0, 1 << 62, (L, 64), generator=gen, dtype=torch.int64,
                         device=ctx.device) % level.mod.q
    wtab = (wide, level.mod.q, level.mod.ratio_lo, level.mod.ratio_hi, bconv.digit_matrix(wide))
    ck.check("bconv", "64 -> 30, (64, 2^15)", lambda: bconv.bconv_matmul(s64, *wtab),
             lambda: bconv.bconv_matmul_plain(s64, *wtab), **bconv_cost(8, 1, 64, L))
    ck.check("bconv", "15 -> 30, (15, 2^15), direct call",
             lambda: direct_bconv(s, *btab), lambda: bconv.bconv_matmul_plain(s, *btab),
             **bconv_cost(8, 1, k_in, m_out), headline=True)
    del s64, wide, wtab
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
    del x, x2, sub, xs, xp, s, s2, t, evk, evk_s, gkey

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
    profiler window after the first in a process can miss the kernels it
    sees first (seen on the H100: the first port kernel of a window, 9 of
    10 launches, or the first nodes of a graph replay, while a single
    one-byte fill led the window; with three fills leading it, 9 of 23
    windows of one run lost all three).  So eight fills of distinct dtypes
    lead the window, each synchronized and 20 ms apart on the host; they
    are not counted (no profiled operation fills memory), and MARKERS
    tallies which of them the profiler missed.  A window that still loses
    events is flagged by profile_ops and taken again by the gated
    callers."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    markers = [torch.zeros(1, dtype=getattr(torch, dt), device="cuda") for dt in MARKER_DTYPES]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i, marker in enumerate(markers):
            if i:
                time.sleep(0.02)
            marker.fill_(1)
            torch.cuda.synchronize()
        run()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    MARKERS["windows"] += 1
    for name in MARKER_NAMES:
        if not any(f"FillFunctor<{name}>" in e.key for e in events):
            MARKERS[f"lost {name}"] += 1
    return [e for e in events if "FillFunctor" not in e.key]


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
    and evaluators, the keys, ops/bconv.py's BEHZ/HPS conversions, which
    call bconv_matmul, and the limb-sharded keyswitch's ends and the
    rescale's dropped limbs (parallel/limb_eval.py; the rest of parallel/
    calls the evaluator's)."""
    from tpu_fhe_torch.eval import auto, bfv_eval, bgv_eval, evaluator as ev
    from tpu_fhe_torch.models import dnn
    from tpu_fhe_torch.ops import bconv
    from tpu_fhe_torch.parallel import limb_eval
    from tpu_fhe_torch.scheme import batch_encoder, bfv, bgv, ckks_encoder, keys

    saved = [(mod, name, getattr(mod, name))
             for mod in (ev, auto, dnn, ckks_encoder, bfv_eval, bgv_eval, bfv, bgv,
                         batch_encoder, keys, bconv, limb_eval)
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


def recorded_calls(calls: dict, ck: Checker):
    """Within this block every call of the path's wrappers counts one in
    calls["count"], and the first call of each distinct wrapper and shapes
    of its arguments is held against its plain version at once, during the
    run (hold_call): calls["args"] keeps its wrapper, kernel, arguments
    (the data arguments as meta tensors, their shapes alone; the context's
    tables and keys by reference) and keywords, and calls["held"] each
    kernel's count of shapes held and its widest call with its data
    cloned, for path_checks to time.  A run of batched ciphertexts gives
    too many large distinct calls to keep a clone of each."""
    data = {name: lead for name, (_, lead) in path_wrappers().items()}
    calls.update(count=0, args={}, held={})

    def make(name, fn):
        def call(*args, **kw):
            key = (name, tuple(_arg_key(a) for a in args),
                   tuple((k, _arg_key(v)) for k, v in sorted(kw.items())))
            calls["count"] += 1
            if key in calls["args"]:
                return fn(*args, **kw)
            kernel, got = hold_call(ck, name, fn, args, kw)
            calls["args"][key] = (name, kernel, tuple(a.to("meta") if i < data[name] else a
                                                      for i, a in enumerate(args)), kw)
            shapes, widest = calls["held"].get(kernel, (0, None))
            if widest is None or args[0].numel() > widest[2][0].numel():
                widest = (name, fn, tuple(a.clone() if i < data[name] else a
                                          for i, a in enumerate(args)), kw)
            calls["held"][kernel] = (shapes + 1, widest)
            return got
        return call
    return swapped_wrappers(make)


def hold_call(ck: Checker, name: str, fn, args: tuple, kw: dict):
    """One call of a path wrapper through its kernel against its plain
    version on the same arguments, bit for bit; -> (the kernel it launched,
    the kernel's result)."""
    import torch

    before = ck.launches()
    got = fn(*args, **kw)
    kernel = [k for k, v in ck.launches().items() if v != before[k]]
    want = path_wrappers()[name][0](*args, **kw)
    torch.cuda.synchronize()
    if len(kernel) != 1:
        fail(f"one call of {name} launched {kernel}")
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
        fail(f"{kernel[0]} ({name}) at {tuple(args[0].shape)} differs from its plain version")
    return kernel[0], got


def wrapper_cost(name: str, args: tuple, kw: dict) -> dict:
    """Bytes and operations of one call of a path wrapper on `args` (the
    forms of ntt_cost, bconv_cost and ks_cost)."""
    x = args[0]
    word, n = x.element_size(), x.shape[-1]
    if name.startswith("bconv"):
        k = x.shape[-2]
        return bconv_cost(word, x.numel() // (k * n), k, args[1].shape[0], n)
    if name.startswith("key_inner_prod"):
        beta, L = x.shape[-3], x.shape[-2]
        return ks_cost(name == "key_inner_prod_shoup", word, x.numel() // (beta * L * n), beta,
                       L, n)
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
    """A run recorded by recorded_calls, whose every kernel was held
    against its plain version at every distinct shape the run gave its
    wrapper, on the run's own arguments and tables: the recorded calls
    must equal the run's launches (`launches`), every kernel the run
    launched must have been held, and each kernel's widest shape is timed
    and bounded (Checker.check, listed under "checks")."""
    plain = {name: fn for name, (fn, _) in path_wrappers().items()}
    if calls["count"] != sum(launches.values()):
        fail(f"{tag} {what}: {calls['count']} wrapper calls recorded against "
             f"{sum(launches.values())} launches")
    t0 = time.time()
    held = calls["held"]
    missing = [k for k, v in launches.items() if v and k not in held]
    if missing:
        fail(f"{tag} {what}: launched but never held against the plain version: {missing}")
    for kernel, (shapes, (name, fn, args, kw)) in held.items():
        dims = ", ".join(f"2^{d.bit_length() - 1}" if i == args[0].dim() - 1 else str(d)
                         for i, d in enumerate(args[0].shape))
        ck.check(kernel, f"({dims}), the widest of {shapes} shapes of the {what}",
                 lambda: fn(*args, **kw), lambda: plain[name](*args, **kw),
                 **wrapper_cost(name, args, kw))
        ck.report[kernel].setdefault("path_shapes", {})[f"{tag} {what}"] = shapes
    log(f"[{tag} kernels] the {what}: every kernel at every distinct shape of its "
        f"{calls['count']} wrapper calls == plain versions, bit for bit, held as they came ("
        + ", ".join(f"{k} {v[0]}" for k, v in held.items())
        + f" shapes; the widest timed in {time.time() - t0:.1f} s)")


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
    when keygen picks them) and without (the u64 plan's Galois keys); then
    the inner products over a batch of KS_BATCH digit sets in one launch,
    u64 on these tables, q32 on the ResNet-20 inference's (phase 13), with
    the per-thread batch and ptxas's report of each instantiation."""
    from tpu_fhe_torch.ops import _build, bconv, ks, ntt

    t0 = time.time()
    ctx = boot_context(tag, BOOT_N, UNIFORM_SINE, BOOT_BUDGET, levels_after=1)
    q32 = ctx.is_q32
    n, word, sfx = BOOT_N, 4 if q32 else 8, f"2^{BOOT_N.bit_length() - 1}"
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
    shape = f"t ({beta}, {qlp_n}, {sfx}), key ({dnum}, 2, {kq.q.shape[0]}, {sfx})"
    ks_checks(ck, kst, kq, t, evk, shape)
    del x, xl, xp, xs, sub, s, s2, t
    # K7-K10 over a batch: u64 on these tables, q32 on the ResNet-20
    # inference's (phase 13's context), at the batch each path gives them
    batch = KS_BATCH[tag]
    if q32:
        del evk, ctx
        ctx = dnn_context("q32", RESNET_N, UNIFORM_SINE, (2, 2), RESNET_LEVELS_AFTER,
                          special=15)
        kst, kq = ctx.level(1).ks, ctx.key_level.mod
        qlp_n, beta = kst.qlp_mod.q.shape[0], kst.beta
        dnum = -(-ctx.params.size_Q // ctx.params.size_P)
        evk = residues(kq.q, dnum, 2)
    t = residues(kst.qlp_mod.q, batch, beta)
    bt = _build.load("ks.cu").tfhe_ks_per_thread(batch)
    log(f"[{tag} kernels] K7-K10 over a batch of {batch}, one launch: K7, K8, K10 {bt} "
        f"ciphertexts per thread, grid.z {-(-batch // bt)}; K9 a thread's key words once, the "
        f"whole batch walked; ptxas (ks.cu): "
        + ("; ".join(ks_ptxas(BUILD_LOGS.get("ks.cu", ""))) or "not rebuilt in this run"))
    ks_checks(ck, kst, kq, t, evk,
              f"t ({batch}, {beta}, {qlp_n}, {sfx}), key ({dnum}, 2, {kq.q.shape[0]}, {sfx}), "
              f"{'ResNet-20' if q32 else 'flagship'} chain index 1")
    del t
    if q32:
        # K9 at the other shapes its paths record on this context: one
        # ResNet convolution's rotation, a packed convolution's chunk at
        # chain index 2, and a batch of 17
        for lead, ci in (((), 1), ((16,), 2), ((17,), 1)):
            kl = ctx.level(ci).ks
            qlp, rows = kl.qlp_mod, kl.qlp_key_rows
            t = residues(qlp.q, *lead, kl.beta)
            bt, L = (lead[0] if lead else 1), qlp.q.shape[0]
            ck.check("key_inner_prod32",
                     f"t ({', '.join(map(str, lead + (kl.beta, L)))}, {sfx}), key ({dnum}, 2, "
                     f"{kq.q.shape[0]}, {sfx}), ResNet-20 chain index {ci}",
                     lambda: ks.key_inner_prod32(t, evk, rows, qlp.q, qlp.fold),
                     lambda: ks.key_inner_prod32_plain(t, evk, rows, qlp.q, qlp.fold),
                     **ks_cost(False, 4, bt, kl.beta, L, n))
            del t
    del evk, ctx
    log(f"[{tag} kernels] the flagship's shapes checked in {time.time() - t0:.1f} s")


def ks_checks(ck: Checker, kst, kq, t, evk, shape: str) -> None:
    """The inner products with a key of dnum digits, with Shoup words (the
    relin key; the Galois keys too on the q32 plan when keygen picks them)
    and without (the u64 plan's Galois keys), on digits t (beta, QlP, N) or
    a batch of them (B, beta, QlP, N) of a level's tables `kst`; the key's
    bytes count once per launch."""
    from tpu_fhe_torch.ops import ks, modarith as mm

    q32 = t.element_size() == 4
    suffix = "32" if q32 else ""
    qlp, rows = kst.qlp_mod, kst.qlp_key_rows
    beta, qlp_n, n = t.shape[-3], t.shape[-2], t.shape[-1]
    batch = t.numel() // (beta * qlp_n * n)
    word = t.element_size()
    evk_s = mm.shoup32_of(evk, kq.q) if q32 else mm.shoup_of(evk, kq.q, kq.ratio_lo,
                                                              kq.ratio_hi)
    ck.check(f"key_inner_prod_shoup{suffix}", shape,
             lambda: ks.key_inner_prod_shoup(t, evk, evk_s, rows, qlp.q),
             lambda: ks.key_inner_prod_shoup_plain(t, evk, evk_s, rows, qlp.q),
             **ks_cost(True, word, batch, beta, qlp_n, n))
    if q32:
        kip, kip_plain, kargs = ks.key_inner_prod32, ks.key_inner_prod32_plain, (rows, qlp.q,
                                                                                 qlp.fold)
    else:
        kip, kip_plain = ks.key_inner_prod, ks.key_inner_prod_plain
        kargs = (rows, qlp.q, qlp.ratio_lo, qlp.ratio_hi)
    ck.check(f"key_inner_prod{suffix}", shape, lambda: kip(t, evk, *kargs),
             lambda: kip_plain(t, evk, *kargs), **ks_cost(False, word, batch, beta, qlp_n, n))


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


def profile_window(tag: str, what: str, run, ms: float, ck: Checker,
                   windows: int = 3) -> tuple[float, float] | None:
    """A device-only profile of one `run()`: the window (CUDA events), the
    device's busy time and idle share, the port's kernels against the glue,
    and the kernels with the most device time.  The profile's count of
    each port kernel must equal the launches its wrapper counted in the same
    run: a window that falls short lost events and is taken again, up to
    `windows` in all; the last is printed as undercounted if it still falls
    short, and a count above the wrapper's fails.  Tracing slows the host's
    enqueue, so the window is longer than an untraced run (`ms`); the idle
    share against `ms` is printed beside it.  Returns (device busy, the
    port's kernels) in ms, or None when the profiler saw no device time."""
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
        return None
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
    return busy, ours


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
    bootstrap, which no longer runs alone: phase 14 took its time) with
    every distinct wrapper call held against its plain version as it comes
    (recorded_calls), and the sparse bootstrap (64 slots) held the same
    way, each decoding to at least BOOT11_MIN_BITS, and the Meta-BTS not
    returning its input.  The example takes the sparse set
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
            # held call by call: a whole second pass through the plain
            # versions took about 50 s of the u64 plan's phase for the
            # Meta-BTS
            calls = {}
            ck.reset()
            with recorded_calls(calls, ck):
                out = boot.eval_bootstrap(ct, slots, iterations, precision)
            torch.cuda.synchronize()
            path_checks(tag, what, ck, calls, ck.launches())
            if out is ct:
                fail(f"{tag} {what}: returned its input")
            bits = precision_bits(enc.decode(sk.decrypt(out), slots=slots).real, x)
            log(f"[{tag} bootstrap] {what}: precision {bits:.3f} bits, chain index "
                f"{ct.chain_index} -> {out.chain_index}")
            if not bits >= BOOT11_MIN_BITS:
                fail(f"{tag} {what}: precision {bits:.3f} bits < {BOOT11_MIN_BITS}")
            if iterations == 1:
                batched_bootstrap(tag, ck, boot, enc, sk, slots, (x, ct, out))
    torch.cuda.synchronize()
    log(f"[{tag} bootstrap] phase 11 in {time.time() - t0:.1f} s")


def batched_bootstrap(tag: str, ck: Checker, boot, enc, sk, slots: int, first: tuple) -> None:
    """Phase 11's batch: `first` (values, input, its bootstrap) and one more
    channel stacked into one (2, 2, L, N) ciphertext and bootstrapped at
    once with every distinct wrapper call held against its plain version as
    it comes (recorded_calls, each kernel's widest timed), bit-identical,
    metadata included, to the two channels' own bootstraps, each channel
    decoding to more than BOOT11_MIN_BITS; the batch's launches beside one
    channel's.  (A whole second pass through the plain versions took about
    40 s of the u64 plan's phase.)"""
    import torch

    from tpu_fhe_torch.boot.bootstrap import precision_bits
    from tpu_fhe_torch.scheme.ciphertext import stack_cts, unstack_cts

    x1, ct1, out1 = first
    x2, ct2 = boot_input(tag, boot.ctx, enc, sk, slots, seed=slots + 7)
    ck.reset()
    out2 = boot.eval_bootstrap(ct2, slots)
    one = ck.launches()
    what = f"N=2^12 bootstrap, {slots} slots, a batch of 2"

    calls = {}
    ck.reset()
    with recorded_calls(calls, ck):
        batch = boot.eval_bootstrap(stack_cts([ct1, ct2]), slots)
    torch.cuda.synchronize()
    launches = ck.launches()
    path_checks(tag, what, ck, calls, launches)
    if tuple(batch.data.shape[:2]) != (2, 2):
        fail(f"{tag} {what}: data {tuple(batch.data.shape)}")
    for i, (x, out, c) in enumerate(zip((x1, x2), (out1, out2), unstack_cts(batch, 2))):
        if not (torch.equal(c.data, out.data) and _meta(c) == _meta(out)):
            fail(f"{tag} {what}: channel {i} differs from its own bootstrap")
        bits = precision_bits(enc.decode(sk.decrypt(c), slots=slots).real, x)
        if not bits >= BOOT11_MIN_BITS:
            fail(f"{tag} {what}: channel {i} precision {bits:.3f} bits < {BOOT11_MIN_BITS}")
    if launches != one:
        fail(f"{tag} {what}: the batch launched {launches}, one channel {one}")
    log(f"[{tag} bootstrap] {what}: == the two channels' own bootstraps, bit for bit, "
        f"metadata included; the batch's launches equal one channel's: "
        f"{ {k: v for k, v in launches.items() if v} }")



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
RESNET_CHECK_BATCH = 2                   # channels of phase 13's batched-vs-per-channel check
# phase 15: ResNet-20's three convolution shapes (channels, width) and its
# classifier (classes, features, rows padded to a power of two), packed
PACKED_LAYERS = ((16, 32), (32, 16), (64, 8))
PACKED_FC = (10, 64, 16)
PACKED_SCALE = 2.0 ** 40                 # the reference's mask scale (conv_packed.py:58)
PACKED_CONV_TOL, PACKED_FC_TOL = 1e-3, 1e-4   # tests/test_conv_packed.py's bounds
PACKED_BATCH = 16                        # a chunk's output channels on an 80 GB card
EMBED_TOL, EMBED_FWD_TOL = 1e-10, 1e-9   # tests/test_special_fft.py's bounds
EMBED_RUN_TOL = 1e-6                     # device- against host-embedded conv, decoded
# the per-channel inference's launches, measured on one H100 (PERF.md's
# kernel table), beside the batched inference's
PER_CHANNEL_LAUNCHES = {"ntt_fwd32": 14294, "ntt_inv32": 43091, "ntt_fwd_landing32": 34944,
                        "key_inner_prod32": 280, "key_inner_prod_shoup32": 16608,
                        "bconv32": 22182}


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
    packed = packed_plain_cases(tag, ctx, enc, sk, ck)
    return {name: count + packed[name] for name, count in launches.items()}


def packed_plain_cases(tag: str, ctx, enc, sk, ck: Checker) -> dict:
    """Phase 12, continued: the packed convolution 5 -> 3 at 6 x 6 (one
    input and one output ciphertext, the output channels in chunks of the
    memory rule's 2) and the diagonal FC layer at rows 4, cols 16 with a
    bias, on phase 12's context with their Galois keys: each through the
    kernels equal to the same through the plain versions, bit for bit,
    metadata included, and decoding within PACKED_CONV_TOL / PACKED_FC_TOL
    of numpy.  The mask scale is 2^40 on q32, where a rescale drops a
    30-bit prime, and 2^59 on u64, where it drops a 59-bit prime.  Returns
    the launch counts of the two layers."""
    import torch

    from tpu_fhe_torch.models.conv_packed import (PackedConv, fc_rotation_indices,
                                                  fc_weight_encode, fully_connected)

    scale = PACKED_SCALE if tag == "q32" else 2.0 ** 59
    pc = PackedConv(ctx, enc, scale=scale)
    lay = pc.layout(6, 3)
    rows, cols = 4, 16
    slots = ctx.n // 2
    gk = sk.galois_key(sorted(set(pc.rotation_indices(lay))
                              | set(fc_rotation_indices(rows, cols, slots))))
    rng = np.random.default_rng(37)
    images = rng.uniform(-1, 1, (5, 6, 6))
    filt = rng.uniform(-0.5, 0.5, (3, 5, 3, 3))
    weight, x, bias = (rng.uniform(-1, 1, (rows, cols)), rng.uniform(-1, 1, cols),
                       rng.uniform(-0.5, 0.5, rows))
    din = pc.zero_pad_encode(images, lay, sk)
    ct = sk.encrypt_symmetric(enc.encode(np.pad(x, (0, slots - cols)), scale, slots=slots))

    def fc():
        diag = fc_weight_encode(enc, weight, scale)
        b = enc.encode(np.pad(bias, (0, slots - rows)), fc_output_scale(ctx, ct, diag[0]),
                       chain_index=2, slots=slots)
        return [fully_connected(ctx, gk, ct, diag, cols, b)]

    cases = [("packed conv 5 -> 3 at 6 x 6", lambda: pc.eval_convolution(filt, gk, din, lay)),
             ("packed FC 16 -> 4 with bias", fc)]
    torch.cuda.synchronize()
    ck.reset()
    outs = [run() for _, run in cases]
    torch.cuda.synchronize()
    launches = ck.launches()
    log(f"[{tag} dnn] the packed conv (output channels in chunks of "
        f"{pc.channel_batch(3)}) and FC: launches {launches}")
    for (what, run), got in zip(cases, outs):
        plain_matches(tag, f"DNN {what}", ck, run, got)
    conv_err = float(np.max(np.abs(pc.decode_outputs(outs[0], lay, 3, sk)
                                   - ref_conv_same(images, filt))))
    fc_err = float(np.max(np.abs(enc.decode(sk.decrypt(outs[1][0])).real[:rows]
                                 - (weight @ x + bias))))
    log(f"[{tag} dnn] packed conv max err {conv_err:.3e} (limit {PACKED_CONV_TOL}), FC "
        f"{fc_err:.3e} (limit {PACKED_FC_TOL}) against numpy")
    if not (conv_err <= PACKED_CONV_TOL and fc_err <= PACKED_FC_TOL):
        fail(f"{tag} packed layers: max error conv {conv_err}, FC {fc_err}")
    return launches


def ref_conv_same(images: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """images (c_in, h, h), filt (c_out, c_in, f, f): the 'same'
    zero-padded convolution in float64 (tests/test_conv_packed.py's)."""
    c_out, c_in, f, _ = filt.shape
    h = images.shape[1]
    p = (f - 1) // 2
    padded = np.pad(images, ((0, 0), (p, p), (p, p)))
    out = np.zeros((c_out, h, h))
    for di in range(f):
        for dj in range(f):
            out += np.einsum("kc,cij->kij", filt[:, :, di, dj], padded[:, di:di + h, dj:dj + h])
    return out


def fc_output_scale(ctx, ct, diag) -> float:
    """The scale of fully_connected's sum, which its bias plaintext takes:
    the product's, divided by the prime that rescale_to_next drops."""
    return ct.scale * diag.scale / ctx.q_values[ctx.level(ct.chain_index).size - 1]


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
    from tpu_fhe_torch.scheme.ciphertext import stack_cts
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
    batch = model.channel_batch(RESNET_PLANES[0])
    log(f"[q32 resnet] channel batch {batch} (budget {model.batch_budget() / 2**30:.2f} GiB of "
        f"the card's memory): {-(-RESNET_PLANES[0] // batch)} chunks of {batch} channels per "
        "stage")
    events = []

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def infer():
        return rn.resnet20_infer(x, model, boot, weights, log=lambda m: log(f"[q32 resnet] {m}"),
                                 blocks=1, layers=1,
                                 on_stage_done=lambda name, t: events.append((name, event())))

    torch.cuda.synchronize()
    timer.clear()
    ck.reset()
    events.append(("start", event()))
    t0 = time.time()
    out = infer()
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
    sections = timer.counts().get("Bootstrap", 0)
    log(f"[q32 resnet] inference (stem + l1b0) {wall:.2f} s (host clock); ms per stage "
        f"(CUDA events): " + ", ".join(f"{b[0]} {a[1].elapsed_time(b[1]):.1f}"
                                       for a, b in zip(events, events[1:])))
    log(f"[q32 resnet] timer buckets (s, sections): " + ", ".join(
        f"{k} {v:.3f} ({timer.counts()[k]})" for k, v in sorted(buckets.items(),
                                                              key=lambda kv: -kv[1])))
    log(f"[q32 resnet] Bootstrap bucket: {sections} sections of {batch} channels, "
        f"{sections * batch} channel bootstraps at {RESNET_SLOTS} slots, "
        f"{1e3 * buckets.get('Bootstrap', 0.0) / max(sections * batch, 1):.1f} ms per channel "
        f"(synchronized host clock) on {card}")
    log(f"[q32 resnet] activations {acts.shape}: max err {err:.3e} against the float64 "
        f"sign-composite shadow (limit {RESNET_MAX_ERR}); max distance "
        f"{float(np.max(np.abs(acts - exact))):.3e} to the exact-ReLU shadow (not gated); "
        f"chain index {out.cts[0].chain_index}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    log("[q32 resnet] launches in the inference, batched (per channel): " + ", ".join(
        f"{k} {v} ({PER_CHANNEL_LAUNCHES.get(k, 0)})" for k, v in launches.items()))
    if not err <= RESNET_MAX_ERR:
        fail(f"q32 resnet: max error {err} > {RESNET_MAX_ERR}")
    ck.require_launched("q32 resnet", launches, ("bconv",))

    ct = out.cts[0]
    ms = cuda_ms(lambda: boot.eval_bootstrap(ct, RESNET_SLOTS), reps=1, samples=3)
    # a chunk's bootstraps and relu_composite once each (the inference ran
    # them at these shapes just before: each takes seconds to tens of seconds)
    stacked = stack_cts(out.cts[:batch])
    ms_b = cuda_ms(lambda: boot.eval_bootstrap(stacked, RESNET_SLOTS), reps=1, samples=1,
                   warm_up=False)
    log(f"[q32 resnet] bootstrap at {RESNET_SLOTS} slots (CUDA events) on {card}: one channel "
        f"{ms:.3f} ms (median of 3 after a warm-up); a chunk of {batch} {ms_b:.3f} ms, "
        f"{ms_b / batch:.3f} ms per channel (one run)")
    del stacked

    chunk = TensorCT(out.cts[:batch], out.width, out.slotstr)

    def relu_chunk():
        return model.relu_composite(chunk, boot)

    relu_ms = cuda_ms(relu_chunk, reps=1, samples=1, warm_up=False)
    log(f"[q32 resnet] relu_composite of a chunk of {batch} channels (three bootstraps): "
        f"{relu_ms:.3f} ms, {relu_ms / batch:.3f} ms per channel (CUDA events, one run) "
        f"on {card}")
    prof = profile_window("q32 resnet", f"relu_composite of a chunk of {batch} channels",
                          relu_chunk, relu_ms, ck)
    if prof is not None:
        busy, ours = prof
        log(f"[q32 resnet profile] per channel of the chunk: device busy {busy / batch:.3f} ms, "
            f"the port's kernels {ours / batch:.3f} ms, glue {(busy - ours) / batch:.3f} ms")
    log(f"[q32 resnet] peak device memory after the inference "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")

    # a chunk's relu_composite batched == the same channels one at a time
    few = TensorCT(out.cts[:RESNET_CHECK_BATCH], out.width, out.slotstr)
    t0 = time.time()
    model.forced_batch = RESNET_CHECK_BATCH
    batched = model.relu_composite(few, boot).cts
    model.forced_batch = 1
    one_by_one = model.relu_composite(few, boot).cts
    model.forced_batch = None
    torch.cuda.synchronize()
    if not all(torch.equal(a.data, b.data) and _meta(a) == _meta(b)
               for a, b in zip(batched, one_by_one)):
        fail(f"q32 resnet: relu_composite of a chunk of {RESNET_CHECK_BATCH} differs from its "
             "channels one at a time")
    log(f"[q32 resnet] relu_composite of a chunk of {RESNET_CHECK_BATCH} channels "
        f"(channel_batch={RESNET_CHECK_BATCH}) == the same channels one at a time "
        f"(channel_batch=1), bit for bit, metadata included ({time.time() - t0:.1f} s)")
    del few, batched, one_by_one, chunk
    checkpoint_round_trip(ctx, out)

    # the inference again, every distinct wrapper call held against its
    # plain version as it comes (after the profiles: each timed check
    # captures and replays a CUDA graph)
    calls: dict = {}
    ck.reset()
    t0 = time.time()
    with recorded_calls(calls, ck):
        again = infer()
    torch.cuda.synchronize()
    if not all(torch.equal(a.data, b.data) and _meta(a) == _meta(b)
               for a, b in zip(again.cts, out.cts)):
        fail("q32 resnet: a second inference differs from the first")
    log(f"[q32 resnet] a second inference, each distinct wrapper call held against its plain "
        f"version as it came, == the first, bit for bit ({time.time() - t0:.1f} s)")
    del again
    path_checks("q32", "ResNet-20 inference", ck, calls, launches)
    pool = pool_fc_check(ck, ctx, enc, sk, weights, image, out.cts[0], card)
    return {name: count + pool[name] for name, count in launches.items()}


def pool_fc_check(ck: Checker, ctx, enc, sk, weights: dict, image, like, card: str) -> dict:
    """Phase 13, continued: ResNet-20's pool and FC at full width from the
    float64 sign-composite shadow's l3b2 output (64 channels at width 8,
    slot stride 2), encrypted and mod-dropped to the chain index, scale and
    noise-scale degree of the inference's own l1b0 output `like`
    (resnet20.enc_stage_output), with the pool's 6 Galois keys: one
    avg_pool_full_con with the FC's bias (counters set to 0 just before)
    with every distinct wrapper call held against its plain version as it
    comes, and the logits, mod-dropped to the fewest limbs that hold them
    and decrypted, within RESNET_MAX_ERR of the shadow's.  Returns its
    launch counts."""
    import torch

    from tpu_fhe_torch.eval import evaluator as ev
    from tpu_fhe_torch.models import resnet20 as rn
    from tpu_fhe_torch.models.dnn import DNN, TensorCT, relu_composite_clear

    t0 = time.time()
    shadow = {}
    rn.resnet20_infer_clear(image, weights, relu=relu_composite_clear,
                            on_stage_done=shadow.__setitem__)
    acts = shadow["l3b2"]
    width = acts.shape[0]
    slotstr = rn.stage_slotstr("pool")
    model = DNN(ctx, enc)
    model.build_galois_key(sk, DNN.avgpool_rotation_indices(width, slotstr))
    x = rn.enc_stage_output(model, acts, sk, "l3b2", like)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.time()
    calls: dict = {}
    ck.reset()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with recorded_calls(calls, ck):
        start.record()
        out = model.avg_pool_full_con(x, weights["fc_weight"], weights["fc_bias"])
        end.record()
    torch.cuda.synchronize()
    launches = ck.launches()
    peak = torch.cuda.max_memory_allocated()
    # each logit mod-dropped to the fewest limbs whose modulus exceeds its
    # scale by 2^24 (the value, its sign and the noise) before decryption:
    # the host's exact CRT composition in decode costs about L^2
    kept = []
    for ct in out.cts:
        while ct.chain_index + 1 < len(ctx.chain) and sum(
                math.log2(q) for q in ctx.level(ct.chain_index + 1).base.values) \
                > math.log2(ct.scale) + 24:
            ct = ev.mod_drop_to_next(ctx, ct)
        kept.append(ct)
    t2 = time.time()
    logits = model.dec_tensor(TensorCT(kept, out.width, out.slotstr), sk)[0, 0, :]
    t2 = time.time() - t2
    want = shadow["pool"]
    if logits.shape != want.shape or not np.all(np.isfinite(logits)):
        fail(f"q32 resnet pool: decoded {logits.shape} (want {want.shape}) or non-finite")
    err = float(np.max(np.abs(logits - want)))
    log(f"[q32 resnet] pool + FC at full width: {x.num_ch} channels at width {width}, slot "
        f"stride {slotstr}, from the shadow's l3b2 output at chain index {like.chain_index} "
        f"({ctx.level(like.chain_index).size} limbs, degree {like.noise_scale_deg}), "
        f"{len(model.gk.keys)} pool Galois keys {sorted(DNN.avgpool_rotation_indices(width, slotstr))}"
        f": avg_pool_full_con {start.elapsed_time(end):.1f} ms (CUDA events, wrapper calls "
        f"held as they came), {len(out.cts)} logits (decrypted at "
        f"{ctx.level(kept[0].chain_index).size} of {ctx.level(out.cts[0].chain_index).size} "
        f"limbs in {t2:.1f} s), max err {err:.3e} against the shadow "
        f"(limit {RESNET_MAX_ERR}), argmax {int(np.argmax(logits))} (shadow "
        f"{int(np.argmax(want))}); device memory {base / 2**30:.2f} GiB before, peak "
        f"{peak / 2**30:.2f} GiB on {card}")
    log("[q32 resnet] launches in the pool + FC: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()))
    if not err <= RESNET_MAX_ERR:
        fail(f"q32 resnet pool: max error {err} > {RESNET_MAX_ERR}")
    # the pool's Galois keys carry no Shoup words (K9, not K10)
    ck.require_launched("q32 resnet pool + FC", launches, ("bconv", "key_inner_prod_shoup32"))
    path_checks("q32", "ResNet-20 pool + FC", ck, calls, launches)
    log(f"[q32 resnet] pool + FC check in {time.time() - t0:.1f} s ({t1 - t0:.1f} s of shadow, "
        "keys and encryption)")
    return launches


def checkpoint_round_trip(ctx, out) -> None:
    """The inference's output through save_tensor_ct and load_tensor_ct in
    a temporary directory: every channel equal, metadata included; the
    files' MB and the seconds of each way."""
    import tempfile

    import torch

    from tpu_fhe_torch.models import resnet20 as rn

    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        rn.save_tensor_ct(out, d, stage="l1b0")
        t1 = time.time()
        back, meta = rn.load_tensor_ct(ctx, d)
        torch.cuda.synchronize()
        t2 = time.time()
        mb = sum(p.stat().st_size for p in Path(d).iterdir()) / 1e6
    if (back.width, back.slotstr, meta["stage"]) != (out.width, out.slotstr, "l1b0") or \
            not all(torch.equal(a.data, b.data) and _meta(a) == _meta(b)
                    for a, b in zip(back.cts, out.cts)) or back.num_ch != out.num_ch:
        fail("q32 resnet: the checkpoint round trip changed the tensor")
    log(f"[q32 resnet] checkpoint of the output ({out.num_ch} channels): {mb:.1f} MB, saved in "
        f"{t1 - t0:.2f} s, loaded in {t2 - t1:.2f} s, every channel equal, metadata included")


def packed_phase(ck: Checker, card: str) -> dict:
    """Phase 15: ResNet-20's layer shapes through the channel-packed
    convolution and the diagonal FC layer (models/conv_packed.py) at full
    width on the q32 plan: phase 13's context (N = 2^16, 60 + 30 limbs,
    dnum 2), mask scale 2^40, Galois keys without Shoup words (K9) for the
    56 distinct steps of the four layers.  Each 3 x 3 convolution c -> c at
    w x w of PACKED_LAYERS (one input and one output ciphertext; the output
    channels in chunks of the memory rule) on images uniform in [-1, 1) and
    He-normal filters, and the FC layer 64 -> 10 (rows zero-padded to 16)
    with a bias, from seeded numpy, through the entry points (PackedConv,
    zero_pad_encode, eval_convolution, decode_outputs, fc_weight_encode,
    fully_connected).  Each layer must decode within PACKED_CONV_TOL /
    PACKED_FC_TOL of numpy float64, and launch K9 once per rotate call.
    Prints per layer the ms (CUDA events, first run), the rotate calls, the
    launches of each kernel (counters set to 0 just before), the host
    seconds spent encoding masks and the peak memory.  A first pass runs
    with every distinct wrapper call held against its plain version as it
    comes (recorded_calls); the timed pass after it must equal it, and each
    kernel's widest call is then timed and bounded (path_checks).  Returns
    the launch counts of the timed pass."""
    import torch

    from tpu_fhe_torch.eval import evaluator as ev
    from tpu_fhe_torch.models.conv_packed import (PackedConv, fc_rotation_indices,
                                                  fc_weight_encode, fully_connected)
    from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder
    from tpu_fhe_torch.scheme.keys import SecretKey

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    ctx = dnn_context("q32", RESNET_N, UNIFORM_SINE, (2, 2), RESNET_LEVELS_AFTER, special=15)
    sk, enc = SecretKey(ctx, seed=2028), CkksEncoder(ctx, device_embed=True)
    pc = PackedConv(ctx, enc, scale=PACKED_SCALE)
    embedding_checks(enc, card)
    slots = ctx.n // 2
    lays = [pc.layout(w, 3) for _, w in PACKED_LAYERS]
    classes, feats, rows = PACKED_FC
    steps = set(fc_rotation_indices(rows, feats, slots))
    for lay in lays:
        steps |= set(pc.rotation_indices(lay))
    torch.cuda.synchronize()
    t1 = time.time()
    gk = sk.galois_key(sorted(steps))
    torch.cuda.synchronize()
    t2 = time.time()
    key = next(iter(gk.keys.values()))
    key_gib = sum(k.data.numel() * k.data.element_size() for k in gk.keys.values()) / 2**30
    log(f"[q32 packed] N=2^{RESNET_N.bit_length() - 1}, {ctx.params.size_Q} + "
        f"{ctx.params.size_P} limbs, mask scale 2^40: context {t1 - t0:.1f} s; "
        f"{len(gk.keys)} Galois keys {tuple(key.data.shape)} {key.data.dtype}, Shoup words: "
        f"{key.shoup is not None}, {key_gib:.2f} GiB, keygen {t2 - t1:.1f} s")

    def low(c):
        """`c` mod-dropped to 4 limbs (about 2^119, far above the values
        at scale 2^60), which decrypt and decode in a fraction of the
        time of the full chain."""
        while ctx.level(c.chain_index).size > 4:
            c = ev.mod_drop_to_next(ctx, c)
        return c

    rng = np.random.default_rng(41)
    layers = []
    for (c, w), lay in zip(PACKED_LAYERS, lays):
        images = rng.uniform(-1, 1, (c, w, w))
        filt = rng.normal(0.0, math.sqrt(2.0 / (9 * c)), (c, c, 3, 3))
        din = pc.zero_pad_encode(images, lay, sk)
        chunks = -(-c // pc.channel_batch(c))
        rotations = (lay.f_h ** 2 - 1) * len(din) + chunks * (lay.n_i.bit_length() - 1)
        layers.append(dict(
            what=f"conv 3x3 {c} -> {c} at {w} x {w} (block {lay.block}, n_i {lay.n_i}, "
                 f"{chunks} chunks of {pc.channel_batch(c)})", filt=filt, din=din,
            run=lambda filt=filt, din=din, lay=lay: pc.eval_convolution(filt, gk, din, lay),
            rotations=rotations, tol=PACKED_CONV_TOL,
            decode=lambda out, lay=lay, c=c: pc.decode_outputs([low(o) for o in out], lay,
                                                               c, sk),
            want=ref_conv_same(images, filt)))
    weight = np.zeros((rows, feats))
    weight[:classes] = rng.normal(0.0, math.sqrt(1.0 / feats), (classes, feats))
    x, bias = rng.uniform(-1, 1, feats), rng.uniform(-0.1, 0.1, classes)
    ct = sk.encrypt_symmetric(enc.encode(np.pad(x, (0, slots - feats)), PACKED_SCALE,
                                         slots=slots))

    def fc():
        with pc.timing_masks():
            diag = fc_weight_encode(enc, weight, PACKED_SCALE)
            b = enc.encode(np.pad(bias, (0, slots - classes)),
                           fc_output_scale(ctx, ct, diag[0]), chain_index=2, slots=slots)
        return [fully_connected(ctx, gk, ct, diag, feats, b)]

    def fc_decode(out):
        return enc.decode(sk.decrypt(low(out[0]))).real[:classes]

    layers.append(dict(what=f"FC {feats} -> {classes} (rows padded to {rows}) with bias",
                       run=fc, rotations=2 * (rows - 1) + (feats // rows).bit_length() - 1,
                       tol=PACKED_FC_TOL, decode=fc_decode,
                       want=weight[:classes] @ x + bias))

    # the first pass: every distinct wrapper call held against its plain
    # version as it comes
    calls: dict = {}
    ck.reset()
    t0 = time.time()
    with recorded_calls(calls, ck):
        held = [layer["run"]() for layer in layers]
    torch.cuda.synchronize()
    log(f"[q32 packed] the four layers with each distinct wrapper call held against its "
        f"plain version as it came: {time.time() - t0:.1f} s")

    def timed(run, conv):
        """(output, ms by CUDA events, host seconds, mask seconds) of one
        run of a layer."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        conv.mask_seconds = 0.0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        h0 = time.time()
        start.record()
        out = run()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end), time.time() - h0, conv.mask_seconds

    total = dict.fromkeys(ck.launches(), 0)
    for layer, first in zip(layers, held):
        ck.reset()
        out, ms, wall, mask_s = timed(layer["run"], pc)
        launches = ck.launches()
        for name, count in launches.items():
            total[name] += count
        if not all(torch.equal(a.data, b.data) and _meta(a) == _meta(b)
                   for a, b in zip(out, first)):
            fail(f"q32 packed {layer['what']}: the timed run differs from the held run")
        if launches["key_inner_prod32"] != layer["rotations"]:
            fail(f"q32 packed {layer['what']}: {launches['key_inner_prod32']} K9 launches "
                 f"for {layer['rotations']} rotate calls")
        t0 = time.time()
        got = layer["decode"](out)
        dec_s = time.time() - t0
        if got.shape != layer["want"].shape or not np.all(np.isfinite(got)):
            fail(f"q32 packed {layer['what']}: decoded {got.shape} (want "
                 f"{layer['want'].shape}) or non-finite values")
        err = float(np.max(np.abs(got - layer["want"])))
        layer.update(got=got, ms=ms, mask_s=mask_s)
        log(f"[q32 packed] {layer['what']}: {ms:.1f} ms (CUDA events, first timed run; host "
            f"clock {wall:.3f} s; encoding masks on the device embedding {mask_s:.4f} s, "
            f"CUDA events around each encode), "
            f"{layer['rotations']} rotate calls, chain index {out[0].chain_index}, peak "
            f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}; "
            f"max err {err:.3e} against numpy (limit {layer['tol']}; decode {dec_s:.1f} s); "
            f"launches {launches}")
        if not err <= layer["tol"]:
            fail(f"q32 packed {layer['what']}: max error {err} > {layer['tol']}")
    ck.require_launched("q32 packed layers", total, ("key_inner_prod_shoup32",))
    del held
    # the first convolution again through the host embedding, in the same call
    c, w = PACKED_LAYERS[0]
    dev_layer = layers[0]
    host_pc = PackedConv(ctx, CkksEncoder(ctx), scale=PACKED_SCALE)
    out, ms, wall, mask_s = timed(
        lambda: host_pc.eval_convolution(dev_layer["filt"], gk, dev_layer["din"], lays[0]),
        host_pc)
    got = host_pc.decode_outputs([low(o) for o in out], lays[0], c, sk)
    diff = float(np.max(np.abs(got - dev_layer["got"])))
    log(f"[q32 packed] conv 3x3 {c} -> {c} at {w} x {w}, masks embedded on the device against "
        f"the host: {dev_layer['ms']:.1f} against {ms:.1f} ms (CUDA events), masks "
        f"{dev_layer['mask_s']:.4f} against {mask_s:.4f} s (host clock of the host run "
        f"{wall:.3f} s); decoded outputs max |diff| {diff:.3e} (limit {EMBED_RUN_TOL}) on "
        f"{card}")
    if not diff <= EMBED_RUN_TOL:
        fail(f"q32 packed: the device-embedded conv differs from the host-embedded one by {diff}")
    path_checks("q32", "packed layers", ck, calls, total)
    return total


def embedding_checks(enc, card: str) -> None:
    """DeviceEmbedding on the card against the host's float64 embedding
    (_host_embed_inverse, numpy) within EMBED_TOL, and embed_forward against
    the host's decode transform within EMBED_FWD_TOL: a chunk's 16 masks at
    full packing (16, 2^15) and at the DNN's sparse slot count, ResNet-20's
    32 x 32 image (16, 1024), each transform's ms (CUDA events)."""
    import torch

    from tpu_fhe_torch.scheme.ckks_encoder import _host_embed_inverse

    rng = np.random.default_rng(43)
    for slots in (enc.slots, RESNET_SLOTS):
        emb = enc.device_embedding_for(slots)
        shape = (PACKED_BATCH, slots)
        z = rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)
        zt = torch.from_numpy(z).to(emb.device)
        got = emb.embed_inverse(zt).cpu().numpy()
        rot = enc._rot_group_for(2 * slots)
        want = np.stack([_host_embed_inverse(v, 2 * slots, rot) for v in z])
        err = float(np.max(np.abs(got - want)))
        ct = torch.from_numpy(want).to(emb.device)
        back = emb.embed_forward(ct).cpu().numpy()
        two_n = 4 * slots
        padded = np.zeros((PACKED_BATCH, two_n), dtype=np.complex128)
        padded[:, :2 * slots] = want
        want_fwd = (np.fft.ifft(padded, axis=-1) * two_n)[:, rot % two_n]
        err_fwd = float(np.max(np.abs(back - want_fwd)))
        inv_ms = cuda_ms(lambda: emb.embed_inverse(zt), reps=10)
        fwd_ms = cuda_ms(lambda: emb.embed_forward(ct), reps=10)
        log(f"[q32 embedding] DeviceEmbedding({slots}) on ({PACKED_BATCH}, {slots}): inverse "
            f"max|diff| {err:.3e} against the host's float64 FFT (limit {EMBED_TOL}), "
            f"{inv_ms:.4f} ms; forward {err_fwd:.3e} (limit {EMBED_FWD_TOL}), {fwd_ms:.4f} ms "
            f"(CUDA events, mean of 10 calls) on {card}")
        if not (err <= EMBED_TOL and err_fwd <= EMBED_FWD_TOL):
            fail(f"DeviceEmbedding({slots}) on the card: inverse {err}, forward {err_fwd}")


EXAMPLES = ("examples/torch_ckks_basics.py", "examples/torch_ckks_chebyshev.py")


def examples_phase(ck: Checker, card: str) -> dict:
    """Phase 16: the CKKS examples EXAMPLES at their default sizes on the
    card, each run in this process as python3 runs it (runpy, no
    arguments), its output printed line by line: a gate that fails exits
    through the example's SystemExit, and an output that does not end in
    OK fails the run.  Returns the launches of the two runs (counters set
    to 0 just before)."""
    import io
    import runpy

    import torch

    ck.reset()
    for script in EXAMPLES:
        out, argv = io.StringIO(), sys.argv
        sys.argv = [script]
        t0 = time.time()
        try:
            with contextlib.redirect_stdout(out):
                runpy.run_path(script, run_name="__main__")
        except SystemExit as e:
            fail(f"{script}: {e}")
        finally:
            sys.argv = argv
        torch.cuda.synchronize()
        lines = out.getvalue().splitlines()
        for line in lines:
            log(f"[u64 examples] {script}: {line}")
        if not lines or lines[-1] != "OK":
            fail(f"{script} did not end with OK")
        log(f"[u64 examples] {script}: {time.time() - t0:.1f} s on {card}")
    launches = ck.launches()
    log(f"[u64 examples] launches {launches}")
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
    with recorded_calls(calls, ck):
        bfv_bgv_run(forms, BFV_N, True)
    torch.cuda.synchronize()
    launches = ck.launches()
    log(f"[u64 bfv/bgv] one pass of the traffic of {len(forms)} contexts in "
        f"{time.time() - t0:.1f} s (host clock, decryption checks, noise budgets and the "
        f"plain-version checks of each distinct call included); launches: {launches}")
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


# --------------------------------------------------------------------------
# phase 17: the sharded paths (tpu_fhe_torch/parallel/) in 4 ranks on the card
# --------------------------------------------------------------------------

PAR_WORLD = 4
PAR_REPS = 3                             # timed calls of each sharded and one-process op
PAR_SEED = 1717
# the kernels each path must launch (summed over the ranks)
PAR_KERNELS = {
    "limb u64": ("ntt_inv", "bconv_mxu", "ntt_fwd", "key_inner_prod_shoup", "ntt_fwd_landing"),
    "batch x limb u64": ("ntt_inv", "bconv_mxu", "ntt_fwd", "key_inner_prod_shoup",
                         "ntt_fwd_landing"),
    "limb q32": ("ntt_inv32", "bconv32", "ntt_fwd32", "key_inner_prod_shoup32",
                 "ntt_fwd_landing32"),
    "coeff u64": ("bconv_mxu", "key_inner_prod_shoup", "key_inner_prod"),
    "bsgs u64": ("ntt_inv", "bconv_mxu", "ntt_fwd", "key_inner_prod", "ntt_fwd_landing"),
    "bsgs q32": ("ntt_inv32", "bconv32", "ntt_fwd32", "key_inner_prod32", "ntt_fwd_landing32"),
}


def parallel_phase(card: str, checkers: list) -> dict:
    """Phase 17: the port's sharded paths in PAR_WORLD ranks, every rank on
    cuda:0, joined by gloo through a file rendezvous (the card's machine has
    one card, and NCCL takes one rank a device): under gloo every CUDA
    tensor a collective is given goes through host memory.  It measures no
    scaling across cards.  The paths (parallel_rank): multiply ->
    relinearize -> rescale on a 1 x 4 limb mesh at bench.py's u64 config
    and on the q32 one (rescale_composite), the same over a stacked batch
    of 4 on 2 x 2, the 4-step NTT, the keyswitch and rotate_4step on a 1 x 4
    coeff mesh, and the flagship bootstrap's first C2S BSGS level (N =
    2^16) limb-sharded.  Each is gathered and held on rank 0 against the
    one-process path through the kernels, bit for bit with its metadata,
    and run in every rank with every wrapper call held against its plain
    version (recorded_calls).  Prints per path the collectives, ms per op
    in each rank beside the one-process ms, the launches and each rank's
    peak memory; the shapes held join each kernel's "path_shapes" in the
    plans' Checkers.  Returns the launches summed over the ranks, by
    kernel."""
    import tempfile

    import torch

    from tpu_fhe_torch.parallel.sharding import run_ranks

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            reports = run_ranks(parallel_rank, PAR_WORLD, (card,), init_file=f"{tmp}/init",
                                backend="gloo", timeout_s=600)
        except RuntimeError as e:
            fail(f"phase 17: {e}")
    log(f"[parallel] {PAR_WORLD} ranks sharing one card ({card}), gloo (every CUDA tensor of a "
        f"collective through host memory): world ran in {time.time() - t0:.1f} s")
    total, shapes = {}, {}
    for path, want in PAR_KERNELS.items():
        first = reports[0][path]
        if not first["equal"]:
            fail(f"phase 17 {path}: the sharded result differs from the one-process path")
        summed = {}
        for rep in reports:
            for name, count in rep[path]["launches"].items():
                summed[name] = summed.get(name, 0) + count
            for name, count in rep[path]["held"].items():
                shapes[name] = shapes.get(name, 0) + count
        missing = [k for k in want if not summed.get(k)]
        if missing:
            fail(f"phase 17 {path}: kernels of the path not launched: {missing}")
        for name, count in summed.items():
            total[name] = total.get(name, 0) + count
        for what, line in first["lines"]:
            log(f"[parallel {path}] {what}: {line}")
        for key in first["ms"]:
            log(f"[parallel {path}] {key}: ms per op by rank "
                + ", ".join(f"{rep[path]['ms'][key]:.3f}" for rep in reports)
                + (f"; one process {first['one_ms'][key]:.3f}" if key in first["one_ms"] else ""))
        log(f"[parallel {path}] collectives per rank: "
            + "; ".join(f"rank {i}: {rep[path]['counts']}" for i, rep in enumerate(reports)))
        log(f"[parallel {path}] distinct wrapper calls held == plain versions by rank: "
            + ", ".join(str(sum(rep[path]["held"].values())) for rep in reports)
            + f"; launches summed over the ranks: {dict(sorted((k, v) for k, v in summed.items() if v))}")
    for ck in checkers:
        for name, count in shapes.items():
            if name in ck.report:
                ck.report[name].setdefault("path_shapes", {})["phase 17, every rank"] = count
    log("[parallel] peak device memory by rank (GiB): "
        + ", ".join(f"{rep['peak_gib']:.2f}" for rep in reports)
        + f"; together {sum(rep['peak_gib'] for rep in reports):.2f}")
    return total


def parallel_rank(rank: int, world: int, card: str) -> dict:
    """One rank of phase 17 (see parallel_phase); returns its report."""
    import torch

    from tpu_fhe_torch.ops import bconv, ks, ntt

    torch.cuda.set_device(0)
    torch.cuda.reset_peak_memory_stats()
    ck = Checker([ntt.NTT_FWD, ntt.NTT_FWD_LANDING, ntt.NTT_INV, bconv.BCONV_MXU, bconv.BCONV,
                  ks.KS_SHOUP, ks.KS, ntt.NTT_FWD32, ntt.NTT_FWD_LANDING32, ntt.NTT_INV32,
                  bconv.BCONV32, ks.KS_SHOUP32, ks.KS32])
    report = {}
    report.update(par_limb_paths(rank, "u64", ck))
    gc.collect()
    torch.cuda.empty_cache()
    report.update(par_limb_paths(rank, "q32", ck))
    gc.collect()
    torch.cuda.empty_cache()
    for plan in ("u64", "q32"):
        report[f"bsgs {plan}"] = par_bsgs(rank, plan, ck)
        gc.collect()
        torch.cuda.empty_cache()
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return report


def par_recorded(path: str, ck: Checker, run):
    """run() once with every wrapper call held against its plain version as
    it comes (recorded_calls); -> (its result, the launches, the rank's
    collectives, the distinct shapes held)."""
    import torch

    from tpu_fhe_torch.parallel import collectives as coll

    calls = {}
    torch.cuda.synchronize()
    ck.reset()
    coll.reset_counts()
    with recorded_calls(calls, ck):
        out = run()
    torch.cuda.synchronize()
    launches, counts = ck.launches(), coll.counts()
    if calls["count"] != sum(launches.values()):
        fail(f"phase 17 {path}: {calls['count']} wrapper calls recorded against "
             f"{sum(launches.values())} launches")
    missing = [k for k, v in launches.items() if v and k not in calls["held"]]
    if missing:
        fail(f"phase 17 {path}: launched but never held against the plain version: {missing}")
    return out, launches, counts, {k: v[0] for k, v in calls["held"].items()}


def par_ms(run, reps: int = PAR_REPS) -> float:
    """Host clock around `reps` calls after a warm-up, each ending in a
    synchronize (a sharded call waits for the other ranks in its
    collectives)."""
    import torch

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def par_same(got, want) -> bool:
    import torch

    return torch.equal(got.data, want.data) and _meta(got) == _meta(want)


def par_one_process(rank: int, fn):
    """fn() on rank 0 alone while the others wait; None on the others."""
    import torch.distributed as dist

    out = fn() if rank == 0 else None
    dist.barrier()
    return out


def par_limb_paths(rank: int, plan: str, ck: Checker) -> dict:
    """The limb mesh (and, on u64, batch x limb and the coeff mesh) at
    phase 3's N = 2^15 configuration of `plan`."""
    from tpu_fhe_torch.core.modulus import CoeffModulus
    from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
    from tpu_fhe_torch.eval import evaluator as ev
    from tpu_fhe_torch.parallel import limb_eval as le, sharding as sh
    from tpu_fhe_torch.scheme.ciphertext import stack_cts
    from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder
    from tpu_fhe_torch.scheme.context import FheContext
    from tpu_fhe_torch.scheme.keys import SecretKey

    q32 = plan == "q32"
    if q32:
        special = COMPOSITE["special_count"]
        params = EncryptionParameters(SchemeType.ckks, N, tuple(CoeffModulus.create_composite(
            N, **COMPOSITE)), special_modulus_size=special, composite_degree=2,
            allow_insecure=True)
        scale, limbs = SCALE32, 2
    else:
        params = EncryptionParameters(SchemeType.ckks, N, tuple(CoeffModulus.create(N, BITS)),
                                      special_modulus_size=SPECIAL, allow_insecure=True)
        scale, limbs = SCALE, 1
    ctx = FheContext(params)
    dev = ctx.device
    count = 1 + 4 * (not q32)
    drawn = None
    if rank == 0:              # drawn once, on rank 0, then broadcast
        sk, enc = SecretKey(ctx, seed=PAR_SEED), CkksEncoder(ctx)
        rng = np.random.default_rng(PAR_SEED)
        cts = [sk.encrypt_symmetric(enc.encode(rng.uniform(-1, 1, N // 2), scale))
               for _ in range(count)]
        drawn = (sk.relin_key(), cts, None if q32 else sk.galois_key([1]))
    rlk = sh.broadcast_relin_key(drawn[0] if drawn else None, dev)
    cts = [sh.broadcast_ciphertext(drawn[1][j] if drawn else None, dev) for j in range(count)]
    out = {}

    def one_step(c, key):
        prod = ev.relinearize(ctx, ev.multiply(ctx, c, c), key)
        return ev.rescale_composite(ctx, prod, 2) if q32 else ev.rescale_to_next(ctx, prod)

    mesh = sh.make_mesh(1, PAR_WORLD)
    sctx = le.LimbShardContext(ctx, mesh)
    rlk_s = sh.shard_relin_key(ctx, rlk, mesh)
    s = sh.shard_ciphertext(ctx, cts[0], mesh)
    prod_s = ev.multiply(sctx, s, s)
    got, launches, counts, held = par_recorded(
        f"limb {plan}", ck, lambda: le.mul_relin_rescale(sctx, s, s, rlk_s, limbs))
    whole = sh.gather(ctx, got, mesh)
    want = par_one_process(rank, lambda: one_step(cts[0], rlk))
    ms = {"multiply -> relinearize -> rescale": par_ms(
        lambda: le.mul_relin_rescale(sctx, s, s, rlk_s, limbs)),
        "relinearize": par_ms(lambda: ev.relinearize(sctx, prod_s, rlk_s))}
    prod = ev.multiply(ctx, cts[0], cts[0])
    one_ms = par_one_process(rank, lambda: {
        "multiply -> relinearize -> rescale": par_ms(lambda: one_step(cts[0], rlk)),
        "relinearize": par_ms(lambda: ev.relinearize(ctx, prod, rlk))})
    out[f"limb {plan}"] = dict(
        equal=rank != 0 or par_same(whole, want), launches=launches, counts=counts, held=held,
        ms=ms, one_ms=one_ms or {},
        lines=[("1 x 4 limb mesh", f"N=2^{N.bit_length() - 1}, {params.size_Q} + "
                f"{params.size_P} limbs, {sctx.bq} + {sctx.bp} rows a rank; chain index "
                f"{cts[0].chain_index} -> {whole.chain_index}, gathered == one process bit for "
                f"bit with its metadata: {rank != 0 or par_same(whole, want)}")])
    if q32:
        return out

    # batch x limb: the stacked batch of 4 over 2 x 2
    mesh22 = sh.make_mesh(2, PAR_WORLD // 2)
    sctx22 = le.LimbShardContext(ctx, mesh22)
    rlk22 = sh.shard_relin_key(ctx, rlk, mesh22)
    batch = stack_cts(cts[1:])
    b = sh.shard_ciphertext(ctx, batch, mesh22, batched=True)
    got, launches, counts, held = par_recorded(
        "batch x limb", ck, lambda: le.mul_relin_rescale(sctx22, b, b, rlk22))
    whole = sh.gather(ctx, got, mesh22, batched=True)
    want = par_one_process(rank, lambda: one_step(batch, rlk))
    equal = rank != 0 or par_same(whole, want)
    out["batch x limb u64"] = dict(
        equal=equal, launches=launches, counts=counts, held=held,
        ms={"multiply -> relinearize -> rescale of the batch": par_ms(
            lambda: le.mul_relin_rescale(sctx22, b, b, rlk22))},
        one_ms=par_one_process(rank, lambda: {
            "multiply -> relinearize -> rescale of the batch": par_ms(
                lambda: one_step(batch, rlk))}) or {},
        lines=[("2 x 2 batch x limb mesh", f"a stacked batch of 4, 2 a rank, gathered == one "
                f"process bit for bit: {equal}")])
    del mesh22, sctx22, rlk22, b
    out["coeff u64"] = par_coeff(rank, ctx, rlk, cts[0], drawn[2] if drawn else None, ck)
    return out


def par_coeff(rank: int, ctx, rlk, ct, gk, ck: Checker) -> dict:
    """The 1 x 4 coeff mesh at the u64 config: the 4-step NTT (N1 = 2^7, N2
    = 2^8) on the (30, 2^15) ciphertext component against K1 and K2, the
    keyswitch (relinearize_4step) and rotate_4step by 1."""
    import torch

    from tpu_fhe_torch.eval import evaluator as ev
    from tpu_fhe_torch.ops.ntt import forward_ntt, inverse_ntt
    from tpu_fhe_torch.parallel import coeff_eval as ce, collectives as coll, ntt4step as n4
    from tpu_fhe_torch.parallel import sharding as sh

    dev = ctx.device
    gk = sh.broadcast_galois_key(gk, dev)
    mesh = sh.coeff_mesh(1, PAR_WORLD)
    level = ctx.level(ct.chain_index)
    x_ntt = ct.data[0]
    x_coeff = inverse_ntt(x_ntt.contiguous(), level.ntt)
    rows, cols = n4.rows_shard(x_ntt, mesh), n4.cols_shard(x_coeff, mesh)
    coll.reset_counts()
    fwd = n4.forward_ntt_4step(cols, level.ntt, mesh)
    inv = n4.inverse_ntt_4step(rows, level.ntt, mesh)
    ntt_counts = coll.counts()
    ntt_equal = torch.equal(n4.gather_rows_layout(fwd, mesh), x_ntt) and \
        torch.equal(n4.gather_cols_layout(inv, mesh), x_coeff)
    shape = f"({level.size}, 2^{ctx.n.bit_length() - 1})"
    ms = {f"forward_ntt_4step {shape}": par_ms(
              lambda: n4.forward_ntt_4step(cols, level.ntt, mesh)),
          f"inverse_ntt_4step {shape}": par_ms(
              lambda: n4.inverse_ntt_4step(rows, level.ntt, mesh))}
    one_ms = par_one_process(rank, lambda: {
        f"forward_ntt_4step {shape}": cuda_ms(lambda: forward_ntt(x_coeff, level.ntt), 20),
        f"inverse_ntt_4step {shape}": cuda_ms(lambda: inverse_ntt(x_ntt.contiguous(),
                                                                  level.ntt), 20)}) or {}
    prod = ev.multiply(ctx, ct, ct)
    p_s, c_s = ce.shard_ciphertext(prod, mesh), ce.shard_ciphertext(ct, mesh)
    rlk_c, gk_c = ce.shard_key(rlk, mesh), ce.shard_galois_key(gk, mesh)

    def run():
        return (ce.relinearize_4step(ctx, p_s, rlk_c, mesh),
                ce.rotate_4step(ctx, c_s, 1, gk_c, mesh))
    (relin, rot), launches, counts, held = par_recorded("coeff u64", ck, run)
    relin_w, rot_w = ce.gather(relin, mesh), ce.gather(rot, mesh)
    want = par_one_process(rank, lambda: (ev.relinearize(ctx, prod, rlk),
                                          ev.rotate(ctx, ct, 1, gk)))
    equal = rank != 0 or (ntt_equal and par_same(relin_w, want[0])
                          and par_same(rot_w, want[1]))
    ms.update({"relinearize_4step": par_ms(lambda: ce.relinearize_4step(ctx, p_s, rlk_c, mesh)),
               "rotate_4step": par_ms(lambda: ce.rotate_4step(ctx, c_s, 1, gk_c, mesh))})
    one_ms.update(par_one_process(rank, lambda: {
        "relinearize_4step": par_ms(lambda: ev.relinearize(ctx, prod, rlk)),
        "rotate_4step": par_ms(lambda: ev.rotate(ctx, ct, 1, gk))}) or {})
    return dict(equal=equal, launches=launches, counts=counts, held=held, ms=ms, one_ms=one_ms,
                lines=[("1 x 4 coeff mesh", f"the 4-step NTT == K1 and K2 bit for bit: "
                        f"{rank != 0 or ntt_equal} (collectives of one forward and one inverse: "
                        f"{ntt_counts}); relinearize_4step and rotate_4step by 1 == one process "
                        f"bit for bit: {equal}; the one-process ms beside the 4-step's are K1's "
                        f"and K2's (CUDA events)")])


def par_bsgs(rank: int, plan: str, ck: Checker) -> dict:
    """The flagship bootstrap's first C2S BSGS level on `plan` (phase 10's
    context: N = 2^16, u64 26 + 13 limbs or q32 52 + 26, budget (4, 4),
    32768 slots), limb-sharded over 1 x 4 with the level's Galois keys
    alone, drawn without Shoup words (K7 on u64, K9 on q32)."""
    import torch

    from tpu_fhe_torch.boot.bootstrap import CkksBootstrapper
    from tpu_fhe_torch.parallel import boot_sharded as bs, limb_eval as le, sharding as sh
    from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder
    from tpu_fhe_torch.scheme.keys import SecretKey

    t0 = time.time()
    ctx = boot_context(plan, BOOT_N, UNIFORM_SINE, BOOT_BUDGET, levels_after=1)
    enc = CkksEncoder(ctx)
    boot = CkksBootstrapper(ctx, enc)
    boot.set_sine_params(*UNIFORM_SINE)
    slots = BOOT_N // 2
    # the plaintexts of the one level run (those of the whole setup), not all
    boot.setup(level_budget=BOOT_BUDGET, dim1=BOOT_DIM1, slots=slots, c2s_stage=0)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    si, rot_in, rot_out, b, g, num_rot, _ = boot.c2s_stage_plans(slots)[0]
    A = boot.precom[slots].a_c2s[si]
    chain_index = next(pt.chain_index for pt in A if pt is not None)
    drawn = None
    if rank == 0:
        sk = SecretKey(ctx, seed=PAR_SEED)
        steps = [st for st in dict.fromkeys(list(rot_in) + list(rot_out)) if st != 0]
        x = np.random.default_rng(PAR_SEED).uniform(-0.8, 0.8, slots)
        drawn = (sk.galois_key(steps), sk.encrypt_symmetric(
            enc.encode(x, 2.0 ** 59, chain_index=chain_index, slots=slots)))
    boot.galois_keys = sh.broadcast_galois_key(drawn[0] if drawn else None, ctx.device)
    ct = sh.broadcast_ciphertext(drawn[1] if drawn else None, ctx.device)
    mesh = sh.make_mesh(1, PAR_WORLD)
    sctx = le.LimbShardContext(ctx, mesh)
    (got, stats), launches, counts, held = par_recorded(
        f"bsgs {plan}", ck, lambda: bs.bsgs_level_limb_sharded(boot, ct, slots, mesh, sctx=sctx))
    whole = sh.gather(ctx, got, mesh)
    keys = boot._keys_for(rot_in, rot_out)

    def one():
        return boot._bsgs_level(ct, A, keys, rot_in, rot_out, b, g, num_rot)
    want = par_one_process(rank, one)
    equal = rank != 0 or par_same(whole, want)
    ms = {"C2S BSGS level 0": par_ms(
        lambda: bs.bsgs_level_limb_sharded(boot, ct, slots, mesh, sctx=sctx), reps=1)}
    one_ms = par_one_process(rank, lambda: {"C2S BSGS level 0": par_ms(one, reps=1)}) or {}
    return dict(equal=equal, launches=launches, counts=counts, held=held, ms=ms, one_ms=one_ms,
                lines=[("C2S BSGS level 0, limb-sharded", f"N=2^{BOOT_N.bit_length() - 1}, "
                        f"{ctx.params.size_Q} + "
                        f"{ctx.params.size_P} limbs, {sctx.bq} + {sctx.bp} rows a rank, chain "
                        f"index {ct.chain_index}, g={g} b={b}, {len(keys)} Galois keys; context and "
                        f"the level's plaintexts {setup_s:.1f} s in each rank; gathered == one process bit for bit "
                        f"with its metadata: {equal}; the level's own collectives {stats}")])


if __name__ == "__main__":
    sys.exit(main())
