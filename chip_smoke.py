#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's CKKS slices on one NVIDIA GPU.

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
    bconv32's int8 operands as a yardstick of its product part;
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
    over 4 steps against 4 separate rotates and 3 adds.

Last, the kernels line (every kernel of both plans) and the line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
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


def bconv_cost(word: int, batch: int, k: int, m: int) -> dict:
    """Bytes, IMADs and int8 operations of one base conversion of `batch`
    rows, k -> m limbs of N coefficients, in its digit-plane form."""
    planes, epi = BCONV_FORMS[word]
    return dict(nbytes=word * N * batch * (k + m), imads=batch * m * N * epi,
                int8_ops=2 * batch * (planes * m) * (planes * k) * N)


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
    log(f"[build] {len(logs)} sources compiled in {time.time() - t0:.1f} s "
        f"(0 = already built)")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()}")

    line = u64_slice(card) + q32_slice(card)
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
        entry["checks"].append(shape)
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
                "bound_by": e["bound_by"], "library_ms": None, "shapes": e["checks"],
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

def u64_slice(card: str) -> list:
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
    rot = rotation_phase("u64", ctx, ck, sk, SCALE, keep=2,
                         off_path=("key_inner_prod_shoup", "bconv"), card=card)
    return ck.line({name: launches[name] + rot[name] for name in launches})


# --------------------------------------------------------------------------
# the q32 plan of composite scaling
# --------------------------------------------------------------------------

def q32_slice(card: str) -> list:
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
    rot = rotation_phase("q32", ctx, ck, sk, SCALE32, keep=4,
                         off_path=("key_inner_prod_shoup32",), card=card)
    return ck.line({name: launches[name] + rot[name] for name in launches})


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
    kernel), so a window that sees that kernel alone but fewer times is
    taken again, up to `windows` in all; a window that sees any other
    kernel, or more launches, fails at once."""
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
        if not alone or seen[0][1] > reps:
            fail(f"{what}: expected {reps} launches of {' '.join(names)} alone, the "
                 f"profile saw {seen}")
        if seen[0][1] == reps:
            break
        log(f"[one launch] {what}: window {window} saw {seen[0][1]} of {reps} launches "
            "(the profiler lost events)")
    else:
        fail(f"{what}: expected {reps} launches of {' '.join(names)}; {windows} profiles "
             f"each lost events, the last saw {seen}")
    log(f"[one launch] {what}: {' '.join(names)}, {reps} calls, {reps} launches")


@contextlib.contextmanager
def plain_versions():
    """Within this block the evaluator (and hoisting, which calls its
    keyswitch stages) computes through the kernels' plain torch versions,
    on the same CUDA tensors: the names it calls are swapped for them."""
    from tpu_fhe_torch.eval import evaluator as ev
    from tpu_fhe_torch.ops import bconv, ks, ntt

    swaps = dict(
        forward_ntt=ntt.forward_ntt_plain, inverse_ntt=ntt.inverse_ntt_plain,
        inverse_ntt_scaled=ntt.inverse_ntt_plain,
        forward_ntt_sub_scale=ntt.forward_ntt_sub_scale_plain,
        bconv_matmul=bconv.bconv_matmul_plain, bconv_matmul32=bconv.bconv_matmul32_plain,
        key_inner_prod=ks.key_inner_prod_plain, key_inner_prod32=ks.key_inner_prod32_plain,
        key_inner_prod_shoup=ks.key_inner_prod_shoup_plain)
    saved = {name: getattr(ev, name) for name in swaps}
    for name, fn in swaps.items():
        setattr(ev, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ev, name, fn)


def same_as_plain(tag: str, what: str, ck: Checker, run) -> None:
    """`run()` (a list of ciphertexts) through the kernels equals the same
    through the plain versions, bit for bit; the plain run launches
    nothing."""
    import torch

    got = [c.data for c in run()]
    ck.reset()
    with plain_versions():
        want = [c.data for c in run()]
    torch.cuda.synchronize()
    if any(ck.launches().values()):
        fail(f"{tag} {what}: the run through the plain versions launched kernels")
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail(f"{tag} {what} through the kernels differs from the plain versions")
    log(f"[{tag} slice] {what}: kernels == plain versions, bit for bit")


def rotation_phase(tag: str, ctx, ck: Checker, sk, scale: float, keep: int, off_path: tuple,
                   card: str) -> dict:
    """Phase 6: Galois keys, ROT_REQUESTS rotation requests at chain index
    1 (results mod-dropped to `keep` limbs before decryption), the launch
    and bit-exact checks, and the rotation timings.  Returns the launch
    counts of the requests."""
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
    return launches


if __name__ == "__main__":
    sys.exit(main())
