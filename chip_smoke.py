#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's CKKS slice on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure (nothing is caught and
turned into a pass, and nothing runs on the CPU when there is no card):

 1. device: the card's name and power limit (nvidia-smi);
 2. build: every kernel of tpu_fhe_torch/csrc, one nvcc each, in parallel;
 3. kernels: each kernel against its plain torch version on the card, at
    the full-width shapes of the slice (N = 2^15, 30 + 15 limbs, chain
    index 1), integer-exact, with its device time (CUDA events around a
    CUDA-graph replay of 20 launches), the plain version's time and the
    least time the card could take;
 4. slice: bench.py's primary configuration, keys, then 4 requests of
    encode -> encrypt (symmetric and asymmetric) -> multiply ->
    relinearize -> rescale -> decrypt -> decode, each within 1e-6 of the
    cleartext product; every kernel's launch counter must have risen;
    one relinearize is held bit-exact against the plain versions on the
    card;
 5. timing: keyswitch ms/op and keyswitch/s (relinearize of a random
    size-3 ciphertext, bench.py's median-of-pairs marginal), launches per
    relinearize, and a device-only torch.profiler window of 10
    relinearizes: kernel time by name and the device's busy share;
 6. the kernels line, then the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N = 1 << 15
BITS = [60] + [50] * 29 + [60] * 15      # bench.py primary config
SPECIAL = 15
SCALE = 2.0 ** 50
REQUESTS = 4
TOL = 1e-6
HBM_BYTES_PER_S = 3.35e12                # H100 SXM device memory
# 32-bit integer multiply-add rate: Hopper issues half as many IMAD as
# FFMA per SM and clock, so half of the 67 TFLOP/s float32 peak.
INT32_OPS_PER_S = 67e12 / 2
IMAD_PER_MUL64 = 4                       # one 64x64 product (lo or hi) in 32-bit IMADs


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


def bound_ms(nbytes: float, mul64: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = mul64 * IMAD_PER_MUL64 / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    try:
        from tpu_fhe_torch.core.modulus import CoeffModulus
        from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
        from tpu_fhe_torch.eval import evaluator as ev
        from tpu_fhe_torch.ops import _build, bconv, ks, modarith as mm, ntt
        from tpu_fhe_torch.scheme.ciphertext import Ciphertext
        from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder
        from tpu_fhe_torch.scheme.context import FheContext
        from tpu_fhe_torch.scheme.keys import SecretKey, encrypt_asymmetric
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

    # -- context (the slice's tables, also the kernels' full-width inputs)
    t0 = time.time()
    params = EncryptionParameters(SchemeType.ckks, N, tuple(CoeffModulus.create(N, BITS)),
                                  special_modulus_size=SPECIAL, allow_insecure=True)
    ctx = FheContext(params)
    torch.cuda.synchronize()
    log(f"[context] N={N} limbs={len(BITS)} on {ctx.device}: {time.time() - t0:.1f} s")
    level = ctx.level(1)
    kst = level.ks
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(2024)

    def residues(q: torch.Tensor, *lead: int) -> torch.Tensor:
        """Uniform residues (*lead, L, N) for moduli q (L, 1)."""
        x = torch.randint(0, 1 << 62, lead + (q.shape[0], N), generator=gen,
                          dtype=torch.int64, device=dev)
        return x % q

    # -- 3. kernels against their plain versions ---------------------------
    kernels = {k.name: k for k in (ntt.NTT_FWD, ntt.NTT_FWD_LANDING, ntt.NTT_INV,
                                   bconv.BCONV, ks.KS_SHOUP)}
    report = {name: {"checks": []} for name in kernels}

    def check(name, shape, kernel_fn, plain_fn, nbytes, mul64, headline=False):
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        if got.shape != want.shape:
            fail(f"{name} {shape}: kernel shape {tuple(got.shape)} != plain {tuple(want.shape)}")
        err = int((got - want).abs().max().item())
        if err != 0:
            fail(f"{name} {shape}: kernel differs from its plain version (max |diff| {err})")
        ms = cuda_ms(kernel_fn, reps=20, graph=True)
        called = cuda_ms(kernel_fn, reps=20)
        plain = cuda_ms(plain_fn, reps=1, samples=3)
        bms, by = bound_ms(nbytes, mul64)
        log(f"[kernel] {name} {shape}: max|diff|=0  {ms:.4f} ms (graph replay; "
            f"{called:.4f} ms called from Python)  plain {plain:.3f} ms  "
            f"bound {bms:.4f} ms ({by})")
        entry = report[name]
        entry["checks"].append(shape)
        if headline or "ms" not in entry:
            entry.update(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)

    L = level.size                                      # 30
    P = kst.p_ntt.num_limbs                             # 15
    dig = kst.digits[0]
    comp = dig.comp_ntt                                 # 30 complement limbs

    def ntt_bytes(rows_, limbs_, tables=2):
        return 8 * N * (2 * rows_ + tables * limbs_)

    def ntt_mul64(rows_):
        return rows_ * (N // 2) * (N.bit_length() - 1) * 3

    x = residues(level.mod.q)
    check("ntt_fwd", "(30, 2^15)", lambda: ntt.forward_ntt(x, level.ntt),
          lambda: ntt.forward_ntt_plain(x, level.ntt), ntt_bytes(L, L), ntt_mul64(L),
          headline=True)
    x2 = residues(comp.q, 2)
    check("ntt_fwd", "(2, 30, 2^15)", lambda: ntt.forward_ntt(x2, comp),
          lambda: ntt.forward_ntt_plain(x2, comp), ntt_bytes(2 * L, L), ntt_mul64(2 * L))
    sub = residues(level.mod.q, 2)
    xs = residues(level.mod.q, 2)
    args = (kst.big_pinv_mod_q, kst.big_pinv_mod_q_shoup)
    check("ntt_fwd_landing", "(2, 30, 2^15)",
          lambda: ntt.forward_ntt_sub_scale(xs, sub, level.ntt, *args),
          lambda: ntt.forward_ntt_sub_scale_plain(xs, sub, level.ntt, *args),
          8 * N * (3 * 2 * L + 2 * L), ntt_mul64(2 * L) + 2 * L * N * 3, headline=True)
    scale = (kst.part_qhatinv, kst.part_qhatinv_shoup)
    check("ntt_inv", "(30, 2^15) scaled", lambda: ntt.inverse_ntt_scaled(x, level.ntt, *scale),
          lambda: ntt.inverse_ntt_plain(x, level.ntt, *scale), ntt_bytes(L, L),
          ntt_mul64(L) + 2 * L * N * 3, headline=True)
    xp = residues(kst.p_mod.q, 2)
    pscale = (kst.p_hatinv, kst.p_hatinv_shoup)
    check("ntt_inv", "(2, 15, 2^15) scaled",
          lambda: ntt.inverse_ntt_scaled(xp, kst.p_ntt, *pscale),
          lambda: ntt.inverse_ntt_plain(xp, kst.p_ntt, *pscale), ntt_bytes(2 * P, P),
          ntt_mul64(2 * P) + 2 * 2 * P * N * 3)
    s = residues(level.mod.q[dig.start:dig.end])
    btab = (dig.qhat_mod_p, dig.comp_mod.q, dig.comp_mod.ratio_lo, dig.comp_mod.ratio_hi)
    k_in, m_out = dig.end - dig.start, dig.comp_mod.q.shape[0]
    check("bconv", "15 -> 30, (15, 2^15)", lambda: bconv.bconv_matmul(s, *btab),
          lambda: bconv.bconv_matmul_plain(s, *btab), 8 * N * (k_in + m_out),
          2 * k_in * m_out * N, headline=True)
    s2 = residues(kst.p_mod.q, 2)
    mtab = (kst.p_hat_mod_q, level.mod.q, level.mod.ratio_lo, level.mod.ratio_hi)
    check("bconv", "15 -> 30, (2, 15, 2^15)", lambda: bconv.bconv_matmul(s2, *mtab),
          lambda: bconv.bconv_matmul_plain(s2, *mtab), 8 * N * 2 * (P + L),
          2 * 2 * P * L * N)
    beta = kst.beta
    qlp = kst.qlp_q
    t = residues(qlp, beta)
    kq = ctx.key_level.mod
    evk = residues(kq.q, 3, 2)
    evk_s = mm.shoup_of(evk, kq.q, kq.ratio_lo, kq.ratio_hi)
    rows = kst.qlp_key_rows
    check("key_inner_prod_shoup", "(2, 45, 2^15)",
          lambda: ks.key_inner_prod_shoup(t, evk, evk_s, rows, qlp),
          lambda: ks.key_inner_prod_shoup_plain(t, evk, evk_s, rows, qlp),
          8 * N * (beta * (L + P) + 2 * 2 * beta * (L + P) + 2 * (L + P)),
          3 * 2 * beta * (L + P) * N, headline=True)
    del x, x2, sub, xs, xp, s, s2, t, evk, evk_s

    # -- 4. the slice: keys, then REQUESTS requests ---------------------
    t0 = time.time()
    sk = SecretKey(ctx, seed=5)
    pk = sk.public_key()
    rlk = sk.relin_key()
    torch.cuda.synchronize()
    log(f"[keygen] secret, public, relin (with Shoup words): {time.time() - t0:.1f} s")
    enc = CkksEncoder(ctx)
    rng = np.random.default_rng(7)
    enc_gen = torch.Generator(device=dev).manual_seed(11)

    for k in kernels.values():
        k.launches = 0
    products = []
    for r in range(REQUESTS):
        x_v, y_v = rng.standard_normal(N // 2), rng.standard_normal(N // 2)
        t0 = time.time()
        ct_x = sk.encrypt_symmetric(enc.encode(x_v, SCALE))
        ct_y = encrypt_asymmetric(ctx, pk, enc.encode(y_v, SCALE), enc_gen)
        torch.cuda.synchronize()
        t1 = time.time()
        prod = ev.multiply(ctx, ct_x, ct_y)
        out = ev.rescale_to_next(ctx, ev.relinearize(ctx, prod, rlk))
        torch.cuda.synchronize()
        t2 = time.time()
        got = enc.decode(sk.decrypt(out)).real
        t3 = time.time()
        if got.shape != (N // 2,) or not np.all(np.isfinite(got)):
            fail(f"request {r}: decoded {got.shape} with non-finite values")
        err = float(np.max(np.abs(got - x_v * y_v)))
        log(f"[request {r}] encode+encrypt {t1 - t0:.3f} s, multiply+relinearize+rescale "
            f"{(t2 - t1) * 1e3:.2f} ms, decrypt+decode {t3 - t2:.2f} s, max err {err:.3e}, "
            f"chain index {out.chain_index}")
        if not err <= TOL:
            fail(f"request {r}: max error {err} > {TOL}")
        products.append(prod)
    launches = {name: k.launches for name, k in kernels.items()}
    log(f"[slice] launches over {REQUESTS} requests: {launches}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"kernel {name} was not launched on the slice")

    # one relinearize through the kernels against the plain versions
    got = ev.relinearize(ctx, products[0], rlk).data
    want = plain_relinearize(ctx, level, products[0].data, rlk, ntt, bconv, ks, mm)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("relinearize through the kernels differs from the plain versions")
    log("[slice] relinearize: kernels == plain versions, bit for bit")

    # -- 5. keyswitch timing (bench.py's median-of-pairs marginal) -------
    ct3 = Ciphertext(torch.stack([residues(level.mod.q) for _ in range(3)]), chain_index=1,
                     scale=SCALE)

    def timed(reps: int) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            ev.relinearize(ctx, ct3, rlk)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    timed(2)
    iters, samples = 50, []
    for _ in range(5):
        short, long_ = timed(2), timed(2 + iters)
        if long_ > short:
            samples.append((long_ - short) / iters)
    if not samples:
        fail("keyswitch timing gave no positive marginal")
    samples.sort()
    ks_ms = samples[len(samples) // 2]
    spread = (samples[-1] - samples[0]) / ks_ms
    log(f"[keyswitch] {ks_ms:.4f} ms/op, {1e3 / ks_ms:.2f} keyswitch/s (median of "
        f"{len(samples)} marginal pairs, spread {spread * 100:.0f}%) on {card}")
    for k in kernels.values():
        k.launches = 0
    ev.relinearize(ctx, ct3, rlk)
    log(f"[keyswitch] launches per relinearize: "
        f"{ {name: k.launches for name, k in kernels.items()} }")
    profile_relinearize(lambda: ev.relinearize(ctx, ct3, rlk))

    # -- 6. the kernels line and the last line ---------------------------
    sources = {"ntt_fwd": "ntt.cu", "ntt_fwd_landing": "ntt.cu", "ntt_inv": "ntt.cu",
               "bconv": "bconv.cu", "key_inner_prod_shoup": "ks.cu"}
    line = []
    for name, k in kernels.items():
        e = report[name]
        file_line, _, _ = k.replaces.partition(" ")
        line.append({
            "name": name, "route": "cuda", "source": f"tpu_fhe_torch/csrc/{sources[name]}",
            "replaces": file_line, "launches": launches[name], "max_abs_err": 0,
            "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
            "bound_by": e["bound_by"], "library_ms": None, "shapes": e["checks"],
        })
        if name == "bconv":
            line[-1]["also_replaces"] = "tpu_fhe/ops/bconv_mxu_pallas.py:82"
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def profile_relinearize(fn, reps: int = 10) -> None:
    """Device time by kernel over `reps` relinearizes (torch.profiler,
    device activity only, so that host tracing does not stretch the
    window), and the device's busy share of the window timed with CUDA
    events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
    window_ms = start.elapsed_time(end)
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    if busy_ms <= 0:
        log("[profile] the profiler saw no device time: busy share not measured")
        return
    log(f"[profile] {reps} relinearizes: window {window_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / window_ms:.1f}%), idle "
        f"{100 * (1 - busy_ms / window_ms):.1f}%")
    for e in sorted(device, key=lambda e: -e.self_device_time_total):
        log(f"[profile]   {e.self_device_time_total / 1e3 / reps:.4f} ms/relinearize  "
            f"{e.count / reps:g} calls  {e.key[:90]}")


def plain_relinearize(ctx, level, data, rlk, ntt, bconv, ks, mm):
    """evaluator.relinearize composed from the plain versions only."""
    import torch

    kst = level.ks
    c2 = data[2].contiguous()
    scaled = ntt.inverse_ntt_plain(c2, level.ntt, kst.part_qhatinv, kst.part_qhatinv_shoup)
    digits = []
    for dt in kst.digits:
        conv = bconv.bconv_matmul_plain(scaled[dt.start:dt.end], dt.qhat_mod_p, dt.comp_mod.q,
                                        dt.comp_mod.ratio_lo, dt.comp_mod.ratio_hi)
        conv = ntt.forward_ntt_plain(conv, dt.comp_ntt)
        digits.append(torch.cat([conv[: dt.start], c2[dt.start:dt.end], conv[dt.start:]]))
    cx = ks.key_inner_prod_shoup_plain(torch.stack(digits), rlk.data, rlk.shoup,
                                       kst.qlp_key_rows, kst.qlp_q)
    size_ql = level.size
    p_scaled = ntt.inverse_ntt_plain(cx[:, size_ql:].contiguous(), kst.p_ntt, kst.p_hatinv,
                                     kst.p_hatinv_shoup)
    delta = bconv.bconv_matmul_plain(p_scaled, kst.p_hat_mod_q, level.mod.q,
                                     level.mod.ratio_lo, level.mod.ratio_hi)
    down = ntt.forward_ntt_sub_scale_plain(delta, cx[:, :size_ql], level.ntt,
                                           kst.big_pinv_mod_q, kst.big_pinv_mod_q_shoup)
    return mm.add_mod(data[:2], down, level.mod.q)


if __name__ == "__main__":
    sys.exit(main())
