#!/usr/bin/env python3
"""Compare the port on one GPU across source trees: its keyswitch and
rotate, or the K9 and K11 kernels alone.

    python3 tools/ab_timing.py TREE_A TREE_B
    python3 tools/ab_timing.py --kernels TREE_A TREE_B

Each TREE is the root of a checkout of this repository (for example the
parent commit unpacked with ``git archive`` into a git-ignored directory,
and ``.``).  The trees run in turns A, B, B, A, each in a process of its
own that builds that tree's kernels and imports that tree's
``tpu_fhe_torch`` and ``chip_smoke`` helpers.  The card's name and power
limit come first; then one line per tree and turn.

Without ``--kernels`` a turn times relinearize (a size-3 ciphertext) and
rotate by one slot at chain index 1 of both plans -- the u64 plan
(bench.py's primary configuration: N = 2^15, 30 + 15 primes of 50/60 bits,
``chip_smoke.BITS``/``SPECIAL``) and the q32 plan (N = 2^15, 60 + 30 primes
of 29-30 bits, ``chip_smoke.COMPOSITE``) -- each as ms/op (chip_smoke's
median-of-pairs marginal), its spread, device busy ms per op
(torch.profiler over 10 calls) and whether the profiler lost events (a
kernel count that is not a multiple of 10).

With ``--kernels`` a turn holds K9 (``key_inner_prod32``) and K11 (the
``bconv`` kernel) against their plain versions, bit for bit, and times
each (``chip_smoke.cuda_ms``: CUDA-graph replay of 20 launches, median of
5) at the shapes of PERF.md's kernel table: K9 on t (B, 2, L, N) of 30-bit
primes with a key of 2 digits -- (2, 89, 2^15), (2, 78, 2^16), (2, 90,
2^16), (4, 2, 89, 2^16), (16, 2, 90, 2^16), (16, 2, 89, 2^16) and (17, 2,
90, 2^16); K11 on 60-bit primes at 64 -> 30 (2^15, through
``bconv_matmul``), 15 -> 30 (2^15, the kernel's entry point called
directly), (2, 127) -> 32 and 190 -> 63 (2^16, through
``bconv_matmul``).  A summary follows the turns: per shape each tree's
two times, their mean, the spread of the turns (the largest of the two
trees' differences between their turns, as a fraction of the faster
mean) and A's mean over B's.  Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

OPS_CHILD = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from tpu_fhe_torch.ops import _build
from tpu_fhe_torch.core.modulus import CoeffModulus
from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
from tpu_fhe_torch.eval import evaluator as ev
from tpu_fhe_torch.scheme.ciphertext import Ciphertext
from tpu_fhe_torch.scheme.context import FheContext
from tpu_fhe_torch.scheme.keys import SecretKey

if not torch.cuda.is_available():
    sys.exit("needs a CUDA device")
_build.build_all()
n = cs.N
plans = {
    "u64": (EncryptionParameters(SchemeType.ckks, n, tuple(CoeffModulus.create(n, cs.BITS)),
                                 special_modulus_size=cs.SPECIAL, allow_insecure=True),
            cs.SCALE),
    "q32": (EncryptionParameters(
        SchemeType.ckks, n, tuple(CoeffModulus.create_composite(n, **cs.COMPOSITE)),
        special_modulus_size=cs.COMPOSITE["special_count"], composite_degree=2,
        allow_insecure=True), cs.SCALE32),
}
marker = torch.zeros(1, dtype=torch.int8, device="cuda")
out = {}
for plan, (params, scale) in plans.items():
    ctx = FheContext(params)
    sk = SecretKey(ctx, seed=5)
    rlk, gk = sk.relin_key(), sk.galois_key([1])
    res = cs.residue_maker(ctx.device, n, 7)
    q = ctx.level(1).mod.q
    ct3 = Ciphertext(torch.stack([res(q) for _ in range(3)]), chain_index=1, scale=scale)
    ct2 = Ciphertext(torch.stack([res(q) for _ in range(2)]), chain_index=1, scale=scale)
    out[plan] = {}
    for name, fn in (("relinearize", lambda: ev.relinearize(ctx, ct3, rlk)),
                     ("rotate", lambda: ev.rotate(ctx, ct2, 1, gk))):
        ms, spread, _ = cs.marginal_ms(name, fn)
        fn()
        torch.cuda.synchronize()
        # a one-byte fill leads the window, uncounted: a profiler window after
        # the first in a process can miss its first kernels
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            marker.fill_(1)
            torch.cuda.synchronize()
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and "FillFunctor" not in e.key]
        busy = sum(e.self_device_time_total for e in device) / 1e3 / 10
        out[plan][name] = {"ms_per_op": ms, "spread": spread, "device_busy_ms": busy,
                           "events_lost": any(e.count % 10 for e in device)}
    del ctx, sk, rlk, gk, ct3, ct2
print(json.dumps(out))
'''

KERNEL_CHILD = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import chip_smoke as cs
from tpu_fhe_torch.core.modulus import CoeffModulus
from tpu_fhe_torch.ops import _build, bconv, ks, modarith as mm
from tpu_fhe_torch.ops._build import ptr

if not torch.cuda.is_available():
    sys.exit("needs a CUDA device")
_build.build_all(["ks.cu", "bconv.cu"])
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(15)


def residues(q, *lead, n):
    x = torch.randint(0, 1 << 62, lead + (q.shape[0], n), generator=gen, dtype=torch.int64,
                      device=dev)
    return (x % q.to(torch.int64)).to(q.dtype)


def timed(fn, plain):
    got, want = fn(), plain()
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        sys.exit("a kernel differs from its plain version")
    return cs.cuda_ms(fn, reps=20, graph=True)


out = {}
# K9: a key of 2 digits over key_rows 30-bit primes; with L < key_rows the
# QlP rows skip one Q row, as chain index 2 of phase 13's context does
for batch, L, key_rows, log_n in ((1, 89, 90, 15), (1, 78, 78, 16), (1, 90, 90, 16),
                                  (4, 89, 90, 16), (16, 90, 90, 16), (16, 89, 90, 16),
                                  (17, 90, 90, 16)):
    n = 1 << log_n
    qs = [m.value for m in CoeffModulus.create(n, [30] * key_rows)]
    rows = list(range(key_rows)) if L == key_rows else list(range(59)) + list(range(60, 90))
    kq = mm.u32_tensor(np.array(qs, dtype=np.uint64).reshape(-1, 1), dev)
    sel = torch.tensor(rows, dtype=torch.int64, device=dev)
    q = kq[sel].contiguous()
    fold = torch.from_numpy(mm.q32_mul_consts([qs[r] for r in rows]).astype(np.int64)
                            .reshape(5, L, 1)).to(dev)
    evk = residues(kq, 2, 2, n=n)
    t = residues(q, *((batch,) if batch > 1 else ()), 2, n=n)
    shape = f"K9 t ({f'{batch}, ' if batch > 1 else ''}2, {L}, 2^{log_n})"
    out[shape] = timed(lambda: ks.key_inner_prod32(t, evk, sel, q, fold),
                       lambda: ks.key_inner_prod32_plain(t, evk, sel, q, fold))
    del evk, t
    torch.cuda.empty_cache()


def u64_col(mods, f):
    return mm.u64_tensor(np.array([[f(m)] for m in mods], dtype=np.uint64), dev)


# K11 on 60-bit output primes and 59-bit input primes
for lead, k, m, log_n, direct in (((), 64, 30, 15, False), ((), 15, 30, 15, True),
                                  ((2,), 127, 32, 16, False), ((), 190, 63, 16, False)):
    n = 1 << log_n
    q_out = CoeffModulus.create(n, [60] * m)
    p, rlo, rhi = (u64_col(q_out, f) for f in (lambda x: x.value, lambda x: x.const_ratio[0],
                                               lambda x: x.const_ratio[1]))
    # the input base repeats 32 primes (at most 64 primes of > 30 bits a chain)
    q_in = u64_col(CoeffModulus.create(n, [59] * 32), lambda x: x.value).repeat(6, 1)[:k]
    table = torch.randint(0, 1 << 62, (m, k), generator=gen, dtype=torch.int64,
                          device=dev) % p
    diag = bconv.digit_matrix(table)
    s = residues(q_in, *lead, n=n)
    tab = (table, p, rlo, rhi)
    if direct:
        # the kernel's entry point at k < 64, which the wrapper sends to K12;
        # before the redesign it took no digit matrix and no input range
        def fn():
            o = torch.empty((m, n), dtype=torch.int64, device=dev)
            if len(bconv.BCONV.argtypes) == 10:
                bconv.BCONV(ptr(s), ptr(o), *(ptr(c) for c in tab), 1, k, m, n)
            else:
                bconv.BCONV(ptr(s), ptr(o), ptr(diag), *(ptr(c) for c in tab[1:]), 1, k, m,
                            n, 0, k, 0)
            return o
    else:
        def fn():
            return bconv.bconv_matmul(s, *tab, diag)
    shape = f"K11 {f'{lead[0]} x ' if lead else ''}{k} -> {m} 2^{log_n}{' direct' if direct else ''}"
    out[shape] = timed(fn, lambda: bconv.bconv_matmul_plain(s, *tab))
print(json.dumps(out))
'''


def main() -> int:
    args = sys.argv[1:]
    kernels = args[:1] == ["--kernels"]
    args = args[1:] if kernels else args
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = [str(Path(t).resolve()) for t in args]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        print(f"nvidia-smi failed: {smi.stderr.strip()}", file=sys.stderr)
        return 1
    print(smi.stdout.strip().splitlines()[0], flush=True)
    turns = []
    for tree in (trees[0], trees[1], trees[1], trees[0]):
        proc = subprocess.run([sys.executable, "-c", KERNEL_CHILD if kernels else OPS_CHILD,
                               tree], capture_output=True, text=True, cwd=tree, timeout=600)
        if proc.returncode != 0:
            print(f"{tree}: failed\n{proc.stderr[-2000:]}", file=sys.stderr)
            return 1
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        turns.append(result)
        print(f"[ab] {tree}: {json.dumps(result)}", flush=True)
    if kernels:
        a, b = (turns[0], turns[3]), (turns[1], turns[2])
        for shape in turns[0]:
            ta, tb = [r[shape] for r in a], [r[shape] for r in b]
            ma, mb = sum(ta) / 2, sum(tb) / 2
            spread = max(abs(ta[0] - ta[1]), abs(tb[0] - tb[1])) / min(ma, mb)
            print(f"[ab] {shape}: A {ta[0]:.4f} {ta[1]:.4f} (mean {ma:.4f})  B {tb[0]:.4f} "
                  f"{tb[1]:.4f} (mean {mb:.4f}) ms  spread {spread:.3%}  A/B {ma / mb:.3f}",
                  flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
