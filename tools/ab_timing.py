#!/usr/bin/env python3
"""Compare the port's keyswitch and rotate across source trees, on one GPU.

    python3 tools/ab_timing.py TREE_A TREE_B

Each TREE is the root of a checkout of this repository (for example the
parent commit unpacked with ``git archive`` into a git-ignored directory,
and ``.``).  The trees run in turns A, B, B, A, each in a process of its
own that builds that tree's kernels and imports that tree's
``tpu_fhe_torch`` and ``chip_smoke`` helpers.  Per tree and turn it prints
one line: relinearize (a size-3 ciphertext) and rotate by one slot at chain
index 1 of both plans -- the u64 plan (bench.py's primary configuration:
N = 2^15, 30 + 15 primes of 50/60 bits, ``chip_smoke.BITS``/``SPECIAL``)
and the q32 plan (N = 2^15, 60 + 30 primes of 29-30 bits,
``chip_smoke.COMPOSITE``) -- each as ms/op (chip_smoke's median-of-pairs
marginal), its spread, device busy ms per op (torch.profiler over 10
calls) and whether the profiler lost events (a kernel count that is not a
multiple of 10).  The card's name and power limit come first.  Needs a CUDA device;
fails without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CHILD = r'''
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


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    trees = [str(Path(t).resolve()) for t in sys.argv[1:]]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        print(f"nvidia-smi failed: {smi.stderr.strip()}", file=sys.stderr)
        return 1
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for tree in (trees[0], trees[1], trees[1], trees[0]):
        proc = subprocess.run([sys.executable, "-c", CHILD, tree], capture_output=True,
                              text=True, cwd=tree, timeout=600)
        if proc.returncode != 0:
            print(f"{tree}: failed\n{proc.stderr[-2000:]}", file=sys.stderr)
            return 1
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"[ab] {tree}: {json.dumps(result)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
