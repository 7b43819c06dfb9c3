"""CKKS bootstrapping end to end on the PyTorch/CUDA port (dense packing by
default).

The port's counterpart of examples/bootstrap_ckks.py: encrypt, exhaust the
levels, bootstrap, then print the ms of each call, the mean bits of
precision (failing at 10 or fewer) and the levels recovered.  It takes the
reference example's flags and chain recipe (u64: [60] + [59] * depth +
[60] * P; --q32: create_composite(n, 58, depth, degree=2, ...)), but the
default sine set (K = 512, r = 6, degree 88) at every logN: the reference
takes the sparse-secret set (K = 28, r = 3, degree 44) up to logN 13, where
a uniform ternary secret's output does not decode.  --sparse-sine takes
that set.  It runs on the CUDA card unless --cpu is given; --device-embed
embeds on the device (CkksEncoder(ctx, device_embed=True)), in the setup's
plaintexts, the input's encode and the output's decode.

Run:  python examples/torch_bootstrap_ckks.py --cpu --logn 6     # quick
      python examples/torch_bootstrap_ckks.py --logn 16 [--q32]  # on the card
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import time

import numpy as np
import torch

MIN_BITS = 10


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    ap.add_argument("--logn", type=int, default=6)
    ap.add_argument("--levels-after", type=int, default=1)
    ap.add_argument("--slots", type=int, default=0,
                    help="slot count (default N/2 = fully packed; smaller = sparse packing)")
    ap.add_argument("--sparse-sine", action="store_true",
                    help="use the sparse-secret sine set K=28, r=3, degree 44 (the "
                         "default set K=512, r=6, degree 88 serves any secret)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="time this many bootstrap calls (the first one warms up)")
    ap.add_argument("--iterations", default="1",
                    help="comma list of Meta-BTS iteration counts to measure, e.g. '1,2'")
    ap.add_argument("--precision", type=int, default=0,
                    help="Meta-BTS precision parameter (bits of the single-pass "
                         "result; default = the measured one)")
    ap.add_argument("--level-budget", default="",
                    help="C2S,S2C level budget, e.g. '3,3' (default: 2,2 small rings; "
                         "4,4 at logn >= 15)")
    ap.add_argument("--dim1", default="", help="baby-step override g for C2S,S2C, e.g. '8,8'")
    ap.add_argument("--size-p", type=int, default=0, help="special-modulus limb count override")
    ap.add_argument("--q32-scale-bits", type=int, default=58,
                    help="composite working-scale bits (pair product)")
    ap.add_argument("--q32", action="store_true",
                    help="composite-scaling q32 plan: one logical level = a pair of "
                         "~29-bit primes, every kernel single-word")
    ap.add_argument("--eager", action="store_true",
                    help="call eval_bootstrap instead of eval_bootstrap_jit (the same "
                         "single-iteration bootstrap in the port)")
    ap.add_argument("--device-embed", action="store_true",
                    help="embed on the device instead of the host's FFT")
    args = ap.parse_args()

    from tpu_fhe_torch.boot.bootstrap import (CkksBootstrapper, gen_sine_coefficients,
                                              precision_bits)
    from tpu_fhe_torch.core.modulus import CoeffModulus
    from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
    from tpu_fhe_torch.eval import auto, chebyshev as cheb, evaluator as ev
    from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder
    from tpu_fhe_torch.scheme.context import FheContext
    from tpu_fhe_torch.scheme.keys import SecretKey

    n = 1 << args.logn
    device = "cpu" if args.cpu else None
    t0 = time.time()
    if args.level_budget:
        level_budget = tuple(int(v) for v in args.level_budget.split(","))
    else:
        level_budget = (4, 4) if args.logn >= 15 else (2, 2)
    sine = (28, 3, 44) if args.sparse_sine else (512, 6, 88)
    approx_depth = cheb.get_mult_depth_by_coeff_vector(
        gen_sine_coefficients(*sine), normalized=False) + sine[1]
    depth = args.levels_after + approx_depth + sum(level_budget) + 2
    if args.q32:
        size_p = args.size_p or (depth + 1)
        mods = CoeffModulus.create_composite(n, args.q32_scale_bits, depth, degree=2,
                                             anchor_bits=30, special_bits=30,
                                             special_count=size_p)
        params = EncryptionParameters(
            scheme=SchemeType.ckks, poly_modulus_degree=n, allow_insecure=True,
            coeff_modulus=tuple(mods), special_modulus_size=size_p, composite_degree=2)
    else:
        size_p = args.size_p or max(2, -(-(depth + 1) // 2))
        bits = [60] + [59] * depth + [60] * size_p
        params = EncryptionParameters(
            scheme=SchemeType.ckks, poly_modulus_degree=n, allow_insecure=True,
            coeff_modulus=tuple(CoeffModulus.create(n, bits)), special_modulus_size=size_p)
    ctx = FheContext(params, device=device)
    nlimbs = len(params.coeff_modulus)
    enc = CkksEncoder(ctx, device_embed=args.device_embed)
    print(f"[context] N={n}, {nlimbs} limbs (Q={nlimbs - size_p}, P={size_p}), sine {sine}, "
          f"budget {level_budget}, device embedding {enc.device_embed}, on {ctx.device} "
          f"({time.time() - t0:.1f}s)")

    def sync():
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)

    t0 = time.time()
    sk = SecretKey(ctx, seed=2024)
    boot = CkksBootstrapper(ctx, enc)
    boot.set_sine_params(*sine)
    slots = args.slots or n // 2
    if args.dim1:
        dim1 = tuple(int(v) for v in args.dim1.split(","))
    else:
        dim1 = (8, 8) if args.logn >= 15 and level_budget[0] >= 4 else (0, 0)
    boot.setup(level_budget=level_budget, slots=slots, dim1=dim1)
    boot.keygen(sk, slots)
    sync()
    print(f"[setup+keygen] ({time.time() - t0:.1f}s)")

    sf, _ = auto.scaling_factors(ctx)
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.8, 0.8, slots)
    ct = sk.encrypt_symmetric(enc.encode(x, sf[0], slots=slots))
    cd = ctx.params.composite_degree
    while ctx.level(ct.chain_index).size > 2 * cd:
        ct = ev.mod_drop_to_next(ctx, ct)
    print(f"[input] levels before bootstrap: {(len(ctx.chain) - 1 - ct.chain_index) // cd}")

    prec = 0.0
    for iters in [int(v) for v in args.iterations.split(",")]:
        meta_prec = args.precision or max(8, int(prec))
        for rep in range(args.repeat):
            sync()
            t0 = time.time()
            if iters == 1:
                out = (boot.eval_bootstrap(ct, slots) if args.eager
                       else boot.eval_bootstrap_jit(ct, slots))
            else:
                out = boot.eval_bootstrap(ct, slots, iters, meta_prec)
            sync()
            ms = (time.time() - t0) * 1e3
            if args.repeat > 1:
                print(f"[bootstrap iters={iters}] call {rep}: {ms:.1f} ms")
        got = enc.decode(sk.decrypt(out), slots=slots).real
        prec = precision_bits(got, x)
        levels_after = (len(ctx.chain) - 1 - out.chain_index) // cd
        print(f"[bootstrap iters={iters}] {ms:.1f} ms (host clock, last call), "
              f"precision={prec:.3f} bits, levels after={levels_after}")
        if not prec > MIN_BITS:
            raise SystemExit(f"FAILED: bootstrap precision {prec:.3f} bits <= {MIN_BITS}")
    print("OK")


if __name__ == "__main__":
    main()
