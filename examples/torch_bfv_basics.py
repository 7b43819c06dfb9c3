"""BFV basics on the PyTorch/CUDA port: exact encrypted integer arithmetic
through the port's public API.

The port's counterpart of examples/bfv_basics.py: context, batch encoder,
encryption (symmetric and public-key), add, BEHZ multiply and relinearize,
rotations, modulus switching and noise budgets, then a multiply on each
HPS form, checking exact equality at each step.  It runs on the CUDA card
unless --cpu is given.

Run:  python examples/torch_bfv_basics.py [--n 4096] [--cpu]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import time

import numpy as np
import torch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096, help="ring degree")
    ap.add_argument("--t-bits", type=int, default=20, help="plain modulus bits")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args()

    from tpu_fhe_torch.core.modulus import CoeffModulus, PlainModulus
    from tpu_fhe_torch.core.params import EncryptionParameters, MulTech, SchemeType
    from tpu_fhe_torch.eval import bfv_eval as bv
    from tpu_fhe_torch.scheme.batch_encoder import BatchEncoder
    from tpu_fhe_torch.scheme.bfv import BfvTools
    from tpu_fhe_torch.scheme.context import FheContext
    from tpu_fhe_torch.scheme.keys import SecretKey

    device = "cpu" if args.cpu else None
    n = args.n
    t0 = time.time()
    # the reference example's recipe: 60-bit data primes and one 60-bit
    # special prime
    bits = [60, 60, 60] if n >= 4096 else [50, 50, 60]
    params = EncryptionParameters(
        SchemeType.bfv, n, tuple(CoeffModulus.create(n, bits)), special_modulus_size=1,
        plain_modulus=PlainModulus.batching(n, args.t_bits), allow_insecure=True)
    ctx = FheContext(params, device=device)
    enc = BatchEncoder(ctx)
    sk = SecretKey(ctx, seed=1)
    pk = sk.public_key()
    rlk = sk.relin_key()
    gk = sk.galois_key([1, -3], include_conj=True)
    tools = BfvTools(ctx)
    t = tools.t.value
    print(f"setup: n={n} t={t} on {ctx.device} ({time.time() - t0:.1f}s)")

    rng = np.random.default_rng(7)
    a = rng.integers(0, t, size=n, dtype=np.uint64)
    b = rng.integers(0, t, size=n, dtype=np.uint64)

    def check(name, ct, expected):
        got = enc.decode(tools.decrypt(sk, ct))
        ok = np.array_equal(got, np.asarray(expected, dtype=np.uint64))
        print(f"  {name:28s} exact={ok} budget={tools.invariant_noise_budget(sk, ct)}")
        if not ok:
            raise SystemExit(f"FAILED: {name}")

    ca = tools.encrypt_symmetric(sk, enc.encode(a))
    cb = tools.encrypt_asymmetric(pk, enc.encode(b),
                                  torch.Generator(device=ctx.device).manual_seed(3))
    check("encrypt sym", ca, a)
    check("encrypt asym", cb, b)
    check("add", bv.add(ctx, ca, cb), (a + b) % t)

    prod = bv.multiply(tools, ca, cb)
    expected = (a.astype(object) * b.astype(object)) % t
    check("multiply (BEHZ)", prod, expected)
    lin = bv.relinearize(tools, prod, rlk)
    check("relinearize", lin, expected)

    half = n // 2
    rows = a.reshape(2, half)
    check("rotate rows +1", bv.rotate_rows(tools, ca, 1, gk), np.roll(rows, -1, axis=1).ravel())
    check("rotate rows -3", bv.rotate_rows(tools, ca, -3, gk), np.roll(rows, 3, axis=1).ravel())
    check("rotate columns", bv.rotate_columns(tools, ca, gk), rows[::-1].ravel())

    ms = bv.mod_switch_to_next(tools, lin)
    check("mod switch", ms, expected)

    sq = bv.relinearize(tools, bv.multiply(tools, lin, lin), rlk)
    check("depth-2 square", sq, (expected * expected) % t)

    # the HPS multiplication forms, chosen when the context is built
    for tech in (MulTech.hps, MulTech.hps_overq, MulTech.hps_overq_leveled):
        hps_ctx = FheContext(EncryptionParameters(
            SchemeType.bfv, n, params.coeff_modulus, special_modulus_size=1,
            plain_modulus=params.plain_modulus, mul_tech=tech, allow_insecure=True),
            device=device)
        hps_enc, hps_sk, hps_tools = BatchEncoder(hps_ctx), SecretKey(hps_ctx, seed=1), \
            BfvTools(hps_ctx)
        hca = hps_tools.encrypt_symmetric(hps_sk, hps_enc.encode(a))
        hcb = hps_tools.encrypt_symmetric(hps_sk, hps_enc.encode(b))
        got = hps_enc.decode(hps_tools.decrypt(hps_sk, bv.multiply(hps_tools, hca, hcb)))
        ok = np.array_equal(got, np.asarray(expected, dtype=np.uint64))
        print(f"  multiply ({tech.name:18s}) exact={ok}")
        if not ok:
            raise SystemExit(f"FAILED: multiply {tech.name}")

    print(f"OK ({time.time() - t0:.1f}s)")


if __name__ == "__main__":
    main()
