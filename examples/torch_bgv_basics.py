"""BGV basics on the PyTorch/CUDA port: exact encrypted integer arithmetic
through the port's public API.

The port's counterpart of examples/bgv_basics.py: context, batch encoder,
encryption (symmetric and public-key), add with correction-factor
balancing, NTT-domain multiply and relinearize, t-preserving modulus
switching and rotations, checking exact equality at each step.  It runs
on the CUDA card unless --cpu is given.

Run:  python examples/torch_bgv_basics.py [--n 4096] [--cpu]
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
    from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
    from tpu_fhe_torch.eval import bgv_eval as bg
    from tpu_fhe_torch.scheme.batch_encoder import BatchEncoder
    from tpu_fhe_torch.scheme.bgv import BgvTools
    from tpu_fhe_torch.scheme.context import FheContext
    from tpu_fhe_torch.scheme.keys import SecretKey

    n = args.n
    t0 = time.time()
    bits = [60, 60, 60, 60] if n >= 4096 else [50, 50, 50, 60]
    ctx = FheContext(EncryptionParameters(
        SchemeType.bgv, n, tuple(CoeffModulus.create(n, bits)), special_modulus_size=1,
        plain_modulus=PlainModulus.batching(n, args.t_bits), allow_insecure=True),
        device="cpu" if args.cpu else None)
    enc = BatchEncoder(ctx)
    sk = SecretKey(ctx, seed=2)
    pk = sk.public_key()
    rlk = sk.relin_key()
    gk = sk.galois_key([1], include_conj=True)
    tools = BgvTools(ctx)
    t = tools.t.value
    print(f"setup: n={n} t={t} on {ctx.device} ({time.time() - t0:.1f}s)")

    rng = np.random.default_rng(9)
    a = rng.integers(0, t, size=n, dtype=np.uint64)
    b = rng.integers(0, t, size=n, dtype=np.uint64)

    def check(name, ct, expected):
        got = enc.decode(tools.decrypt(sk, ct))
        ok = np.array_equal(got, np.asarray(expected, dtype=np.uint64))
        print(f"  {name:30s} exact={ok} cf={ct.correction_factor != 1}")
        if not ok:
            raise SystemExit(f"FAILED: {name}")

    ca = tools.encrypt_symmetric(sk, enc.encode(a))
    cb = tools.encrypt_asymmetric(pk, enc.encode(b),
                                  torch.Generator(device=ctx.device).manual_seed(3))
    check("encrypt sym", ca, a)
    check("encrypt asym", cb, b)
    check("add", bg.add(tools, ca, cb), (a + b) % t)

    expected = (a.astype(object) * b.astype(object)) % t
    lin = bg.relinearize(ctx, bg.multiply(tools, ca, cb), rlk)
    check("multiply+relin", lin, expected)

    ms = bg.mod_switch_to_next(tools, lin)
    check("mod switch (t-preserving)", ms, expected)
    # a balanced add across different correction factors
    ca_ms = bg.mod_switch_to_next(tools, ca)
    lin_b = bg.relinearize(ctx, bg.multiply(tools, ca_ms, ca_ms), rlk)
    if lin_b.correction_factor == ms.correction_factor:
        raise SystemExit("FAILED: the balanced add's operands share a correction factor")
    check("balanced add", bg.add(tools, ms, lin_b), (expected + (a.astype(object) ** 2)) % t)

    half = n // 2
    rows = a.reshape(2, half)
    check("rotate +1", bg.rotate(ctx, ca, 1, gk), np.roll(rows, -1, axis=1).ravel())
    check("conjugate", bg.conjugate(ctx, ca, gk), rows[::-1].ravel())

    sq2 = bg.relinearize(ctx, bg.multiply(tools, ms, ms), rlk)
    check("depth-2 square", sq2, (expected * expected) % t)

    print(f"OK ({time.time() - t0:.1f}s)")


if __name__ == "__main__":
    main()
