"""CKKS basics on the PyTorch/CUDA port: encrypted arithmetic end to end
through the port's public API.

The port's counterpart of examples/ckks_basics.py: context, keys (secret,
public, relinearization, Galois), encode and encrypt (symmetric and
public-key), add, multiply + relinearize + rescale, rotate, conjugate and a
depth-2 chain, decrypt and decode, printing the max error of each step and
failing above 1e-6.  It runs on the CUDA card unless --cpu is given;
--device-embed embeds on the device (CkksEncoder(ctx, device_embed=True)).

Run:  python examples/torch_ckks_basics.py [--n 4096] [--cpu] [--device-embed]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import time

import numpy as np
import torch

TOL = 1e-6


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048, help="ring degree")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    ap.add_argument("--bits", default="60,40,40,40,60",
                    help="comma-separated coeff-modulus bit sizes (last one "
                         "is the special modulus); all <= 30 engages the q32 "
                         "single-word plan")
    ap.add_argument("--device-embed", action="store_true",
                    help="embed on the device instead of the host's FFT")
    args = ap.parse_args()

    from tpu_fhe_torch.core.modulus import CoeffModulus
    from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
    from tpu_fhe_torch.eval import evaluator as ev
    from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder
    from tpu_fhe_torch.scheme.context import FheContext
    from tpu_fhe_torch.scheme.keys import SecretKey, encrypt_asymmetric

    n = args.n
    t0 = time.time()
    bits = [int(b) for b in args.bits.split(",")]
    params = EncryptionParameters(
        scheme=SchemeType.ckks, poly_modulus_degree=n, allow_insecure=True,
        coeff_modulus=tuple(CoeffModulus.create(n, bits)), special_modulus_size=1)
    ctx = FheContext(params, device="cpu" if args.cpu else None)
    print(f"[context] N={n}, logQP={sum(bits)} bits, levels={params.size_Q} on {ctx.device} "
          f"({time.time() - t0:.2f}s)")

    t0 = time.time()
    sk = SecretKey(ctx, seed=2024)
    pk = sk.public_key()
    rlk = sk.relin_key()
    gk = sk.galois_key([1, 2, 4], include_conj=True)
    print(f"[keygen] secret/public/relin/galois ({time.time() - t0:.2f}s)")

    enc = CkksEncoder(ctx, device_embed=args.device_embed)
    slots = n // 2
    rng = np.random.default_rng(0)
    x = rng.standard_normal(slots)
    y = rng.standard_normal(slots)
    scale = 2.0 ** bits[1]  # rescale-friendly: matches the data primes

    ct_x = encrypt_asymmetric(ctx, pk, enc.encode(x, scale),
                              torch.Generator(device=ctx.device).manual_seed(1))
    ct_y = sk.encrypt_symmetric(enc.encode(y, scale))

    def check(name, ct, expect, extra=""):
        got = enc.decode(sk.decrypt(ct))
        err = float(np.max(np.abs(got - expect)))
        print(f"[{name}] err={err:.2e}{extra}")
        if not err <= TOL:
            raise SystemExit(f"FAILED: {name}: max error {err:.3e} > {TOL}")

    check("encrypt asym", ct_x, x)
    check("encrypt sym", ct_y, y)

    t0 = time.time()
    check("add", ev.add(ctx, ct_x, ct_y), x + y, f" ({time.time() - t0:.2f}s)")

    t0 = time.time()
    ct_prod = ev.rescale_to_next(ctx, ev.relinearize(ctx, ev.multiply(ctx, ct_x, ct_y), rlk))
    check("mul+relin+rescale", ct_prod, x * y,
          f" chain_index={ct_prod.chain_index} ({time.time() - t0:.2f}s)")

    t0 = time.time()
    check("rotate 2", ev.rotate(ctx, ct_x, 2, gk), np.roll(x, -2), f" ({time.time() - t0:.2f}s)")

    z = x + 1j * y
    ct_z = sk.encrypt_symmetric(enc.encode(z, scale))
    check("conjugate", ev.conjugate(ctx, ct_z, gk), z.conj())

    # depth-2 chain: ((x*y)*x)
    ct_x_low = ct_x
    while ct_x_low.chain_index < ct_prod.chain_index:
        ct_x_low = ev.mod_drop_to_next(ctx, ct_x_low)
    ct_d2 = ev.rescale_to_next(ctx, ev.relinearize(ctx, ev.multiply(ctx, ct_prod, ct_x_low), rlk))
    check("depth2", ct_d2, x * x * y, f" chain_index={ct_d2.chain_index}")
    print("OK")


if __name__ == "__main__":
    main()
