"""Serialization through the PyTorch/CUDA port: save and load a ciphertext
(also in the seed-compressed symmetric form) and every key type, then keep
computing with the loaded objects.

The port's counterpart of examples/serialization.py, in the same file
format (tpu_fhe_torch/utils/serialize.py), so either package reads the
other's files (but for the seeded form, whose `a` each package draws from
its own generator).  It runs on the CUDA device unless --cpu is given.

Run:  python examples/torch_serialization.py [--cpu] [--n 2048]
"""

import os as _os
import sys as _sys

# make the repo importable when run as `python examples/<name>.py`
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import io
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: CUDA)")
    args = ap.parse_args()

    from tpu_fhe_torch.core.modulus import CoeffModulus
    from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
    from tpu_fhe_torch.eval import evaluator as ev
    from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder
    from tpu_fhe_torch.scheme.context import FheContext
    from tpu_fhe_torch.scheme.keys import SecretKey
    from tpu_fhe_torch.utils import serialize as ser

    t0 = time.time()
    n = args.n
    params = EncryptionParameters(scheme=SchemeType.ckks, poly_modulus_degree=n,
                                  allow_insecure=True,
                                  coeff_modulus=tuple(CoeffModulus.create(n, [60, 40, 40, 60])),
                                  special_modulus_size=1)
    ctx = FheContext(params, device="cpu" if args.cpu else None)
    enc = CkksEncoder(ctx)
    sk = SecretKey(ctx, seed=5)
    print(f"setup on {ctx.device} ({time.time() - t0:.1f}s)")

    rng = np.random.default_rng(1)
    x = rng.standard_normal(n // 2)
    scale = 2.0 ** 40
    tol = 1e-6

    def size_of(save, obj):
        buf = io.BytesIO()
        save(obj, buf)
        return buf.tell(), buf

    def check(name, err, limit):
        print(f"{name} err={err:.2e}")
        if not err <= limit:
            raise SystemExit(f"{name}: error {err} above {limit}")

    # full ciphertext round trip
    ct = sk.encrypt_symmetric(enc.encode(x, scale))
    nbytes, buf = size_of(ser.save_ciphertext, ct)
    buf.seek(0)
    ct2 = ser.load_ciphertext(ctx, buf)
    print(f"ciphertext: {nbytes} bytes")
    check("  roundtrip", np.max(np.abs(enc.decode(sk.decrypt(ct2)).real - x)), tol)

    # seed-compressed symmetric form
    ct_seeded, seed = sk.encrypt_symmetric_seeded(enc.encode(x, scale))
    buf2 = io.BytesIO()
    ser.save_ciphertext_symmetric(ct_seeded, seed, buf2)
    print(f"seed-compressed: {buf2.tell()} bytes ({buf2.tell() / nbytes:.2f}x of full)")
    buf2.seek(0)
    ct3 = ser.load_ciphertext_symmetric(ctx, buf2)
    check("  seed-compressed roundtrip", np.max(np.abs(enc.decode(sk.decrypt(ct3)).real - x)),
          tol)

    # keys
    for name, save, load, obj in (
            ("secret key", ser.save_secret_key, lambda b: ser.load_secret_key(ctx, b), sk),
            ("public key", ser.save_public_key, lambda b: ser.load_public_key(ctx, b),
             sk.public_key()),
            ("relin key", ser.save_relin_key, lambda b: ser.load_relin_key(ctx, b),
             sk.relin_key()),
            ("galois key", ser.save_galois_key, lambda b: ser.load_galois_key(ctx, b),
             sk.galois_key([1, -1], include_conj=True))):
        nbytes, buf = size_of(save, obj)
        buf.seek(0)
        loaded = load(buf)
        print(f"{name}: {nbytes} bytes")
        if name == "secret key":
            check("  loaded secret key decrypts",
                  np.max(np.abs(enc.decode(loaded.decrypt(ct)).real - x)), tol)
        if name == "relin key":
            prod = ev.rescale_to_next(ctx, ev.relinearize(ctx, ev.multiply(ctx, ct, ct), loaded))
            check("  loaded relin key works",
                  np.max(np.abs(enc.decode(sk.decrypt(prod)).real - x * x)), 1e-4)
        if name == "galois key":
            rot = ev.rotate(ctx, ct, 1, loaded)
            check("  loaded galois key works",
                  np.max(np.abs(enc.decode(sk.decrypt(rot)).real - np.roll(x, -1))), tol)
    print("OK")


if __name__ == "__main__":
    main()
