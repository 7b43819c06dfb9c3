"""Encrypted function evaluation by Chebyshev series (FLEXIBLEAUTO) on the
PyTorch/CUDA port.

The port's counterpart of examples/ckks_chebyshev.py: exp(x) by a degree-4
series and sin(pi x) by a degree-27 Paterson-Stockmeyer series on N/2
encrypted values uniform in [-1, 1], each within 5e-2 of numpy.  It runs on
the CUDA card unless --cpu is given; --device-embed embeds on the device
(CkksEncoder(ctx, device_embed=True)).

Run:  python examples/torch_ckks_chebyshev.py [--cpu] [--n 1024] [--device-embed]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import math
import time

import numpy as np

TOL = 5e-2


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    ap.add_argument("--n", type=int, default=1024,
                    help="ring degree (the reference's default is 512; the card's NTT "
                         "kernels take N >= 1024)")
    ap.add_argument("--device-embed", action="store_true",
                    help="embed on the device instead of the host's FFT")
    args = ap.parse_args()

    from tpu_fhe_torch.core.modulus import CoeffModulus
    from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
    from tpu_fhe_torch.eval import auto, chebyshev as cheb
    from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder
    from tpu_fhe_torch.scheme.context import FheContext
    from tpu_fhe_torch.scheme.keys import SecretKey

    n = args.n
    bits = [45] + [40] * 10 + [50]
    params = EncryptionParameters(
        scheme=SchemeType.ckks, poly_modulus_degree=n, allow_insecure=True,
        coeff_modulus=tuple(CoeffModulus.create(n, bits)), special_modulus_size=1)
    ctx = FheContext(params, device="cpu" if args.cpu else None)
    enc = CkksEncoder(ctx, device_embed=args.device_embed)
    sk = SecretKey(ctx, seed=42)
    rlk = sk.relin_key()
    sf, _ = auto.scaling_factors(ctx)

    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, n // 2)
    ct = sk.encrypt_symmetric(enc.encode(x, sf[0]))

    def run(name, f, degree, expect):
        t0 = time.time()
        coeffs = cheb.eval_chebyshev_coefficients(f, -1.0, 1.0, degree)
        out = cheb.eval_chebyshev_series(ctx, ct, rlk, coeffs, -1.0, 1.0)
        got = enc.decode(sk.decrypt(out)).real
        err = float(np.max(np.abs(got - expect)))
        print(f"[chebyshev {name}] err={err:.2e} levels used={out.chain_index - 1} "
              f"({time.time() - t0:.1f}s) on {ctx.device}")
        if not err <= TOL:
            raise SystemExit(f"FAILED: chebyshev {name}: max error {err:.3e} > {TOL}")

    run("deg-4 exp", math.exp, 4, np.exp(x))
    run("deg-27 PS sin", lambda t: math.sin(math.pi * t), 27, np.sin(np.pi * x))
    print("OK")


if __name__ == "__main__":
    main()
