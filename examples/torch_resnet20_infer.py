"""Encrypted ResNet-20 / CIFAR-10 inference through the PyTorch/CUDA port.

The port's counterpart of examples/resnet20_infer.py, with the same
parameter recipe: N = 2^16, 59-bit data primes, a 60-bit first prime,
15 x 60-bit special primes, level budget (2, 2), 11 levels after the
bootstrap, sparse packing at (w << slotstr)^2 slots, ReluComposite
activations with interleaved bootstraps; --q32 takes the composite-scaling
chain (30-bit prime pairs at working scale 2^58).  It runs on the CUDA
device unless --cpu is given.

Full scale (GPU):      python examples/torch_resnet20_infer.py --q32
Doll-scale demo (CPU): python examples/torch_resnet20_infer.py --cpu --demo
Resumable:             ... --ckpt DIR [--budget SECONDS]

Channels run in chunks of the DNN's channel batch (its memory rule by
default; --channel-batch 1 runs them one at a time).  With --ckpt the
tensor is saved after every stage and a rerun resumes after the last saved
stage; --budget checkpoints and exits with code 3 once the inference has
taken that many seconds (run again to continue).

The demo shrinks ring, width and planes but runs the identical pipeline
(conv, bn, ReluComposite with bootstraps, residual, downsample, pool and
fc) and compares it with the float64 shadow of the same computation.
Without --weights / --image the weights come from random_weights and the
image from np.random.default_rng(17), as in the reference's example.
"""

import os as _os
import sys as _sys

# make the repo importable when run as `python examples/<name>.py`
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: CUDA)")
    ap.add_argument("--demo", action="store_true", help="doll-scale config")
    ap.add_argument("--n", type=int, default=0, help="ring degree override")
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--planes", type=str, default="16,32,64")
    ap.add_argument("--blocks", type=int, default=3, help="blocks per layer")
    ap.add_argument("--layers", type=int, default=3,
                    help="layers to run (< 3 truncates; skips final pool)")
    ap.add_argument("--weights", type=str, default="", help=".npy weight dir")
    ap.add_argument("--image", type=str, default="", help="CIFAR .npy file")
    ap.add_argument("--image-index", type=int, default=0)
    ap.add_argument("--level-budget", type=str, default="",
                    help="C2S,S2C level budget (default 2,2)")
    ap.add_argument("--q32", action="store_true",
                    help="composite-scaling regime (30-bit limb pairs, working scale 2^58)")
    ap.add_argument("--channel-batch", type=int, default=0,
                    help="channels per chunk (default: the DNN's memory rule; 1: one at a time)")
    ap.add_argument("--ckpt", type=str, default="",
                    help="checkpoint dir: save the tensor after every stage and resume from "
                         "the last one on restart")
    ap.add_argument("--budget", type=float, default=0.0,
                    help="wall-clock seconds: checkpoint and exit(3) when exceeded (run again "
                         "to continue)")
    args = ap.parse_args()
    if args.budget and not args.ckpt:
        ap.error("--budget requires --ckpt (otherwise completed work would be lost at the "
                 "budget exit)")

    from tpu_fhe_torch.boot.bootstrap import CkksBootstrapper, gen_sine_coefficients
    from tpu_fhe_torch.core.modulus import CoeffModulus
    from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
    from tpu_fhe_torch.eval import auto, chebyshev as cheb
    from tpu_fhe_torch.models import resnet20 as rn
    from tpu_fhe_torch.models.dnn import DNN, relu_composite_clear
    from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder
    from tpu_fhe_torch.scheme.context import FheContext
    from tpu_fhe_torch.scheme.keys import SecretKey
    from tpu_fhe_torch.utils import timer

    device = "cpu" if args.cpu else None
    t0 = time.time()
    if args.demo:
        n = args.n or 256
        width = min(args.width, 8)
        planes = (2, 2, 2)
        blocks = min(args.blocks, 3)
        sine = (28, 3, 44)          # small-ring secret: sparse sine bound
        levels_after = 10
    else:
        n = args.n or 1 << 16
        width = args.width
        planes = tuple(int(p) for p in args.planes.split(","))
        blocks = args.blocks
        sine = (512, 6, 88)         # the uniform-secret parameters
        levels_after = 11
    level_budget = (tuple(int(v) for v in args.level_budget.split(","))
                    if args.level_budget else (2, 2))
    first_mod, dcrt_bits, aux_mod, size_p = 60, 59, 60, 15 if not args.demo else 3

    approx = cheb.get_mult_depth_by_coeff_vector(gen_sine_coefficients(*sine), normalized=False)
    boot_depth = approx + sine[1] + level_budget[0] + level_budget[1]
    depth = levels_after + boot_depth
    print(f"[params] N={n} levels={depth + 1} boot_depth={boot_depth} "
          f"regime={'q32' if args.q32 else '60-bit'} level_budget={level_budget}")

    if args.q32:
        size_p = depth + 1
        mods = CoeffModulus.create_composite(n, 58, depth, degree=2, anchor_bits=30,
                                             special_bits=30, special_count=size_p)
        params = EncryptionParameters(scheme=SchemeType.ckks, poly_modulus_degree=n,
                                      allow_insecure=True, coeff_modulus=tuple(mods),
                                      special_modulus_size=size_p, composite_degree=2)
    else:
        bits = [first_mod] + [dcrt_bits] * depth + [aux_mod] * size_p
        params = EncryptionParameters(scheme=SchemeType.ckks, poly_modulus_degree=n,
                                      allow_insecure=True,
                                      coeff_modulus=tuple(CoeffModulus.create(n, bits)),
                                      special_modulus_size=size_p)
    ctx = FheContext(params, device=device)
    enc = CkksEncoder(ctx)
    sk = SecretKey(ctx, seed=1)
    print(f"[context] logQP={sum(m.bit_count for m in params.coeff_modulus)} on {ctx.device} "
          f"({time.time() - t0:.1f}s)")

    sf, _ = auto.scaling_factors(ctx)
    model = DNN(ctx, enc, scale=sf[0], channel_batch=args.channel_batch or None)
    rn.prepare_resnet20(model, sk, width=width, layers=args.layers)

    slots = width * width
    boot = CkksBootstrapper(ctx, enc)
    boot.set_sine_params(*sine)
    boot.setup(level_budget=level_budget, slots=slots,
               dim1=(8, 8) if (not args.demo and level_budget[0] >= 4) else (0, 0))
    boot.keygen(sk, slots=slots)
    model.mul_key = boot.mul_key
    print(f"[keys+bootstrap setup] ({time.time() - t0:.1f}s)")

    rng = np.random.default_rng(17)
    weights = rn.load_weights(args.weights) if args.weights else \
        rn.random_weights(rng, planes=planes)
    image = rn.load_cifar_image(args.image, args.image_index) if args.image else \
        rng.uniform(-0.5, 0.5, (width, width, 3))

    print(f"[inference] start, {model.channel_batch(planes[0])} channels per chunk")
    t1 = time.time()
    timer.clear()
    start_after = ""
    if args.ckpt and _os.path.exists(f"{args.ckpt}/meta.json"):
        x, meta = rn.load_tensor_ct(ctx, args.ckpt)
        start_after = meta["stage"]
        print(f"[resume] from the checkpoint after stage {start_after!r}")
    else:
        x = model.enc_tensor(image, sk=sk)

    class _Budget(Exception):
        pass

    def stage_done(name, t):
        if args.ckpt:
            ts = time.time()
            rn.save_tensor_ct(t, args.ckpt, stage=name)
            print(f"  [ckpt] saved after {name} ({time.time() - ts:.1f}s)")
        if args.budget and time.time() - t1 > args.budget and name != "pool":
            # pool is the last stage: let the logits print
            raise _Budget(name)

    try:
        out = rn.resnet20_infer(x, model, boot, weights, blocks=blocks, layers=args.layers,
                                log=lambda m: print(f"  {m} ({time.time() - t1:.0f}s)"),
                                start_after=start_after, on_stage_done=stage_done)
    except _Budget as e:
        print(f"[budget] exceeded after stage {e} ({time.time() - t1:.0f}s); checkpointed, "
              "run again to continue")
        timer.print_accumulated()
        sys.exit(3)
    wall = time.time() - t1
    if args.layers < 3:
        acts = model.dec_tensor(out, sk)
        print(f"[inference] truncated ({args.layers} layers) done in {wall:.1f}s; "
              f"activation sample {np.round(acts[0, 0, :4], 4)}")
        timer.print_accumulated()
        shadow = rn.resnet20_infer_clear(image, weights, relu=relu_composite_clear,
                                         blocks=blocks, layers=args.layers)
        print(f"max |encrypted - shadow| {float(np.max(np.abs(acts - shadow))):.3e} "
              "(the shadow applies the same sign composite)")
        return
    logits = model.dec_tensor(out, sk)[0, 0, :]
    print(f"[inference] done in {wall:.1f}s")
    timer.print_accumulated()
    print(f"encrypted logits: {np.round(logits, 4)}")
    print(f"predicted class:  {int(np.argmax(logits))}")
    if not args.weights or blocks < 3:
        # the exact-ReLU shadow beside the sign-composite one the encrypted
        # pipeline computes
        clear = rn.resnet20_infer_clear(image, weights, blocks=blocks)
        shadow = rn.resnet20_infer_clear(image, weights, relu=relu_composite_clear,
                                         blocks=blocks)
        print(f"cleartext logits: {np.round(clear, 4)}")
        print(f"clear class:      {int(np.argmax(clear))}")
        print(f"max |encrypted - composite shadow| {float(np.max(np.abs(logits - shadow))):.3e}")


if __name__ == "__main__":
    main()
