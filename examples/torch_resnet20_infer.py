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
Per-stage record:      ... --record PATH

Channels run in chunks of the DNN's channel batch (its memory rule by
default; --channel-batch 1 runs them one at a time).  With --ckpt the
tensor is saved after every stage and a rerun resumes after the last saved
stage; --budget checkpoints and exits with code 3 once the inference has
taken that many seconds (run again to continue).

--record appends one JSON line per stage to PATH and prints it: the
stage's seconds (synchronized host clock), the timer buckets' seconds and
sections within it, the chunk, the channel bootstraps, the kernel launches,
the peak device memory within the stage, the output's chain index and
limbs, and max_err, the largest |decrypted output - the float64
sign-composite shadow's output of the same stage| (the pool's: the logits,
beside the exact-ReLU shadow's, and the three argmaxes); then a closing
line with the totals and the setup's seconds.

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
import json
import subprocess
import sys
import time

import numpy as np


def card_name(device) -> str:
    """`nvidia-smi`'s name and power limit of the card (the device's name
    alone where nvidia-smi does not answer), or "cpu"."""
    import torch

    if device.type != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", str(device.index or 0)],
                             capture_output=True, text=True, timeout=60)
        if smi.returncode == 0 and smi.stdout.strip():
            return smi.stdout.strip().splitlines()[0]
    except OSError:
        pass
    return f"{torch.cuda.get_device_name(device)}, power limit not read"


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
    ap.add_argument("--record", type=str, default="",
                    help="append one JSON line per stage and a closing line to this file")
    args = ap.parse_args()
    if args.budget and not args.ckpt:
        ap.error("--budget requires --ckpt (otherwise completed work would be lost at the "
                 "budget exit)")

    import torch

    from tpu_fhe_torch.boot.bootstrap import CkksBootstrapper, gen_sine_coefficients
    from tpu_fhe_torch.core.modulus import CoeffModulus
    from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
    from tpu_fhe_torch.eval import auto, chebyshev as cheb
    from tpu_fhe_torch.models import resnet20 as rn
    from tpu_fhe_torch.models.dnn import DNN, relu_composite_clear
    from tpu_fhe_torch.ops import bconv, ks, ntt
    from tpu_fhe_torch.ops._build import CudaKernel
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
    names = rn.stage_names(blocks, args.layers)

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
    dev = ctx.device
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def peak_gib():
        return torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None

    enc = CkksEncoder(ctx)
    sk = SecretKey(ctx, seed=1)
    sync()
    setup = {"context": time.time() - t0}
    print(f"[context] logQP={sum(m.bit_count for m in params.coeff_modulus)} on {dev} "
          f"({setup['context']:.1f}s)")

    sf, _ = auto.scaling_factors(ctx)
    model = DNN(ctx, enc, scale=sf[0], channel_batch=args.channel_batch or None)
    ts = time.time()
    rn.prepare_resnet20(model, sk, width=width, layers=args.layers)
    sync()
    setup["dnn_keys"] = time.time() - ts

    slots = width * width
    ts = time.time()
    boot = CkksBootstrapper(ctx, enc)
    boot.set_sine_params(*sine)
    boot.setup(level_budget=level_budget, slots=slots,
               dim1=(8, 8) if (not args.demo and level_budget[0] >= 4) else (0, 0))
    sync()
    setup["bootstrap_setup"] = time.time() - ts
    ts = time.time()
    boot.keygen(sk, slots=slots)
    model.mul_key = boot.mul_key
    sync()
    setup["bootstrap_keygen"] = time.time() - ts
    setup["peak_gib"] = peak_gib()
    print(f"[keys+bootstrap setup] ({time.time() - t0:.1f}s)")

    rng = np.random.default_rng(17)
    weights = rn.load_weights(args.weights) if args.weights else \
        rn.random_weights(rng, planes=planes)
    image = rn.load_cifar_image(args.image, args.image_index) if args.image else \
        rng.uniform(-0.5, 0.5, (width, width, 3))
    # the float64 shadows, each stage's output kept
    shadow, exact = {}, {}
    rn.resnet20_infer_clear(image, weights, relu=relu_composite_clear, blocks=blocks,
                            layers=args.layers, on_stage_done=shadow.__setitem__)
    rn.resnet20_infer_clear(image, weights, blocks=blocks, layers=args.layers,
                            on_stage_done=exact.__setitem__)

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

    card = card_name(dev)
    kernels = list({k.name: k for mod in (ntt, bconv, ks) for k in vars(mod).values()
                    if isinstance(k, CudaKernel)}.values())
    record = open(args.record, "a") if args.record else None
    launches = dict.fromkeys((k.name for k in kernels), 0)
    lines = []

    def emit(line: dict):
        text = json.dumps(line)
        print(text, flush=True)
        if record is not None:
            record.write(text + "\n")
            record.flush()

    state: dict = {}

    def stage_start():
        sync()
        for k in kernels:
            k.launches = 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        state.update(t=time.time(), acc=timer.accumulated(), counts=timer.counts())

    class _Budget(Exception):
        pass

    def stage_done(name, t):
        sync()
        secs = time.time() - state["t"]
        counts = timer.counts()
        buckets = {k: [v - state["acc"].get(k, 0.0), counts[k] - state["counts"].get(k, 0)]
                   for k, v in timer.accumulated().items()
                   if counts[k] != state["counts"].get(k, 0)}
        stage_launches = {k.name: k.launches for k in kernels}
        if args.record:
            chunk = model.channel_batch(shadow[name].shape[-1] if name != "pool"
                                        else planes[2])
            acts = model.dec_tensor(t, sk)
            line = dict(stage=name, seconds=secs, timers=buckets, chunk=chunk,
                        channel_bootstraps=buckets.get("Bootstrap", [0, 0])[1] * chunk,
                        launches=stage_launches, peak_gib=peak_gib(), card=card,
                        chain_index=t.cts[0].chain_index,
                        limbs=ctx.level(t.cts[0].chain_index).size,
                        channels=t.num_ch, width=t.width, slotstr=t.slotstr)
            if name == "pool":
                logits = acts[0, 0, :]
                line.update(max_err=float(np.max(np.abs(logits - shadow[name]))),
                            max_err_exact=float(np.max(np.abs(logits - exact[name]))),
                            logits=logits.tolist(), shadow_logits=shadow[name].tolist(),
                            exact_logits=exact[name].tolist(),
                            argmax=int(np.argmax(logits)),
                            argmax_shadow=int(np.argmax(shadow[name])),
                            argmax_exact=int(np.argmax(exact[name])))
            else:
                line.update(max_err=float(np.max(np.abs(acts - shadow[name]))),
                            finite=bool(np.all(np.isfinite(acts))))
            lines.append(line)
            emit(line)
        for k, v in stage_launches.items():
            launches[k] += v
        if args.ckpt:
            ts = time.time()
            rn.save_tensor_ct(t, args.ckpt, stage=name)
            print(f"  [ckpt] saved after {name} ({time.time() - ts:.1f}s)")
        if args.budget and time.time() - t1 > args.budget and name != "pool":
            # pool is the last stage: let the logits print
            raise _Budget(name)
        stage_start()

    def closing(last: str):
        if not lines:
            return
        emit(dict(stage="total", stages=[ln["stage"] for ln in lines], last=last,
                  seconds=sum(ln["seconds"] for ln in lines),
                  wall_seconds=time.time() - t1,
                  channel_bootstraps=sum(ln["channel_bootstraps"] for ln in lines),
                  bootstrap_sections=sum(ln["timers"].get("Bootstrap", [0, 0])[1]
                                         for ln in lines),
                  launches=launches,
                  peak_gib=max(ln["peak_gib"] for ln in lines) if cuda else None,
                  max_err=max(ln["max_err"] for ln in lines), card=card,
                  setup_seconds=setup, n=n, width=width, planes=list(planes), blocks=blocks,
                  layers=args.layers, q32=args.q32, start_after=start_after or None))

    stage_start()
    try:
        out = rn.resnet20_infer(x, model, boot, weights, blocks=blocks, layers=args.layers,
                                log=lambda m: print(f"  {m} ({time.time() - t1:.0f}s)"),
                                start_after=start_after, on_stage_done=stage_done)
    except _Budget as e:
        closing(str(e))
        print(f"[budget] exceeded after stage {e} ({time.time() - t1:.0f}s); checkpointed, "
              "run again to continue")
        timer.print_accumulated()
        sys.exit(3)
    closing(names[-1])
    wall = time.time() - t1
    if args.layers < 3:
        acts = model.dec_tensor(out, sk)
        print(f"[inference] truncated ({args.layers} layers) done in {wall:.1f}s; "
              f"activation sample {np.round(acts[0, 0, :4], 4)}")
        timer.print_accumulated()
        print(f"max |encrypted - shadow| {float(np.max(np.abs(acts - shadow[names[-1]]))):.3e} "
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
        print(f"cleartext logits: {np.round(exact['pool'], 4)}")
        print(f"clear class:      {int(np.argmax(exact['pool']))}")
        print(f"max |encrypted - composite shadow| "
              f"{float(np.max(np.abs(logits - shadow['pool']))):.3e}")


if __name__ == "__main__":
    main()
