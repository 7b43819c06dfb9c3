#!/usr/bin/env python3
"""Remake the golden files of tests/test_torch_dnn.py and
tests/test_torch_resnet20.py.

    python3 tools/dnn_golden.py [--plan u64|q32|all] [--out DIR]

runs tpu_fhe's DNN layers and ResNet-20 (the JAX reference, eagerly on the
CPU) at N = 64, width 4, with the sparse sine set K = 28, r = 3, degree 44,
level budget (2, 2) and LEVELS_AFTER levels after the bootstrap (the least
ResNet-20 needs), on both plans: the u64 plan of examples/resnet20_infer.py
--demo ([60] + [59] * depth + [60] * 3) and its --q32 plan
(create_composite(64, 58, depth, degree=2, anchor_bits=30, special_bits=30,
special_count=depth + 1)).  It writes tests/data/torch_dnn_golden_<plan>.npz
with the reference's secret key (NTT form, the key level) and:

  * every case of LAYER_CASES, on both plans: its input tensors (per-channel
    ciphertext arrays with their metadata), and its output as a 64-bit
    BLAKE2b digest per (component, limb) of each channel, its metadata and
    its decoded values.  A case's input may be an earlier case's output
    (the reference's own, stored in full);
  * on the u64 plan, each stage of resnet20_infer(layers=3, blocks=1) on
    planes (1, 1, 1) -- stem, l1b0, l2b0, l3b0, pool -- with the same
    record, and the decoded logits.  Each stage's stored input is the
    reference's output of the stage before it (the stem's, the encrypted
    image).  The stages run in parallel processes: each takes as its input
    the port's output of the stage before, and the tool checks that this
    equals the reference's output of that stage, per limb, before it writes
    the file.

The secret key is the reference's (SecretKey(ctx, key=SECRET_SEED)); the
switching keys are the port's, made on the CPU under that secret by
tpu_fhe_torch's keygen (the DNN's Galois keys from KEY_SEED, the
bootstrapper's keys, whose relin key is the DNN's too, from BOOT_KEY_SEED)
and injected into the reference through utils/convert.py; the file keeps
their digest, and the tests remake them.  The inputs are the port's
enc_tensor under that secret (generator INPUT_SEED), so the tests remake
them too.  The reference is slow eagerly (a relu_composite of one channel
takes about 45 minutes on a CPU core), so the run takes about two hours of
wall time in 13 parallel processes of about 4.5 GB each.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

N = 64
WIDTH = 4
PLANES = (1, 1, 1)
SINE = (28, 3, 44)
LEVEL_BUDGET = (2, 2)
LEVELS_AFTER = 9
SLOTS = WIDTH * WIDTH
SECRET_SEED = 1
KEY_SEED, BOOT_KEY_SEED, INPUT_SEED = 7, 8, 11
LAYER_SEED = 5
IMAGE_SEED = 17          # examples/resnet20_infer.py:177-185: weights, then image
STAGES = ("stem", "l1b0", "l2b0", "l3b0", "pool")

# (case, op, inputs, arguments).  An input names a fresh tensor of
# layer_inputs() or an earlier case's output.  conv's "device" is the
# encode path: a pair (reference, port) where they differ -- the port's
# device-encode path falls back to host encoding where the reference's
# would raise (a weight of |weight| * scale >= 2^61).
LAYER_CASES = [
    ("conv_dev_s1", "conv", ("x2",), dict(weight="conv", stride=1, device=True)),
    ("conv_dev_s2", "conv", ("x2",), dict(weight="conv", stride=2, device=True)),
    ("conv_host_s1", "conv", ("x2",), dict(weight="conv_pruned", stride=1, device=False)),
    ("conv_host_s2", "conv", ("x2",), dict(weight="conv", stride=2, device=False)),
    ("conv_wide", "conv", ("x2",), dict(weight="conv_wide", stride=1, device=(False, True))),
    ("bn", "batch_norm", ("x2",), dict(bn="bn")),
    ("conv_dev_deg2", "conv", ("bn",), dict(weight="conv", stride=1, device=True)),
    ("conv_dev_strided", "conv", ("conv_dev_s2",), dict(weight="conv", stride=2, device=True)),
    ("add", "add", ("bn", "y2"), {}),
    ("relu", "relu", ("x2",), dict(a=-1.0, b=1.0, deg=15)),
    ("sign", "sign", ("x2",), dict(k=0)),
    ("softmax", "softmax", ("x2",), {}),
    ("pool", "avg_pool_full_con", ("x2",), dict(fc="fc")),
    ("relu_composite", "relu_composite", ("x1",), {}),
]
# cases run together in one process (a case's chained inputs with it)
LAYER_JOBS = [["conv_dev_s1", "conv_dev_s2", "conv_host_s1", "conv_host_s2", "conv_wide",
               "bn", "conv_dev_deg2", "conv_dev_strided", "add"],
              ["relu", "sign", "pool"], ["softmax"], ["relu_composite"]]


def depth() -> int:
    """LEVELS_AFTER + the bootstrap's depth (examples/resnet20_infer.py:122-126)."""
    from tpu_fhe_torch.boot.bootstrap import gen_sine_coefficients
    from tpu_fhe_torch.eval import chebyshev as cheb

    approx = cheb.get_mult_depth_by_coeff_vector(gen_sine_coefficients(*SINE),
                                                 normalized=False)
    return LEVELS_AFTER + approx + SINE[1] + sum(LEVEL_BUDGET)


def params(plan: str, cm, ep, st):
    """The plan's EncryptionParameters from either package's classes."""
    d = depth()
    if plan == "q32":
        return ep(scheme=st.ckks, poly_modulus_degree=N, allow_insecure=True,
                  coeff_modulus=tuple(cm.create_composite(
                      N, 58, d, degree=2, anchor_bits=30, special_bits=30, special_count=d + 1)),
                  special_modulus_size=d + 1, composite_degree=2)
    return ep(scheme=st.ckks, poly_modulus_degree=N, allow_insecure=True,
              coeff_modulus=tuple(cm.create(N, [60] + [59] * d + [60] * 3)),
              special_modulus_size=3)


def rotations() -> list[int]:
    """The DNN's rotation steps: prepare_resnet20's at width 4 (every
    resolution) and the average pool's at width 4."""
    from tpu_fhe_torch.models.dnn import DNN

    return (DNN.conv_rotation_indices(WIDTH, 3, 0) + DNN.conv_rotation_indices(WIDTH // 2, 3, 1)
            + DNN.conv_rotation_indices(WIDTH // 4, 3, 2)
            + DNN.avgpool_rotation_indices(WIDTH // 4, 2) + DNN.avgpool_rotation_indices(WIDTH, 0))


def layer_inputs() -> dict:
    """The fresh images of the layer cases: (w, w, ch) uniform in
    [-0.5, 0.5)."""
    rng = np.random.default_rng(LAYER_SEED)
    return {"x2": rng.uniform(-0.5, 0.5, (WIDTH, WIDTH, 2)),
            "y2": rng.uniform(-0.5, 0.5, (WIDTH, WIDTH, 2)),
            "x1": rng.uniform(-0.5, 0.5, (WIDTH, WIDTH, 1))}


def layer_consts() -> dict:
    """The layer cases' weights: conv (3, 3, 2, 2); conv_pruned with output
    channel 1 and one tap zero; conv_wide with one weight of 12 (past the
    device-encode path's fixed-point range); bn and fc as
    (weight, bias, mean, var) and (weight (3, 2), bias (3,))."""
    rng = np.random.default_rng(LAYER_SEED + 1)
    conv = rng.normal(0.0, 0.3, (3, 3, 2, 2))
    pruned = conv.copy()
    pruned[..., 1] = 0.0
    pruned[0, 0, 0, 0] = 0.0
    wide = conv.copy()
    wide[1, 1, 0, 0] = 12.0
    bn = (rng.uniform(0.7, 1.3, 2), rng.uniform(-0.1, 0.1, 2), rng.uniform(-0.1, 0.1, 2),
          rng.uniform(0.8, 1.2, 2))
    fc = (rng.normal(0.0, 0.5, (3, 2)), rng.normal(0.0, 0.1, 3))
    return dict(conv=conv, conv_pruned=pruned, conv_wide=wide, bn=bn, fc=fc)


def apply_layer(model, boot, op: str, args: dict, xs: list, consts: dict, reference: bool):
    """One layer case through either package's DNN (`reference`: tpu_fhe's,
    whose conv encode path is its environment switch)."""
    if op == "conv":
        device = args["device"]
        if isinstance(device, tuple):
            device = device[0 if reference else 1]
        w = consts[args["weight"]]
        if reference:
            os.environ["TPU_FHE_CONV_DEVICE_ENCODE"] = "1" if device else "0"
            return model.conv(xs[0], w, args["stride"])
        return model.conv(xs[0], w, args["stride"], device_encode=device)
    if op == "batch_norm":
        return model.batch_norm(xs[0], *consts[args["bn"]])
    if op == "add":
        return model.add(xs[0], xs[1])
    if op == "relu":
        return model.relu(xs[0], args["a"], args["b"], args["deg"])
    if op == "sign":
        return model.sign(xs[0], args["k"])
    if op == "softmax":
        return model.softmax(xs[0])
    if op == "avg_pool_full_con":
        return model.avg_pool_full_con(xs[0], *consts[args["fc"]])
    if op == "relu_composite":
        return model.relu_composite(xs[0], boot)
    raise ValueError(op)


def limb_digests(residues: np.ndarray) -> list[str]:
    """64-bit BLAKE2b digests (hex) of each (component, limb) row of
    (size, L, N) residues, as uint64."""
    res = np.ascontiguousarray(np.asarray(residues).astype(np.uint64))
    return [hashlib.blake2b(row.tobytes(), digest_size=8).hexdigest()
            for row in res.reshape(-1, res.shape[-1])]


def key_digest(gk_np: dict, rlk_np: tuple, boot_gk_np: dict) -> str:
    """One digest of the DNN's Galois keys, the relin key and the
    bootstrapper's Galois keys (numpy, as utils/convert.py's *_to_np give
    them), in element order."""
    h = hashlib.blake2b(digest_size=16)
    for keys in (gk_np, boot_gk_np):
        for elt in sorted(keys):
            h.update(str(elt).encode())
            for part in keys[elt]:
                if part is not None:
                    h.update(np.ascontiguousarray(part).astype(np.uint64).tobytes())
    for part in rlk_np:
        if part is not None:
            h.update(np.ascontiguousarray(part).astype(np.uint64).tobytes())
    return h.hexdigest()


def tensor_record(prefix: str, data: list, meta: list, width: int, slotstr: int,
                  decoded: np.ndarray, arrays: dict | None) -> dict:
    """A tensor's record: per channel its metadata and digests, the decoded
    values, and with `arrays` its data under `prefix`/<channel>."""
    if arrays is not None:
        for c, d in enumerate(data):
            arrays[f"{prefix}/{c}"] = np.asarray(d).astype(np.uint64)
    return dict(width=width, slotstr=slotstr, channels=meta,
                digests=[limb_digests(d) for d in data], decoded=decoded.tolist())


def port_setup(plan: str, secret: np.ndarray):
    """The port's context, encoder, DNN (keys from KEY_SEED, relin key the
    bootstrapper's) and bootstrapper (keys from BOOT_KEY_SEED) on the CPU,
    under `secret`, and the secret key enc_tensor encrypts under (generator
    INPUT_SEED)."""
    from tpu_fhe_torch.boot.bootstrap import CkksBootstrapper
    from tpu_fhe_torch.core.modulus import CoeffModulus
    from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
    from tpu_fhe_torch.models.dnn import DNN
    from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder
    from tpu_fhe_torch.scheme.context import FheContext
    from tpu_fhe_torch.utils.convert import secret_key_from_np

    ctx = FheContext(params(plan, CoeffModulus, EncryptionParameters, SchemeType), device="cpu")
    enc = CkksEncoder(ctx)
    model = DNN(ctx, enc)
    model.build_galois_key(secret_key_from_np(ctx, secret, seed=KEY_SEED), rotations())
    boot = CkksBootstrapper(ctx, enc)
    boot.set_sine_params(*SINE)
    boot.setup(level_budget=LEVEL_BUDGET, slots=SLOTS)
    boot.keygen(secret_key_from_np(ctx, secret, seed=BOOT_KEY_SEED), SLOTS)
    model.mul_key = boot.mul_key
    return ctx, enc, model, boot, secret_key_from_np(ctx, secret, seed=INPUT_SEED)


def port_key_digest(model, boot) -> str:
    from tpu_fhe_torch.utils.convert import galois_key_to_np, relin_key_to_np

    return key_digest(galois_key_to_np(model.gk), relin_key_to_np(model.mul_key),
                      galois_key_to_np(boot.galois_keys))


def reference_secret(plan: str) -> np.ndarray:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tpu_fhe.core.modulus import CoeffModulus as JCM
    from tpu_fhe.core.params import EncryptionParameters as JEP, SchemeType as JST
    from tpu_fhe.scheme.context import FheContext as JContext
    from tpu_fhe.scheme.keys import SecretKey as JSK

    jctx = JContext(params(plan, JCM, JEP, JST))
    return _np(JSK(jctx, key=SECRET_SEED).s_ntt)


def _np(x) -> np.ndarray:
    """A reference array (W64, compact W64 or bare uint32) as uint64 numpy."""
    return x.to_np() if hasattr(x, "to_np") else np.asarray(x).astype(np.uint64)


class Reference:
    """tpu_fhe's DNN and bootstrapper on `plan`, with the port's keys under
    the reference's secret."""

    def __init__(self, plan: str):
        import jax

        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp
        import torch

        torch.set_num_threads(1)
        from tpu_fhe.boot.bootstrap import CkksBootstrapper as JBoot
        from tpu_fhe.core.modulus import CoeffModulus as JCM
        from tpu_fhe.core.params import EncryptionParameters as JEP, SchemeType as JST
        from tpu_fhe.eval import auto as jauto
        from tpu_fhe.models.dnn import DNN as JDNN, TensorCT as JTensorCT
        from tpu_fhe.ops.w64 import W64
        from tpu_fhe.scheme.ciphertext import Ciphertext as JCiphertext
        from tpu_fhe.scheme.ckks_encoder import CkksEncoder as JEncoder
        from tpu_fhe.scheme.context import FheContext as JContext
        from tpu_fhe.scheme.keys import GaloisKey as JGK, RelinKey as JRK, SecretKey as JSK

        from tpu_fhe_torch.utils.convert import galois_key_to_np, relin_key_to_np

        self.jctx = jctx = JContext(params(plan, JCM, JEP, JST))
        self.enc = JEncoder(jctx)
        self.sk = JSK(jctx, key=SECRET_SEED)
        self.secret = _np(self.sk.s_ntt)
        _, _, tmodel, tboot, self.sk_in = port_setup(plan, self.secret)
        self.port = (tmodel, tboot)
        self.key_digest = port_key_digest(tmodel, tboot)

        def word(data):
            data = np.asarray(data)
            if jctx.is_q32:
                return jnp.asarray(data.astype(np.uint32))
            return W64.from_np(data)

        def key(data, shoup):
            return JRK(word(data), None if shoup is None else word(shoup))

        def gkey(gk):
            return JGK({elt: key(*pair) for elt, pair in galois_key_to_np(gk).items()})

        sf, _ = jauto.scaling_factors(jctx)
        self.model = JDNN(jctx, self.enc, scale=sf[0])
        self.model.gk = gkey(tmodel.gk)
        self.model.mul_key = key(*relin_key_to_np(tmodel.mul_key))
        self.boot = JBoot(jctx, self.enc)
        self.boot.set_sine_params(*SINE)
        self.boot.setup(level_budget=LEVEL_BUDGET, slots=SLOTS)
        self.boot.galois_keys = gkey(tboot.galois_keys)
        self.boot.mul_key = self.model.mul_key

        def ciphertext(data, m):
            data = np.asarray(data)
            lo = jnp.asarray((data & np.uint64(0xFFFFFFFF)).astype(np.uint32))
            w = W64(lo, None) if jctx.is_q32 else W64.from_np(data)
            return JCiphertext(data=w, chain_index=m["chain_index"], scale=m["scale"],
                               noise_scale_deg=m["noise_scale_deg"])

        self.tensor = lambda data, meta, width, slotstr: JTensorCT(
            [ciphertext(d, m) for d, m in zip(data, meta)], width, slotstr)

    def record(self, prefix: str, t, arrays: dict | None) -> dict:
        data = [_np(c.data) for c in t.cts]
        meta = [dict(chain_index=int(c.chain_index), scale=float(c.scale),
                     noise_scale_deg=int(c.noise_scale_deg)) for c in t.cts]
        return tensor_record(prefix, data, meta, t.width, t.slotstr,
                             self.model.dec_tensor(t, self.sk), arrays)


def port_tensor_record(prefix: str, t, dec: np.ndarray, arrays: dict | None) -> dict:
    from tpu_fhe_torch.models.dnn import tensor_ct_to_np

    data, meta, width, slotstr = tensor_ct_to_np(t)
    return tensor_record(prefix, data, meta, width, slotstr, dec, arrays)


def run_layers(plan: str, names: list[str]) -> tuple[dict, dict]:
    """The layer cases `names` through the reference; -> (arrays, records)."""
    from tpu_fhe_torch.models.dnn import tensor_ct_to_np

    ref = Reference(plan)
    tmodel = ref.port[0]
    consts = layer_consts()
    arrays, records = {}, {}
    fresh = {}
    for name, image in layer_inputs().items():
        t = tmodel.enc_tensor(image, sk=ref.sk_in)
        fresh[name] = t
        records[f"input:{name}"] = port_tensor_record(f"input/{name}", t,
                                                      tmodel.dec_tensor(t, ref.sk_in), arrays)
    arrays["secret"] = ref.secret
    outs = {}
    cases = {c[0]: c for c in LAYER_CASES}
    for name in names:
        _, op, inputs, args = cases[name]
        xs = []
        for src in inputs:
            xs.append(outs[src] if src in outs else ref.tensor(*tensor_ct_to_np(fresh[src])))
        t0 = time.time()
        outs[name] = apply_layer(ref.model, ref.boot, op, args, xs, consts, reference=True)
        chained = any(name in c[2] for c in LAYER_CASES)
        records[name] = ref.record(f"case/{name}", outs[name], arrays if chained else None)
        records[name]["seconds"] = time.time() - t0
        print(f"[{plan} {name}] {time.time() - t0:.1f} s", flush=True)
    return arrays, dict(cases=records, key_digest=ref.key_digest)


class _Stop(Exception):
    pass


def resnet_setup(module):
    """(weights, image) of examples/resnet20_infer.py --demo's recipe from
    `module` (either package's resnet20): random_weights(default_rng(17),
    planes=PLANES), then the image uniform in [-0.5, 0.5)."""
    rng = np.random.default_rng(IMAGE_SEED)
    weights = module.random_weights(rng, planes=PLANES)
    return weights, rng.uniform(-0.5, 0.5, (WIDTH, WIDTH, 3))


def run_stage(plan: str, stage: str, x_np: tuple) -> tuple[dict, dict]:
    """One ResNet-20 stage through the reference on the input `x_np`
    (tensor_ct_to_np form); -> (arrays, records)."""
    from tpu_fhe.models import resnet20 as jrn

    ref = Reference(plan)
    weights, _ = resnet_setup(jrn)
    i = STAGES.index(stage)
    out = {}

    def stop(name, t):
        if name == stage:
            out["t"] = t
            raise _Stop

    t0 = time.time()
    try:
        jrn.resnet20_infer(ref.tensor(*x_np), ref.model, ref.boot, weights, log=lambda m: None,
                           blocks=1, layers=3, start_after=STAGES[i - 1] if i else "",
                           on_stage_done=stop)
    except _Stop:
        pass
    arrays = {}
    rec = ref.record(f"stage/{stage}/out", out["t"], arrays)
    rec["seconds"] = time.time() - t0
    print(f"[{plan} stage {stage}] {rec['seconds']:.1f} s", flush=True)
    return arrays, {"stage": stage, "out": rec}


def port_stages(plan: str, secret: np.ndarray) -> tuple[dict, list]:
    """The port's pipeline on the demo image: each stage's input
    (tensor_ct_to_np form and record) and output record; -> (arrays,
    [(stage, input numpy, input record, output record)])."""
    from tpu_fhe_torch.models import resnet20 as rn
    from tpu_fhe_torch.models.dnn import tensor_ct_to_np

    ctx, enc, model, boot, sk_in = port_setup(plan, secret)
    weights, image = resnet_setup(rn)
    arrays, out = {}, []
    x = model.enc_tensor(image, sk=sk_in)

    def done(name, t):
        prev = x_box[0]
        out.append((name, tensor_ct_to_np(prev),
                    port_tensor_record(f"stage/{name}/in", prev, model.dec_tensor(prev, sk_in),
                                       arrays),
                    port_tensor_record("", t, model.dec_tensor(t, sk_in), None)))
        x_box[0] = t

    x_box = [x]
    rn.resnet20_infer(x, model, boot, weights, log=lambda m: None, blocks=1, layers=3,
                      on_stage_done=done)
    return arrays, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plan", choices=["u64", "q32", "all"], default="all")
    ap.add_argument("--out", default=str(ROOT / "tests" / "data"))
    args = ap.parse_args()
    plans = ["u64", "q32"] if args.plan == "all" else [args.plan]
    t0 = time.time()
    status = 0
    jobs = [(plan, names) for plan in plans for names in LAYER_JOBS]
    n_workers = len(jobs) + (len(STAGES) if "u64" in plans else 0)
    ctx = get_context("spawn")
    with ProcessPoolExecutor(n_workers, mp_context=ctx) as pool:
        layer_futs = [(plan, pool.submit(run_layers, plan, names)) for plan, names in jobs]
        stage_futs, port = [], []
        if "u64" in plans:
            secret = pool.submit(reference_secret, "u64").result()
            port_arrays, port = port_stages("u64", secret)
            print(f"[u64] the port's pipeline in {time.time() - t0:.1f} s", flush=True)
            stage_futs = [pool.submit(run_stage, "u64", stage, x_np)
                          for stage, x_np, _, _ in port]
        docs = {plan: dict(plan=plan, n=N, width=WIDTH, planes=PLANES, sine=SINE,
                           level_budget=LEVEL_BUDGET, levels_after=LEVELS_AFTER,
                           seeds=dict(secret=SECRET_SEED, key=KEY_SEED, boot_key=BOOT_KEY_SEED,
                                      input=INPUT_SEED, layer=LAYER_SEED, image=IMAGE_SEED),
                           cases={}) for plan in plans}
        arrays = {plan: {} for plan in plans}
        for plan, fut in layer_futs:
            arr, rec = fut.result()
            arrays[plan].update(arr)
            docs[plan]["cases"].update(rec["cases"])
            docs[plan]["key_digest"] = rec["key_digest"]
        if port:
            arrays["u64"].update(port_arrays)
            stages = {}
            for (stage, _, rec_in, _), fut in zip(port, stage_futs):
                arr, rec = fut.result()
                arrays["u64"].update(arr)
                stages[stage] = dict(input=rec_in, output=rec["out"])
            # each stage's input is the port's output of the stage before:
            # it must be the reference's own
            bad = [stage for (stage, _, _, port_out), _ in zip(port, STAGES[1:])
                   if (port_out["digests"], port_out["channels"])
                   != (stages[stage]["output"]["digests"], stages[stage]["output"]["channels"])]
            if bad:
                print(f"FAILED: the port's output of stage(s) {bad} differs from the "
                      "reference's, so the next stage's input is not the reference's own; "
                      "the stages are left out", file=sys.stderr)
                status = 1
            else:
                docs["u64"]["stages"] = stages
                docs["u64"]["logits"] = stages["pool"]["output"]["decoded"][0][0]
    for plan in plans:
        path = Path(args.out) / f"torch_dnn_golden_{plan}.npz"
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(path, meta=np.array(json.dumps(docs[plan])), **arrays[plan])
        print(f"wrote {path}")
    print(f"[time] {time.time() - t0:.1f} s")
    return status


if __name__ == "__main__":
    sys.exit(main())
