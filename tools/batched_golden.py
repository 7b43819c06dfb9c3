#!/usr/bin/env python3
"""Remake the golden file of tests/test_torch_batched.py and
tests/test_torch_serialize.py.

    python3 tools/batched_golden.py [--plan u64|q32|all] [--out DIR]

runs tpu_fhe's channel-batched stages (the JAX reference, eagerly on the
CPU, its vmapped stage programs over ciphertexts stacked with stack_cts)
on the N = 64 stack of tools/dnn_golden.py, on both plans, with the port's
keys under the reference's secret (dnn_golden.Reference), and writes
tests/data/torch_batched_golden_<plan>.npz:

  * "c2s": coeffs_to_slots of the two channels of the layer input "x2",
    each first switched down one level (the depth the sparse prelude's
    ModReduce leaves), stacked into one (2, 2, L, N) ciphertext;
  * "sine": the bootstrap's sine stage (the Chebyshev series, ModReduce and
    the double angles, boot._sine_jit(batched=True)) of the stacked "x2";
  * "relu_composite": DNN.relu_composite of "x2" with TPU_FHE_DNN_BATCH=2,
    one chunk of two channels through each stage and bootstrap;

each as a 64-bit BLAKE2b digest per (component, limb) of each channel with
its metadata and decoded values; and

  * files the reference's utils/serialize.py wrote: a ciphertext (channel
    0 of "x2"), a plaintext, the public, relin, Galois and secret keys, and
    one seeded symmetric ciphertext, as the bytes of each file.

The inputs are the port's enc_tensor of "x2" under the reference's secret
(generator INPUT_SEED, the first draw), so the tests remake them.  The
relu_composite jobs take about an hour of one CPU core each (three eager
vmapped bootstraps); the four jobs run in parallel processes of a few GB.
"""

from __future__ import annotations

import argparse
import importlib.util
import io
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
_spec = importlib.util.spec_from_file_location("dnn_golden", ROOT / "tools" / "dnn_golden.py")
dg = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(dg)

BATCH = 2
FILE_KINDS = ("ciphertext", "plaintext", "public_key", "relin_key", "galois_key",
              "secret_key", "ciphertext_sym")
GALOIS_STEPS = (1, 2)


def port_inputs(ref) -> list:
    """The port's encryption of "x2" (the first draw of the input key), as
    the reference's ciphertexts."""
    from tpu_fhe_torch.models.dnn import tensor_ct_to_np

    t = ref.port[0].enc_tensor(dg.layer_inputs()["x2"], sk=ref.sk_in)
    return ref.tensor(*tensor_ct_to_np(t)).cts


def record(ref, cts: list, width: int, slotstr: int) -> dict:
    from tpu_fhe.models.dnn import TensorCT as JTensorCT

    return ref.record("", JTensorCT(cts, width, slotstr), None)


def run_stages(plan: str) -> tuple[dict, dict]:
    """The batched C2S and sine through the reference, and the reference's
    serialized files; -> (arrays, records)."""
    from tpu_fhe.boot.bootstrap import gen_sine_coefficients
    from tpu_fhe.eval import auto as jauto
    from tpu_fhe.scheme.ciphertext import stack_cts, unstack_cts

    ref = dg.Reference(plan)
    ctx, boot = ref.jctx, ref.boot
    cts = port_inputs(ref)
    records = {}
    t0 = time.time()
    down = [jauto.mod_switch_level(ctx, c, 1) for c in cts]
    out = unstack_cts(boot.coeffs_to_slots(stack_cts(down), dg.SLOTS), BATCH)
    records["c2s"] = dict(record(ref, out, dg.WIDTH, 0), seconds=time.time() - t0)
    print(f"[{plan} c2s] {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    coeffs = tuple(gen_sine_coefficients(*dg.SINE))
    out = unstack_cts(boot._sine_jit(coeffs, batched=True)(stack_cts(cts), boot.mul_key),
                      BATCH)
    records["sine"] = dict(record(ref, out, dg.WIDTH, 0), seconds=time.time() - t0)
    print(f"[{plan} sine] {time.time() - t0:.1f} s", flush=True)
    arrays = reference_files(ref, cts[0])
    arrays["secret"] = ref.secret
    return arrays, dict(cases=records, key_digest=ref.key_digest)


def reference_files(ref, ct) -> dict:
    """The bytes of each kind of file the reference's serializer writes,
    under file/<kind>."""
    from tpu_fhe.utils import serialize as ser

    sk = ref.sk
    pt = ref.enc.encode(np.linspace(-0.5, 0.5, dg.SLOTS), ct.scale, slots=dg.SLOTS)
    ct_seeded, seed = sk.encrypt_symmetric_seeded(pt)
    writers = dict(
        ciphertext=lambda fp: ser.save_ciphertext(ct, fp),
        plaintext=lambda fp: ser.save_plaintext(pt, fp),
        public_key=lambda fp: ser.save_public_key(sk.public_key(), fp),
        relin_key=lambda fp: ser.save_relin_key(sk.relin_key(), fp),
        galois_key=lambda fp: ser.save_galois_key(
            sk.galois_key(list(GALOIS_STEPS), include_conj=True), fp),
        secret_key=lambda fp: ser.save_secret_key(sk, fp),
        ciphertext_sym=lambda fp: ser.save_ciphertext_symmetric(ct_seeded, seed, fp),
    )
    out = {}
    for kind in FILE_KINDS:
        buf = io.BytesIO()
        writers[kind](buf)
        out[f"file/{kind}"] = np.frombuffer(buf.getvalue(), dtype=np.uint8)
    return out


def run_relu_composite(plan: str) -> tuple[dict, dict]:
    """DNN.relu_composite of "x2" through the reference, batched."""
    from tpu_fhe.models.dnn import TensorCT as JTensorCT

    os.environ["TPU_FHE_DNN_BATCH"] = str(BATCH)
    ref = dg.Reference(plan)
    cts = port_inputs(ref)
    t0 = time.time()
    out = ref.model.relu_composite(JTensorCT(cts, dg.WIDTH, 0), ref.boot)
    rec = dict(ref.record("", out, None), seconds=time.time() - t0)
    print(f"[{plan} relu_composite] {time.time() - t0:.1f} s", flush=True)
    return {}, dict(cases={"relu_composite": rec}, key_digest=ref.key_digest)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plan", choices=["u64", "q32", "all"], default="all")
    ap.add_argument("--out", default=str(ROOT / "tests" / "data"))
    args = ap.parse_args()
    plans = ["u64", "q32"] if args.plan == "all" else [args.plan]
    t0 = time.time()
    jobs = [(plan, fn) for plan in plans for fn in (run_relu_composite, run_stages)]
    docs = {plan: dict(plan=plan, n=dg.N, width=dg.WIDTH, batch=BATCH, sine=dg.SINE,
                       level_budget=dg.LEVEL_BUDGET, levels_after=dg.LEVELS_AFTER,
                       galois_steps=GALOIS_STEPS, cases={}) for plan in plans}
    arrays = {plan: {} for plan in plans}
    with ProcessPoolExecutor(len(jobs), mp_context=get_context("spawn")) as pool:
        futs = [(plan, pool.submit(fn, plan)) for plan, fn in jobs]
        for plan, fut in futs:
            arr, rec = fut.result()
            arrays[plan].update(arr)
            docs[plan]["cases"].update(rec["cases"])
            docs[plan]["key_digest"] = rec["key_digest"]
    for plan in plans:
        path = Path(args.out) / f"torch_batched_golden_{plan}.npz"
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(path, meta=np.array(json.dumps(docs[plan])), **arrays[plan])
        print(f"wrote {path}")
    print(f"[time] {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
