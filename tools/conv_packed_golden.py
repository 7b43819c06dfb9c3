#!/usr/bin/env python3
"""Remake the golden files of tests/test_torch_conv_packed.py.

    python3 tools/conv_packed_golden.py [--plan u64|q32|all] [--out DIR]

runs tpu_fhe's packed convolution and diagonal fully-connected layer
(tpu_fhe/models/conv_packed.py, the JAX reference, eagerly on the CPU) at
N = 512 on both plans: the u64 plan of the reference's own test
(tests/test_conv_packed.py: [60, 40, 40, 40, 60], one special prime) and a
q32 plan (create_composite(512, 58, 3, degree=2, anchor_bits=30,
special_bits=30, special_count=4)), mask scale 2^40.  It writes
tests/data/torch_conv_packed_golden_<plan>.npz with the reference's secret
key (NTT form, the key level) and these cases:

  * "encode": zero_pad_encode of 5 channels of 6 x 6 (two ciphertexts at
    this ring size); the reference's plaintexts, encrypted by the port's
    keys (below), are the stored inputs of the convolutions;
  * "conv": eval_convolution 5 -> 3 with 3 x 3 filters, and
    "conv_pruned": the same with a tap that is zero for every output
    channel, a tap that is zero for one output channel only, and a tap
    that is zero for one output channel on one input ciphertext only;
  * "fc" and "fc_bias": fc_weight_encode and fully_connected at rows 4,
    cols 16, without and with a bias plaintext.

Each output is recorded as a 64-bit BLAKE2b digest per (component, limb)
of each ciphertext or plaintext, with its metadata and its decoded values.

The secret key is the reference's (SecretKey(ctx, key=SECRET_SEED)).  The
Galois keys are the port's, made on the CPU under that secret by
tpu_fhe_torch's keygen (generator KEY_SEED) and injected into the
reference through utils/convert.py; the file keeps their digest and the
tests remake them.  The reference's encryptions are the port's too: its
SecretKey's encrypt_symmetric is replaced by the port's under the same
secret (generator INPUT_SEED, one draw per ciphertext in order), so the
stored ciphertexts are what the port's zero_pad_encode gives exactly when
its plaintexts are the reference's.  The cases run in six processes of
about a GB each; the reference's eager convolution takes about two minutes
at this size.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
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

N = 512
SCALE = 2.0 ** 40
SECRET_SEED, KEY_SEED, INPUT_SEED = 21, 7, 11
DATA_SEED = 88
IN_H, F_H, C_IN, C_OUT = 6, 3, 5, 3
FC_ROWS, FC_COLS = 4, 16
JOBS = (("encode", "conv"), ("conv_pruned",), ("fc", "fc_bias"))


def params(plan: str, cm, ep, st):
    """The plan's EncryptionParameters from either package's classes."""
    if plan == "q32":
        return ep(scheme=st.ckks, poly_modulus_degree=N, allow_insecure=True,
                  coeff_modulus=tuple(cm.create_composite(N, 58, 3, degree=2, anchor_bits=30,
                                                          special_bits=30, special_count=4)),
                  special_modulus_size=4, composite_degree=2)
    return ep(scheme=st.ckks, poly_modulus_degree=N, allow_insecure=True,
              coeff_modulus=tuple(cm.create(N, [60, 40, 40, 40, 60])), special_modulus_size=1)


def data() -> dict:
    """The cases' numbers: images (5, 6, 6) uniform in [-1, 1), filters
    (3, 5, 3, 3) uniform in [-0.5, 0.5) and their pruned copy, the FC
    weight (4, 16), input (16,) and bias (4,)."""
    rng = np.random.default_rng(DATA_SEED)
    images = rng.uniform(-1, 1, (C_IN, IN_H, IN_H))
    filt = rng.uniform(-0.5, 0.5, (C_OUT, C_IN, F_H, F_H))
    pruned = filt.copy()
    pruned[:, :, 2, 2] = 0.0          # zero for every output channel
    pruned[1, :, 0, 1] = 0.0          # zero for output channel 1 only
    pruned[2, :4, 1, 0] = 0.0         # channel 2: zero on the first input ct only
    return dict(images=images, filt=filt, filt_pruned=pruned,
                fc_weight=rng.uniform(-1, 1, (FC_ROWS, FC_COLS)),
                fc_x=rng.uniform(-1, 1, FC_COLS), fc_bias=rng.uniform(-0.5, 0.5, FC_ROWS))


def rotations(slots: int) -> list[int]:
    """Every step of the cases: the convolution's and the FC layer's."""
    from tpu_fhe_torch.models.conv_packed import PackedConv, fc_rotation_indices
    from types import SimpleNamespace

    pc = PackedConv(SimpleNamespace(n=2 * slots), None)
    return sorted(set(pc.rotation_indices(pc.layout(IN_H, F_H)))
                  | set(fc_rotation_indices(FC_ROWS, FC_COLS, slots)))


def port_setup(plan: str, secret: np.ndarray):
    """The port's context, encoder and Galois keys (from KEY_SEED), on the
    CPU under `secret`."""
    from tpu_fhe_torch.core.modulus import CoeffModulus
    from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
    from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder
    from tpu_fhe_torch.scheme.context import FheContext
    from tpu_fhe_torch.utils.convert import secret_key_from_np

    ctx = FheContext(params(plan, CoeffModulus, EncryptionParameters, SchemeType), device="cpu")
    enc = CkksEncoder(ctx)
    return ctx, enc, secret_key_from_np(ctx, secret, seed=KEY_SEED).galois_key(rotations(N // 2))


def key_digest(gk) -> str:
    from tpu_fhe_torch.utils.convert import galois_key_to_np

    return dg.key_digest(galois_key_to_np(gk), (), {})


def meta(c) -> dict:
    return dict(chain_index=int(c.chain_index), scale=float(c.scale),
                noise_scale_deg=int(c.noise_scale_deg))


def record(items: list, decoded: np.ndarray | None = None) -> dict:
    """Digests and metadata of reference ciphertexts or plaintexts."""
    rec = dict(digests=[dg.limb_digests(dg._np(c.data)) for c in items],
               meta=[meta(c) for c in items])
    if decoded is not None:
        rec["decoded"] = np.asarray(decoded).tolist()
    return rec


class Reference:
    """tpu_fhe's context, encoder and secret key on `plan`, the port's
    Galois keys under its secret, and encrypt_symmetric, the port's in
    place of the reference's, which keeps each plaintext it encrypts: a
    secret key for the reference's zero_pad_encode."""

    def __init__(self, plan: str):
        import jax

        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp
        import torch

        torch.set_num_threads(1)
        from tpu_fhe.core.modulus import CoeffModulus as JCM
        from tpu_fhe.core.params import EncryptionParameters as JEP, SchemeType as JST
        from tpu_fhe.ops.w64 import W64
        from tpu_fhe.scheme.ciphertext import Ciphertext as JCiphertext
        from tpu_fhe.scheme.ckks_encoder import CkksEncoder as JEncoder
        from tpu_fhe.scheme.context import FheContext as JContext
        from tpu_fhe.scheme.keys import GaloisKey as JGK, RelinKey as JRK, SecretKey as JSK

        from tpu_fhe_torch.utils.convert import galois_key_to_np, plaintext_from_np, to_numpy

        self.jctx = jctx = JContext(params(plan, JCM, JEP, JST))
        self.enc = JEncoder(jctx)
        self.sk = JSK(jctx, key=SECRET_SEED)
        self.secret = dg._np(self.sk.s_ntt)
        self.ctx, _, tgk = port_setup(plan, self.secret)
        self.key_digest = key_digest(tgk)

        def word(d):
            d = np.asarray(d)
            return jnp.asarray(d.astype(np.uint32)) if jctx.is_q32 else W64.from_np(d)

        self.gk = JGK({elt: JRK(word(d), None if s is None else word(s))
                       for elt, (d, s) in galois_key_to_np(tgk).items()})

        def ciphertext(d, c):
            d = np.asarray(d).astype(np.uint64)
            lo = jnp.asarray((d & np.uint64(0xFFFFFFFF)).astype(np.uint32))
            w = W64(lo, None) if jctx.is_q32 else W64.from_np(d)
            return JCiphertext(data=w, chain_index=c.chain_index, scale=c.scale,
                               noise_scale_deg=c.noise_scale_deg)

        def encrypt_symmetric(pt):
            self.plaintexts.append(pt)
            ct = self.sk_in.encrypt_symmetric(
                plaintext_from_np(self.ctx, dg._np(pt.data), pt.chain_index, pt.scale))
            return ciphertext(to_numpy(ct.data), ct)

        self.encrypt_symmetric = encrypt_symmetric
        self.reset_inputs()

    def reset_inputs(self):
        """A fresh input key, whose next encryption is its generator's
        first draw, as each case's first is, and no plaintexts kept."""
        from tpu_fhe_torch.utils.convert import secret_key_from_np

        self.sk_in = secret_key_from_np(self.ctx, self.secret, seed=INPUT_SEED)
        self.plaintexts = []


def run_job(plan: str, names: tuple) -> tuple[dict, dict]:
    """The cases `names` through the reference; -> (arrays, records)."""
    from tpu_fhe.models.conv_packed import PackedConv, fc_weight_encode, fully_connected

    ref = Reference(plan)
    d = data()
    pc = PackedConv(ref.jctx, ref.enc, scale=SCALE)
    lay = pc.layout(IN_H, F_H)
    arrays, records = {"secret": ref.secret}, {}
    for name in names:
        t0 = time.time()
        ref.reset_inputs()
        if name == "encode":
            cts = pc.zero_pad_encode(d["images"], lay, ref)
            for i, c in enumerate(cts):
                arrays[f"input/conv/{i}"] = dg._np(c.data)
            rec = record(cts, pc.decode_outputs(cts, lay, C_IN, ref.sk))
            rec["plaintexts"] = record(ref.plaintexts)
        elif name in ("conv", "conv_pruned"):
            din = pc.zero_pad_encode(d["images"], lay, ref)
            filt = d["filt" if name == "conv" else "filt_pruned"]
            out = pc.eval_convolution(filt, ref.gk, din, lay)
            rec = record(out, pc.decode_outputs(out, lay, C_OUT, ref.sk))
        else:
            slots = ref.enc.slots
            full = np.zeros(slots)
            full[:FC_COLS] = d["fc_x"]
            ct = ref.encrypt_symmetric(ref.enc.encode(full, SCALE, slots=slots))
            arrays["input/fc"] = dg._np(ct.data)
            diag = fc_weight_encode(ref.enc, d["fc_weight"], SCALE)
            bias = None
            if name == "fc_bias":
                bias = ref.enc.encode(np.pad(d["fc_bias"], (0, slots - FC_ROWS)), bias_scale(
                    ref.jctx, ct.scale, diag[0].scale), chain_index=2, slots=slots)
            out = fully_connected(ref.jctx, ref.gk, ct, diag, FC_COLS, bias)
            rec = record([out], ref.enc.decode(ref.sk.decrypt(out)).real[:FC_ROWS])
            rec["diagonals"] = record(diag)
            if bias is not None:
                rec["bias"] = record([bias])
        rec["seconds"] = time.time() - t0
        records[name] = rec
        print(f"[{plan} {name}] {rec['seconds']:.1f} s", flush=True)
    return arrays, dict(cases=records, key_digest=ref.key_digest)


def bias_scale(ctx, ct_scale: float, diag_scale: float) -> float:
    """The scale of fully_connected's sum before the bias: the product's,
    divided by the prime that rescale_to_next drops at chain index 1."""
    return ct_scale * diag_scale / ctx.q_values[ctx.level(1).size - 1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plan", choices=["u64", "q32", "all"], default="all")
    ap.add_argument("--out", default=str(ROOT / "tests" / "data"))
    args = ap.parse_args()
    plans = ["u64", "q32"] if args.plan == "all" else [args.plan]
    t0 = time.time()
    docs = {plan: dict(plan=plan, n=N, scale=SCALE, layout=[IN_H, F_H], channels=[C_IN, C_OUT],
                       fc=[FC_ROWS, FC_COLS],
                       seeds=dict(secret=SECRET_SEED, key=KEY_SEED, input=INPUT_SEED,
                                  data=DATA_SEED), cases={}) for plan in plans}
    arrays = {plan: {} for plan in plans}
    jobs = [(plan, names) for plan in plans for names in JOBS]
    with ProcessPoolExecutor(len(jobs), mp_context=get_context("spawn")) as pool:
        futs = [(plan, pool.submit(run_job, plan, names)) for plan, names in jobs]
        for plan, fut in futs:
            arr, rec = fut.result()
            arrays[plan].update(arr)
            docs[plan]["cases"].update(rec["cases"])
            docs[plan]["key_digest"] = rec["key_digest"]
    for plan in plans:
        path = Path(args.out) / f"torch_conv_packed_golden_{plan}.npz"
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(path, meta=np.array(json.dumps(docs[plan])), **arrays[plan])
        print(f"wrote {path}")
    print(f"[time] {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
