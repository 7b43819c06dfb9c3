#!/usr/bin/env python3
"""Remake the golden files of tests/test_torch_bootstrap.py.

    python3 tools/boot_golden.py [--plan u64|q32|all] [--out DIR]

runs tpu_fhe's CkksBootstrapper (the JAX reference, on the CPU) at N = 64
on both plans -- the u64 plan on tests/test_bootstrap.py's parameters and
the q32 plan on tests/test_boot_composite.py's -- for each case of CASES:
the dense bootstrap, the sparse one (8 slots) and, on the u64 plan, a
two-iteration Meta-BTS.  It writes tests/data/torch_boot_golden_<plan>.npz
with, per case:

  * the reference's secret key (NTT form, the key level) and its input
    ciphertext (encrypted under that key and mod-dropped as the reference
    tests drop it);
  * its output ciphertext (chain index, scale and noise-scale degree in the
    metadata) and its decoded precision in bits;
  * the setup's results: the correction factor, the collapsed-FFT
    parameters, the bootstrap depth, the rotation indices, both stage
    plans, and a 64-bit BLAKE2b digest of every limb of every C2S and S2C
    plaintext (the plaintexts themselves would take megabytes);
  * on the dense case, the input and output of the first C2S BSGS level
    (``_bsgs_level``) and of the first ``apply_double_angle``.

The switching keys are the port's: tpu_fhe_torch's keygen makes them on the
CPU under the reference's secret from KEY_SEED, they go into the reference's
bootstrapper through utils/convert.py, and the file keeps their digest.  The
test remakes them the same way (at N = 64 a key set is megabytes, too large
to keep).  A reference bootstrap takes several minutes eagerly on a CPU, so
each case runs in a process of its own, all at once (about 11 minutes and
a few GB of memory in all).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
N = 64
SINE = (28, 3, 44)
LEVEL_BUDGET = (2, 2)
KEY_SEED = 7
META_PRECISION = 12
PLANS = {
    # tests/test_bootstrap.py:45-55
    "u64": dict(bits=[60] + [59] * 15 + [60] * 3, special=3, drop_to=2),
    # tests/test_boot_composite.py:37-50, 106-131: _ctx(n=64, pairs=15, sp=4)
    "q32": dict(composite=dict(scale_bits=56, levels=15, degree=2, anchor_bits=30,
                               special_bits=30, special_count=4),
                special=4, drop_to=4),
}
# (case, slots (0: N/2), secret seed, input seed, iterations, extra levels).
# Meta-BTS needs two more levels than the dense case's chain leaves: there
# the first bootstrap's output, mod-reduced, keeps no more limbs than the
# input, and Meta-BTS returns its input unchanged.
CASES = {
    "u64": [("dense", 0, 33, 3, 1, 0), ("sparse", 8, 44, 5, 1, 0), ("meta", 0, 33, 3, 2, 2)],
    "q32": [("dense", 0, 33, 3, 1, 0), ("sparse", 8, 44, 5, 1, 0)],
}


def params(plan: str, cm, ep, st, extra: int = 0):
    """The plan's EncryptionParameters, with `extra` more data levels, from
    either package's classes."""
    cfg = PLANS[plan]
    if "bits" in cfg:
        bits = cfg["bits"][:1] + [59] * extra + cfg["bits"][1:]
        return ep(scheme=st.ckks, poly_modulus_degree=N, allow_insecure=True,
                  coeff_modulus=tuple(cm.create(N, bits)), special_modulus_size=cfg["special"])
    composite = dict(cfg["composite"], levels=cfg["composite"]["levels"] + extra)
    return ep(scheme=st.ckks, poly_modulus_degree=N, allow_insecure=True,
              coeff_modulus=tuple(cm.create_composite(N, **composite)),
              special_modulus_size=cfg["special"], composite_degree=2)


def limb_digests(residues: np.ndarray) -> list[str]:
    """64-bit BLAKE2b digests (hex) of each limb of (L, N) residues, as uint64."""
    res = np.ascontiguousarray(np.asarray(residues).astype(np.uint64))
    return [hashlib.blake2b(row.tobytes(), digest_size=8).hexdigest() for row in res]


def key_digest(gk_np: dict, rlk_np: tuple) -> str:
    """One digest of a Galois key set and a relin key (numpy, as
    utils/convert.py's *_to_np give them), in element order."""
    h = hashlib.blake2b(digest_size=16)
    for elt in sorted(gk_np):
        for part in gk_np[elt]:
            h.update(str(elt).encode())
            if part is not None:
                h.update(np.ascontiguousarray(part).astype(np.uint64).tobytes())
    for part in rlk_np:
        if part is not None:
            h.update(np.ascontiguousarray(part).astype(np.uint64).tobytes())
    return h.hexdigest()


def setup_record(boot, slots: int, plaintexts) -> dict:
    """What setup decides, for either package's bootstrapper; `plaintexts`
    maps a plaintext to (chain index, scale, degree, residues)."""
    pre = boot.precom[slots]
    out = dict(correction_factor=boot.correction_factor, params_enc=list(pre.params_enc),
               params_dec=list(pre.params_dec),
               depth=boot.get_bootstrap_depth(LEVEL_BUDGET),
               rotation_indices=[int(v) for v in boot.find_rotation_indices(slots)],
               c2s_plans=json.loads(json.dumps(boot.c2s_stage_plans(slots))),
               s2c_plans=json.loads(json.dumps(boot.s2c_stage_plans(slots))))
    for name, table in (("c2s", pre.a_c2s), ("s2c", pre.a_s2c)):
        out[name] = [[None if pt is None else dict(zip(
            ("chain_index", "scale", "noise_scale_deg", "limbs"),
            (*plaintexts(pt)[:3], limb_digests(plaintexts(pt)[3])))) for pt in stage]
            for stage in table]
    return out


def _np(x) -> np.ndarray:
    """A reference array (W64, compact W64 or bare uint32) as uint64 numpy."""
    return x.to_np() if hasattr(x, "to_np") else np.asarray(x).astype(np.uint64)


def _ct(prefix: str, ct, arrays: dict) -> dict:
    arrays[prefix] = _np(ct.data)
    return dict(chain_index=int(ct.chain_index), scale=float(ct.scale),
                noise_scale_deg=int(ct.noise_scale_deg))


def run_case(plan: str, case: tuple) -> tuple[dict, dict]:
    """Run one case through the reference; returns (arrays, metadata)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    from tpu_fhe.boot.bootstrap import CkksBootstrapper as JBoot
    from tpu_fhe.core.modulus import CoeffModulus as JCM
    from tpu_fhe.core.params import EncryptionParameters as JEP, SchemeType as JST
    from tpu_fhe.eval import auto as jauto, evaluator as jev
    from tpu_fhe.ops.w64 import W64
    from tpu_fhe.scheme.ckks_encoder import CkksEncoder as JEncoder
    from tpu_fhe.scheme.context import FheContext as JContext
    from tpu_fhe.scheme.keys import GaloisKey as JGK, RelinKey as JRK, SecretKey as JSK

    from tpu_fhe_torch.boot.bootstrap import CkksBootstrapper, precision_bits
    from tpu_fhe_torch.core.modulus import CoeffModulus
    from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
    from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder
    from tpu_fhe_torch.scheme.context import FheContext
    from tpu_fhe_torch.utils.convert import (galois_key_to_np, relin_key_to_np,
                                             secret_key_from_np)

    name, slots, secret_seed, input_seed, iterations, extra = case
    jctx = JContext(params(plan, JCM, JEP, JST, extra))
    enc = JEncoder(jctx)
    sk = JSK(jctx, key=secret_seed)
    boot = JBoot(jctx, enc)
    boot.set_sine_params(*SINE)
    slots = slots or N // 2
    boot.setup(level_budget=LEVEL_BUDGET, slots=slots)

    # the port's keys under the reference's secret
    arrays = {"secret": _np(sk.s_ntt)}
    tctx = FheContext(params(plan, CoeffModulus, EncryptionParameters, SchemeType, extra),
                      device="cpu")
    tboot = CkksBootstrapper(tctx, CkksEncoder(tctx))
    tboot.set_sine_params(*SINE)
    tboot.setup(level_budget=LEVEL_BUDGET, slots=slots, precompute=False)
    tboot.keygen(secret_key_from_np(tctx, arrays["secret"], seed=KEY_SEED), slots)
    gk_np, rlk_np = galois_key_to_np(tboot.galois_keys), relin_key_to_np(tboot.mul_key)

    def jkey(data, shoup):
        if jctx.is_q32:
            return JRK(jnp.asarray(data), None if shoup is None else jnp.asarray(shoup))
        return JRK(W64.from_np(data), None if shoup is None else W64.from_np(shoup))
    boot.galois_keys = JGK({elt: jkey(*pair) for elt, pair in gk_np.items()})
    boot.mul_key = jkey(*rlk_np)

    meta = dict(case=name, slots=slots, secret_seed=secret_seed, input_seed=input_seed,
                iterations=iterations, extra_levels=extra, key_seed=KEY_SEED,
                key_shoup=tboot.key_shoup,
                key_digest=key_digest(gk_np, rlk_np),
                setup=setup_record(boot, slots, lambda pt: (
                    int(pt.chain_index), float(pt.scale), int(pt.noise_scale_deg),
                    _np(pt.data))))

    sf, _ = jauto.scaling_factors(jctx)
    x = np.random.default_rng(input_seed).uniform(-0.8, 0.8, slots)
    ct = sk.encrypt_symmetric(enc.encode(x, sf[0], slots=slots))
    while jctx.level(ct.chain_index).size > PLANS[plan]["drop_to"]:
        ct = jev.mod_drop_to_next(jctx, ct)
    meta["input"] = _ct("input", ct, arrays)

    if name == "dense":
        seen = {}
        bsgs, double_angle = boot._bsgs_level, boot.apply_double_angle

        def bsgs_rec(result, A, keys, rot_in, rot_out, b, g, num_rot):
            out = bsgs(result, A, keys, rot_in, rot_out, b, g, num_rot)
            if "bsgs" not in seen:
                seen["bsgs"] = (_ct("bsgs_in", result, arrays), _ct("bsgs_out", out, arrays),
                                [list(rot_in), list(rot_out), b, g, num_rot])
            return out

        def double_angle_rec(ct_in, num_iter, mul_key=None):
            out = double_angle(ct_in, num_iter, mul_key)
            if "double_angle" not in seen:
                seen["double_angle"] = (_ct("double_angle_in", ct_in, arrays),
                                        _ct("double_angle_out", out, arrays))
            return out
        boot._bsgs_level, boot.apply_double_angle = bsgs_rec, double_angle_rec

    out = boot.eval_bootstrap(ct, slots, iterations, META_PRECISION if iterations > 1 else 0)
    meta["output"] = _ct("output", out, arrays)
    got = enc.decode(sk.decrypt(out), slots=slots).real
    meta["precision"] = precision_bits(got, x)
    meta["levels_after"] = (len(jctx.chain) - 1 - out.chain_index) // (2 if jctx.is_q32 else 1)
    if name == "dense":
        meta["bsgs"], meta["double_angle"] = seen["bsgs"], seen["double_angle"]
    print(f"[{plan} {name}] precision {meta['precision']:.3f} bits, "
          f"levels after {meta['levels_after']}", flush=True)
    return {f"{name}/{k}": v for k, v in arrays.items()}, meta


def write(plan: str, results: list, out_dir: Path) -> Path:
    arrays, metas = {}, {}
    for arr, meta in results:
        arrays.update(arr)
        metas[meta["case"]] = meta
    doc = dict(plan=plan, n=N, sine=SINE, level_budget=LEVEL_BUDGET,
               meta_precision=META_PRECISION, **PLANS[plan], cases=metas)
    path = out_dir / f"torch_boot_golden_{plan}.npz"
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, meta=np.array(json.dumps(doc)), **arrays)
    return path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plan", choices=["u64", "q32", "all"], default="all")
    ap.add_argument("--out", default=str(ROOT / "tests" / "data"))
    args = ap.parse_args()
    plans = list(PLANS) if args.plan == "all" else [args.plan]
    jobs = [(plan, case) for plan in plans for case in CASES[plan]]
    with ProcessPoolExecutor(len(jobs), mp_context=get_context("spawn")) as pool:
        futures = [(plan, pool.submit(run_case, plan, case)) for plan, case in jobs]
        done = {plan: [] for plan in plans}
        for plan, fut in futures:
            done[plan].append(fut.result())
    for plan in plans:
        print(f"wrote {write(plan, done[plan], Path(args.out))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
