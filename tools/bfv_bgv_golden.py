#!/usr/bin/env python3
"""Remake the golden file of tests/test_torch_bfv.py and tests/test_torch_bgv.py.

    JAX_PLATFORMS=cpu python3 tools/bfv_bgv_golden.py [--out DIR]

runs tpu_fhe's BFV and BGV (the JAX reference, on the CPU) on the reference
tests' own fixtures (tests/test_bfv.py, tests/test_bgv.py): N = 256, t the
20-bit batching prime, (50, 50, 60) for BFV with BEHZ, (50, 50, 50, 60) for
each HPS form and for BGV, and a chain of 30-bit primes at N = 64 for each
scheme.  Each program runs keygen, encode and both encryptions, then every
op of eval/bfv_eval.py or eval/bgv_eval.py, decryption, BFV's noise budget
and find_levels_to_drop, and writes tests/data/torch_bfv_bgv_golden.npz:
the secret key, the keys, the plaintexts and input ciphertexts the port is
handed, and every op's output residues and metadata.  Each program runs in
a process of its own, all at once (about 2 minutes in all).
"""

from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
T_BITS = 20
ROT_STEPS = (1, 2)
# name: (scheme, mul_tech, N, prime bits, secret seed, slot seed)
PROGRAMS = {
    "bfv_behz": ("bfv", "behz", 256, (50, 50, 60), 11, 2024),
    "bfv_hps": ("bfv", "hps", 256, (50, 50, 50, 60), 11, 2024),
    "bfv_hps_overq": ("bfv", "hps_overq", 256, (50, 50, 50, 60), 11, 2024),
    "bfv_hps_overq_leveled": ("bfv", "hps_overq_leveled", 256, (50, 50, 50, 60), 11, 2024),
    "bfv_q32": ("bfv", "behz", 64, (30, 30, 30), 11, 7),
    "bgv": ("bgv", "behz", 256, (50, 50, 50, 60), 13, 31),
    "bgv_q32": ("bgv", "behz", 64, (30, 30, 30, 30), 13, 7),
}


# -- the file's format: arrays by path, everything else in one JSON tree --

def pack(tree, arrays: dict, path: str = ""):
    if isinstance(tree, np.ndarray):
        arrays[path] = tree
        return {"__array": path}
    if isinstance(tree, dict):
        return {str(k): pack(v, arrays, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {"__list": [pack(v, arrays, f"{path}/{i}") for i, v in enumerate(tree)]}
    if isinstance(tree, (np.integer, np.bool_)):
        return tree.item()
    return tree


def write(path: Path, programs: dict) -> None:
    arrays: dict = {}
    tree = pack(programs, arrays)
    np.savez_compressed(path, __tree=np.array(json.dumps(tree)), **arrays)


# -- the reference programs --------------------------------------------------

def _np(x) -> np.ndarray:
    return np.asarray(x.to_np() if hasattr(x, "to_np") else x, dtype=np.uint64)


def _ct(ct) -> dict:
    return dict(data=_np(ct.data), meta=[ct.chain_index, ct.scale, ct.correction_factor,
                                         ct.noise_scale_deg, ct.is_ntt_form, ct.is_asymmetric])


def _key(k) -> dict:
    return dict(data=_np(k.data), shoup=None if k.shoup is None else _np(k.shoup))


def run_program(name: str) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from tpu_fhe.core.modulus import CoeffModulus, PlainModulus
    from tpu_fhe.core.params import EncryptionParameters, MulTech, SchemeType
    from tpu_fhe.scheme.batch_encoder import BatchEncoder
    from tpu_fhe.scheme.context import FheContext
    from tpu_fhe.scheme.keys import SecretKey

    scheme, tech, n, bits, key_seed, slot_seed = PROGRAMS[name]
    mods = CoeffModulus.create(n, list(bits))
    t = PlainModulus.batching(n, T_BITS)
    ctx = FheContext(EncryptionParameters(
        scheme=getattr(SchemeType, scheme), poly_modulus_degree=n, allow_insecure=True,
        coeff_modulus=tuple(mods), special_modulus_size=1, plain_modulus=t,
        mul_tech=getattr(MulTech, tech)))
    enc, sk = BatchEncoder(ctx), SecretKey(ctx, key=key_seed)
    rng = np.random.default_rng(slot_seed)
    vals = [rng.integers(0, t.value, size=n, dtype=np.uint64) for _ in range(3)]
    pts = [enc.encode(v) for v in vals]
    out = dict(scheme=scheme, mul_tech=tech, n=n, primes=[q.value for q in mods], t=t.value,
               is_q32=bool(ctx.is_q32), values=vals, s_ntt=_np(sk.s_ntt),
               plain=[_np(p.data) for p in pts])
    if scheme == "bfv":
        out.update(_bfv(ctx, enc, sk, pts, tech, n))
    else:
        out.update(_bgv(ctx, enc, sk, pts, n))
    return out


def _bfv(ctx, enc, sk, pts, tech, n) -> dict:
    import jax

    from tpu_fhe.core.params import MulTech
    from tpu_fhe.eval import bfv_eval as bv
    from tpu_fhe.scheme.bfv import BfvTools

    tools = BfvTools(ctx)
    pa, pb, pm = pts
    ca = tools.encrypt_symmetric(sk, pa)
    cb = tools.encrypt_asymmetric(sk.public_key(), pb, jax.random.key(5))
    rlk = sk.relin_key()
    prod = bv.multiply(tools, ca, cb)
    ops = dict(multiply=prod, square=bv.square(tools, ca), relinearize=bv.relinearize(tools, prod, rlk))
    out = dict(rlk=_key(rlk), ca=_ct(ca), cb=_ct(cb))
    if n == 64:
        out["ops"] = {"square": _ct(ops["square"])}
        out["decrypt"] = {"ca": _np(tools.decrypt(sk, ca).data)}
        return out
    out["decrypt"] = {k: _np(tools.decrypt(sk, c).data)
                      for k, c in (("ca", ca), ("cb", cb), ("multiply", prod))}
    out["budget"] = {k: tools.invariant_noise_budget(sk, c)
                     for k, c in (("ca", ca), ("multiply", prod))}
    out["levels_to_drop"] = [[d, ks, asym, tools.find_levels_to_drop(d, ks, asym)]
                             for d in range(4) for ks in (False, True) for asym in (False, True)]
    if tech == "hps_overq_leveled":
        # the multiply with a dropped level (Q -> Ql scale and round, then the
        # re-expansion), which the fixture's own depth does not reach
        fn = bv._hps_mul_impl_factory(tools, tools.hps(1, 1), MulTech.hps_overq_leveled)
        out["dropped"] = _np(fn(ctx.level(1), ca.data, cb.data))
    if tech == "behz":
        gk = sk.galois_key(list(ROT_STEPS), include_conj=True)
        out["gk"] = {str(elt): _key(k) for elt, k in gk.keys.items()}
        ops.update(
            rotate_rows=bv.rotate_rows(tools, ca, ROT_STEPS[0], gk),
            rotate_rows_2=bv.rotate_rows(tools, ca, ROT_STEPS[1], gk),
            rotate_columns=bv.rotate_columns(tools, ca, gk),
            add=bv.add(ctx, ca, cb), sub=bv.sub(ctx, ca, cb), negate=bv.negate(ctx, ca),
            add_plain=bv.add_plain(tools, ca, pm), sub_plain=bv.sub_plain(tools, ca, pm),
            multiply_plain=bv.multiply_plain(tools, ca, pm),
            mod_switch_to_next=bv.mod_switch_to_next(tools, ca),
        )
        zero = sk.encrypt_zero_symmetric(1)
        out["zero"] = _np(zero.data)
        out["finish_encrypt"] = _np(tools._finish_encrypt(ctx.level(1), zero.data, pm.data))
    out["ops"] = {k: _ct(c) for k, c in ops.items()}
    return out


def _bgv(ctx, enc, sk, pts, n) -> dict:
    import jax

    from tpu_fhe.eval import bgv_eval as bg, evaluator as ev
    from tpu_fhe.ops import w64
    from tpu_fhe.scheme.bgv import BgvTools

    tools = BgvTools(ctx)
    pa, pb, pm = pts
    level = ctx.level(1)
    ca = tools.encrypt_symmetric(sk, pa)
    cb = tools.encrypt_asymmetric(sk.public_key(), pb, jax.random.key(4))
    rlk = sk.relin_key()
    prod = bg.multiply(tools, ca, cb)
    out = dict(rlk=_key(rlk), ca=_ct(ca), cb=_ct(cb),
               lifted=_np(tools._lift_ntt(level, pa.data)))
    ops = dict(multiply=prod, relinearize=bg.relinearize(ctx, prod, rlk))
    if n == 64:
        out["ops"] = {k: _ct(c) for k, c in ops.items()}
        out["decrypt"] = {"ca": _np(tools.decrypt(sk, ca).data)}
        return out
    gk = sk.galois_key(list(ROT_STEPS), include_conj=True)
    out["gk"] = {str(elt): _key(k) for elt, k in gk.keys.items()}
    ms_a = bg.mod_switch_to_next(tools, ca)
    ms_b = bg.mod_switch_to_next(tools, cb)
    ms_prod = bg.relinearize(ctx, bg.multiply(tools, ms_a, ms_b), rlk)   # cf = cf(ms)^2
    sq = bg.mod_switch_to_next(tools, bg.relinearize(ctx, bg.multiply(tools, ca, ca), rlk))
    ops.update(
        rotate=bg.rotate(ctx, ca, ROT_STEPS[0], gk),
        rotate_cf=bg.rotate(ctx, ms_a, ROT_STEPS[1], gk),
        conjugate=bg.conjugate(ctx, ca, gk),
        mod_switch_to_next=ms_a, mod_switch_b=ms_b, mod_switch_twice=bg.mod_switch_to_next(tools, ms_a),
        ms_prod=ms_prod,
        add=bg.add(tools, ca, cb), sub=bg.sub(tools, ca, cb),
        add_balanced=bg.add(tools, ms_a, ms_prod), sub_balanced=bg.sub(tools, ms_prod, ms_a),
        add_plain=bg.add_plain(tools, ca, pm), sub_plain=bg.sub_plain(tools, ca, pm),
        multiply_plain=bg.multiply_plain(tools, ca, pm),
        add_plain_cf=bg.add_plain(tools, ms_a, pm), sub_plain_cf=bg.sub_plain(tools, ms_a, pm),
        multiply_plain_cf=bg.multiply_plain(tools, ms_a, pm),
        square_ms=sq, depth2=bg.relinearize(ctx, bg.multiply(tools, sq, sq), rlk),
    )
    out["ops"] = {k: _ct(c) for k, c in ops.items()}
    out["decrypt"] = {k: _np(tools.decrypt(sk, ops[k]).data)
                      for k in ("multiply", "relinearize", "mod_switch_to_next", "add_balanced",
                                "rotate_cf", "depth2")}
    out["decrypt"]["ca"] = _np(tools.decrypt(sk, ca).data)
    out["decrypt"]["cb"] = _np(tools.decrypt(sk, cb).data)
    # the t-preserving moddown into coefficient form (no op of the reference
    # takes this branch; the keyswitch with output_ntt=False reaches it)
    rng = np.random.default_rng(5)
    qlp = list(level.base.values) + [m.value for m in ctx.key_modulus[ctx.params.size_Q:]]
    cx = rng.integers(0, 2**62, size=(2, len(qlp), n), dtype=np.uint64) % \
        np.asarray(qlp, dtype=np.uint64)[:, None]
    out["moddown_in"] = cx
    out["moddown_coeff"] = _np(ev.moddown_from_ntt(ctx, level, w64.as_w64(cx), output_ntt=False))
    out["moddown_ntt"] = _np(ev.moddown_from_ntt(ctx, level, w64.as_w64(cx)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "tests" / "data"))
    args = ap.parse_args()
    with ProcessPoolExecutor(len(PROGRAMS), mp_context=get_context("spawn")) as pool:
        results = dict(zip(PROGRAMS, pool.map(run_program, PROGRAMS)))
    path = Path(args.out) / "torch_bfv_bgv_golden.npz"
    write(path, results)
    print(f"wrote {path} ({path.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
