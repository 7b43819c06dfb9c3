#!/usr/bin/env python3
"""Remake the golden file of tests/test_torch_parallel.py.

    JAX_PLATFORMS=cpu python3 tools/parallel_golden.py [--out DIR]

runs the reference's sharded functions (``tpu_fhe/parallel/``) on its
8-virtual-device CPU mesh, at its own tests' fixtures, with the port's
inputs injected: the same secrets, keys and ciphertexts that
tests/torch_parallel_ranks.py draws from its seeds with the port's keygen
(on the CPU), carried over as numpy.  It writes
tests/data/torch_parallel_golden.npz: one array per case (uint64) and, in
``meta`` (JSON), each case's metadata and the reference's refusals:

  * tests/test_ntt4step.py: ``forward_ntt_4step`` and ``inverse_ntt_4step``
    over a ('coeff',) mesh of 8, N = 256, on [50]*3 (u64) and on three
    30-bit primes (the reference's single-word plan), the default split and
    n1 = 32;
  * tests/test_sharded_eval.py: multiply -> relinearize -> rescale under a
    1 x 8 ('batch', 'limb') mesh at the top of the chain and at its bottom,
    and vmapped over a batch of 4 under 2 x 4; the same on a q32 composite
    context, with ``rescale_composite`` by a pair of limbs;
  * tests/test_coeff_sharded.py: ``rotate_4step`` by 3 and the
    coefficient-sharded relinearize under ``coeff_mesh(1, 8)``, on the u64
    context and on the q32 one;
  * tests/test_boot_sharded.py: ``bsgs_level_limb_sharded``, level 0 of
    CoeffsToSlots, under 2 x 4, on the u64 plan and on the q32 one (whose
    30 rows run on 2 x 3, the refusal on 2 x 4 recorded).

Every case goes through the reference's function.  Where it raises, the
case has no array and ``meta["refused"]`` keeps the exception's type and
text; tests/test_torch_parallel.py pins which cases those are.  A limb
case whose rows do not divide over 8 devices is recorded refused on 1 x 8
("<case> on 1 x 8") and then run on the widest limb mesh that divides
them.  Each case's metadata is the reference's own (``jax.eval_shape`` of
the same function).  About six minutes.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def reference_cases() -> tuple[dict, dict]:
    """Every case through the reference; -> (arrays, meta)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_num_cpu_devices", 8)
    from jax.sharding import Mesh, NamedSharding

    import jax.numpy as jnp
    import torch

    import torch_parallel_ranks as R
    from tpu_fhe.boot.bootstrap import CkksBootstrapper as JBoot
    from tpu_fhe.core.modulus import CoeffModulus as JCM
    from tpu_fhe.core.ntt_tables import make_ntt_tables as j_tables
    from tpu_fhe.core.params import EncryptionParameters as JEP, SchemeType as JST
    from tpu_fhe.eval import evaluator as jev
    from tpu_fhe.ops import w64
    from tpu_fhe.ops.ntt import build_device_ntt_tables as j_build
    from tpu_fhe.ops.w64 import W64
    from tpu_fhe.parallel import coeff_eval as jce
    from tpu_fhe.parallel.boot_sharded import bsgs_level_limb_sharded
    from tpu_fhe.parallel.ntt4step import forward_ntt_4step, inverse_ntt_4step
    from tpu_fhe.parallel.sharding import ct_sharding, make_mesh, shard_relin_key
    from tpu_fhe.scheme.ciphertext import Ciphertext as JCt
    from tpu_fhe.scheme.ckks_encoder import CkksEncoder as JEncoder
    from tpu_fhe.scheme.context import FheContext as JContext
    from tpu_fhe.scheme.keys import GaloisKey as JGK, RelinKey as JRK
    from tpu_fhe_torch.utils.convert import to_numpy

    arrays, meta = {}, {"refused": {}, "meta": {}}

    def u64(t):
        return to_numpy(t).astype(np.uint64)

    def jarr(t, compact):
        """A port tensor as the reference holds it: W64 on the u64 plan; on a
        q32 context a ciphertext's compact W64 (no hi plane) or a key's
        bare uint32 array (tpu_fhe/scheme/keys.py)."""
        if t.dtype != torch.int32:
            return W64.from_np(u64(t))
        lo = jnp.asarray(to_numpy(t))
        return W64(lo, None) if compact else lo

    def out_np(x):
        return x.to_np() if hasattr(x, "to_np") else np.asarray(x).astype(np.uint64)

    def jct(ct):
        return JCt(jarr(ct.data, True), chain_index=ct.chain_index, scale=ct.scale,
                   noise_scale_deg=ct.noise_scale_deg)

    def jkey(key):
        return JRK(jarr(key.data, False),
                   None if key.shoup is None else jarr(key.shoup, False))

    def jcontext(bits=None, special=1, composite=None):
        if composite is not None:
            return JContext(JEP(scheme=JST.ckks, poly_modulus_degree=R.N, allow_insecure=True,
                                coeff_modulus=tuple(JCM.create_composite(R.N, **composite)),
                                special_modulus_size=special, composite_degree=2))
        return JContext(JEP(scheme=JST.ckks, poly_modulus_degree=R.N, allow_insecure=True,
                            coeff_modulus=tuple(JCM.create(R.N, bits)),
                            special_modulus_size=special))

    def widest(rows, most):
        """The widest limb axis of at most `most` devices that divides `rows`."""
        return max(d for d in range(2, most + 1) if rows % d == 0)

    def ct_meta(c):
        return [int(c.chain_index), float(c.scale), int(c.noise_scale_deg)]

    def record(name, run, refused_as=None):
        try:
            got, info = run()
        except Exception as e:            # a plan the reference's function refuses
            why = meta["refused"][refused_as or name] = f"{type(e).__name__}: {e}"[:400]
            print(f"[{refused_as or name}] refused: {why[:160]}", flush=True)
            return
        arrays[name] = out_np(got)
        if info is not None:
            meta["meta"][name] = info
        print(f"[{name}] ran", flush=True)

    # -- the 4-step NTT --------------------------------------------------
    coeff8 = Mesh(np.asarray(jax.devices()[:8]).reshape(8), ("coeff",))
    for plan in R.NTT_BITS:
        tables, x = R.ntt_inputs(plan)
        qs = [int(v) for v in tables.q.reshape(-1).tolist()]
        t = j_build([j_tables(R.N.bit_length() - 1, q) for q in qs])
        xw = W64.from_np(u64(x))
        for n1 in R.NTT_SPLITS:
            def fwd(n1=n1):
                with coeff8:
                    got = jax.jit(lambda v: forward_ntt_4step(v, t, coeff8, n1))(xw)
                return got, None

            def inv(n1=n1):
                with coeff8:
                    f = jax.jit(lambda v: forward_ntt_4step(v, t, coeff8, n1))(xw)
                    got = jax.jit(lambda v: inverse_ntt_4step(v, t, coeff8, n1))(f)
                return got, None
            record(f"ntt {plan} forward n1={n1}", fwd)
            record(f"ntt {plan} inverse n1={n1}", inv)

    # -- the limb mesh and batch x limb (tests/test_sharded_eval.py) --------
    def mul_relin_rescale(ctx, proto, key, limbs):
        def one(data):
            c = proto.with_data(data)
            prod = jev.relinearize(ctx, jev.multiply(ctx, c, c), key)
            return jev.rescale_composite(ctx, prod, limbs)
        return one

    def limb_cases(plan, tctx, trlk, tct, jctx, limbs):
        """Both ends of the chain on 1 x 8, as the reference's tests run it;
        where its device_put refuses the case's rows over 8 devices, that
        refusal is recorded and the case runs on the widest limb mesh that
        divides its rows (the array's meta names the mesh)."""
        jrlk = jkey(trlk)
        for end, ci in (("top", 1), ("bottom", R.bottom(tctx, limbs))):
            c = jct(R.drop_to(tctx, tct, ci))
            name = f"limb {plan} {end}"
            for n_limb in (8, widest(tctx.level(ci).size, 8)):
                def limb(c=c, mesh=make_mesh(1, n_limb), n_limb=n_limb):
                    step = mul_relin_rescale(jctx, c, shard_relin_key(jrlk, mesh), limbs)
                    with mesh:
                        got = jax.jit(lambda d: step(d).data, in_shardings=ct_sharding(mesh))(
                            jax.device_put(c.data, ct_sharding(mesh)))
                    return got, ct_meta(jax.eval_shape(step, c.data)) + [f"1 x {n_limb}"]
                record(name, limb, refused_as=f"{name} on 1 x {n_limb}")
                if name in arrays:
                    break

    ctx, enc = R.context(R.EVAL_BITS, R.EVAL_SPECIAL)
    _, rlk, cts, _ = R.eval_inputs(ctx, enc, R.LIMB_SECRET, R.LIMB_INPUT, 1 + R.BATCH, R.SCALE)
    jctx = jcontext(R.EVAL_BITS, R.EVAL_SPECIAL)
    limb_cases("u64", ctx, rlk, cts[0], jctx, 1)

    def batch():
        mesh24 = make_mesh(2, 4)
        proto = jct(cts[1])
        step = mul_relin_rescale(jctx, proto, shard_relin_key(jkey(rlk), mesh24), 1)
        stacked = jax.device_put(w64.stack([jct(c).data for c in cts[1:]]),
                                 ct_sharding(mesh24, batched=True))
        with mesh24:
            got = jax.jit(jax.vmap(lambda d: step(d).data),
                          in_shardings=ct_sharding(mesh24, batched=True))(stacked)
        return got, ct_meta(jax.eval_shape(step, proto.data))
    record("batch x limb", batch)

    qctx, qenc = R.context(special=R.Q32_COMPOSITE["special_count"], composite=R.Q32_COMPOSITE)
    _, qrlk, qcts, _ = R.eval_inputs(qctx, qenc, R.Q32_SECRET, R.Q32_INPUT, 1, R.Q32_SCALE)
    jqctx = jcontext(special=R.Q32_COMPOSITE["special_count"], composite=R.Q32_COMPOSITE)
    limb_cases("q32", qctx, qrlk, qcts[0], jqctx, 2)

    # -- the coeff mesh (tests/test_coeff_sharded.py) -----------------------
    cmesh = jce.coeff_mesh(1, 8)

    def coeff_cases(suffix, tctx, tenc, jctx, scale):
        sk, _, ccts, _ = R.eval_inputs(tctx, tenc, R.COEFF_SECRET, R.COEFF_INPUT, 1, scale)
        gk = JGK({elt: jkey(k) for elt, k in sk.galois_key([R.COEFF_STEP]).keys.items()})
        crlk = jkey(sk.relin_key())
        cct = jct(ccts[0])

        def rotate():
            data = jax.device_put(cct.data, NamedSharding(cmesh, jce.CT_SPEC))
            with cmesh:
                got = jax.jit(lambda d: jce.rotate_4step(jctx, cct.with_data(d), R.COEFF_STEP,
                                                         gk, cmesh).data)(data)
            return got, None
        record(f"coeff rotate{suffix}", rotate)

        def relinearize():
            prod = jev.multiply(jctx, cct, cct)
            level = jctx.level(prod.chain_index)

            def f(d):
                ks = jce.keyswitch_core_4step(jctx, level, d[2], crlk, cmesh)
                return w64.stack([w64.add_mod(d[0], ks[0], level.mod.q),
                                  w64.add_mod(d[1], ks[1], level.mod.q)])
            data = jax.device_put(prod.data, NamedSharding(cmesh, jce.CT_SPEC))
            with cmesh:
                got = jax.jit(f)(data)
            return got, None
        record(f"coeff relinearize{suffix}", relinearize)

    coeff_cases("", ctx, enc, jctx, R.SCALE)
    coeff_cases(" q32", qctx, qenc, jqctx, R.Q32_SCALE)

    # -- the limb-sharded BSGS level (tests/test_boot_sharded.py) -----------
    for plan, name in (("u64", "bsgs level"), ("q32", "bsgs level q32")):
        bctx, benc = R.boot_context(plan)
        tboot = R.boot_setup(bctx, benc)
        _, bgk, bct = R.boot_inputs(bctx, benc, tboot)
        if plan == "q32":
            jbctx = jcontext(special=R.BOOT_Q32["special_count"], composite=R.BOOT_Q32)
        else:
            jbctx = jcontext(R.BOOT_BITS, R.BOOT_SPECIAL)
        jboot = JBoot(jbctx, JEncoder(jbctx))
        jboot.set_sine_params(*R.BOOT_SINE)
        jboot.setup(level_budget=R.BOOT_BUDGET, slots=R.BOOT_SLOTS)
        jboot.galois_keys = JGK({elt: jkey(k) for elt, k in bgk.keys.items()})

        # 2 x 4 as the reference's test runs it; where the level's rows do
        # not divide over 4, that refusal is recorded and 2 x 3 or 2 x 2 runs
        for n_limb in (4, widest(bctx.level(bct.chain_index).size, 4)):
            def bsgs(jboot=jboot, bct=bct, n_limb=n_limb):
                got, stats = bsgs_level_limb_sharded(jboot, jct(bct), R.BOOT_SLOTS,
                                                     make_mesh(2, n_limb))
                return got.data, dict(zip(("chain_index", "scale", "noise_scale_deg"),
                                          ct_meta(got)), hlo_collectives=stats,
                                      mesh=f"2 x {n_limb}")
            record(name, bsgs, refused_as=f"{name} on 2 x {n_limb}")
            if name in arrays:
                break
    return arrays, meta


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "tests" / "data"))
    args = ap.parse_args()
    arrays, meta = reference_cases()
    out = Path(args.out) / "torch_parallel_golden.npz"
    np.savez_compressed(out, meta=np.array(json.dumps(meta)), **arrays)
    print(f"wrote {out}: {sorted(arrays)}; refused: {sorted(meta['refused'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
