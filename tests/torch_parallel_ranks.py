"""The ranks of tests/test_torch_parallel.py, and the inputs its cases share
with their one-process path and with tools/parallel_golden.py.

This module imports torch, numpy and the port alone: ``run_ranks`` spawns
processes that import it, and they must not import JAX.  Every secret, key
and ciphertext is drawn on the CPU from an explicit seed; in a world, rank
0 draws it and broadcasts it (``sharding.broadcast_*``), so every rank
holds the same state.  ``rank_main`` runs every case in one world of
WORLD ranks; ``one_process`` runs the same cases in one process.  Both
return {case: result} with numpy results (uint64, or uint32 on a q32
context), the rank's collective counts beside each sharded path's.
"""

from __future__ import annotations

import numpy as np
import torch

WORLD = 4
N = 256
# tests/test_ntt4step.py: N = 256 on [50]*3 primes, x drawn from seed 42,
# the default split and n1 = 32; the q32 plan on three 30-bit primes too
NTT_BITS = {"u64": [50] * 3, "q32": [30] * 3}
NTT_SEED = 42
NTT_SPLITS = (None, 32)
# tests/test_sharded_eval.py and tests/test_coeff_sharded.py: N = 256,
# [40]*9 with one special prime (8 Q limbs and 1 P limb), scale 2^35
EVAL_BITS, EVAL_SPECIAL, SCALE = [40] * 9, 1, 2.0 ** 35
LIMB_SECRET, LIMB_INPUT, BATCH = 3, 7, 4
COEFF_SECRET, COEFF_INPUT, COEFF_STEP = 5, 11, 3
# the q32 plan's composite rescale: 10 Q and 3 P primes of 29-30 bits, so
# that over 4 ranks (3 Q rows a rank) the top level's dropped pair straddles
# two ranks' blocks
Q32_COMPOSITE = dict(scale_bits=58, levels=4, degree=2, anchor_bits=30, special_bits=30,
                     special_count=3)
Q32_SECRET, Q32_INPUT, Q32_SCALE = 9, 13, 2.0 ** 40
# tests/test_boot_sharded.py: N = 256, 21 + 3 primes, 16 slots, budget
# (2, 2), the sparse sine set; level 0 of CoeffsToSlots
BOOT_BITS, BOOT_SPECIAL = [60] + [59] * 20 + [60] * 3, 3
BOOT_SLOTS, BOOT_BUDGET, BOOT_SINE, BOOT_SECRET = 16, (2, 2), (28, 3, 44), 17
# the same level on the q32 plan (the port's own case): tools/boot_golden.py's
# q32 chain (tests/test_boot_composite.py's) at N = 256, 32 + 4 primes
BOOT_Q32 = dict(scale_bits=56, levels=15, degree=2, anchor_bits=30, special_bits=30,
                special_count=4)


def context(bits=None, special: int = 1, composite: dict | None = None, n: int = N,
            device="cpu"):
    from tpu_fhe_torch.core.modulus import CoeffModulus
    from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
    from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder
    from tpu_fhe_torch.scheme.context import FheContext

    if composite is not None:
        mods = CoeffModulus.create_composite(n, **composite)
        params = EncryptionParameters(scheme=SchemeType.ckks, poly_modulus_degree=n,
                                      allow_insecure=True, coeff_modulus=tuple(mods),
                                      special_modulus_size=special, composite_degree=2)
    else:
        params = EncryptionParameters(scheme=SchemeType.ckks, poly_modulus_degree=n,
                                      allow_insecure=True,
                                      coeff_modulus=tuple(CoeffModulus.create(n, bits)),
                                      special_modulus_size=special)
    ctx = FheContext(params, device=device)
    return ctx, CkksEncoder(ctx)


def ntt_inputs(plan: str):
    """The NTT tables of the plan's primes and x (3, N) in [0, q)."""
    from tpu_fhe_torch.core.modulus import CoeffModulus
    from tpu_fhe_torch.core.ntt_tables import make_ntt_tables
    from tpu_fhe_torch.ops.ntt import build_device_ntt_tables

    mods = CoeffModulus.create(N, NTT_BITS[plan])
    tables = build_device_ntt_tables([make_ntt_tables(N.bit_length() - 1, m.value)
                                      for m in mods], "cpu")
    qs = np.array([[m.value] for m in mods], dtype=np.uint64)
    x = np.random.default_rng(NTT_SEED).integers(0, 1 << 62, (3, N), dtype=np.uint64) % qs
    return tables, torch.from_numpy(x.astype(np.int64)).to(tables.q.dtype)


def eval_inputs(ctx, enc, secret: int, seed: int, count: int, scale: float):
    """(secret key, relin key, `count` fresh ciphertexts of N/2 normal
    values drawn from `seed`, the values)."""
    from tpu_fhe_torch.scheme.keys import SecretKey

    sk = SecretKey(ctx, seed=secret)
    rlk = sk.relin_key()
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(ctx.n // 2) for _ in range(count)]
    return sk, rlk, [sk.encrypt_symmetric(enc.encode(x, scale)) for x in xs], xs


def boot_setup(ctx, enc, c2s_stage: int | None = None):
    """The bootstrapper of the BSGS level's case; with c2s_stage, only that
    C2S level's plaintexts (what a rank runs)."""
    from tpu_fhe_torch.boot.bootstrap import CkksBootstrapper

    boot = CkksBootstrapper(ctx, enc)
    boot.set_sine_params(*BOOT_SINE)
    boot.setup(level_budget=BOOT_BUDGET, slots=BOOT_SLOTS, c2s_stage=c2s_stage)
    return boot


def boot_level_steps(boot) -> list[int]:
    """The rotation steps of C2S level 0 (the keys the level needs)."""
    _, rot_in, rot_out, *_ = boot.c2s_stage_plans(BOOT_SLOTS)[0]
    return [s for s in dict.fromkeys(list(rot_in) + list(rot_out)) if s != 0]


def boot_context(plan: str):
    if plan == "q32":
        return context(special=BOOT_Q32["special_count"], composite=BOOT_Q32)
    return context(BOOT_BITS, BOOT_SPECIAL)


def boot_inputs(ctx, enc, boot):
    """(secret key, the level's Galois keys, the input: the values encoded
    at 2^59, encrypted and switched one level down, as the reference test
    does)."""
    from tpu_fhe_torch.eval import auto
    from tpu_fhe_torch.scheme.keys import SecretKey

    sk = SecretKey(ctx, seed=BOOT_SECRET)
    gk = sk.galois_key(boot_level_steps(boot))
    pt = enc.encode(np.linspace(-0.8, 0.8, BOOT_SLOTS), 2.0 ** 59, chain_index=1,
                    slots=BOOT_SLOTS)
    return sk, gk, auto.mod_switch_level(ctx, sk.encrypt_symmetric(pt), 1)


def bottom(ctx, limbs: int = 1) -> int:
    """The last chain index at which a rescale by `limbs` limbs still fits."""
    return len(ctx.chain) - 1 - limbs


def drop_to(ctx, ct, chain_index: int):
    from tpu_fhe_torch.eval import evaluator as ev

    while ct.chain_index < chain_index:
        ct = ev.mod_drop_to_next(ctx, ct)
    return ct


def _np(x: torch.Tensor) -> np.ndarray:
    from tpu_fhe_torch.utils.convert import to_numpy

    return to_numpy(x)


def _meta(ct) -> tuple:
    return (ct.chain_index, ct.scale, ct.noise_scale_deg)


# --------------------------------------------------------------------------
# one process
# --------------------------------------------------------------------------

def one_process() -> dict:
    """Every case's result through the port's one-process path."""
    from tpu_fhe_torch.eval import evaluator as ev
    from tpu_fhe_torch.ops.ntt import forward_ntt, inverse_ntt
    from tpu_fhe_torch.scheme.ciphertext import stack_cts

    out = {}
    for plan in NTT_BITS:
        t, x = ntt_inputs(plan)
        fwd = forward_ntt(x, t)
        out[f"ntt {plan} forward"] = _np(fwd)
        out[f"ntt {plan} inverse"] = _np(inverse_ntt(fwd, t))

    ctx, enc = context(EVAL_BITS, EVAL_SPECIAL)
    _, rlk, cts, _ = eval_inputs(ctx, enc, LIMB_SECRET, LIMB_INPUT, 1 + BATCH, SCALE)
    for end, ci in (("top", 1), ("bottom", bottom(ctx))):
        c = drop_to(ctx, cts[0], ci)
        r = ev.rescale_to_next(ctx, ev.relinearize(ctx, ev.multiply(ctx, c, c), rlk))
        out[f"limb u64 {end}"] = (_np(r.data), _meta(r))
    b = stack_cts(cts[1:])
    r = ev.rescale_to_next(ctx, ev.relinearize(ctx, ev.multiply(ctx, b, b), rlk))
    out["batch x limb"] = (_np(r.data), _meta(r))
    out["relin key"] = _np(rlk.data), _np(rlk.shoup)

    qctx, qenc = context(special=Q32_COMPOSITE["special_count"], composite=Q32_COMPOSITE)
    _, qrlk, qcts, _ = eval_inputs(qctx, qenc, Q32_SECRET, Q32_INPUT, 1, Q32_SCALE)
    for end, ci in (("top", 1), ("bottom", bottom(qctx, 2))):
        c = drop_to(qctx, qcts[0], ci)
        r = ev.rescale_composite(qctx, ev.relinearize(qctx, ev.multiply(qctx, c, c), qrlk), 2)
        out[f"limb q32 {end}"] = (_np(r.data), _meta(r))

    for suffix, c, e, scale in (("", ctx, enc, SCALE), (" q32", qctx, qenc, Q32_SCALE)):
        sk, _, cts, _ = eval_inputs(c, e, COEFF_SECRET, COEFF_INPUT, 1, scale)
        gk = sk.galois_key([COEFF_STEP])
        out[f"coeff rotate{suffix}"] = _np(ev.rotate(c, cts[0], COEFF_STEP, gk).data)
        out[f"coeff relinearize{suffix}"] = _np(ev.relinearize(
            c, ev.multiply(c, cts[0], cts[0]), sk.relin_key()).data)

    for plan, name in (("u64", "bsgs level"), ("q32", "bsgs level q32")):
        bctx, benc = boot_context(plan)
        boot = boot_setup(bctx, benc)
        _, bgk, bct = boot_inputs(bctx, benc, boot)
        boot.galois_keys = bgk
        si, rot_in, rot_out, bb, g, num_rot, _ = boot.c2s_stage_plans(BOOT_SLOTS)[0]
        A = boot.precom[BOOT_SLOTS].a_c2s[si]
        r = boot._bsgs_level(bct, A, boot._keys_for(rot_in, rot_out), rot_in, rot_out, bb, g,
                             num_rot)
        out[name] = (_np(r.data), _meta(r))
    return out


# --------------------------------------------------------------------------
# the world
# --------------------------------------------------------------------------

def _counted(run):
    from tpu_fhe_torch.parallel import collectives as coll

    coll.reset_counts()
    got = run()
    return got, coll.counts()


def rank_main(rank: int, world: int) -> dict:
    """Every case in this rank: the whole result (gathered), the
    collectives of the sharded path alone, and the checks that need the
    rank's own shards."""
    from tpu_fhe_torch.eval import evaluator as ev
    from tpu_fhe_torch.parallel import boot_sharded as bs, coeff_eval as ce
    from tpu_fhe_torch.parallel import limb_eval as le, ntt4step as n4, sharding as sh
    from tpu_fhe_torch.scheme.ciphertext import stack_cts

    torch.set_num_threads(1)
    first = rank == 0
    limb = sh.make_mesh(1, world)
    batch_limb = sh.make_mesh(2, world // 2)
    coeff = sh.coeff_mesh(1, world)
    out = {}

    for plan in NTT_BITS:
        t, x = ntt_inputs(plan)
        for n1 in NTT_SPLITS:
            f, fc = _counted(lambda: n4.forward_ntt_4step(n4.cols_shard(x, coeff, n1), t,
                                                          coeff, n1))
            i, ic = _counted(lambda: n4.inverse_ntt_4step(f, t, coeff, n1))
            out[f"ntt {plan} n1={n1}"] = dict(
                forward=_np(n4.gather_rows_layout(f, coeff)),
                inverse=_np(n4.gather_cols_layout(i, coeff, n1)), counts=(fc, ic))

    # the limb mesh, u64: rank 0 draws the key and the ciphertexts
    ctx, enc = context(EVAL_BITS, EVAL_SPECIAL)
    drawn = eval_inputs(ctx, enc, LIMB_SECRET, LIMB_INPUT, 1 + BATCH, SCALE) if first else None
    rlk = sh.broadcast_relin_key(drawn[1] if first else None, ctx.device)
    cts = [sh.broadcast_ciphertext(drawn[2][j] if first else None, ctx.device)
           for j in range(1 + BATCH)]
    rlk_s = sh.shard_relin_key(ctx, rlk, limb)
    sctx = le.LimbShardContext(ctx, limb)
    for end, ci in (("top", 1), ("bottom", bottom(ctx))):
        s = sh.shard_ciphertext(ctx, drop_to(ctx, cts[0], ci), limb)
        r, counts = _counted(lambda: le.mul_relin_rescale(sctx, s, s, rlk_s))
        whole = sh.gather(ctx, r, limb)
        out[f"limb u64 {end}"] = (_np(whole.data), _meta(whole), counts)
    out["key rows"] = (limb.index("limb"), _np(rlk_s.data), _np(rlk_s.shoup))
    back = sh.gather(ctx, sh.shard_ciphertext(ctx, cts[0], limb), limb)
    key_back = sh.gather_relin_key(ctx, rlk_s, limb)
    # a mod switch on the shard from the top to the bottom, a row at a time
    dropped, want = sh.shard_ciphertext(ctx, cts[0], limb), cts[0]
    mod_drop = True
    while dropped.chain_index < bottom(ctx):
        dropped, want = ev.mod_drop_to_next(sctx, dropped), ev.mod_drop_to_next(ctx, want)
        got = sh.gather(ctx, dropped, limb)
        mod_drop &= torch.equal(got.data, want.data) and _meta(got) == _meta(want)
    out["shard gather"] = dict(
        ciphertext=torch.equal(back.data, cts[0].data) and _meta(back) == _meta(cts[0]),
        key=torch.equal(key_back.data, rlk.data) and torch.equal(key_back.shoup, rlk.shoup),
        mod_drop=mod_drop)

    # batch x limb: the stacked batch of BATCH ciphertexts
    sctx2 = le.LimbShardContext(ctx, batch_limb)
    b = sh.shard_ciphertext(ctx, stack_cts(cts[1:]), batch_limb, batched=True)
    r, counts = _counted(lambda: le.mul_relin_rescale(
        sctx2, b, b, sh.shard_relin_key(ctx, rlk, batch_limb)))
    whole = sh.gather(ctx, r, batch_limb, batched=True)
    out["batch x limb"] = (_np(whole.data), _meta(whole), counts)

    # the limb mesh, q32: rescale_composite
    qctx, qenc = context(special=Q32_COMPOSITE["special_count"], composite=Q32_COMPOSITE)
    drawn = eval_inputs(qctx, qenc, Q32_SECRET, Q32_INPUT, 1, Q32_SCALE) if first else None
    qrlk = sh.broadcast_relin_key(drawn[1] if first else None, qctx.device)
    qct = sh.broadcast_ciphertext(drawn[2][0] if first else None, qctx.device)
    qsctx = le.LimbShardContext(qctx, limb)
    qrlk_s = sh.shard_relin_key(qctx, qrlk, limb)
    for end, ci in (("top", 1), ("bottom", bottom(qctx, 2))):
        s = sh.shard_ciphertext(qctx, drop_to(qctx, qct, ci), limb)
        r, counts = _counted(lambda: le.mul_relin_rescale(qsctx, s, s, qrlk_s, 2))
        whole = sh.gather(qctx, r, limb)
        out[f"limb q32 {end}"] = (_np(whole.data), _meta(whole), counts)

    # the coeff mesh: rotate and relinearize, on both plans
    for suffix, c, e, scale in (("", ctx, enc, SCALE), (" q32", qctx, qenc, Q32_SCALE)):
        if first:
            sk, _, ccts, _ = eval_inputs(c, e, COEFF_SECRET, COEFF_INPUT, 1, scale)
            drawn = (sk.galois_key([COEFF_STEP]), sk.relin_key(), ccts[0])
        gk = sh.broadcast_galois_key(drawn[0] if first else None, c.device)
        crlk = sh.broadcast_relin_key(drawn[1] if first else None, c.device)
        cct = sh.broadcast_ciphertext(drawn[2] if first else None, c.device)
        s = ce.shard_ciphertext(cct, coeff)
        r, counts = _counted(lambda: ce.rotate_4step(c, s, COEFF_STEP,
                                                     ce.shard_galois_key(gk, coeff), coeff))
        out[f"coeff rotate{suffix}"] = (_np(ce.gather(r, coeff).data), counts)
        s = ce.shard_ciphertext(ev.multiply(c, cct, cct), coeff)
        r, counts = _counted(lambda: ce.relinearize_4step(c, s, ce.shard_key(crlk, coeff),
                                                          coeff))
        out[f"coeff relinearize{suffix}"] = (_np(ce.gather(r, coeff).data), counts)

    # the limb-sharded BSGS level: each rank makes the level's plaintexts alone
    for plan, name in (("u64", "bsgs level"), ("q32", "bsgs level q32")):
        bctx, benc = boot_context(plan)
        boot = boot_setup(bctx, benc, c2s_stage=0)
        drawn = boot_inputs(bctx, benc, boot) if first else None
        boot.galois_keys = sh.broadcast_galois_key(drawn[1] if first else None, bctx.device)
        bct = sh.broadcast_ciphertext(drawn[2] if first else None, bctx.device)
        r, counts = bs.bsgs_level_limb_sharded(boot, bct, BOOT_SLOTS, limb)
        whole = sh.gather(bctx, r, limb)
        out[name] = (_np(whole.data), _meta(whole), counts)
    return out


def relinearize_rank(rank: int, world: int, device: str = "cpu", n: int = N) -> bool:
    """A limb-sharded relinearize at ring size n on `device` in a world of
    `world` ranks, equal to the one-process relinearize (the blocked-import
    run of tests/test_torch_imports.py; on the card, the cuda-marked case
    of tests/test_torch_cuda.py)."""
    from tpu_fhe_torch.eval import evaluator as ev
    from tpu_fhe_torch.parallel import limb_eval as le, sharding as sh

    ctx, enc = context(EVAL_BITS, EVAL_SPECIAL, n=n, device=device)
    drawn = eval_inputs(ctx, enc, LIMB_SECRET, LIMB_INPUT, 1, SCALE) if rank == 0 else None
    rlk = sh.broadcast_relin_key(drawn[1] if rank == 0 else None, ctx.device)
    ct = sh.broadcast_ciphertext(drawn[2][0] if rank == 0 else None, ctx.device)
    prod = ev.multiply(ctx, ct, ct)
    mesh = sh.make_mesh(1, world)
    got = ev.relinearize(le.LimbShardContext(ctx, mesh), sh.shard_ciphertext(ctx, prod, mesh),
                         sh.shard_relin_key(ctx, rlk, mesh))
    return torch.equal(sh.gather(ctx, got, mesh).data, ev.relinearize(ctx, prod, rlk).data)


def relinearize_rank_blocked(rank: int, world: int) -> bool:
    """relinearize_rank in a rank where importing jax or tpu_fhe fails (a
    spawned rank starts a fresh interpreter: the block is set here, before
    the port is imported)."""
    import sys

    sys.modules["jax"] = None
    sys.modules["tpu_fhe"] = None
    ok = relinearize_rank(rank, world)
    loaded = [m for m in sys.modules if sys.modules[m] is not None
              and (m == "jax" or m.startswith(("jax.", "tpu_fhe.")))]
    return ok and not loaded
