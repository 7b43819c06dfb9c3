"""One hoisted bootstrap BSGS level with the limb axis sharded.

Port of ``tpu_fhe/parallel/boot_sharded.py``.  The bootstrap's time lies in
its hoisted CoeffsToSlots / SlotsToCoeffs BSGS levels; this runs one of
them -- the port's own ``CkksBootstrapper._bsgs_level``, not a copy of its
loop -- on a rank's view of the context (``limb_eval.LimbShardContext``):
the ciphertext's limbs, every switching key of the level
(``_keys_for``) and the level's QlP plaintexts cut to the rank's rows.
Through the evaluator's hooks each modup and moddown of the level is the
limb-sharded one (one all-gather each); everything else in the loop is
row-local.  The reference returns the collectives counted in its compiled
HLO; the port returns those it called (``collectives.diff``).
"""

from __future__ import annotations

import copy

from . import collectives as coll
from .limb_eval import LimbShardContext
from .sharding import Mesh, shard_ciphertext, shard_ext_plaintext, shard_relin_key


def bsgs_level_limb_sharded(boot, ct, slots: int, mesh: Mesh, stage: int = 0,
                            which: str = "c2s", sctx: LimbShardContext | None = None):
    """Run the `stage`-th hoisted C2S (or S2C) BSGS level of `boot` on this
    rank's shard of `ct`.  Every rank passes the same whole bootstrapper
    (set up, with its Galois keys) and ciphertext.  `sctx`, the rank's
    view of boot's context, is built when not given.  Returns (this rank's
    shard of the result, the collectives the level called: {kind: {"calls",
    "bytes"}}); ``sharding.gather`` gives the whole result, bit-identical to
    ``boot._bsgs_level`` on the same inputs."""
    ctx = boot.ctx
    sctx = sctx or LimbShardContext(ctx, mesh)
    plans = boot.c2s_stage_plans(slots) if which == "c2s" else boot.s2c_stage_plans(slots)
    si, rot_in, rot_out, b, g, num_rot, _ = plans[stage]
    pre = boot.precom[slots]
    A = (pre.a_c2s if which == "c2s" else pre.a_s2c)[si]
    keys = {elt: shard_relin_key(ctx, k, mesh)
            for elt, k in boot._keys_for(rot_in, rot_out).items()}
    A_s = [shard_ext_plaintext(ctx, pt, mesh) for pt in A]
    ct_s = shard_ciphertext(ctx, ct, mesh, batched=False)
    view = copy.copy(boot)          # the same bootstrapper on the rank's view
    view.ctx = sctx
    before = coll.counts()
    out = view._bsgs_level(ct_s, A_s, keys, rot_in, rot_out, b, g, num_rot)
    return out, coll.diff(coll.counts(), before)
