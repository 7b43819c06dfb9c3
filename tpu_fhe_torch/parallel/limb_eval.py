"""The CKKS keyswitch and rescale with the limb axis sharded over a mesh.

Counterpart of the reference evaluator's mesh branches
(``tpu_fhe/eval/evaluator.py:203-320``: ``_limb_mesh_active``,
``_replicate_mesh``, ``_mesh_modup_tables``, ``_modup_mesh``) and of the
collectives its partitioner inserts around them, as explicit SPMD.

A ``LimbShardContext`` is one rank's view of a context under a mesh with a
'limb' axis: its ``level(i)`` is a ``ContextLevel`` whose every per-limb
table is cut to the rank's rows (``sharding.owned``: a Q block of bq rows
and a P block of bp rows, pad slots included), so the evaluator's
row-local functions run on a shard unchanged: multiply, add, the
plaintext ops, the inner product (K7-K10 on the rank's QlP rows, with the
key's shard, no collective), and hoisting's QlP sums.  At a pad slot every
table holds the modulus of Q row 0 (or P row 0) and every scale that lands
a result (the iNTT's digit scale, the moddown and rescale landings, P mod
q) is 0, so pad rows stay zero.

The evaluator hands a call on a ``LimbShardContext`` to its methods here
(``ctx.limb_shard``) at the four places where rows cross ranks:

  * ``modup``: the scaled iNTT (K2/K5) on the rank's own Ql rows, then one
    all-gather of the scaled (Ql, N) block (``_replicate_mesh``); per digit
    a conversion (K12/K13) into the rank's own QlP rows with the digit's
    own rows and the pad rows zero in the table (``_mesh_modup_tables``,
    cut to the rank's rows), the forward NTT (K1/K4) of those rows and a
    select of the digit's own rows from the input (``_modup_mesh``);
  * ``moddown_from_ntt``: the scaled iNTT of the rank's P rows, one
    all-gather of the scaled P block, a conversion into the rank's own Ql
    rows and the landing (K3/K6);
  * ``drop_limbs``, what ``rescale_to_next`` and ``rescale_composite`` read
    of the limbs they drop: the owner of the dropped limb (or each owner of
    the dropped limbs; one when they share a block) transforms it back and
    sends it to the others in one broadcast, and every rank lands all its
    rows, the dropped ones with a landing scale of 0.  The rescale's
    arithmetic is the evaluator's own;
  * ``mod_drop_to_next``: the owner zeroes the dropped row, which becomes
    a pad slot (no collective).

Ownership is fixed against the top of the chain (``sharding.owned``), so a
dropped limb leaves its slot as a pad slot and no rank's block changes.  A
multiply, relinearize and rescale thus costs 2 all-gathers and 1
broadcast.  A context attribute that the view does not provide (the
context's NTT views, its keys' tables, ...) raises an AttributeError that
says so.  CKKS only; BFV's coefficient-form keyswitch and BGV's
t-preserving moddown are not sharded (the reference shards neither).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..eval import evaluator as ev
from ..ops.bconv import digit_matrix, digit_matrix32
from ..ops.ntt import (DeviceNTTTables, forward_ntt, forward_ntt_sub_scale, inverse_ntt,
                       inverse_ntt_scaled)
from ..scheme.ciphertext import Ciphertext
from ..scheme.context import ContextLevel, FheContext, ModulusVec, SchemeType
from . import collectives as coll
from .sharding import Mesh, block, gather_rows, owned


def _rows(mv: ModulusVec, idx: torch.Tensor) -> ModulusVec:
    return ModulusVec(mv.q[idx], mv.ratio_lo[idx], mv.ratio_hi[idx],
                      None if mv.fold is None else mv.fold[:, idx])


def _cat(a: ModulusVec, b: ModulusVec) -> ModulusVec:
    return ModulusVec(torch.cat([a.q, b.q]), torch.cat([a.ratio_lo, b.ratio_lo]),
                      torch.cat([a.ratio_hi, b.ratio_hi]),
                      None if a.fold is None else torch.cat([a.fold, b.fold], dim=1))


@dataclass(frozen=True)
class ShardTables:
    """What the sharded keyswitch adds to a level's local tables: the NTT
    tables of the rank's QlP rows, and per digit the conversion table into
    those rows (zero at the digit's own rows and at pad rows), its digit
    matrix and the mask of the digit's own rows."""

    qlp_ntt: DeviceNTTTables
    modup: tuple


class LimbShardContext:
    """One rank's view of `ctx` under the 'limb' axis of `mesh` (see the
    module's docstring).  Levels are built at first use; a level's ``base``
    stays its whole Ql base, its ``size`` is the rank's block."""

    # what the evaluator, hoisting and _bsgs_level read of a context
    PROVIDED = ("n", "params", "device", "chain", "q_values", "level",
                "composite_rescale_tables", "limb_shard")

    def __init__(self, ctx: FheContext, mesh: Mesh):
        if ctx.scheme != SchemeType.ckks:
            raise ValueError("the limb-sharded path is CKKS only")
        self.full = ctx
        self.mesh = mesh
        self.limb_shard = self          # what the evaluator's hooks look for
        p = ctx.params
        self.bq = block(p.size_Q, mesh.size("limb"))
        self.bp = block(p.size_P, mesh.size("limb"))
        self._levels: dict = {}
        self._composite: dict = {}

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        raise AttributeError(f"a limb-sharded view of a context has no {name!r}: it provides "
                             f"{', '.join(self.PROVIDED)}, and the evaluator's functions that "
                             "read more are not sharded")

    # -- what the evaluator, hoisting and _bsgs_level read of a context ---
    @property
    def n(self) -> int:
        return self.full.n

    @property
    def chain(self) -> list[ContextLevel]:
        """The whole chain (its length bounds the rescales)."""
        return self.full.chain

    @property
    def q_values(self) -> list[int]:
        return self.full.q_values

    @property
    def params(self):
        return self.full.params

    @property
    def device(self):
        return self.full.device

    def level(self, chain_index: int) -> ContextLevel:
        return self._built(chain_index)[0]

    def tables(self, chain_index: int) -> ShardTables:
        return self._built(chain_index)[1]

    def composite_rescale_tables(self, chain_index: int, limbs: int):
        """The context's tables of rescale_composite, the per-limb ones at
        the rank's slots of the next level (0 at the others); no NTT tables
        of the dropped limbs (drop_limbs transforms them)."""
        key = (chain_index, limbs)
        got = self._composite.get(key)
        if got is None:
            _, inv, inv_shoup, half_mod = self.full.composite_rescale_tables(chain_index, limbs)
            rows_now = self.full.level(chain_index).size - limbs
            got = (None, *(self._landing(col, rows_now) for col in (inv, inv_shoup, half_mod)))
            self._composite[key] = got
        return got

    # -- the local tables ------------------------------------------------
    def _slots(self, size_ql: int):
        p = self.params
        return owned(p.size_Q, size_ql, self.mesh), owned(p.size_P, p.size_P, self.mesh)

    def _index(self, slots) -> tuple[torch.Tensor, torch.Tensor]:
        dev = self.device
        idx = torch.tensor([0 if g is None else g for g in slots], dtype=torch.int64, device=dev)
        real = torch.tensor([g is not None for g in slots], device=dev).reshape(-1, 1)
        return idx, real

    def _built(self, chain_index: int):
        got = self._levels.get(chain_index)
        if got is not None:
            return got
        if chain_index < 1:
            raise ValueError("the key level has no sharded view")
        ctx, p = self.full, self.params
        lv = ctx.level(chain_index)
        ks = lv.ks
        size_ql = lv.size
        q_slots, p_slots = self._slots(size_ql)
        qi, qreal = self._index(q_slots)
        pi, preal = self._index(p_slots)

        def zeroed(col, idx, real):
            return torch.where(real, col[idx], torch.zeros_like(col[idx]))

        diag = digit_matrix32 if ctx.is_q32 else digit_matrix
        mod, p_mod = _rows(lv.mod, qi), _rows(ks.p_mod, pi)
        key_q = qi.tolist()
        key_p = [p.size_Q + j for j in pi.tolist()]
        p_hat_mod_q = zeroed(ks.p_hat_mod_q, qi, qreal)
        local_ks = replace(
            ks, alpha=self.bp,
            part_qhatinv=zeroed(ks.part_qhatinv, qi, qreal),
            part_qhatinv_shoup=zeroed(ks.part_qhatinv_shoup, qi, qreal),
            qlp_mod=_cat(mod, p_mod),
            qlp_key_rows=torch.arange(self.bq + self.bp, dtype=torch.int64, device=self.device),
            p_hatinv=zeroed(ks.p_hatinv, pi, preal),
            p_hatinv_shoup=zeroed(ks.p_hatinv_shoup, pi, preal),
            p_hat_mod_q=p_hat_mod_q, p_hat_mod_q_diag=diag(p_hat_mod_q),
            p_mod=p_mod, p_ntt=ctx.key_ntt.slice_limbs(key_p),
            big_pinv_mod_q=zeroed(ks.big_pinv_mod_q, qi, qreal),
            big_pinv_mod_q_shoup=zeroed(ks.big_pinv_mod_q_shoup, qi, qreal),
            big_p_mod_q=zeroed(ks.big_p_mod_q, qi, qreal),
            big_p_mod_q_shoup=zeroed(ks.big_p_mod_q_shoup, qi, qreal))
        # limb_indices: the global Q row of each slot, -1 at a pad slot
        inv_last = [None if col is None else self._landing(col, size_ql - 1)
                    for col in (lv.inv_q_last_mod_q, lv.inv_q_last_mod_q_shoup)]
        local = replace(lv, limb_indices=tuple(-1 if g is None else g for g in q_slots),
                        mod=mod, ntt=ctx.key_ntt.slice_limbs(key_q), inv_q_last_mod_q=inv_last[0],
                        inv_q_last_mod_q_shoup=inv_last[1], ks=local_ks)

        modup = []
        for dt in ks.digits:
            alpha = dt.end - dt.start
            # QlP row -> row of the digit's complement table (_mesh_modup_tables)
            src = [None if g is None or dt.start <= g < dt.end
                   else (g if g < dt.start else g - alpha) for g in q_slots]
            src += [None if j is None else size_ql - alpha + j for j in p_slots]
            si, sreal = self._index(src)
            table = zeroed(dt.qhat_mod_p, si, sreal)
            own = torch.tensor([g is not None and dt.start <= g < dt.end for g in q_slots]
                               + [False] * self.bp, device=self.device).reshape(-1, 1)
            modup.append((table, diag(table), own))
        tables = ShardTables(qlp_ntt=ctx.key_ntt.slice_limbs(key_q + key_p), modup=tuple(modup))
        self._levels[chain_index] = (local, tables)
        return local, tables

    # -- the keyswitch's two ends (reached through the evaluator) --------
    def modup(self, level: ContextLevel, c2: torch.Tensor, *, is_ntt: bool = True) -> torch.Tensor:
        """(..., bq, N) NTT-form shard -> (..., beta, bq + bp, N): the
        digits at the rank's QlP rows."""
        if not is_ntt:
            raise ValueError("the limb-sharded modup takes NTT-form input (CKKS)")
        ks = level.ks
        tabs = self.tables(level.chain_index)
        scaled = inverse_ntt_scaled(c2, level.ntt, ks.part_qhatinv, ks.part_qhatinv_shoup)
        whole = gather_rows(scaled, self.full.level(level.chain_index).size, self.mesh)
        own_ext = torch.cat([c2, c2.new_zeros(c2.shape[:-2] + (self.bp, c2.shape[-1]))], dim=-2)
        digits = []
        for dt, (table, diag, own) in zip(ks.digits, tabs.modup):
            conv = ev._bconv(whole[..., dt.start:dt.end, :].contiguous(), table, diag, ks.qlp_mod)
            digits.append(torch.where(own, own_ext, forward_ntt(conv, tabs.qlp_ntt)))
        return torch.stack(digits, dim=-3)

    def moddown_from_ntt(self, level: ContextLevel, cx: torch.Tensor, *,
                         output_ntt: bool = True) -> torch.Tensor:
        """(..., bq + bp, N) NTT form -> (..., bq, N): the P rows' scaled
        iNTT, one all-gather of them, the conversion into the rank's Ql rows
        and the landing."""
        if not output_ntt:
            raise ValueError("the limb-sharded moddown gives NTT-form output (CKKS)")
        ks = level.ks
        bq = self.bq
        scaled = inverse_ntt_scaled(cx[..., bq:, :].contiguous(), ks.p_ntt, ks.p_hatinv,
                                    ks.p_hatinv_shoup)
        whole_p = gather_rows(scaled, self.params.size_P, self.mesh)
        delta = ev._bconv(whole_p, ks.p_hat_mod_q, ks.p_hat_mod_q_diag, level.mod)
        return forward_ntt_sub_scale(delta, cx[..., :bq, :].contiguous(), level.ntt,
                                     ks.big_pinv_mod_q, ks.big_pinv_mod_q_shoup)

    # -- the rescale's and the mod switch's rows -------------------------
    def drop_limbs(self, level: ContextLevel, data: torch.Tensor, limbs: int):
        """ev._drop_limbs on a shard: the moduli of the dropped limbs, their
        coefficient form on every rank (``_dropped``), and every row of the
        shard, since a dropped row's landing scale is 0."""
        size = len(level.base)
        keep = size - limbs
        whole = self.full.level(level.chain_index)
        return whole.mod.rows(slice(keep, size)), self._dropped(data, list(range(keep, size))), \
            data

    def mod_drop_to_next(self, a: Ciphertext) -> Ciphertext:
        """ev.mod_drop_to_next on a shard: the dropped row's slot becomes a
        pad slot, zeroed by its owner."""
        _, real = self._index(self._slots(self.full.level(a.chain_index + 1).size)[0])
        return replace(a, data=torch.where(real, a.data, torch.zeros_like(a.data)),
                       chain_index=a.chain_index + 1)

    def _dropped(self, data: torch.Tensor, rows: list[int]) -> torch.Tensor:
        """The coefficient form of the global Q rows `rows` (the dropped
        limbs) on every rank: each owner transforms its own and sends them
        in one broadcast.  -> (..., len(rows), N)."""
        parts = []
        for owner in sorted({g // self.bq for g in rows}):
            mine = [g for g in rows if g // self.bq == owner]
            slot = mine[0] - owner * self.bq
            if owner == self.mesh.index("limb"):
                view = self.full.ntt_view(self.full.key_ntt, tuple(mine))
                part = inverse_ntt(data[..., slot:slot + len(mine), :].contiguous(), view)
            else:
                part = data.new_empty(data.shape[:-2] + (len(mine), data.shape[-1]))
            parts.append(coll.broadcast(part, self.mesh, "limb", owner))
        return torch.cat(parts, dim=-2)

    def _landing(self, col: torch.Tensor, rows_now: int) -> torch.Tensor:
        """A per-limb (k, 1) constant of the rows 0 .. rows_now - 1 at the
        rank's slots, 0 at the others."""
        idx, real = self._index(self._slots(rows_now)[0])
        return torch.where(real, col[idx], torch.zeros_like(col[idx]))


def mul_relin_rescale(sctx: LimbShardContext, a: Ciphertext, b: Ciphertext, rlk,
                      rescale_limbs: int = 1) -> Ciphertext:
    """multiply -> relinearize -> rescale on shards (rescale_composite by
    `rescale_limbs` on a q32 context): 2 all-gathers and 1 broadcast."""
    prod = ev.relinearize(sctx, ev.multiply(sctx, a, b), rlk)
    return ev.rescale_composite(sctx, prod, rescale_limbs)
