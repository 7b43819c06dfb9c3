"""The port's sharded paths (tpu_fhe_torch/parallel/) in one world of 4
gloo ranks on the CPU, bit for bit against the reference's sharded
functions and against the port's one-process path.

One world runs every case (tests/torch_parallel_ranks.py rank_main: the
module imports torch and the port alone, so the ranks never import JAX);
the rendezvous is a file under tmp_path.  Its results are held, without
tolerance, against tests/data/torch_parallel_golden.npz (the reference's
``tpu_fhe/parallel`` functions on its 8-device CPU mesh at its own tests'
fixtures, with the port's inputs injected: tools/parallel_golden.py) and
against the same cases through the port in this process.  Every case went
through the reference; the cases it refused, and the reason each gave, are
pinned in REFUSED, so that a refusal the golden tool did not expect fails
here instead of leaving a case held against the port alone.  The
slow-marked test runs the reference live instead of reading the file.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_ranks as R  # noqa: E402

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_parallel_golden.npz"
NTT_CASES = [(plan, n1) for plan in R.NTT_BITS for n1 in R.NTT_SPLITS]
LIMB_CASES = ["limb u64 top", "limb u64 bottom", "limb q32 top", "limb q32 bottom"]
# the cases the reference's sharded functions refuse, and a piece of the
# reason each gives (tools/parallel_golden.py records the whole text).  A
# limb case whose rows do not divide over 8 devices is refused on 1 x 8 and
# then run on the widest limb mesh that divides them (LIMB_MESH).
ROWS = "should be divisible by 8, but it is equal to {}"
REFUSED = {
    "limb u64 bottom on 1 x 8": ROWS.format(2),
    "limb q32 top on 1 x 8": ROWS.format(10),
    "limb q32 bottom on 1 x 8": ROWS.format(3),
    # the q32 level's 30 rows over 2 x 4; it runs on 2 x 3 (BSGS_MESH)
    "bsgs level q32 on 2 x 4": "should be divisible by 4, but it is equal to 30",
}
BSGS_MESH = {"bsgs level": "2 x 4", "bsgs level q32": "2 x 3"}
LIMB_MESH = {"limb u64 top": "1 x 8", "limb u64 bottom": "1 x 2", "limb q32 top": "1 x 5",
             "limb q32 bottom": "1 x 3"}
# the collectives each path calls, per rank (the design's counts)
LIMB_COUNTS = {"all_gather": 2, "broadcast": 1}
BROADCASTS = {"limb q32 top": 2}      # the dropped pair straddles two ranks' blocks


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from tpu_fhe_torch.parallel.sharding import run_ranks

    init = tmp_path_factory.mktemp("rendezvous") / "init"
    return run_ranks(R.rank_main, R.WORLD, init_file=str(init), timeout_s=300)


@pytest.fixture(scope="module")
def one():
    return R.one_process()


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as f:
        arrays = {k: f[k] for k in f.files if k != "meta"}
        meta = json.loads(str(f["meta"]))
    return arrays, meta


def _u64(a):
    return np.asarray(a).astype(np.uint64)


def _calls(counts: dict) -> dict:
    return {kind: e["calls"] for kind, e in counts.items()}


def _meta(meta: tuple) -> list:
    return [meta[0], meta[1], meta[2]]


def _hold(name, got, one_np, golden, meta=None):
    """got equals the one-process result and, where the reference accepted
    the case, the golden array (and metadata); a case the reference refused
    is one of REFUSED, refused for its reason."""
    arrays, gmeta = golden
    np.testing.assert_array_equal(_u64(got), _u64(one_np))
    if name in REFUSED:
        assert name not in arrays
        assert REFUSED[name] in gmeta["refused"][name]
        return
    np.testing.assert_array_equal(_u64(got), arrays[name])
    if meta is not None:
        assert _meta(meta) == gmeta["meta"][name][:3]


def test_the_reference_refused_the_pinned_cases_alone(golden):
    arrays, gmeta = golden
    assert set(gmeta["refused"]) == set(REFUSED)
    for name, why in REFUSED.items():
        assert why in gmeta["refused"][name]
        assert name not in arrays
    assert set(LIMB_MESH) | set(BSGS_MESH) <= set(arrays)


@pytest.mark.parametrize("plan,n1", NTT_CASES)
@pytest.mark.parametrize("what", ["forward", "inverse", "round trip"])
def test_ntt_4step(world, one, golden, plan, n1, what):
    _, x = R.ntt_inputs(plan)
    for res in world:
        got = res[f"ntt {plan} n1={n1}"]
        fwd_counts, inv_counts = got["counts"]
        assert _calls(fwd_counts) == {"all_to_all": 1}
        assert _calls(inv_counts) == {"all_to_all": 1}
        if what == "forward":
            _hold(f"ntt {plan} forward n1={n1}", got["forward"], one[f"ntt {plan} forward"],
                  golden)
        elif what == "inverse":
            _hold(f"ntt {plan} inverse n1={n1}", got["inverse"], one[f"ntt {plan} inverse"],
                  golden)
        else:
            np.testing.assert_array_equal(_u64(got["inverse"]), _u64(x.numpy()))


@pytest.mark.parametrize("case", LIMB_CASES)
def test_limb_mesh_mul_relin_rescale(world, one, golden, case):
    """1 x 4 limb mesh: 8 Q limbs (3 rows a rank and padding on q32, P
    padded on every rank but the first) at both ends of the chain."""
    assert golden[1]["meta"][case][3] == LIMB_MESH[case]
    for res in world:
        data, meta, counts = res[case]
        assert meta == one[case][1]
        _hold(case, data, one[case][0], golden, meta)
        assert _calls(counts) == dict(LIMB_COUNTS, broadcast=BROADCASTS.get(case, 1))


def test_batch_limb_mesh(world, one, golden):
    for res in world:
        data, meta, counts = res["batch x limb"]
        assert meta == one["batch x limb"][1]
        _hold("batch x limb", data, one["batch x limb"][0], golden, meta)
        assert _calls(counts) == LIMB_COUNTS


def test_batch_limb_mesh_decrypts(world):
    """Each ciphertext of the gathered batch decrypts within 1e-3 of x^2."""
    from tpu_fhe_torch.utils.convert import ciphertext_from_np

    ctx, enc = R.context(R.EVAL_BITS, R.EVAL_SPECIAL)
    sk, _, _, xs = R.eval_inputs(ctx, enc, R.LIMB_SECRET, R.LIMB_INPUT, 1 + R.BATCH, R.SCALE)
    data, (ci, scale, deg), _ = world[0]["batch x limb"]
    for i, x in enumerate(xs[1:]):
        ct = ciphertext_from_np(ctx, data[i], ci, scale, deg)
        got = enc.decode(sk.decrypt(ct)).real
        np.testing.assert_allclose(got, x * x, atol=1e-3)


@pytest.mark.parametrize("case", ["coeff rotate", "coeff relinearize", "coeff rotate q32",
                                  "coeff relinearize q32"])
def test_coeff_mesh(world, one, golden, case):
    """1 x 4 coeff mesh: one all-to-all a transform (the iNTT of modup, its
    forward NTT per digit -- 8 digits of 1 limb on u64, 4 of up to 3 on
    q32 -- and moddown's two), and the rotation's one all-gather."""
    digits = 4 if case.endswith("q32") else 8
    want = {"all_to_all": digits + 3,
            **({"all_gather": 1} if case.startswith("coeff rotate") else {})}
    for res in world:
        data, counts = res[case]
        _hold(case, data, one[case], golden)
        assert _calls(counts) == want


@pytest.mark.parametrize("case", ["bsgs level", "bsgs level q32"])
def test_bsgs_level(world, one, golden, case):
    """C2S level 0 of a bootstrap (u64 21 + 3 limbs; q32 32 + 4),
    limb-sharded: one all-gather a modup and a moddown, no other
    collective."""
    for res in world:
        data, meta, counts = res[case]
        assert meta == one[case][1]
        _hold(case, data, one[case][0], golden)
        assert _meta(meta) == [golden[1]["meta"][case][k]
                               for k in ("chain_index", "scale", "noise_scale_deg")]
        assert _calls(counts) == {"all_gather": 5}
    assert golden[1]["meta"][case]["mesh"] == BSGS_MESH[case]


@pytest.mark.parametrize("what", ["ciphertext", "key", "mod_drop"])
def test_shard_then_gather_is_whole(world, what):
    """shard -> gather == whole for a ciphertext and a key, and a mod switch
    on the shard from the top of the chain to its bottom equal, level by
    level, to the one-process mod switch."""
    assert all(res["shard gather"][what] for res in world)


def test_limb_shard_view_names_what_it_lacks():
    """A rank's view cuts a level to its block; a context attribute it does
    not provide raises an AttributeError that says so (built without a
    process group: no collective runs)."""
    from tpu_fhe_torch.parallel.limb_eval import LimbShardContext
    from tpu_fhe_torch.parallel.sharding import Mesh

    ctx, _ = R.context(R.EVAL_BITS, R.EVAL_SPECIAL)
    mesh = Mesh(axis_names=("batch", "limb"), shape={"batch": 1, "limb": R.WORLD},
                coords={"batch": 0, "limb": 1}, groups={}, group_ranks={}, backend="gloo")
    view = LimbShardContext(ctx, mesh)
    level = view.level(1)
    assert (level.size, len(level.base)) == (2, ctx.level(1).size)
    assert level.limb_indices == (2, 3)
    with pytest.raises(AttributeError, match="limb-sharded view of a context has no 'ntt_view'"):
        view.ntt_view


@pytest.mark.parametrize("plan", ["u64", "q32"])
def test_setup_of_one_c2s_stage(plan):
    """setup(c2s_stage=0), which each rank runs, makes that level's
    plaintexts equal to the whole setup's, and no S2C plaintexts."""
    ctx, enc = R.boot_context(plan)
    whole, part = R.boot_setup(ctx, enc), R.boot_setup(ctx, enc, c2s_stage=0)
    si = whole.c2s_stage_plans(R.BOOT_SLOTS)[0][0]
    want, got = whole.precom[R.BOOT_SLOTS], part.precom[R.BOOT_SLOTS]
    assert got.a_s2c is None
    for s, stage in enumerate(got.a_c2s):
        if s != si:
            assert all(pt is None for pt in stage)
    assert len(got.a_c2s[si]) == len(want.a_c2s[si])
    for a, b in zip(got.a_c2s[si], want.a_c2s[si]):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a.data, b.data)
            assert (a.chain_index, a.scale) == (b.chain_index, b.scale)


def test_every_rank_holds_the_one_process_key_rows(world, one):
    """Rank r's relin-key shard is its Q block and P block of the key the
    one-process path draws from the same seed (rank 0 drew it once and
    broadcast it)."""
    data, shoup = one["relin key"]
    ctx, _ = R.context(R.EVAL_BITS, R.EVAL_SPECIAL)
    size_q, size_p = ctx.params.size_Q, ctx.params.size_P
    bq, bp = -(-size_q // R.WORLD), -(-size_p // R.WORLD)
    seen = set()
    for res in world:
        r, got, got_shoup = res["key rows"]
        seen.add(r)
        for full, part in ((data, got), (shoup, got_shoup)):
            want = np.zeros(full.shape[:2] + (bq + bp, full.shape[-1]), dtype=full.dtype)
            q_rows = full[:, :, r * bq:min((r + 1) * bq, size_q)]
            p_rows = full[:, :, size_q + r * bp:size_q + min((r + 1) * bp, size_p)]
            want[:, :, :q_rows.shape[2]] = q_rows
            want[:, :, bq:bq + p_rows.shape[2]] = p_rows
            np.testing.assert_array_equal(part, want)
    assert seen == set(range(R.WORLD))


@pytest.mark.slow
def test_against_the_live_reference(world):
    """The same cases through the reference's sharded functions now (about
    four minutes), not through the golden file."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    import parallel_golden

    arrays, meta = parallel_golden.reference_cases()
    assert set(meta["refused"]) == set(REFUSED)
    res = world[0]
    for name, want in arrays.items():
        if name.startswith("ntt"):
            _, plan, what, n1 = name.split()
            got = res[f"ntt {plan} {n1}"][what]
        else:
            got = res[name][0]
        np.testing.assert_array_equal(_u64(got), want)
