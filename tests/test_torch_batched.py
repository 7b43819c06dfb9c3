"""Channel batching in the port: ciphertexts stacked with stack_cts
((B, size, L, N) data) through the evaluation layer, the bootstrap and the
DNN layers, on both plans at N = 64 (tools/dnn_golden.py's stack: width 4,
the sparse sine set K = 28, r = 3, degree 44, level budget (2, 2)).

  * Every batched operation equals the same channels one at a time, bit for
    bit, chain index, scale and noise-scale degree included: CoeffsToSlots,
    EvalMod, the sparse and the dense bootstrap, Meta-BTS over a batch
    (which the reference, too, runs channel by channel), and the DNN's
    relu, sign, relu_composite and residual add with channel_batch 2
    against channel_batch 1; on the u64 plan, whose plain arithmetic is
    slower, CoeffsToSlots and the DNN's relu, sign and add.
  * The port's batched CoeffsToSlots, sine stage and relu_composite equal
    tpu_fhe's batched runs (its vmapped stage programs) on the same inputs
    and keys: tests/data/torch_batched_golden_{u64,q32}.npz, written by
    tools/batched_golden.py, holds a digest per (component, limb) of each
    channel.
  * DNN.channel_batch follows the reference's rule on a table of contexts,
    channel counts and forced values.
  * The batched plain key inner products (all four forms) equal a loop of
    the one-set version over the batch.

The inputs are the port's enc_tensor of the golden run's image "x2" under
the reference's secret, and the keys the port's keygen under it, as in
tests/test_torch_dnn.py.
"""

import functools
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpu_fhe_torch.boot.bootstrap import CkksBootstrapper
from tpu_fhe_torch.eval import auto
from tpu_fhe_torch.models.dnn import DNN, TensorCT, tensor_ct_to_np
from tpu_fhe_torch.ops import ks, modarith as mm
from tpu_fhe_torch.scheme.ciphertext import stack_cts, unstack_cts
from tpu_fhe_torch.utils.convert import secret_key_from_np

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DATA = Path(__file__).resolve().parent / "data"
_spec = importlib.util.spec_from_file_location("dnn_golden", ROOT / "tools" / "dnn_golden.py")
dg = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(dg)

PLANS = ("u64", "q32")
BATCH = 2
OPS = ("c2s", "eval_mod", "boot_sparse", "boot_dense", "meta_bts", "relu", "sign",
       "relu_composite", "add")
GOLDEN_OPS = {"c2s": "c2s", "eval_mod": "sine", "relu_composite": "relu_composite"}


@functools.lru_cache(maxsize=None)
def golden(plan):
    with np.load(DATA / f"torch_batched_golden_{plan}.npz") as f:
        arrays = {k: f[k] for k in f.files}
    return arrays, json.loads(str(arrays.pop("meta")))


@functools.lru_cache(maxsize=None)
def port(plan):
    """(ctx, enc, DNN, sparse bootstrapper, input key) of the golden run."""
    return dg.port_setup(plan, golden(plan)[0]["secret"])


@functools.lru_cache(maxsize=None)
def dense_boot(plan):
    ctx, enc, model, _, _ = port(plan)
    boot = CkksBootstrapper(ctx, enc)
    boot.set_sine_params(*dg.SINE)
    boot.setup(level_budget=dg.LEVEL_BUDGET, slots=ctx.n // 2)
    boot.keygen(secret_key_from_np(ctx, golden(plan)[0]["secret"], seed=dg.BOOT_KEY_SEED),
                ctx.n // 2)
    return boot


@functools.lru_cache(maxsize=None)
def channels(plan) -> tuple:
    """enc_tensor of "x2" (the input key's first draw): two channels at
    chain index 1, and the same two switched down to three logical levels
    (a bootstrap's input)."""
    ctx, _, model, _, sk = port(plan)
    cts = model.enc_tensor(dg.layer_inputs()["x2"], sk=sk).cts
    low = ctx.level(1).size // auto.composite_degree(ctx) - 3
    return tuple(cts), tuple(auto.mod_switch_level(ctx, c, low) for c in cts)


def run(plan, op, batch: int) -> list:
    """`op` on the two channels, as one stacked batch (batch 2) or one
    channel at a time (batch 1)."""
    ctx, enc, model, boot, sk = port(plan)
    fresh, low = channels(plan)
    if op in ("relu", "sign", "relu_composite", "add"):
        model = DNN(ctx, enc, channel_batch=batch)
        model.mul_key, model.gk = port(plan)[2].mul_key, port(plan)[2].gk
        t = TensorCT(list(fresh), dg.WIDTH)
        out = {"relu": lambda: model.relu(t, -1.0, 1.0, 15),
               "sign": lambda: model.sign(t, 0),
               "relu_composite": lambda: model.relu_composite(t, boot),
               "add": lambda: model.add(t, model.batch_norm(t, *dg.layer_consts()["bn"]))}[op]()
        return out.cts
    fns = {"c2s": lambda c: boot.coeffs_to_slots(c, dg.SLOTS),
           "eval_mod": boot.eval_mod,
           "boot_sparse": lambda c: boot.eval_bootstrap(c, dg.SLOTS),
           "boot_dense": lambda c: dense_boot(plan).eval_bootstrap(c),
           "meta_bts": lambda c: boot.eval_bootstrap(c, dg.SLOTS, 2, 12)}
    inputs = {"c2s": [auto.mod_switch_level(ctx, c, 1) for c in fresh],
              "eval_mod": list(fresh)}.get(op, list(low))
    if batch == 1:
        return [fns[op](c) for c in inputs]
    out = fns[op](stack_cts(inputs))
    assert out.data.shape[0] == BATCH
    return unstack_cts(out, BATCH)


@functools.lru_cache(maxsize=None)
def result(plan, op, batch: int) -> tuple:
    return tuple(run(plan, op, batch))


def meta(c) -> tuple:
    return (c.chain_index, c.scale, c.noise_scale_deg, c.correction_factor, c.is_ntt_form,
            c.is_asymmetric)


# The u64 plan's plain modular arithmetic is about six times the q32 plan's
# on a CPU: its bootstraps and EvalMod run batched only (EvalMod and
# relu_composite against the reference's batched runs), the q32 plan's
# both ways.
PER_CHANNEL_CASES = [("q32", op) for op in OPS] + [
    ("u64", op) for op in ("c2s", "relu", "sign", "add")]


@pytest.mark.parametrize("plan,op", PER_CHANNEL_CASES)
def test_batched_equals_per_channel(plan, op):
    got, want = result(plan, op, BATCH), result(plan, op, 1)
    assert len(got) == len(want) == BATCH
    for g, w in zip(got, want):
        assert g.data.shape == w.data.shape
        assert torch.equal(g.data, w.data)
        assert meta(g) == meta(w)
    if op.startswith("boot") or op == "meta_bts":
        assert got[0].chain_index < channels(plan)[1][0].chain_index   # not the input back


@pytest.mark.parametrize("plan,op", [(p, o) for p in PLANS for o in GOLDEN_OPS])
def test_batched_equals_reference_batched(plan, op):
    """The port's batched run against tpu_fhe's vmapped one: per channel the
    metadata, every (component, limb) digest and the decoded values."""
    rec = golden(plan)[1]["cases"][GOLDEN_OPS[op]]
    _, _, model, _, sk = port(plan)
    got = TensorCT(list(result(plan, op, BATCH)), dg.WIDTH)
    data, metas, _, _ = tensor_ct_to_np(got)
    assert metas == rec["channels"]
    for c, (d, want) in enumerate(zip(data, rec["digests"])):
        bad = [i for i, (a, b) in enumerate(zip(dg.limb_digests(d), want)) if a != b]
        assert not bad, f"channel {c}: rows that differ: {bad}"
    np.testing.assert_allclose(model.dec_tensor(got, sk), rec["decoded"], rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("plan", PLANS)
def test_keys_are_the_golden_keys(plan):
    _, _, model, boot, _ = port(plan)
    assert dg.port_key_digest(model, boot) == golden(plan)[1]["key_digest"]


# (N, size of chain index 1, size_P, channels, forced value)
BATCH_CASES = [(64, 21, 3, 2, None), (64, 21, 3, 16, None), (64, 21, 3, 128, None),
               (1 << 16, 60, 30, 16, None), (1 << 16, 60, 30, 64, None),
               (1 << 16, 26, 13, 16, None), (1 << 15, 30, 15, 3, None),
               (1 << 16, 60, 30, 16, 4), (1 << 16, 60, 30, 16, 0), (1 << 16, 60, 30, 2, 8),
               (1 << 16, 60, 30, 16, 1), (1 << 17, 90, 45, 32, None)]


@pytest.mark.parametrize("case", BATCH_CASES)
def test_channel_batch_is_the_reference_rule(case, monkeypatch):
    """DNN.channel_batch on the CPU (the reference's 2500 MB budget) and
    with a forced value equals tpu_fhe's DNN.channel_batch on a context of
    the same N and limb counts (its TPU_FHE_DNN_BATCH forcing the value)."""
    from tpu_fhe.models.dnn import DNN as JDNN

    n, size, size_p, n_ch, forced = case
    ctx = SimpleNamespace(n=n, params=SimpleNamespace(size_P=size_p),
                          level=lambda ci: SimpleNamespace(size=size),
                          device=torch.device("cpu"))
    if forced is None:
        monkeypatch.delenv("TPU_FHE_DNN_BATCH", raising=False)
    else:
        monkeypatch.setenv("TPU_FHE_DNN_BATCH", str(forced))
    monkeypatch.delenv("TPU_FHE_DNN_BATCH_MB", raising=False)
    want = JDNN.channel_batch(SimpleNamespace(ctx=ctx), n_ch)
    model = DNN.__new__(DNN)
    model.ctx, model.forced_batch = ctx, forced
    assert model.channel_batch(n_ch) == want


@pytest.mark.parametrize("form", ["k7", "k8", "k9", "k10"])
def test_batched_plain_inner_products_loop_the_one_set_version(form):
    """The plain versions on t (B, beta, L, N) equal a loop of the one-set
    call over the batch, for every form."""
    ctx = port("q32" if form in ("k9", "k10") else "u64")[0]
    kst, kq = ctx.level(1).ks, ctx.key_level.mod
    qlp, rows = kst.qlp_mod, kst.qlp_key_rows
    g = torch.Generator().manual_seed(3)
    dnum = -(-ctx.params.size_Q // ctx.params.size_P)

    def res(q, *lead):
        x = torch.randint(0, 1 << 62, lead + (q.shape[0], ctx.n), generator=g)
        return (x % q.to(torch.int64)).to(q.dtype)

    evk = res(kq.q, dnum, 2)
    t = res(qlp.q, 3, kst.beta)
    fn, args = {
        "k7": (ks.key_inner_prod, (evk, rows, qlp.q, qlp.ratio_lo, qlp.ratio_hi)),
        "k9": (ks.key_inner_prod32, (evk, rows, qlp.q, qlp.fold)),
        "k8": (ks.key_inner_prod_shoup,
               (evk, mm.shoup_of(evk, kq.q, kq.ratio_lo, kq.ratio_hi), rows, qlp.q)),
        "k10": (ks.key_inner_prod_shoup, (evk, mm.shoup32_of(evk, kq.q), rows, qlp.q)),
    }[form]
    got = fn(t, *args)
    assert got.shape == (3, 2) + tuple(t.shape[-2:])
    assert torch.equal(got, torch.stack([fn(t[b], *args) for b in range(3)]))
    with pytest.raises(ValueError, match="t must be"):
        fn(t[None], *args)
