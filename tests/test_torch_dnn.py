"""The port's DNN layer library (tpu_fhe_torch/models/dnn.py) against
tpu_fhe's, bit for bit per RNS limb, on both plans at N = 64.

tpu_fhe's layers run eagerly on a CPU at seconds to minutes per layer (its
own tests/test_dnn.py takes minutes), so their results come from golden
files, tests/data/torch_dnn_golden_{u64,q32}.npz, which tools/dnn_golden.py
writes from live runs of tpu_fhe's DNN: N = 64, width 4, the sparse sine
set K = 28, r = 3, degree 44, level budget (2, 2), on the u64 plan of
examples/resnet20_infer.py --demo and its --q32 plan.  The file holds the
reference's secret key, each case's input tensors, and its output as a
digest per (component, limb) of each channel with the metadata and the
decoded values.

The port makes its keys with its own keygen under the reference's secret
from the seeds the golden run used (a digest holds them equal to the keys
the reference ran with) and encrypts its inputs with enc_tensor.  Then
every case of the tool's LAYER_CASES -- conv at stride 1 and 2 on both
encode paths (and on an input at noise-scale degree 2, on a strided input,
with pruned weights, and with a weight past the device-encode path's
fixed-point range, where the port falls back to host encoding), batch norm,
the residual add, the Chebyshev ReLU, a sign stage, softmax, the average
pool with the fully connected layer and the sign-composite ReLU with its
three bootstraps -- must equal the reference's on the same input, with the
same chain index, scale and noise-scale degree."""

import functools
import importlib.util
import json
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_fhe_torch.models.dnn import (TensorCT, relu_composite_clear, tensor_ct_from_np,
                                      tensor_ct_to_np)
from tpu_fhe_torch.scheme.ciphertext import stack_cts, unstack_cts
from tpu_fhe_torch.utils import timer
from tpu_fhe_torch.utils.convert import secret_key_from_np

# The suite runs in several worker processes at once: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DATA = Path(__file__).resolve().parent / "data"
_spec = importlib.util.spec_from_file_location("dnn_golden", ROOT / "tools" / "dnn_golden.py")
dg = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(dg)

PLANS = ("u64", "q32")
CASES = [(plan, case[0]) for plan in PLANS for case in dg.LAYER_CASES]


@functools.lru_cache(maxsize=None)
def golden(plan):
    with np.load(DATA / f"torch_dnn_golden_{plan}.npz") as f:
        arrays = {k: f[k] for k in f.files}
    return arrays, json.loads(str(arrays.pop("meta")))


@functools.lru_cache(maxsize=None)
def port(plan):
    """(ctx, enc, DNN, bootstrapper, input secret key) of the golden run,
    with the port's keys under the reference's secret."""
    return dg.port_setup(plan, golden(plan)[0]["secret"])


def stored_tensor(plan, prefix: str, rec: dict) -> TensorCT:
    arrays = golden(plan)[0]
    data = [arrays[f"{prefix}/{c}"] for c in range(len(rec["channels"]))]
    return tensor_ct_from_np(port(plan)[0], data, rec["channels"], rec["width"], rec["slotstr"])


def case_input(plan, name: str) -> TensorCT:
    """A fresh input, or an earlier case's output (the reference's)."""
    cases = golden(plan)[1]["cases"]
    if name in cases:
        return stored_tensor(plan, f"case/{name}", cases[name])
    return stored_tensor(plan, f"input/{name}", cases[f"input:{name}"])


def assert_same(plan, got: TensorCT, rec: dict):
    """Same geometry and metadata, every (component, limb) of every channel
    equal, and the same decoded values."""
    data, meta, width, slotstr = tensor_ct_to_np(got)
    assert (width, slotstr) == (rec["width"], rec["slotstr"])
    assert meta == rec["channels"]
    for c, (d, want) in enumerate(zip(data, rec["digests"])):
        bad = [i for i, (a, b) in enumerate(zip(dg.limb_digests(d), want)) if a != b]
        assert not bad, f"channel {c}: (component * limbs + limb) rows that differ: {bad}"
    _, _, model, _, sk = port(plan)
    np.testing.assert_allclose(model.dec_tensor(got, sk), rec["decoded"], rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("plan", PLANS)
def test_keys_are_the_golden_keys(plan):
    _, _, model, boot, _ = port(plan)
    assert dg.port_key_digest(model, boot) == golden(plan)[1]["key_digest"]


@pytest.mark.parametrize("plan", PLANS)
def test_enc_tensor_makes_the_golden_inputs(plan):
    """enc_tensor of the case images under the golden secret and input seed
    gives the stored inputs, in their order."""
    ctx, _, model, _, _ = port(plan)
    sk = secret_key_from_np(ctx, golden(plan)[0]["secret"], seed=dg.INPUT_SEED)
    for name, image in dg.layer_inputs().items():
        got = model.enc_tensor(image, sk=sk)
        want = case_input(plan, name)
        assert (got.width, got.slotstr) == (want.width, want.slotstr) == (dg.WIDTH, 0)
        for g, w in zip(got.cts, want.cts):
            assert torch.equal(g.data, w.data)
            assert (g.chain_index, g.scale, g.noise_scale_deg) == \
                (w.chain_index, w.scale, w.noise_scale_deg)


@pytest.mark.parametrize("plan,case", CASES)
def test_layer(plan, case):
    _, op, inputs, args = next(c for c in dg.LAYER_CASES if c[0] == case)
    _, _, model, boot, _ = port(plan)
    xs = [case_input(plan, name) for name in inputs]
    got = dg.apply_layer(model, boot, op, args, xs, dg.layer_consts(), reference=False)
    assert_same(plan, got, golden(plan)[1]["cases"][case])


@pytest.mark.parametrize("plan", PLANS)
def test_relu_composite_is_the_sign_composite(plan):
    """The reference's decoded ReluComposite equals relu_composite_clear,
    the float64 composite the chip run gates ResNet-20 against."""
    want = relu_composite_clear(dg.layer_inputs()["x1"])
    got = np.asarray(golden(plan)[1]["cases"]["relu_composite"]["decoded"])
    assert np.max(np.abs(got - want)) < 1e-4


def test_stack_unstack():
    """stack_cts adds a leading batch axis and unstack_cts takes it off; a
    mismatch of metadata raises (the reference's contract,
    tests/test_dnn_batched.py:67-88)."""
    t = case_input("q32", "x2")
    stacked = stack_cts(t.cts)
    assert stacked.data.shape == (2,) + tuple(t.cts[0].data.shape)
    for a, b in zip(t.cts, unstack_cts(stacked, 2)):
        assert torch.equal(a.data, b.data)
        assert (a.chain_index, a.scale, a.noise_scale_deg) == \
            (b.chain_index, b.scale, b.noise_scale_deg)
    with pytest.raises(ValueError, match="metadata"):
        stack_cts([t.cts[0], replace(t.cts[1], scale=t.cts[1].scale * 2)])


@pytest.mark.parametrize("plan", PLANS)
def test_encode_coeff_rows_is_encode(plan):
    """encode_coeff_rows of embed_for_slots rows equals encode (sparse, at
    the level's basis) and encode_ext (at QlP), limb for limb."""
    ctx, enc, _, _, _ = port(plan)
    vals = np.random.default_rng(3).uniform(-1, 1, (2, 16))
    scale = 2.0 ** 40
    rows = [enc.embed_for_slots(v, 16) for v in vals]
    for ext in (False, True):
        got = enc.encode_coeff_rows(rows, scale, 3, ext=ext)
        for v, pt in zip(vals, got):
            want = (enc.encode_ext if ext else enc.encode)(v, scale, 3, slots=16)
            assert torch.equal(pt.data, want.data)
            assert (pt.chain_index, pt.scale) == (want.chain_index, want.scale)


@pytest.mark.parametrize("plan", PLANS)
def test_mask_embedding_encodes_as_its_mask(plan):
    """A tap's cached mask embedding, scaled and encoded by
    encode_coeff_rows, is the encoding of the zero-padding mask itself at
    the tap's scale."""
    from tpu_fhe_torch.eval import auto

    ctx, enc, model, _, _ = port(plan)
    ct = case_input(plan, "x2").cts[0]
    i, j = 0, 2                                  # the tap (row - 1, column + 1)
    mask = np.zeros(16)
    for ip in range(4):
        for jp in range(4):
            if 0 <= ip + i - 1 <= 3 and 0 <= jp + j - 1 <= 3:
                mask[ip * 4 + jp] = 1.0
    scale = auto.scaling_factors(ctx)[0][auto._level(ct, ctx)]
    got = enc.encode_coeff_rows([model._mask_embedding(4, 0, 3, i, j)], scale,
                                ct.chain_index)[0]
    want = enc.encode(mask, scale, chain_index=ct.chain_index, slots=len(mask))
    assert torch.equal(got.data, want.data) and got.scale == want.scale


def test_timer_buckets():
    timer.clear()
    for _ in range(2):
        with timer.section("Relu"):
            pass
    with timer.section("Bootstrap"):
        pass
    assert set(timer.accumulated()) == {"Relu", "Bootstrap"}
    assert timer.counts() == {"Relu": 2, "Bootstrap": 1}
    lines = []
    timer.print_accumulated(lines.append)
    assert len(lines) == 2 and all(" ms  (x" in line for line in lines)
    timer.clear()
    assert timer.accumulated() == {}
