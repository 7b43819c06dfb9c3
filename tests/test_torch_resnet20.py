"""The port's ResNet-20 (tpu_fhe_torch/models/resnet20.py) against
tpu_fhe's, bit for bit per RNS limb, on the u64 plan at N = 64.

tools/dnn_golden.py runs tpu_fhe's resnet20_infer(layers=3, blocks=1) on
planes (1, 1, 1) and a 4 x 4 x 3 image, with the weights and image of
examples/resnet20_infer.py --demo's recipe (random_weights of
np.random.default_rng(17), then the image from the same generator), and
keeps each stage -- stem, l1b0, l2b0, l3b0, pool -- with its input (the
reference's output of the stage before; the stem's, the encrypted image)
in tests/data/torch_dnn_golden_u64.npz, beside the layer cases of
tests/test_torch_dnn.py.  Each stage of the port must equal the
reference's on the same input.  The stem and the pool run in tier-1; the
three blocks (six bootstraps each) and the whole pipeline from the seeded
image to the logits are slow-marked."""

import functools
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_fhe_torch.models import resnet20 as rn
from tpu_fhe_torch.models.dnn import relu_composite_clear, tensor_ct_from_np, tensor_ct_to_np
from tpu_fhe_torch.utils import timer
from tpu_fhe_torch.utils.convert import secret_key_from_np

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DATA = Path(__file__).resolve().parent / "data"
_spec = importlib.util.spec_from_file_location("dnn_golden", ROOT / "tools" / "dnn_golden.py")
dg = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(dg)

SLOW_STAGES = ("l1b0", "l2b0", "l3b0")


@functools.lru_cache(maxsize=None)
def golden():
    with np.load(DATA / "torch_dnn_golden_u64.npz") as f:
        arrays = {k: f[k] for k in f.files}
    return arrays, json.loads(str(arrays.pop("meta")))


@functools.lru_cache(maxsize=None)
def port():
    return dg.port_setup("u64", golden()[0]["secret"])


def stage_input(stage: str):
    arrays, doc = golden()
    rec = doc["stages"][stage]["input"]
    data = [arrays[f"stage/{stage}/in/{c}"] for c in range(len(rec["channels"]))]
    return tensor_ct_from_np(port()[0], data, rec["channels"], rec["width"], rec["slotstr"])


def assert_same(got, rec: dict):
    """Same geometry and metadata, every (component, limb) of every channel
    equal, and the same decoded values."""
    data, meta, width, slotstr = tensor_ct_to_np(got)
    assert (width, slotstr) == (rec["width"], rec["slotstr"])
    assert meta == rec["channels"]
    for c, (d, want) in enumerate(zip(data, rec["digests"])):
        bad = [i for i, (a, b) in enumerate(zip(dg.limb_digests(d), want)) if a != b]
        assert not bad, f"channel {c}: (component * limbs + limb) rows that differ: {bad}"
    _, _, model, _, sk = port()
    np.testing.assert_allclose(model.dec_tensor(got, sk), rec["decoded"], rtol=1e-9,
                               atol=1e-12)


class _Stop(Exception):
    pass


def run_stage(stage: str):
    """`stage` of the port's resnet20_infer, started after the stage before
    it and stopped after it."""
    _, _, model, boot, _ = port()
    weights, _ = dg.resnet_setup(rn)
    i = dg.STAGES.index(stage)
    out = {}

    def done(name, t):
        out[name] = t
        raise _Stop

    with pytest.raises(_Stop):
        rn.resnet20_infer(stage_input(stage), model, boot, weights, log=lambda m: None,
                          blocks=1, layers=3, start_after=dg.STAGES[i - 1] if i else "",
                          on_stage_done=done)
    return out[stage]


@pytest.mark.parametrize("stage", [pytest.param(s, marks=pytest.mark.slow)
                                   if s in SLOW_STAGES else s for s in dg.STAGES])
def test_stage(stage):
    assert_same(run_stage(stage), golden()[1]["stages"][stage]["output"])


def test_stage_inputs_chain():
    """Each stage's stored input is the stored output of the stage before
    (the reference's), and the stem's is the port's enc_tensor of the demo
    image."""
    _, doc = golden()
    stages = doc["stages"]
    for prev, stage in zip(dg.STAGES, dg.STAGES[1:]):
        assert stages[stage]["input"]["digests"] == stages[prev]["output"]["digests"]
        assert stages[stage]["input"]["channels"] == stages[prev]["output"]["channels"]
    ctx, _, model, _, _ = port()
    sk = secret_key_from_np(ctx, golden()[0]["secret"], seed=dg.INPUT_SEED)
    _, image = dg.resnet_setup(rn)
    x = model.enc_tensor(image, sk=sk)
    assert [dg.limb_digests(d) for d in tensor_ct_to_np(x)[0]] == \
        stages["stem"]["input"]["digests"]


def test_weights_are_the_reference_weights():
    """random_weights draws the reference's weights from the same generator,
    and rn.weights_from_np carries the reference's dict over unchanged."""
    from tpu_fhe.models import resnet20 as jrn

    want, want_image = dg.resnet_setup(jrn)
    got, image = dg.resnet_setup(rn)
    carried = rn.weights_from_np(want)
    np.testing.assert_array_equal(image, want_image)
    assert list(got) == list(want) == list(carried)
    for name, v in got.items():
        for w in (want[name], carried[name]):
            if isinstance(v, rn.BatchNormParams):
                assert isinstance(carried[name], rn.BatchNormParams)
                for f in ("weight", "bias", "mean", "var"):
                    np.testing.assert_array_equal(getattr(v, f), getattr(w, f))
            else:
                np.testing.assert_array_equal(v, w)


def test_clear_shadow_is_the_reference_logits():
    """The float64 shadow with the sign composite for ReLU lands on the
    reference's decoded logits; the exact-ReLU shadow is the reference's
    resnet20_infer_clear."""
    from tpu_fhe.models import resnet20 as jrn

    weights, image = dg.resnet_setup(rn)
    logits = golden()[1]["logits"]
    shadow = rn.resnet20_infer_clear(image, weights, relu=relu_composite_clear, blocks=1)
    assert np.max(np.abs(shadow - logits)) < 1e-4
    jweights, _ = dg.resnet_setup(jrn)
    np.testing.assert_allclose(rn.resnet20_infer_clear(image, weights),
                               jrn.resnet20_infer_clear(image, jweights), rtol=1e-12)


def test_stage_names_and_start_after():
    assert rn.stage_names(1, 3) == list(dg.STAGES)
    assert rn.stage_names(3, 1) == ["stem", "l1b0", "l1b1", "l1b2"]
    with pytest.raises(ValueError, match="not in pipeline"):
        rn.resnet20_infer(None, None, None, {}, blocks=1, layers=1, start_after="pool")


def test_loaders(tmp_path):
    """load_weights and load_cifar_image read the reference's .npy layout:
    PyTorch [out, in, kh, kw] convolutions and (n, 3, 32, 32) images."""
    weights = rn.random_weights(np.random.default_rng(2), planes=(2, 2, 2))

    def save(name, arr):
        np.save(tmp_path / f"{name}.npy", arr)

    for name, v in weights.items():
        if isinstance(v, rn.BatchNormParams):
            for f, suffix in (("weight", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                              ("var", "running_var")):
                save(f"{name}_{suffix}", getattr(v, f))
        elif name.startswith("fc"):
            save(name, v)
        else:
            save(f"{name}_weight", v.transpose(3, 2, 0, 1))
    got = rn.load_weights(str(tmp_path))
    assert list(got) == list(weights)
    for name, v in weights.items():
        if isinstance(v, rn.BatchNormParams):
            for f in ("weight", "bias", "mean", "var"):
                np.testing.assert_array_equal(getattr(got[name], f), getattr(v, f))
        else:
            np.testing.assert_array_equal(got[name], v)
    images = np.random.default_rng(3).uniform(0, 1, (2, 3, 32, 32)).astype(np.float32)
    np.save(tmp_path / "cifar.npy", images)
    np.testing.assert_array_equal(rn.load_cifar_image(str(tmp_path / "cifar.npy"), 1),
                                  images[1].transpose(1, 2, 0))
    with pytest.raises(ValueError, match="4D"):
        save("bad", np.zeros((3, 3)))
        rn.load_weight_4d(str(tmp_path / "bad.npy"))


@pytest.mark.slow
def test_pipeline_from_the_image():
    """The whole pipeline: the demo image encrypted with enc_tensor, every
    stage, and the decoded logits (the reference's), with the timer buckets
    of the reference."""
    ctx, _, model, boot, _ = port()
    sk = secret_key_from_np(ctx, golden()[0]["secret"], seed=dg.INPUT_SEED)
    weights, image = dg.resnet_setup(rn)
    timer.clear()
    out = rn.resnet20_infer(model.enc_tensor(image, sk=sk), model, boot, weights,
                            log=lambda m: None, blocks=1, layers=3)
    assert_same(out, golden()[1]["stages"]["pool"]["output"])
    assert set(timer.accumulated()) == {"Convolution", "BatchNorm", "Relu", "Bootstrap",
                                        "PoolFC"}
    assert timer.counts()["Bootstrap"] == 21
    np.testing.assert_allclose(model.dec_tensor(out, sk)[0, 0, :], golden()[1]["logits"],
                               rtol=1e-9, atol=1e-12)
