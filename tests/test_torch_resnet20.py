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


# --------------------------------------------------------------------------
# the float64 shadow's stages, the pool's layout at slot stride > 0, and a
# stage's output encrypted from the shadow
# --------------------------------------------------------------------------

SHADOW_WIDTH, SHADOW_PLANES = 8, (2, 3, 4)


@pytest.mark.parametrize("blocks", [1, 3])
def test_clear_stage_outputs_are_the_truncated_runs(blocks):
    """resnet20_infer_clear(on_stage_done=) reports every stage of
    stage_names in order; each output equals the truncated shadow wherever
    `layers` and `blocks` can express the stage (the stem: layers=0; the
    last block of a layer: layers=that layer; layer 1's blocks: blocks=b +
    1), and the pool's is the logits."""
    rng = np.random.default_rng(5)
    weights = rn.random_weights(rng, planes=SHADOW_PLANES)
    image = rng.uniform(-0.5, 0.5, (SHADOW_WIDTH, SHADOW_WIDTH, 3))
    for relu in (None, relu_composite_clear):
        got = []
        logits = rn.resnet20_infer_clear(image, weights, relu=relu, blocks=blocks,
                                         on_stage_done=lambda n, a: got.append((n, a)))
        assert [n for n, _ in got] == rn.stage_names(blocks, 3)
        stages = dict(got)
        np.testing.assert_array_equal(stages["pool"], logits)

        def clear(**kw):
            return rn.resnet20_infer_clear(image, weights, relu=relu, **kw)

        np.testing.assert_array_equal(stages["stem"], clear(blocks=blocks, layers=0))
        for layer in (1, 2):
            np.testing.assert_array_equal(stages[f"l{layer}b{blocks - 1}"],
                                          clear(blocks=blocks, layers=layer))
        for blk in range(blocks):
            np.testing.assert_array_equal(stages[f"l1b{blk}"], clear(blocks=blk + 1, layers=1))
        for name, acts in got[:-1]:
            layer = 1 if name == "stem" else int(name[1])
            assert acts.shape == (SHADOW_WIDTH >> (layer - 1), SHADOW_WIDTH >> (layer - 1),
                                  SHADOW_PLANES[layer - 1])


@functools.lru_cache(maxsize=None)
def small_q32():
    """A composite-chain context at N = 256 (no bootstrap), its encoder and
    secret key."""
    from tpu_fhe_torch.core.modulus import CoeffModulus
    from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
    from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder
    from tpu_fhe_torch.scheme.context import FheContext
    from tpu_fhe_torch.scheme.keys import SecretKey

    n, depth = 256, 5
    params = EncryptionParameters(
        scheme=SchemeType.ckks, poly_modulus_degree=n, allow_insecure=True,
        coeff_modulus=tuple(CoeffModulus.create_composite(
            n, 58, depth, degree=2, anchor_bits=30, special_bits=30, special_count=depth + 1)),
        special_modulus_size=depth + 1, composite_degree=2)
    ctx = FheContext(params, device="cpu")
    return ctx, CkksEncoder(ctx), SecretKey(ctx, seed=3)


@pytest.mark.parametrize("width,slotstr", [(4, 0), (4, 1), (2, 1), (2, 2)])
def test_pool_sums_every_pixel_at_any_slot_stride(width, slotstr):
    """avg_pool_full_con at slot stride s sums the w x w pixels, which lie
    (w << s) << s slots apart row to row: its row steps are (2^j << s) *
    (w << s).  The reference's are (2^j << s) * w, one pixel row apart only
    at s = 0 (there the steps are the reference's), so at s > 0 it summed
    slot rows between the pixels instead (the logits of the whole
    inference off by 6e-2 at the demo size).  The logits must equal the
    float64 FC of the pixel sums."""
    from tpu_fhe.models.dnn import DNN as RefDNN
    from tpu_fhe_torch.models.dnn import DNN

    ctx, enc, sk = small_q32()
    model = DNN(ctx, enc)
    steps = DNN.avgpool_rotation_indices(width, slotstr)
    ref_steps = RefDNN.avgpool_rotation_indices(width, slotstr)
    assert (steps == ref_steps) == (slotstr == 0 or width == 1)
    model.build_galois_key(sk, steps)
    rng = np.random.default_rng(width * 10 + slotstr)
    image = rng.uniform(-0.5, 0.5, (width, width, 3))
    fc_w, fc_b = rng.normal(0.0, 1.0, (4, 3)), rng.normal(0.0, 1.0, 4)
    x = model.enc_tensor(image, sk=sk, slotstr=slotstr)
    np.testing.assert_allclose(model.dec_tensor(x, sk), image, atol=1e-9)
    out = model.avg_pool_full_con(x, fc_w, fc_b)
    assert (out.num_ch, out.width, out.slotstr) == (4, width, slotstr)
    np.testing.assert_allclose(model.dec_tensor(out, sk)[0, 0, :],
                               fc_w @ image.sum(axis=(0, 1)) + fc_b, atol=1e-6)


class _StepsRead(Exception):
    pass


def reference_pool_steps(monkeypatch, width: int, slotstr: int) -> list[int]:
    """The rotation steps tpu_fhe's DNN.avg_pool_full_con takes at this
    width and slot stride, read off the function itself: its Galois
    elements are the steps (galois_elt_from_step swapped for the step) and
    it stops when it first reaches the channels, before any ciphertext
    work."""
    import types

    import tpu_fhe.ops.galois as ref_galois
    from tpu_fhe.models.dnn import DNN as RefDNN

    steps = []

    class Keys:
        def key_for_elt(self, elt):
            steps.append(elt)

    class Channels:
        def __iter__(self):
            raise _StepsRead

    monkeypatch.setattr(ref_galois, "galois_elt_from_step", lambda step, n: step)
    ref = types.SimpleNamespace(ctx=types.SimpleNamespace(n=1 << 10), gk=Keys())
    t = types.SimpleNamespace(num_ch=1, width=width, slotstr=slotstr, cts=Channels())
    with pytest.raises(_StepsRead):
        RefDNN.avg_pool_full_con(ref, t, np.zeros((1, 1)), np.zeros(1))
    return steps


def pooled_slot0(image: np.ndarray, slotstr: int, steps: list[int]) -> np.ndarray:
    """Slot 0 of each channel after the log-rotation sum, on the float
    layout a stride-s stage leaves ((i, j) at slot (i (w << s) + j) << s of
    (w << s)^2, 0 between): each step adds the slots rotated left by it,
    as a rotation of a sparse-packed ciphertext acts on its slots."""
    w, _, ch = image.shape
    big_w, pow_s = w << slotstr, 1 << slotstr
    out = np.zeros(ch)
    for k in range(ch):
        acc = np.zeros((big_w, big_w))
        acc[::pow_s, ::pow_s] = image[:, :, k]
        acc = acc.reshape(-1)
        for s_ in steps:
            acc = acc + np.roll(acc, -s_)
        out[k] = acc[0]
    return out


@pytest.mark.parametrize("width,slotstr", [(4, 1), (2, 2), (4, 0)])
def test_reference_pool_misses_pixel_rows_at_slot_stride(monkeypatch, width, slotstr):
    """The divergence from tpu_fhe's pool, shown on the same inputs: the
    reference's own steps, applied to the float layout of a stride-s stage,
    miss the float64 pixel sums at s > 0 (its row steps land on the zero
    slot rows between the pixel rows, so pixel rows drop out), and so do
    its logits; the port's steps reach the sums, and the port's encrypted
    pool and FC give the float64 FC of them.  At s = 0 both agree."""
    from tpu_fhe_torch.models.dnn import DNN

    ref_steps = reference_pool_steps(monkeypatch, width, slotstr)
    steps = DNN.avgpool_rotation_indices(width, slotstr)
    rng = np.random.default_rng(100 + width * 10 + slotstr)
    image = rng.uniform(0.1, 0.5, (width, width, 3))
    fc_w, fc_b = rng.normal(0.0, 1.0, (4, 3)), rng.normal(0.0, 1.0, 4)
    sums = image.sum(axis=(0, 1))
    want = fc_w @ sums + fc_b
    np.testing.assert_allclose(pooled_slot0(image, slotstr, steps), sums, rtol=1e-12)
    ref_sums = pooled_slot0(image, slotstr, ref_steps)
    ref_logits = fc_w @ ref_sums + fc_b
    if slotstr == 0:
        assert ref_steps == steps
        np.testing.assert_allclose(ref_logits, want, rtol=1e-12)
    else:
        # positive pixels: every dropped row lowers each channel's sum
        assert np.all(sums - ref_sums > 0.1)
        assert np.max(np.abs(ref_logits - want)) > 0.1

    ctx, enc, sk = small_q32()
    model = DNN(ctx, enc)
    model.build_galois_key(sk, steps)
    out = model.avg_pool_full_con(model.enc_tensor(image, sk=sk, slotstr=slotstr), fc_w, fc_b)
    np.testing.assert_allclose(model.dec_tensor(out, sk)[0, 0, :], want, atol=1e-6)


@pytest.mark.parametrize("stage", ["l1b2", "l2b1", "l3b2"])
def test_enc_stage_output_takes_the_layout_and_level(stage):
    """enc_stage_output encrypts a stage's activations at its slot stride
    (0, 1, 2 through layers 1, 2, 3), with the chain index, scale and
    noise-scale degree of the ciphertext it is given (a degree-2 one here,
    as a bootstrap leaves it), and decrypts to the activations."""
    from dataclasses import replace

    from tpu_fhe_torch.eval import auto
    from tpu_fhe_torch.models.dnn import DNN

    ctx, enc, sk = small_q32()
    model = DNN(ctx, enc)
    like = auto.mult_const(ctx, model.enc_tensor(np.zeros((2, 2, 1)), sk=sk).cts[0], 1.0)
    like = replace(like, data=like.data[:, :ctx.level(5).size], chain_index=5)
    slotstr = rn.stage_slotstr(stage)
    assert slotstr == int(stage[1]) - 1
    acts = np.random.default_rng(1).uniform(-1.0, 1.0, (8 >> slotstr, 8 >> slotstr, 3))
    t = rn.enc_stage_output(model, acts, sk, stage, like)
    assert (t.num_ch, t.width, t.slotstr) == (3, 8 >> slotstr, slotstr)
    for ct in t.cts:
        assert (ct.chain_index, ct.scale, ct.noise_scale_deg) == \
            (like.chain_index, like.scale, 2)
    np.testing.assert_allclose(model.dec_tensor(t, sk), acts, atol=1e-9)


def run_example(tmp_path):
    """examples/torch_resnet20_infer.py --cpu --demo --q32 --blocks 1
    --layers 3 --record in a process where importing jax or tpu_fhe
    fails; -> its record lines."""
    import subprocess
    import sys

    record = tmp_path / "record.jsonl"
    argv = ["examples/torch_resnet20_infer.py", "--cpu", "--demo", "--q32", "--blocks", "1",
            "--layers", "3", "--record", str(record)]
    code = ("import sys, runpy\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['tpu_fhe'] = None\n"
            f"sys.argv = {argv!r}\n"
            f"runpy.run_path({argv[0]!r}, run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(line) for line in record.read_text().splitlines()]
    printed = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert printed == lines
    return lines


@pytest.mark.slow
def test_example_records_every_stage(tmp_path):
    """The demo pipeline's record: one line per stage (stem, l1b0, l2b0,
    l3b0, pool) and a closing line, every max_err within 1e-2 of the
    sign-composite shadow, the pool's argmax the shadows', and each stage
    at the slot stride and chain index its layout gives."""
    lines = run_example(tmp_path)
    assert [ln["stage"] for ln in lines] == list(dg.STAGES) + ["total"]
    for ln in lines[:-1]:
        assert ln["max_err"] <= 1e-2, ln
        assert ln["slotstr"] == rn.stage_slotstr(ln["stage"])
        assert ln["seconds"] > 0 and ln["card"] == "cpu"
    assert [ln["channel_bootstraps"] for ln in lines[:-1]] == [6, 12, 12, 12, 0]
    pool, total = lines[-2], lines[-1]
    assert pool["argmax"] == pool["argmax_shadow"] == pool["argmax_exact"]
    assert len(pool["logits"]) == 10
    assert total["channel_bootstraps"] == 42 and total["bootstrap_sections"] == 21
    assert total["max_err"] == max(ln["max_err"] for ln in lines[:-1])
