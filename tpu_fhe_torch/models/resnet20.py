"""Encrypted ResNet-20 / CIFAR-10 inference.

Port of ``tpu_fhe/models/resnet20.py``: the stem (conv, batch norm,
ReluComposite), 3 layers of 3 residual blocks with a stride-2 downsample
at block 0 of layers 2 and 3, and the average pool with the fully
connected layer, on ``models/dnn.py``.  Weights load from PyTorch-layout
.npy files ([out, in, kh, kw] -> (kh, kw, in, out)) or come from
``random_weights``; CIFAR images from a (10000, 3, 32, 32) float32 .npy.
``resnet20_infer_clear`` is the float64 shadow of the same layer math with
an exact ReLU.  ``save_tensor_ct`` / ``load_tensor_ct`` checkpoint a
tensor between stages (one file per channel in the serializer's format,
which the reference reads too, and a ``meta.json`` with the geometry, the
stage and the timer buckets), so that a long run resumes in a later
process (``start_after``).  ``enc_stage_output`` encrypts the shadow's
output of a stage in the layout and at the level the encrypted pipeline
holds it there.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, replace

import numpy as np

from ..eval import auto, evaluator as ev
from ..scheme.ciphertext import Ciphertext
from ..scheme.context import FheContext
from ..utils import serialize as ser, timer
from .dnn import DNN, TensorCT


# --------------------------------------------------------------------------
# weight and input loaders
# --------------------------------------------------------------------------

def load_weight_4d(path: str) -> np.ndarray:
    """PyTorch conv weight [out, in, kH, kW] -> (kH, kW, in, out)."""
    arr = np.load(path).astype(np.float64)
    if arr.ndim != 4:
        raise ValueError(f"expected 4D weight tensor: {path}")
    return arr.transpose(2, 3, 1, 0)


def load_weight_2d(path: str) -> np.ndarray:
    arr = np.load(path).astype(np.float64)
    if arr.ndim != 2:
        raise ValueError(f"expected 2D weight: {path}")
    return arr


def load_weight_1d(path: str) -> np.ndarray:
    arr = np.load(path).astype(np.float64)
    if arr.ndim != 1:
        raise ValueError(f"expected 1D weight: {path}")
    return arr


@dataclass
class BatchNormParams:
    weight: np.ndarray
    bias: np.ndarray
    mean: np.ndarray
    var: np.ndarray


def weights_from_np(weights: dict) -> dict:
    """A weight dict of numpy arrays and batch-norm records (any object with
    weight, bias, mean and var) with this module's BatchNormParams."""
    out = {}
    for name, v in weights.items():
        if all(hasattr(v, f) for f in ("weight", "bias", "mean", "var")):
            v = BatchNormParams(*(np.asarray(getattr(v, f), dtype=np.float64)
                                  for f in ("weight", "bias", "mean", "var")))
        else:
            v = np.asarray(v, dtype=np.float64)
        out[name] = v
    return out


def load_bn(weight_dir: str, prefix: str) -> BatchNormParams:
    return BatchNormParams(
        weight=load_weight_1d(f"{weight_dir}/{prefix}_weight.npy"),
        bias=load_weight_1d(f"{weight_dir}/{prefix}_bias.npy"),
        mean=load_weight_1d(f"{weight_dir}/{prefix}_running_mean.npy"),
        var=load_weight_1d(f"{weight_dir}/{prefix}_running_var.npy"),
    )


def load_cifar_image(npy_path: str, index: int = 0) -> np.ndarray:
    """(10000, 3, 32, 32) float32 -> (32, 32, 3)."""
    arr = np.load(npy_path, mmap_mode="r")
    return np.asarray(arr[index], dtype=np.float64).transpose(1, 2, 0)


def random_weights(rng: np.random.Generator, planes=(16, 32, 64), in_ch=3,
                   classes=10) -> dict:
    """Random weights of ResNet-20's shapes (He-scaled and halved, so that
    activations stay in the sign composite's input range), drawn from `rng`
    in the reference's order."""
    w = {}

    def conv(kh, cin, cout):
        std = math.sqrt(2.0 / (kh * kh * cin)) * 0.5
        return rng.normal(0.0, std, (kh, kh, cin, cout))

    def bn(c):
        return BatchNormParams(
            weight=rng.uniform(0.7, 1.3, c), bias=rng.uniform(-0.1, 0.1, c),
            mean=rng.uniform(-0.1, 0.1, c), var=rng.uniform(0.8, 1.2, c),
        )

    w["conv1"] = conv(3, in_ch, planes[0])
    w["bn1"] = bn(planes[0])
    for layer, p in enumerate(planes, start=1):
        prev = planes[layer - 2] if layer > 1 else planes[0]
        for blk in range(3):
            cin = prev if blk == 0 else p
            pre = f"layer{layer}_{blk}"
            w[f"{pre}_conv1"] = conv(3, cin, p)
            w[f"{pre}_bn1"] = bn(p)
            w[f"{pre}_conv2"] = conv(3, p, p)
            w[f"{pre}_bn2"] = bn(p)
            if layer > 1 and blk == 0:
                w[f"{pre}_downsample_0"] = conv(3, cin, p)
                w[f"{pre}_downsample_1"] = bn(p)
    w["fc_weight"] = rng.normal(0.0, 0.1, (classes, planes[2]))
    w["fc_bias"] = rng.normal(0.0, 0.1, classes)
    return w


def load_weights(weight_dir: str) -> dict:
    """Every ResNet-20 weight from the reference's .npy layout."""
    w = {"conv1": load_weight_4d(f"{weight_dir}/conv1_weight.npy"),
         "bn1": load_bn(weight_dir, "bn1")}
    for layer in (1, 2, 3):
        for blk in range(3):
            pre = f"layer{layer}_{blk}"
            w[f"{pre}_conv1"] = load_weight_4d(f"{weight_dir}/{pre}_conv1_weight.npy")
            w[f"{pre}_bn1"] = load_bn(weight_dir, f"{pre}_bn1")
            w[f"{pre}_conv2"] = load_weight_4d(f"{weight_dir}/{pre}_conv2_weight.npy")
            w[f"{pre}_bn2"] = load_bn(weight_dir, f"{pre}_bn2")
            if layer > 1 and blk == 0:
                w[f"{pre}_downsample_0"] = load_weight_4d(
                    f"{weight_dir}/{pre}_downsample_0_weight.npy")
                w[f"{pre}_downsample_1"] = load_bn(weight_dir, f"{pre}_downsample_1")
    w["fc_weight"] = load_weight_2d(f"{weight_dir}/fc_weight.npy")
    w["fc_bias"] = load_weight_1d(f"{weight_dir}/fc_bias.npy")
    return w


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------

def prepare_resnet20(model: DNN, sk, width: int = 32, layers: int = 3):
    """The rotation keys of each resolution the network visits (`layers` < 3
    visits fewer) and of the average pool, and the relin key."""
    rots: list[int] = []
    rots += DNN.conv_rotation_indices(width, 3, 0)
    if layers >= 2:
        rots += DNN.conv_rotation_indices(width // 2, 3, 1)
    if layers >= 3:
        rots += DNN.conv_rotation_indices(width // 4, 3, 2)
        rots += DNN.avgpool_rotation_indices(width // 4, 2)
    model.build_galois_key(sk, rots)
    model.relin_keygen(sk)


def stage_names(blocks: int = 3, layers: int = 3) -> list[str]:
    """The pipeline's stages in order: 'stem', 'l{layer}b{block}', 'pool'."""
    names = ["stem"] + [f"l{layer}b{blk}" for layer in (1, 2, 3)[:layers]
                        for blk in range(blocks)]
    return names + (["pool"] if layers >= 3 else [])


def stage_slotstr(name: str) -> int:
    """The slot stride of a stage's output: 0 through layer 1, 1 in layer
    2, 2 in layer 3 and the pool (each stride-2 block doubles it)."""
    if name.startswith("l2"):
        return 1
    return 2 if name.startswith(("l3", "pool")) else 0


def enc_stage_output(model: DNN, acts: np.ndarray, sk, stage: str,
                     like: Ciphertext) -> TensorCT:
    """The float64 activations `acts` (w, w, ch) of `stage`'s output in the
    form the encrypted pipeline holds them there: at the stage's slot
    stride (DNN.enc_tensor under `sk`, 0 between the pixels), then
    mod-dropped to the chain index of `like` (a stage output's: every
    stage ends in the same bootstrap) with its scale and noise-scale
    degree; a degree of 2 is reached by mult_const(1.0) at that level from
    the scale like.scale / sf[level]."""
    ctx = model.ctx
    deg2 = like.noise_scale_deg == 2
    scale = like.scale / auto.scaling_factors(ctx)[0][auto._level(like, ctx)] if deg2 \
        else like.scale
    slotstr = stage_slotstr(stage)
    cts = []
    for k in range(acts.shape[-1]):     # one channel at a time at chain index 1
        ct = model.enc_tensor(acts[..., k:k + 1], sk=sk, slotstr=slotstr, scale=scale).cts[0]
        while ct.chain_index < like.chain_index:
            ct = ev.mod_drop_to_next(ctx, ct)
        if deg2:
            ct = replace(auto.mult_const(ctx, ct, 1.0), scale=like.scale)
        cts.append(ct)
    return TensorCT(cts, acts.shape[0], slotstr)


def resnet20_infer(x: TensorCT, model: DNN, bootstrapper, weights: dict, log=print,
                   blocks: int = 3, layers: int = 3, start_after: str = "",
                   on_stage_done=None) -> TensorCT:
    """The encrypted forward pass with the timer buckets Convolution,
    BatchNorm, Relu, Bootstrap and PoolFC (print them with
    utils.timer.print_accumulated).  `blocks` < 3 truncates each layer,
    `layers` < 3 drops whole layers and the final pool.  The pipeline is a
    chain of named stages (``stage_names``): `on_stage_done(name, x)` is
    called after each, and `start_after=name` starts right after that stage
    with `x` as its output."""

    def conv(t, w, stride, key):
        with timer.section("Convolution"):
            return model.conv(t, w, stride, cache_key=key)

    def bnorm(t, p):
        with timer.section("BatchNorm"):
            return model.batch_norm(t, p.weight, p.bias, p.mean, p.var)

    def stem(t):
        t = conv(t, weights["conv1"], 1, "conv1")
        t = bnorm(t, weights["bn1"])
        return model.relu_composite(t, bootstrapper)

    def make_block(layer, blk):
        def block(t):
            pre = f"layer{layer}_{blk}"
            stride = 2 if (layer > 1 and blk == 0) else 1
            t_skip = t
            t_main = conv(t, weights[f"{pre}_conv1"], stride, f"{pre}_conv1")
            t_main = bnorm(t_main, weights[f"{pre}_bn1"])
            t_main = model.relu_composite(t_main, bootstrapper)
            t_main = conv(t_main, weights[f"{pre}_conv2"], 1, f"{pre}_conv2")
            t_main = bnorm(t_main, weights[f"{pre}_bn2"])
            if stride == 2:
                t_skip = conv(t_skip, weights[f"{pre}_downsample_0"], 2, f"{pre}_downsample_0")
                t_skip = bnorm(t_skip, weights[f"{pre}_downsample_1"])
            t = model.add(t_main, t_skip)
            return model.relu_composite(t, bootstrapper)
        return block

    def pool(t):
        with timer.section("PoolFC"):
            return model.avg_pool_full_con(t, weights["fc_weight"], weights["fc_bias"])

    fns = {"stem": stem, "pool": pool}
    for layer in (1, 2, 3):
        for blk in range(3):
            fns[f"l{layer}b{blk}"] = make_block(layer, blk)
    names = stage_names(blocks, layers)
    if start_after and start_after not in names:
        raise ValueError(f"start_after stage {start_after!r} not in pipeline")
    started = not start_after
    for name in names:
        if not started:
            started = name == start_after
            continue
        log(f"stage {name}")
        x = fns[name](x)
        if on_stage_done is not None:
            on_stage_done(name, x)
    return x


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def save_tensor_ct(t: TensorCT, path: str, stage: str = "", extra: dict | None = None):
    """Write every channel (``ch<k>.ct``), then ``meta.json`` (channels,
    width, slot stride, `stage`, the timer buckets' seconds and `extra`)
    through a temporary file and an atomic replace: a directory with a
    meta.json holds a whole checkpoint."""
    os.makedirs(path, exist_ok=True)
    for k, ct in enumerate(t.cts):
        with open(f"{path}/ch{k:03d}.ct", "wb") as fp:
            ser.save_ciphertext(ct, fp)
    meta = {"num_ch": t.num_ch, "width": t.width, "slotstr": t.slotstr, "stage": stage,
            "timers": timer.accumulated()}
    if extra:
        meta.update(extra)
    tmp = f"{path}/meta.json.tmp"
    with open(tmp, "w") as fp:
        json.dump(meta, fp)
    os.replace(tmp, f"{path}/meta.json")


def load_tensor_ct(ctx: FheContext, path: str) -> tuple[TensorCT, dict]:
    """-> (tensor, meta) of a checkpoint, on `ctx`'s device; adds the saved
    timer buckets' seconds to this process's."""
    with open(f"{path}/meta.json") as fp:
        meta = json.load(fp)
    cts = []
    for k in range(meta["num_ch"]):
        with open(f"{path}/ch{k:03d}.ct", "rb") as fp:
            cts.append(ser.load_ciphertext(ctx, fp))
    for name, secs in meta.get("timers", {}).items():
        timer.add_accumulated(name, secs)
    return TensorCT(cts, meta["width"], meta["slotstr"]), meta


def resnet20_infer_clear(image: np.ndarray, weights: dict, relu=None, blocks: int = 3,
                         layers: int = 3, on_stage_done=None) -> np.ndarray:
    """The float64 shadow of the encrypted pipeline (the same layer math,
    the pool not averaged): the logits, or with `layers` < 3 the activations
    (w, w, ch) after the truncated pipeline.  `relu` replaces the exact
    max(0, x), e.g. by the sign composite the encrypted pipeline applies.
    `on_stage_done(name, acts)` is called after each stage of stage_names
    with its output: (w, w, ch) activations, the pool's the logits."""
    relu = relu or (lambda v: np.maximum(v, 0.0))

    def conv(img, w4, stride):
        wdt = img.shape[0]
        kh = w4.shape[0]
        c = kh // 2
        out = np.zeros((wdt, wdt, w4.shape[3]))
        for i in range(kh):
            for j in range(kh):
                shifted = np.zeros_like(img)
                si0, sj0 = i - c, j - c
                src_i = slice(max(0, si0), min(wdt, wdt + si0))
                dst_i = slice(max(0, -si0), min(wdt, wdt - si0))
                src_j = slice(max(0, sj0), min(wdt, wdt + sj0))
                dst_j = slice(max(0, -sj0), min(wdt, wdt - sj0))
                shifted[dst_i, dst_j] = img[src_i, src_j]
                out += np.einsum("xyk,kh->xyh", shifted, w4[i, j])
        return out[::stride, ::stride]

    def bnorm(img, p):
        a = p.weight / np.sqrt(p.var + 1e-5)
        return img * a + (p.bias - a * p.mean)

    done = on_stage_done or (lambda name, acts: None)
    x = relu(bnorm(conv(image, weights["conv1"], 1), weights["bn1"]))
    done("stem", x)
    for layer in (1, 2, 3)[:layers]:
        for blk in range(blocks):
            pre = f"layer{layer}_{blk}"
            stride = 2 if (layer > 1 and blk == 0) else 1
            x_skip = x
            xm = relu(bnorm(conv(x, weights[f"{pre}_conv1"], stride), weights[f"{pre}_bn1"]))
            xm = bnorm(conv(xm, weights[f"{pre}_conv2"], 1), weights[f"{pre}_bn2"])
            if stride == 2:
                x_skip = bnorm(conv(x_skip, weights[f"{pre}_downsample_0"], 2),
                               weights[f"{pre}_downsample_1"])
            x = relu(xm + x_skip)
            done(f"l{layer}b{blk}", x)
    if layers < 3:
        return x
    sums = x.sum(axis=(0, 1))
    logits = weights["fc_weight"] @ sums + weights["fc_bias"]
    done("pool", logits)
    return logits
