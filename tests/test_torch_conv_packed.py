"""The port's channel-packed convolution and diagonal fully-connected layer
(tpu_fhe_torch/models/conv_packed.py) against tpu_fhe's, bit for bit per
RNS limb, on both plans at N = 512.

The layout arithmetic (layout, rotation_indices, fc_rotation_indices) is
held live against the reference's, which reads nothing of its context but
the ring degree.  The reference's convolution runs eagerly at about two
minutes a call on a CPU, so the layers' results come from golden files,
tests/data/torch_conv_packed_golden_{u64,q32}.npz, which
tools/conv_packed_golden.py writes from live runs of tpu_fhe's layers: on
the reference test's u64 stack ([60, 40, 40, 40, 60], one special prime)
and on a q32 composite stack, mask scale 2^40.  The file holds the
reference's secret key, the convolution's and the FC layer's inputs, and
each output as a digest per (component, limb) with its metadata and
decoded values.

The port makes the Galois keys with its own keygen under the reference's
secret from the golden run's seed (a digest holds them equal), and its
input key encrypts the reference's plaintexts in the golden run, so the
port's zero_pad_encode must give the stored ciphertexts exactly.  The
convolution runs with its output channels one at a time, in chunks of 2
(the memory rule's choice here) and in one chunk of 3: every way gives the
reference's residues and metadata."""

import functools
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpu_fhe_torch.eval import evaluator as ev
from tpu_fhe_torch.models.conv_packed import (PackedConv, fc_rotation_indices,
                                              fc_weight_encode, fully_connected)
from tpu_fhe_torch.models.dnn import CPU_BATCH_BUDGET, DNN, MAX_CHANNEL_BATCH
from tpu_fhe_torch.scheme.ciphertext import Ciphertext, stack_cts, unstack_cts
from tpu_fhe_torch.utils.convert import ciphertext_from_np, secret_key_from_np, to_numpy

# The suite runs in several worker processes at once: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DATA = Path(__file__).resolve().parent / "data"
_spec = importlib.util.spec_from_file_location("conv_packed_golden",
                                               ROOT / "tools" / "conv_packed_golden.py")
cg = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cg)

PLANS = ("u64", "q32")


@functools.lru_cache(maxsize=None)
def golden(plan):
    with np.load(DATA / f"torch_conv_packed_golden_{plan}.npz") as f:
        arrays = {k: f[k] for k in f.files}
    return arrays, json.loads(str(arrays.pop("meta")))


@functools.lru_cache(maxsize=None)
def port(plan):
    """(ctx, encoder, Galois keys) of the golden run, the keys the port's
    under the reference's secret."""
    return cg.port_setup(plan, golden(plan)[0]["secret"])


def input_key(plan):
    """A fresh input key: its first draw is each case's first encryption."""
    return secret_key_from_np(port(plan)[0], golden(plan)[0]["secret"], seed=cg.INPUT_SEED)


def case(plan, name) -> dict:
    return golden(plan)[1]["cases"][name]


def assert_same(items: list, rec: dict):
    """Every (component, limb) of each ciphertext or plaintext equal to the
    record's, and the same metadata."""
    assert len(items) == len(rec["digests"])
    for i, (c, want) in enumerate(zip(items, rec["digests"])):
        got = cg.dg.limb_digests(to_numpy(c.data))
        bad = [r for r, (a, b) in enumerate(zip(got, want)) if a != b]
        assert not bad, f"item {i}: (component * limbs + limb) rows that differ: {bad}"
    assert [cg.meta(c) for c in items] == rec["meta"]


def conv_inputs(plan) -> list:
    ctx = port(plan)[0]
    arrays = golden(plan)[0]
    return [ciphertext_from_np(ctx, arrays[f"input/conv/{i}"], **m)
            for i, m in enumerate(case(plan, "encode")["meta"])]


def ref_conv_same(images, filt):
    """images (c_in, h, h), filt (c_out, c_in, f, f), zero 'same' pad (the
    reference test's numpy convolution)."""
    c_out, c_in, f, _ = filt.shape
    h = images.shape[1]
    p = (f - 1) // 2
    padded = np.pad(images, ((0, 0), (p, p), (p, p)))
    out = np.zeros((c_out, h, h))
    for k in range(c_out):
        for c in range(c_in):
            for di in range(f):
                for dj in range(f):
                    out[k] += filt[k, c, di, dj] * padded[c, di:di + h, dj:dj + h]
    return out


# -- the layout, live against the reference --------------------------------

LAYOUTS = [(6, 3, 512), (6, 3, 1024), (32, 3, 1 << 16), (16, 3, 1 << 16), (8, 3, 1 << 16),
           (5, 5, 256), (7, 1, 128), (30, 3, 1024), (62, 3, 4096)]


@pytest.mark.parametrize("in_h,f_h,n", LAYOUTS)
def test_layout_and_rotations_match_reference(in_h, f_h, n):
    from tpu_fhe.models.conv_packed import PackedConv as JPackedConv

    ctx = SimpleNamespace(n=n)
    ours, theirs = PackedConv(ctx, None), JPackedConv(ctx, None)
    try:
        want = theirs.layout(in_h, f_h)
    except NotImplementedError:
        with pytest.raises(NotImplementedError):
            ours.layout(in_h, f_h)
        return
    got = ours.layout(in_h, f_h)
    assert (got.in_h, got.f_h, got.block, got.n_i, got.wpp, got.pad) == \
        (want.in_h, want.f_h, want.block, want.n_i, want.wpp, want.pad)
    assert ours.rotation_indices(got) == theirs.rotation_indices(want)


@pytest.mark.parametrize("rows,cols,slots", [(4, 16, 256), (16, 64, 1 << 15), (8, 8, 8),
                                             (2, 32, 32), (1, 16, 256), (32, 32, 512)])
def test_fc_rotation_indices_match_reference(rows, cols, slots):
    from tpu_fhe.models.conv_packed import fc_rotation_indices as jfc

    assert fc_rotation_indices(rows, cols, slots) == jfc(rows, cols, slots)


def test_channel_batch_is_the_dnn_rule():
    """The output channels' chunks follow the DNN's rule, forced or not."""
    ctx = port("q32")[0]
    for forced in (None, 1, 2, 3, 100):
        pc = PackedConv(ctx, None, channel_batch=forced)
        model = DNN.__new__(DNN)
        model.ctx, model.forced_batch = ctx, forced
        for n_ch in (1, 3, 16, 64):
            assert pc.channel_batch(n_ch) == model.channel_batch(n_ch)


# -- the layers, against the golden runs ------------------------------------

@pytest.mark.parametrize("plan", PLANS)
def test_keys_are_the_golden_keys(plan):
    assert cg.key_digest(port(plan)[2]) == golden(plan)[1]["key_digest"]


@pytest.mark.parametrize("plan", PLANS)
def test_zero_pad_encode(plan):
    """zero_pad_encode's plaintexts are the reference's, so its ciphertexts
    (the port's encryptions of them) are the stored inputs; decode_outputs
    reads the images back."""
    ctx, enc, _ = port(plan)
    sk = input_key(plan)
    pts = []

    class Recording:
        @staticmethod
        def encrypt_symmetric(pt):
            pts.append(pt)
            return sk.encrypt_symmetric(pt)

    pc = PackedConv(ctx, enc, scale=cg.SCALE)
    lay = pc.layout(cg.IN_H, cg.F_H)
    d = cg.data()
    cts = pc.zero_pad_encode(d["images"], lay, Recording)
    rec = case(plan, "encode")
    assert len(cts) == 2
    assert_same(pts, rec["plaintexts"])
    assert_same(cts, rec)
    got = pc.decode_outputs(cts, lay, cg.C_IN, sk)
    np.testing.assert_allclose(got, rec["decoded"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got, d["images"], atol=1e-6)


@functools.lru_cache(maxsize=None)
def convolution(plan, name, batch):
    """eval_convolution of the case's filters on the stored inputs, with
    `batch` output channels per chunk; -> (PackedConv, layout, outputs)."""
    ctx, enc, gk = port(plan)
    pc = PackedConv(ctx, enc, scale=cg.SCALE, channel_batch=batch)
    lay = pc.layout(cg.IN_H, cg.F_H)
    filt = cg.data()["filt" if name == "conv" else "filt_pruned"]
    return pc, lay, pc.eval_convolution(filt, gk, conv_inputs(plan), lay)


@pytest.mark.parametrize("batch", [1, 2, 3])
@pytest.mark.parametrize("name", ["conv", "conv_pruned"])
@pytest.mark.parametrize("plan", PLANS)
def test_eval_convolution(plan, name, batch):
    pc, lay, out = convolution(plan, name, batch)
    rec = case(plan, name)
    assert_same(out, rec)
    got = pc.decode_outputs(out, lay, cg.C_OUT, input_key(plan))
    np.testing.assert_allclose(got, rec["decoded"], rtol=1e-9, atol=1e-12)
    d = cg.data()
    filt = d["filt" if name == "conv" else "filt_pruned"]
    np.testing.assert_allclose(got, ref_conv_same(d["images"], filt), atol=1e-3)


@pytest.mark.parametrize("plan", PLANS)
def test_batched_conv_is_one_channel_at_a_time(plan):
    """Chunks of 2 output channels give the residues and metadata of the
    channels one at a time."""
    assert convolution(plan, "conv_pruned", 2)[0].channel_batch(cg.C_OUT) == 2
    assert convolution(plan, "conv_pruned", 1)[0].channel_batch(cg.C_OUT) == 1
    for a, b in zip(convolution(plan, "conv_pruned", 2)[2],
                    convolution(plan, "conv_pruned", 1)[2]):
        assert torch.equal(a.data, b.data) and cg.meta(a) == cg.meta(b)


@pytest.mark.parametrize("name", ["conv", "conv_pruned"])
@pytest.mark.parametrize("plan", PLANS)
def test_chunk_rule_and_masks_per_encode(plan, name):
    """With two input ciphertexts (5 channels, 4 a ciphertext), the memory
    rule picks the chunk, and each mask encode holds one tap's masks of
    one chunk: one encode of the chunk's channels for each (input ct, tap)
    that is nonzero for some channel of the chunk, then one of its select
    masks.  So a chunk's masks never all exist at once, however many input
    ciphertexts the layer has."""
    ctx, enc, gk = port(plan)
    sizes = []

    class Counting:
        def __getattr__(self, attr):
            return getattr(enc, attr)

        @staticmethod
        def encode_coeff_poly(rows, *args, **kw):
            sizes.append(len(rows))
            return enc.encode_coeff_poly(rows, *args, **kw)

    pc = PackedConv(ctx, Counting(), scale=cg.SCALE)
    lay = pc.layout(cg.IN_H, cg.F_H)
    din = conv_inputs(plan)
    assert len(din) == 2
    per_ch = 10 * (ctx.level(1).size + ctx.params.size_P) * ctx.n * 8
    rule = min(cg.C_OUT, MAX_CHANNEL_BATCH, CPU_BATCH_BUDGET // per_ch)
    chunk = pc.channel_batch(cg.C_OUT)
    assert chunk == 1 << (rule.bit_length() - 1) == 2
    filt = cg.data()["filt" if name == "conv" else "filt_pruned"]
    out = pc.eval_convolution(filt, gk, din, lay)
    assert_same(out, case(plan, name))
    want = []
    for lo in range(0, cg.C_OUT, chunk):
        ks = list(range(lo, min(lo + chunk, cg.C_OUT)))
        taps = sum(bool(filt[ks][:, i * lay.n_i:(i + 1) * lay.n_i, di, dj].any())
                   for i in range(len(din)) for di in range(cg.F_H) for dj in range(cg.F_H))
        want += [len(ks)] * (taps + 1)
    assert sizes == want


def test_zero_output_channel():
    """An output channel whose filters are all zero is an exact zero, one
    channel at a time and in a chunk alike (the reference's loop raises on
    it: it has no term to rescale)."""
    ctx, enc, gk = port("q32")
    d = cg.data()
    filt = d["filt"].copy()
    filt[1] = 0.0
    outs = []
    for batch in (1, 2):
        pc = PackedConv(ctx, enc, scale=cg.SCALE, channel_batch=batch)
        lay = pc.layout(cg.IN_H, cg.F_H)
        outs.append(pc.eval_convolution(filt, gk, conv_inputs("q32"), lay))
    for a, b in zip(*outs):
        assert torch.equal(a.data, b.data) and cg.meta(a) == cg.meta(b)
    got = pc.decode_outputs(outs[0], lay, cg.C_OUT, input_key("q32"))
    np.testing.assert_allclose(got, ref_conv_same(d["images"], filt), atol=1e-3)


@pytest.mark.parametrize("name", ["fc", "fc_bias"])
@pytest.mark.parametrize("plan", PLANS)
def test_fully_connected(plan, name):
    ctx, enc, gk = port(plan)
    d = cg.data()
    rec = case(plan, name)
    ct = ciphertext_from_np(ctx, golden(plan)[0]["input/fc"], 1, cg.SCALE)
    diag = fc_weight_encode(enc, d["fc_weight"], cg.SCALE)
    assert_same(diag, rec["diagonals"])
    bias, want = None, d["fc_weight"] @ d["fc_x"]
    if name == "fc_bias":
        slots = enc.slots
        bias = enc.encode(np.pad(d["fc_bias"], (0, slots - cg.FC_ROWS)),
                          cg.bias_scale(ctx, ct.scale, diag[0].scale), chain_index=2,
                          slots=slots)
        assert_same([bias], rec["bias"])
        want = want + d["fc_bias"]
    out = fully_connected(ctx, gk, ct, diag, cg.FC_COLS, bias)
    assert_same([out], rec)
    got = enc.decode(input_key(plan).decrypt(out)).real[:cg.FC_ROWS]
    np.testing.assert_allclose(got, rec["decoded"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got, want, atol=1e-4)


# -- the evaluator's multiply_plain over a stacked plaintext ----------------

@pytest.mark.parametrize("plan", PLANS)
def test_multiply_plain_stacked(plan):
    """A stacked (B, L, N) plaintext multiplies a (B, 2, L, N) batch
    channel by channel; one (L, N) plaintext multiplies one ciphertext and
    every channel of a batch as it always did."""
    ctx, enc, _ = port(plan)
    cts = conv_inputs(plan)
    rng = np.random.default_rng(5)
    pts = [enc.encode(rng.uniform(-1, 1, enc.slots), cg.SCALE) for _ in cts]
    batch = stack_cts(cts)
    stacked_pt = pts[0].__class__(data=torch.stack([p.data for p in pts]), chain_index=1,
                                  scale=cg.SCALE)
    got = unstack_cts(ev.multiply_plain(ctx, batch, stacked_pt), len(cts))
    for g, c, p in zip(got, cts, pts):
        want = ev.multiply_plain(ctx, c, p)
        assert torch.equal(g.data, want.data) and cg.meta(g) == cg.meta(want)
    mod = ctx.level(1).mod
    one = ev.multiply_plain(ctx, cts[0], pts[0])
    assert isinstance(one, Ciphertext) and one.data.shape == cts[0].data.shape
    assert torch.equal(one.data, mod.mul(cts[0].data, pts[0].data[None]))
    for g, c in zip(unstack_cts(ev.multiply_plain(ctx, batch, pts[0]), len(cts)), cts):
        assert torch.equal(g.data, ev.multiply_plain(ctx, c, pts[0]).data)
