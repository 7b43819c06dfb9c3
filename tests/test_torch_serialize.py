"""The port's serializer (tpu_fhe_torch/utils/serialize.py) reads and
writes tpu_fhe's file format, on both plans at N = 64 (tools/dnn_golden.py's
stack).

  * Files tpu_fhe's utils/serialize.py wrote (tests/data/
    torch_batched_golden_{u64,q32}.npz, from tools/batched_golden.py: a
    ciphertext, a plaintext and the public, relin, Galois and secret keys)
    load into the port bit for bit, metadata included; the secret is the
    reference's own and the ciphertext the port's encryption the golden run
    fed it.
  * Files the port writes load into tpu_fhe's loaders (numpy loads and
    array wraps, no compilation) bit for bit.
  * The port's seed-compressed form round-trips within the port; a seeded
    file of the reference (its a drawn from threefry) raises ValueError.
  * save_tensor_ct / load_tensor_ct round-trip a tensor and its timers.
"""

import functools
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_fhe_torch.models import resnet20 as rn
from tpu_fhe_torch.models.dnn import TensorCT
from tpu_fhe_torch.scheme.ciphertext import Ciphertext, stack_cts
from tpu_fhe_torch.scheme.keys import evk_shoup
from tpu_fhe_torch.utils import serialize as ser, timer
from tpu_fhe_torch.utils.convert import to_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DATA = Path(__file__).resolve().parent / "data"
_spec = importlib.util.spec_from_file_location("dnn_golden", ROOT / "tools" / "dnn_golden.py")
dg = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(dg)

PLANS = ("u64", "q32")
KINDS = ("ciphertext", "plaintext", "public_key", "relin_key", "galois_key", "secret_key")


@functools.lru_cache(maxsize=None)
def golden(plan):
    with np.load(DATA / f"torch_batched_golden_{plan}.npz") as f:
        arrays = {k: f[k] for k in f.files}
    return arrays, json.loads(str(arrays.pop("meta")))


@functools.lru_cache(maxsize=None)
def port(plan):
    return dg.port_setup(plan, golden(plan)[0]["secret"])


@functools.lru_cache(maxsize=None)
def objects(plan) -> dict:
    """One object of each kind, the port's own."""
    ctx, enc, model, _, sk = port(plan)
    ct = model.enc_tensor(dg.layer_inputs()["x2"], sk=sk).cts[0]
    return dict(ciphertext=ct,
                plaintext=enc.encode(np.linspace(-0.5, 0.5, dg.SLOTS), ct.scale, slots=dg.SLOTS),
                public_key=sk.public_key(), relin_key=model.mul_key, galois_key=model.gk,
                secret_key=sk)


def file_of(plan, kind) -> io.BytesIO:
    return io.BytesIO(golden(plan)[0][f"file/{kind}"].tobytes())


def planes(buf: io.BytesIO, name: str = "") -> np.ndarray:
    """The uint64 words a file stores under lo/hi (hi absent, or the None
    the reference stores for a compact plaintext's: zero).  The golden
    file is this repository's, so its pickled None may be read."""
    with np.load(io.BytesIO(buf.getvalue()), allow_pickle=True) as f:
        lo = f[f"lo{name}"].astype(np.uint64)
        hi = f[f"hi{name}"] if f"hi{name}" in f.files else None
    hi = np.uint64(0) if hi is None or hi.dtype == object else hi.astype(np.uint64)
    return lo | (hi << np.uint64(32))


def loader(ctx, kind):
    return {"ciphertext": ser.load_ciphertext, "plaintext": ser.load_plaintext,
            "public_key": ser.load_public_key, "relin_key": ser.load_relin_key,
            "galois_key": ser.load_galois_key, "secret_key": ser.load_secret_key}[kind]


def data_of(obj) -> dict:
    """The payload tensors of an object, by the suffix of their planes."""
    if hasattr(obj, "keys"):
        return {f"_{elt}": k.data for elt, k in obj.keys.items()}
    return {"": obj.s_ntt if hasattr(obj, "s_ntt") else obj.data}


@pytest.mark.parametrize("plan,kind", [(p, k) for p in PLANS for k in KINDS])
def test_reference_file_loads_into_port(plan, kind):
    ctx = port(plan)[0]
    buf = file_of(plan, kind)
    got = loader(ctx, kind)(ctx, buf)
    for suffix, t in data_of(got).items():
        assert t.dtype == ctx.dtype and t.device == ctx.device
        assert np.array_equal(to_numpy(t).astype(np.uint64), planes(buf, suffix))
    if kind == "secret_key":
        assert np.array_equal(to_numpy(got.s_ntt).astype(np.uint64), golden(plan)[0]["secret"])
    if kind == "ciphertext":
        want = objects(plan)["ciphertext"]
        assert torch.equal(got.data, want.data)
        assert (got.chain_index, got.scale, got.noise_scale_deg, got.is_ntt_form) == \
            (want.chain_index, want.scale, want.noise_scale_deg, want.is_ntt_form)
    if kind == "relin_key":
        assert torch.equal(got.shoup, evk_shoup(ctx, got.data))
    if kind == "galois_key":
        assert sorted(got.keys) == json.loads(bytes(np.load(
            io.BytesIO(buf.getvalue()))["__meta__"]).decode())["elts"]
        assert all(k.shoup is None for k in got.keys.values())


def reference_loader(plan, kind):
    from tpu_fhe.utils import serialize as jser

    if kind == "secret_key":
        return lambda fp: jser.load_secret_key(reference_context(plan), fp)
    return getattr(jser, f"load_{kind}")


@functools.lru_cache(maxsize=None)
def reference_context(plan):
    from tpu_fhe.core.modulus import CoeffModulus
    from tpu_fhe.core.params import EncryptionParameters, SchemeType
    from tpu_fhe.scheme.context import FheContext

    return FheContext(dg.params(plan, CoeffModulus, EncryptionParameters, SchemeType))


def reference_words(x) -> np.ndarray:
    """A reference array (W64, compact W64 or bare uint32) as uint64."""
    if hasattr(x, "lo"):
        lo = np.asarray(x.lo).astype(np.uint64)
        hi = getattr(x, "hi_", None)
        return lo if hi is None else lo | (np.asarray(hi).astype(np.uint64) << np.uint64(32))
    return np.asarray(x).astype(np.uint64)


@pytest.mark.parametrize("plan,kind", [(p, k) for p in PLANS for k in KINDS])
def test_port_file_loads_into_reference(plan, kind):
    obj = objects(plan)[kind]
    buf = io.BytesIO()
    getattr(ser, f"save_{kind}")(obj, buf)
    buf.seek(0)
    back = reference_loader(plan, kind)(buf)
    if kind == "galois_key":
        assert sorted(back.keys) == sorted(obj.keys)
        for elt, key in obj.keys.items():
            assert np.array_equal(reference_words(back.keys[elt].data),
                                  to_numpy(key.data).astype(np.uint64))
        return
    got = back.s_ntt if kind == "secret_key" else back.data
    assert np.array_equal(reference_words(got), to_numpy(data_of(obj)[""]).astype(np.uint64))
    if kind in ("ciphertext", "plaintext"):
        assert (back.chain_index, back.scale, back.noise_scale_deg, back.is_ntt_form) == \
            (obj.chain_index, obj.scale, obj.noise_scale_deg, obj.is_ntt_form)


@pytest.mark.parametrize("plan", PLANS)
def test_seeded_round_trip(plan):
    """c0 and the seed, about half a full ciphertext's bytes, give the
    ciphertext back, which decrypts."""
    ctx, enc, model, _, sk = port(plan)
    pt = objects(plan)["plaintext"]
    ct, seed = sk.encrypt_symmetric_seeded(pt)
    buf, full = io.BytesIO(), io.BytesIO()
    ser.save_ciphertext_symmetric(ct, seed, buf)
    ser.save_ciphertext(ct, full)
    assert buf.tell() < 0.6 * full.tell()
    buf.seek(0)
    back = ser.load_ciphertext_symmetric(ctx, buf)
    assert torch.equal(back.data, ct.data) and back.scale == ct.scale
    np.testing.assert_allclose(enc.decode(sk.decrypt(back), slots=dg.SLOTS).real,
                               np.linspace(-0.5, 0.5, dg.SLOTS), atol=1e-6)


@pytest.mark.parametrize("plan", PLANS)
def test_reference_seeded_file_raises(plan):
    ctx = port(plan)[0]
    with pytest.raises(ValueError, match="threefry"):
        ser.load_ciphertext_symmetric(ctx, file_of(plan, "ciphertext_sym"))


@pytest.mark.parametrize("plan", PLANS)
def test_batched_ciphertext_round_trip(plan):
    """A stacked (2, 2, L, N) ciphertext round-trips whole."""
    ctx, _, model, _, sk = port(plan)
    stacked = stack_cts(model.enc_tensor(dg.layer_inputs()["x2"], sk=sk).cts)
    buf = io.BytesIO()
    ser.save_ciphertext(stacked, buf)
    buf.seek(0)
    back = ser.load_ciphertext(ctx, buf)
    assert isinstance(back, Ciphertext) and torch.equal(back.data, stacked.data)
    with pytest.raises(ValueError, match="expected plaintext"):
        buf.seek(0)
        ser.load_plaintext(ctx, buf)


def test_tensor_checkpoint_round_trip(tmp_path):
    """save_tensor_ct writes one file per channel and meta.json last;
    load_tensor_ct gives the tensor back and adds the saved timer buckets
    to this process's."""
    ctx, _, model, _, sk = port("q32")
    t = model.enc_tensor(dg.layer_inputs()["x2"], sk=sk)
    t = TensorCT(t.cts, t.width, slotstr=1)
    timer.clear()
    timer.add_accumulated("Bootstrap", 1.5)
    rn.save_tensor_ct(t, str(tmp_path), stage="l1b0", extra={"note": 7})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ch000.ct", "ch001.ct", "meta.json"]
    timer.clear()
    timer.add_accumulated("Bootstrap", 0.25)
    back, meta = rn.load_tensor_ct(ctx, str(tmp_path))
    assert (meta["stage"], meta["note"], meta["num_ch"]) == ("l1b0", 7, 2)
    assert (back.width, back.slotstr) == (t.width, t.slotstr)
    for a, b in zip(back.cts, t.cts):
        assert torch.equal(a.data, b.data)
        assert (a.chain_index, a.scale, a.noise_scale_deg) == \
            (b.chain_index, b.scale, b.noise_scale_deg)
    assert timer.accumulated() == {"Bootstrap": 1.75}
    timer.clear()
