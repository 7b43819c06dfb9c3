"""The port's special FFT (tpu_fhe_torch/ops/special_fft.py) and the
encoder's device embedding (CkksEncoder(ctx, device_embed=True)) against
tpu_fhe's, on the CPU.

The cases mirror tests/test_special_fft.py at its tolerances: the
transform against the reference's DeviceEmbedding and the host embedding
(inverse 1e-10, forward 1e-9) at logn 3, 6 and 10, the round trip at scale
2^40, a batch equal to its rows one at a time (atol 0), the encoder's
device path end to end on both plans, and the sparse path within 1e-10 of
the tiled one.  The device path rounds differently from the host's FFT, so
its rounded coefficients are held within one of the host path's (and of
the reference's device path's).  The packed convolution and FC layer run
on tests/test_torch_conv_packed.py's N = 512 golden inputs with a
device-embedding encoder: within 1e-6 of the golden runs' decoded outputs
and within 1e-3 / 1e-4 of numpy.  With device_embed off the encoder is the
host path that every golden test holds bit for bit."""

import functools
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpu_fhe.ops.special_fft import DeviceEmbedding as JEmbedding
from tpu_fhe.scheme.ckks_encoder import CkksEncoder as JEncoder

from tpu_fhe_torch.core.modulus import CoeffModulus
from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
from tpu_fhe_torch.models.conv_packed import PackedConv, fc_weight_encode, fully_connected
from tpu_fhe_torch.ops.special_fft import DeviceEmbedding
from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder
from tpu_fhe_torch.scheme.context import FheContext
from tpu_fhe_torch.scheme.keys import SecretKey
from tpu_fhe_torch.utils.convert import ciphertext_from_np, secret_key_from_np

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
RNG = np.random.default_rng(7)


def _slots(n, rng=RNG, lead=()):
    return rng.normal(size=lead + (n,)) + 1j * rng.normal(size=lead + (n,))


@functools.lru_cache(maxsize=None)
def context(plan):
    """The conv golden runs' context of `plan` (N = 512) on the CPU."""
    return FheContext(cg.params(plan, CoeffModulus, EncryptionParameters, SchemeType),
                      device="cpu")


# -- the transform ---------------------------------------------------------

@pytest.mark.parametrize("logn", [3, 6, 10])
def test_device_embedding_matches_reference_and_host(logn):
    n = 1 << logn
    host = CkksEncoder(FheContext(EncryptionParameters(
        SchemeType.ckks, n, tuple(CoeffModulus.create(n, [40, 30, 40])),
        special_modulus_size=1, allow_insecure=True), device="cpu"))
    dev, ref = DeviceEmbedding(n // 2, "cpu"), JEmbedding(n // 2)
    z = _slots(n // 2)

    coeffs = dev.embed_inverse(z)
    assert coeffs.dtype == torch.float64 and coeffs.shape == (n,)
    np.testing.assert_allclose(coeffs.numpy(), host._embed_inverse(z), rtol=0, atol=1e-10)
    np.testing.assert_allclose(coeffs.numpy(), ref.embed_inverse(z), rtol=0, atol=1e-10)

    c = host._embed_inverse(z)
    slots = dev.embed_forward(c)
    assert slots.dtype == torch.complex128 and slots.shape == (n // 2,)
    np.testing.assert_allclose(slots.numpy(), host._embed_forward(c), rtol=0, atol=1e-9)
    np.testing.assert_allclose(slots.numpy(), ref.embed_forward(c), rtol=0, atol=1e-9)


def test_device_embedding_roundtrip_large_scale():
    """Values at CKKS-scale magnitude: float64 survives 2^40."""
    dev = DeviceEmbedding(256, "cpu")
    z = _slots(256)
    coeffs = dev.embed_inverse(z) * 2.0 ** 40
    back = dev.embed_forward(coeffs / 2.0 ** 40)
    np.testing.assert_allclose(back.numpy(), z, rtol=0, atol=1e-9)


@pytest.mark.parametrize("lead", [(3,), (2, 3)])
def test_device_embedding_batched(lead):
    """Leading batch axes go through in one pass, equal to one row at a
    time in both directions."""
    dev = DeviceEmbedding(64, "cpu")
    z = torch.from_numpy(_slots(64, lead=lead))
    rows = z.reshape(-1, 64)
    batched = dev.embed_inverse(z)
    single = torch.stack([dev.embed_inverse(r) for r in rows]).reshape(lead + (128,))
    assert torch.equal(batched, single)
    back = dev.embed_forward(batched)
    one = torch.stack([dev.embed_forward(r) for r in batched.reshape(-1, 128)])
    assert torch.equal(back, one.reshape(lead + (64,)))


@pytest.mark.parametrize("n", [0, 1, 3, 48])
def test_device_embedding_refuses_bad_slot_count(n):
    with pytest.raises(ValueError, match="power of two"):
        DeviceEmbedding(n, "cpu")


# -- the encoder -----------------------------------------------------------

@pytest.mark.parametrize("slots", [16, 256])
@pytest.mark.parametrize("plan", PLANS)
def test_encoder_device_path_end_to_end(plan, slots):
    """encode -> encrypt -> decrypt -> decode within 1e-6 through the device
    path (decoded by either encoder); its rounded coefficients within one
    of the host path's and of the reference's device path's."""
    ctx = context(plan)
    n = ctx.n
    enc_dev, enc_host = CkksEncoder(ctx, device_embed=True), CkksEncoder(ctx)
    assert enc_dev.device_embed and not enc_host.device_embed
    sk = SecretKey(ctx, seed=3)
    x = RNG.uniform(-1, 1, slots)
    scale = cg.SCALE
    ct = sk.encrypt_symmetric(enc_dev.encode(x, scale, slots=slots))
    for enc in (enc_host, enc_dev):
        out = enc.decode(sk.decrypt(ct), slots=slots)
        assert isinstance(out, np.ndarray)
        np.testing.assert_allclose(out.real, x, atol=1e-6)

    values = x.astype(np.complex128)
    dev = torch.round(enc_dev._embed_inverse_slots(values, slots) * scale)
    host = np.rint(enc_host._embed_inverse_slots(values, slots) * scale)
    ref = np.rint(JEncoder(SimpleNamespace(n=n), device_embed=True)
                  ._embed_inverse_slots(values, slots) * scale)
    assert dev.shape == (n,)
    assert np.max(np.abs(dev.numpy() - host)) <= 1
    assert np.max(np.abs(dev.numpy() - ref)) <= 1


@pytest.mark.parametrize("m", [2, 8, 64])
def test_sparse_device_path_matches_tiled(m):
    """The sparse path (a transform at ring degree 2m scattered at stride
    N / 2m) within 1e-10 of the tiled host embedding and of the
    reference's device path."""
    ctx = context("u64")
    n = ctx.n
    z = _slots(m)
    fast = CkksEncoder(ctx, device_embed=True)._embed_inverse_slots(z, m)
    tiled = CkksEncoder(ctx)._embed_inverse(np.tile(z, (n // 2) // m))
    np.testing.assert_allclose(fast.numpy(), tiled, rtol=0, atol=1e-10)
    ref = JEncoder(SimpleNamespace(n=n), device_embed=True)._embed_inverse_slots(z, m)
    np.testing.assert_allclose(fast.numpy(), ref, rtol=0, atol=1e-10)


@pytest.mark.parametrize("magnitude", [2.0 ** 40, 2.0 ** 70])
def test_residues_of_a_tensor_equal_those_of_numpy(magnitude):
    """The device path's round and reduction (a tensor) equals the host
    path's (a numpy array) on the same coefficients, bit for bit: in int64
    below 2^62, through exact integers at and above it."""
    ctx = FheContext(EncryptionParameters(
        SchemeType.ckks, 64, tuple(CoeffModulus.create(64, [60] * 3 + [60])),
        special_modulus_size=1, allow_insecure=True), device="cpu")
    enc = CkksEncoder(ctx, device_embed=True)
    coeffs = RNG.uniform(-1, 1, (3, 64)) * magnitude
    coeffs[0, :4] = [0.5, 1.5, -2.5, -0.5]
    base = ctx.level(1).base
    assert torch.equal(enc._residues(torch.from_numpy(coeffs), base), enc._residues(coeffs, base))


@pytest.mark.parametrize("plan", PLANS)
def test_embed_rows_and_embed_for_slots(plan):
    """embed_for_slots returns float64 numpy in both modes; embed_rows is
    the rows' embed_for_slots, a numpy array equal bit for bit on the host
    path, a tensor within 1e-10 through the device embedding."""
    ctx = context(plan)
    enc_dev, enc_host = CkksEncoder(ctx, device_embed=True), CkksEncoder(ctx)
    for slots in (16, ctx.n // 2):
        rows = RNG.uniform(-1, 1, (3, slots))
        want = np.stack([enc_host.embed_for_slots(r, slots) for r in rows])
        got_host = enc_host.embed_rows(torch.from_numpy(rows), slots)
        assert isinstance(got_host, np.ndarray) and np.array_equal(got_host, want)
        got_dev = enc_dev.embed_rows(torch.from_numpy(rows), slots)
        np.testing.assert_allclose(got_dev.numpy(), want, rtol=0, atol=1e-10)
        one = enc_dev.embed_for_slots(rows[0], slots)
        assert isinstance(one, np.ndarray) and one.dtype == np.float64
        np.testing.assert_allclose(one, want[0], rtol=0, atol=1e-10)


# -- the packed layers on the golden inputs ---------------------------------

@functools.lru_cache(maxsize=None)
def golden(plan):
    with np.load(DATA / f"torch_conv_packed_golden_{plan}.npz") as f:
        arrays = {k: f[k] for k in f.files}
    return arrays, json.loads(str(arrays.pop("meta")))


@functools.lru_cache(maxsize=None)
def device_setup(plan):
    """The golden run's context and Galois keys (the port's, under the
    reference's secret), with a device-embedding encoder, and the input
    key."""
    arrays = golden(plan)[0]
    ctx, _, gk = cg.port_setup(plan, arrays["secret"])
    sk = secret_key_from_np(ctx, arrays["secret"], seed=cg.INPUT_SEED)
    return ctx, CkksEncoder(ctx, device_embed=True), gk, sk


def ref_conv_same(images, filt):
    c_out, c_in, f, _ = filt.shape
    h = images.shape[1]
    p = (f - 1) // 2
    padded = np.pad(images, ((0, 0), (p, p), (p, p)))
    return sum(np.einsum("kc,cij->kij", filt[:, :, i, j], padded[:, i:i + h, j:j + h])
               for i in range(f) for j in range(f))


@pytest.mark.parametrize("name", ["conv", "conv_pruned"])
@pytest.mark.parametrize("plan", PLANS)
def test_packed_conv_with_device_embedding(plan, name):
    ctx, enc, gk, sk = device_setup(plan)
    arrays, meta = golden(plan)
    din = [ciphertext_from_np(ctx, arrays[f"input/conv/{i}"], **m)
           for i, m in enumerate(meta["cases"]["encode"]["meta"])]
    pc = PackedConv(ctx, enc, scale=cg.SCALE)
    lay = pc.layout(cg.IN_H, cg.F_H)
    d = cg.data()
    filt = d["filt" if name == "conv" else "filt_pruned"]
    got = pc.decode_outputs(pc.eval_convolution(filt, gk, din, lay), lay, cg.C_OUT, sk)
    assert pc.mask_seconds > 0.0
    np.testing.assert_allclose(got, meta["cases"][name]["decoded"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, ref_conv_same(d["images"], filt), atol=1e-3)


@pytest.mark.parametrize("name", ["fc", "fc_bias"])
@pytest.mark.parametrize("plan", PLANS)
def test_fully_connected_with_device_embedding(plan, name):
    ctx, enc, gk, sk = device_setup(plan)
    arrays, meta = golden(plan)
    d = cg.data()
    ct = ciphertext_from_np(ctx, arrays["input/fc"], 1, cg.SCALE)
    diag = fc_weight_encode(enc, d["fc_weight"], cg.SCALE)
    bias, want = None, d["fc_weight"] @ d["fc_x"]
    if name == "fc_bias":
        bias = enc.encode(np.pad(d["fc_bias"], (0, enc.slots - cg.FC_ROWS)),
                          cg.bias_scale(ctx, ct.scale, diag[0].scale), chain_index=2,
                          slots=enc.slots)
        want = want + d["fc_bias"]
    out = fully_connected(ctx, gk, ct, diag, cg.FC_COLS, bias)
    got = enc.decode(sk.decrypt(out)).real[:cg.FC_ROWS]
    np.testing.assert_allclose(got, meta["cases"][name]["decoded"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, want, atol=1e-4)
