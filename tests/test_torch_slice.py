"""The port's CKKS slice end to end on the CPU: the reference's secret key
and ciphertexts carried across, and a relin key the port generates for
that secret handed to both; multiply -> relinearize -> rescale in both
packages, bit-identical per limb; decrypt/decode in the port within 1e-6
of the cleartext product.  Also the port's own
keygen -> encode -> encrypt -> multiply -> relinearize -> rescale ->
decrypt -> decode round trip, and the encoder's host layer (embedding,
rounding, RNS decomposition and CRT composition) against the reference's.

The plaintexts the reference encrypts come from the port's encoder, whose
forward NTT is held against the reference in test_torch_ntt.py."""

import numpy as np
import pytest
import torch

from test_torch_keyswitch import SCALE, contexts, jax_reference
from tpu_fhe.ops.w64 import W64
from tpu_fhe.scheme import ckks_encoder as jencoder
from tpu_fhe.scheme.ciphertext import Plaintext as JPlaintext
from tpu_fhe.scheme.keys import SecretKey as JSecretKey

from tpu_fhe_torch.eval import evaluator as ev
from tpu_fhe_torch.scheme import ckks_encoder
from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder
from tpu_fhe_torch.scheme.keys import SecretKey, encrypt_asymmetric
from tpu_fhe_torch.utils.convert import (
    ciphertext_from_np, plaintext_from_np, relin_key_from_np, relin_key_to_np,
    secret_key_from_np, to_numpy,
)

# The suite runs in several worker processes at once: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

N = 1024
TOL = 1e-6


@pytest.fixture(scope="module")
def carried():
    jctx, tctx = contexts(N)
    rng = np.random.default_rng(42)
    x, y = rng.standard_normal(N // 2), rng.standard_normal(N // 2)
    sk = JSecretKey(jctx, key=7)
    tsk = secret_key_from_np(tctx, sk.s_ntt.to_np())
    rlk = tsk.relin_key()
    enc = CkksEncoder(tctx)
    ct_x, ct_y = (
        sk.encrypt_symmetric(JPlaintext(W64.from_np(to_numpy(enc.encode(v, SCALE).data)),
                                        chain_index=1, scale=SCALE))
        for v in (x, y))
    ct_x, ct_y = ct_x.data.to_np(), ct_y.data.to_np()
    key_data, key_shoup = relin_key_to_np(rlk)
    ref = jax_reference(N)(ct_x, ct_y, key_data, key_shoup,
                           np.zeros((2, 1, N), dtype=np.uint64))
    return dict(tctx=tctx, jctx=jctx, x=x, y=y, ct_x=ct_x, ct_y=ct_y, ref=ref, sk=tsk,
                rlk=relin_key_from_np(tctx, key_data, key_shoup))


def test_encoder_host_layer_matches_reference(carried):
    tctx, jctx = carried["tctx"], carried["jctx"]
    base, jbase = tctx.level(1).base, jctx.level(1).base
    ours, ref = CkksEncoder(tctx), jencoder.CkksEncoder(jctx)
    coeffs = ours._embed_inverse(carried["x"])
    np.testing.assert_array_equal(coeffs, ref._embed_inverse(carried["x"]))
    np.testing.assert_array_equal(ours._embed_forward(coeffs), ref._embed_forward(coeffs))
    res = ckks_encoder._round_decompose(coeffs * SCALE, base)
    np.testing.assert_array_equal(res, jencoder._round_decompose(coeffs * SCALE, jbase))
    big = coeffs * 2.0 ** 70          # beyond int64: the exact big-int path
    res_big = ckks_encoder._round_decompose(big, base)
    np.testing.assert_array_equal(res_big, jencoder._round_decompose(big, jbase))
    assert ckks_encoder._compose_signed(res_big, base) == \
        jencoder._compose_signed(res_big, jbase)


def test_slice_bit_identical_and_decodes(carried):
    tctx = carried["tctx"]
    a = ciphertext_from_np(tctx, carried["ct_x"], 1, SCALE)
    b = ciphertext_from_np(tctx, carried["ct_y"], 1, SCALE)
    prod = ev.multiply(tctx, a, b)
    np.testing.assert_array_equal(to_numpy(prod.data), carried["ref"]["prod"])
    relin = ev.relinearize(tctx, prod, carried["rlk"])
    np.testing.assert_array_equal(to_numpy(relin.data), carried["ref"]["relin"])
    out = ev.rescale_to_next(tctx, relin)
    np.testing.assert_array_equal(to_numpy(out.data), carried["ref"]["rescale"])
    got = CkksEncoder(tctx).decode(carried["sk"].decrypt(out)).real
    assert np.max(np.abs(got - carried["x"] * carried["y"])) <= TOL


def test_decrypt_carried_plaintext(carried):
    tctx = carried["tctx"]
    pt = carried["sk"].decrypt(ciphertext_from_np(tctx, carried["ct_x"], 1, SCALE))
    got = CkksEncoder(tctx).decode(pt).real
    assert np.max(np.abs(got - carried["x"])) <= TOL
    back = plaintext_from_np(tctx, to_numpy(pt.data), 1, SCALE)
    assert torch.equal(back.data, pt.data)
    data, shoup = relin_key_to_np(carried["rlk"])
    assert data.dtype == shoup.dtype == np.uint64


@pytest.mark.parametrize("n", [1024, 4096])
def test_port_round_trip(n):
    _, tctx = contexts(n)
    sk = SecretKey(tctx, seed=n)
    pk, rlk = sk.public_key(), sk.relin_key()
    enc = CkksEncoder(tctx)
    rng = np.random.default_rng(n)
    x, y = rng.standard_normal(n // 2), rng.standard_normal(n // 2)
    ct_x = sk.encrypt_symmetric(enc.encode(x, SCALE))
    ct_y = encrypt_asymmetric(tctx, pk, enc.encode(y, SCALE),
                              torch.Generator().manual_seed(n + 1))
    for ct, want in ((ct_x, x), (ct_y, y)):
        assert np.max(np.abs(enc.decode(sk.decrypt(ct)).real - want)) <= TOL
    out = ev.rescale_to_next(tctx, ev.relinearize(tctx, ev.multiply(tctx, ct_x, ct_y), rlk))
    assert out.chain_index == 2 and out.data.shape == (2, 4, n)
    assert np.max(np.abs(enc.decode(sk.decrypt(out)).real - x * y)) <= TOL
    summed = ev.add(tctx, ct_x, ct_y)
    assert np.max(np.abs(enc.decode(sk.decrypt(summed)).real - (x + y))) <= TOL
    sq = ev.rescale_to_next(tctx, ev.relinearize(tctx, ev.square(tctx, ct_x), rlk))
    assert np.max(np.abs(enc.decode(sk.decrypt(sq)).real - x * x)) <= TOL
