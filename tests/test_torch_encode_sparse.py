"""The port's CKKS encode against tpu_fhe's, bit for bit per RNS limb, for
sparse slot counts on both plans.

For 2 <= slots < N/2 the reference embeds the slot vector at ring degree
2 * slots and scatters it at coefficient stride N / (2 * slots)
(tpu_fhe/scheme/ckks_encoder.py:62-99, 345-354).  Tiling the vector to N/2
slots and embedding at ring degree N gives the same values mathematically
but rounds differently: at N = 1024, slots = 16, some coefficients differ
by one after rounding.  The port follows the reference's path, so its
NTT-form plaintexts equal the reference's in every word, at N = 1024 and
4096, slots 4, 16, 64 and N/2, five seeds each.  The u64 plan uses the
chain [60, 50, 50, 60] (one special prime) at scale 2^50, the q32 plan
tests/test_torch_q32.py's composite chain at scale 2^58; both encode at
chain index 1.

The reference's plaintext is its encode's own composition
(``_embed_inverse_slots``, ``_round_decompose``, ``forward_ntt``) with the
forward NTT taken through its XLA path, jitted once per context: its
encode would take the Pallas kernel, whose interpret-mode compile costs
about 8 s per ring size on a CPU, and the two paths are held equal by the
reference's own tests."""

import functools

import jax
import numpy as np
import pytest
import torch

from tpu_fhe.core.modulus import CoeffModulus as JCoeffModulus
from tpu_fhe.core.params import EncryptionParameters as JParams, SchemeType as JScheme
from tpu_fhe.ops.ntt import forward_ntt as jforward_ntt
from tpu_fhe.scheme.ckks_encoder import CkksEncoder as JEncoder, _round_decompose
from tpu_fhe.scheme.context import FheContext as JContext

import test_torch_q32
from tpu_fhe_torch.core.modulus import CoeffModulus
from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder
from tpu_fhe_torch.scheme.context import FheContext
from tpu_fhe_torch.utils.convert import to_numpy

# The suite runs in several worker processes at once: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

U64_BITS = [60, 50, 50, 60]
SCALES = {"u64": 2.0 ** 50, "q32": 2.0 ** 58}
RINGS = (1024, 4096)
SEEDS = range(5)


@functools.lru_cache(maxsize=None)
def encoders(plan, n):
    """The reference's and the port's encoders on one plan's contexts."""
    if plan == "q32":
        jctx, tctx = test_torch_q32.contexts(n)
    else:
        jctx = JContext(JParams(scheme=JScheme.ckks, poly_modulus_degree=n,
                                coeff_modulus=tuple(JCoeffModulus.create(n, U64_BITS)),
                                special_modulus_size=1, allow_insecure=True))
        tctx = FheContext(EncryptionParameters(
            SchemeType.ckks, n, tuple(CoeffModulus.create(n, U64_BITS)),
            special_modulus_size=1, allow_insecure=True), device="cpu")
    jlevel = jctx.level(1)
    ntt = jax.jit(lambda d: jforward_ntt(d, jlevel.ntt))
    jenc = JEncoder(jctx)

    def reference(x, scale, slots):
        coeffs = jenc._embed_inverse_slots(x, slots) * scale
        return np.asarray(ntt(_round_decompose(coeffs, jlevel.base)))
    return reference, CkksEncoder(tctx)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("slots", [4, 16, 64, "half"])
@pytest.mark.parametrize("n", RINGS)
@pytest.mark.parametrize("plan", ["u64", "q32"])
def test_encode_matches_reference(plan, n, slots, seed):
    slots = n // 2 if slots == "half" else slots
    reference, tenc = encoders(plan, n)
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, slots) + 1j * rng.uniform(-1, 1, slots)
    want = reference(x, SCALES[plan], slots)
    got = tenc.encode(x, SCALES[plan], chain_index=1, slots=slots)
    assert got.data.dtype == tenc.context.dtype
    got = to_numpy(got.data).astype(np.uint64)
    diff = int(np.count_nonzero(got != want))
    assert diff == 0, f"{diff} of {want.size} words differ"
    # the decoded slots are the input's
    back = tenc.decode(tenc.encode(x, SCALES[plan], slots=slots), slots=slots)
    assert np.max(np.abs(back - x)) < 1e-6

