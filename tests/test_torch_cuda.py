"""The port's CUDA kernels against their plain torch versions, on the card.

A CUDA kernel has no interpret mode, so these tests need an NVIDIA GPU and
nvcc; without a card they skip.  They import neither jax nor tpu_fhe, so
they run where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from tpu_fhe_torch.core.modulus import CoeffModulus
from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
from tpu_fhe_torch.eval import evaluator as ev
from tpu_fhe_torch.ops import bconv, ks, modarith as mm, ntt
from tpu_fhe_torch.scheme.context import FheContext
from tpu_fhe_torch.scheme.keys import SecretKey
from tpu_fhe_torch.utils.convert import (
    ciphertext_from_np, relin_key_from_np, relin_key_to_np, to_numpy,
)

pytestmark = pytest.mark.cuda

BITS = [60, 50, 50, 50, 50, 60, 60]


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=[1024, 4096])
def ctx(gpu, request):
    n = request.param
    return FheContext(EncryptionParameters(
        SchemeType.ckks, n, tuple(CoeffModulus.create(n, BITS)),
        special_modulus_size=2, allow_insecure=True), device=gpu)


def _res(ctx, q, *lead, seed=0):
    g = torch.Generator(device=ctx.device).manual_seed(seed)
    x = torch.randint(0, 1 << 62, lead + (q.shape[0], ctx.n), generator=g,
                      dtype=torch.int64, device=ctx.device)
    return x % q


def test_ntt_kernels_equal_plain(ctx):
    level = ctx.level(1)
    x = _res(ctx, level.mod.q, 2)
    assert torch.equal(ntt.forward_ntt(x, level.ntt), ntt.forward_ntt_plain(x, level.ntt))
    assert torch.equal(ntt.inverse_ntt(x, level.ntt), ntt.inverse_ntt_plain(x, level.ntt))
    kst = level.ks
    s = (kst.part_qhatinv, kst.part_qhatinv_shoup)
    assert torch.equal(ntt.inverse_ntt_scaled(x, level.ntt, *s),
                       ntt.inverse_ntt_plain(x, level.ntt, *s))
    sub = _res(ctx, level.mod.q, 2, seed=1)
    post = (kst.big_pinv_mod_q, kst.big_pinv_mod_q_shoup)
    for pre in ((None, None), post):
        assert torch.equal(ntt.forward_ntt_sub_scale(x, sub, level.ntt, *post, *pre),
                           ntt.forward_ntt_sub_scale_plain(x, sub, level.ntt, *post, *pre))
    view = kst.digits[2].comp_ntt                # a limb-mapped view
    y = _res(ctx, view.q, seed=2)
    assert torch.equal(ntt.forward_ntt(y, view), ntt.forward_ntt_plain(y, view))


def test_bconv_and_inner_product_equal_plain(ctx):
    level = ctx.level(1)
    kst = level.ks
    for dt in kst.digits:
        s = _res(ctx, level.mod.q[dt.start:dt.end], 2)
        tab = (dt.qhat_mod_p, dt.comp_mod.q, dt.comp_mod.ratio_lo, dt.comp_mod.ratio_hi)
        assert torch.equal(bconv.bconv_matmul(s, *tab), bconv.bconv_matmul_plain(s, *tab))
    kq = ctx.key_level.mod
    evk = _res(ctx, kq.q, 3, 2)
    evk_s = mm.shoup_of(evk, kq.q, kq.ratio_lo, kq.ratio_hi)
    t = _res(ctx, kst.qlp_q, kst.beta)
    args = (t, evk, evk_s, kst.qlp_key_rows, kst.qlp_q)
    assert torch.equal(ks.key_inner_prod_shoup(*args), ks.key_inner_prod_shoup_plain(*args))


def test_relinearize_rescale_equal_cpu(ctx):
    """The slice on the card equals the slice on the CPU, bit for bit."""
    cpu = FheContext(ctx.params, device="cpu")
    sk = SecretKey(cpu, seed=3)
    data, shoup = relin_key_to_np(sk.relin_key())
    rng = np.random.default_rng(4)
    qs = np.array(cpu.level(1).base.values, dtype=np.uint64)[:, None]
    c3 = rng.integers(0, 2**62, size=(3, len(qs), ctx.n), dtype=np.uint64) % qs
    outs = []
    for c in (cpu, ctx):
        ct = ciphertext_from_np(c, c3, 1, 2.0 ** 100)
        out = ev.rescale_to_next(c, ev.relinearize(c, ct, relin_key_from_np(c, data, shoup)))
        outs.append(to_numpy(out.data))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_wrappers_refuse_bad_input(ctx):
    level = ctx.level(1)
    x = _res(ctx, level.mod.q, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ntt.forward_ntt(x.transpose(0, 1).contiguous().transpose(0, 1), level.ntt)
    with pytest.raises(ValueError):
        ntt.forward_ntt(x[:, :3], level.ntt)
