"""The port's CUDA kernels against their plain torch versions, on the card:
the u64 plan's (K1-K3, K7, K8, K11, K12) on a 50/60-bit chain, the q32
plan's (K4-K6, K9, K10, K13) on a composite chain of 30-bit primes, the
one-cluster-launch transforms (K1-K6) at every ring size from 2^10 to
2^17, the tensor-core base conversions (K11, K12, K13) over their ranges of
inputs and outputs, K9 over batches, digit counts and ring sizes, and each
slice
(relinearize and rescale; rotate, conjugate and the hoisted rotation sum;
the FLEXIBLEAUTO ops, raise_mod and a Chebyshev series; the encoder's QlP
plaintexts) on the card against the same slice on the CPU, and one N = 2^12
bootstrap, one DNN conv and one batch norm, the packed convolution and the
diagonal FC layer at N = 2^10, and BFV's and BGV's multiply paths at
N = 2^12, through the kernels against the same through the plain versions;
a limb-sharded relinearize at N = 2^12 in two gloo ranks on the card
against the one-process relinearize;
K9 over a chunk of the packed convolution's output channels at N = 2^16;
the encoder's device embedding (ops/special_fft.py) on the card against the
host's float64 embedding, and a device-embedding encode against the host
path's.
Every method of the graph-replaying Evaluator equals the eager op through
its CUDA graph, at small rings and at 2^15, and raises when its capture
fails.

A CUDA kernel has no interpret mode, so these tests need an NVIDIA GPU and
nvcc; without a card they skip.  They import neither jax nor tpu_fhe, so
they run where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from tpu_fhe_torch.core.modulus import CoeffModulus
from tpu_fhe_torch.core.ntt_tables import make_ntt_tables, shoup_np
from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
from tpu_fhe_torch.eval import auto, chebyshev as cheb, evaluator as ev, hoisting as ho
from tpu_fhe_torch.eval.jit import Evaluator
from tpu_fhe_torch.ops.galois import galois_elt_from_step
from tpu_fhe_torch.ops import _build, bconv, ks, modarith as mm, ntt
from tpu_fhe_torch.ops.ntt import build_device_ntt_tables
from tpu_fhe_torch.scheme.context import FheContext
from tpu_fhe_torch.scheme.keys import SecretKey
from tpu_fhe_torch.utils.convert import (
    ciphertext_from_np, galois_key_from_np, galois_key_to_np, plaintext_from_np,
    relin_key_from_np, relin_key_to_np, to_numpy,
)

pytestmark = pytest.mark.cuda

BITS = [60, 50, 50, 50, 50, 60, 60]
# an anchor pair, two data pairs, four special primes: beta = 2 with a
# ragged last digit at chain index 1
COMPOSITE = dict(scale_bits=58, levels=2, degree=2, anchor_bits=30, special_bits=30,
                 special_count=4)


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
        tab = (dt.qhat_mod_p, dt.comp_mod.q, dt.comp_mod.ratio_lo, dt.comp_mod.ratio_hi,
               dt.qhat_mod_p_diag)
        assert torch.equal(bconv.bconv_matmul(s, *tab), bconv.bconv_matmul_plain(s, *tab))
    kq = ctx.key_level.mod
    evk = _res(ctx, kq.q, 3, 2)
    evk_s = mm.shoup_of(evk, kq.q, kq.ratio_lo, kq.ratio_hi)
    t = _res(ctx, kst.qlp_mod.q, kst.beta)
    args = (t, evk, evk_s, kst.qlp_key_rows, kst.qlp_mod.q)
    assert torch.equal(ks.key_inner_prod_shoup(*args), ks.key_inner_prod_shoup_plain(*args))


def test_inner_product_without_shoup_equals_plain(ctx):
    """K7 at chain index 1 (beta = 3) and 4 (beta = 1 < dnum: the P rows of
    the key are no prefix of QlP's)."""
    kq = ctx.key_level.mod
    evk = _res(ctx, kq.q, 3, 2)
    for ci in (1, 4):
        kst = ctx.level(ci).ks
        qlp = kst.qlp_mod
        t = _res(ctx, qlp.q, kst.beta, seed=ci)
        args = (t, evk, kst.qlp_key_rows, qlp.q, qlp.ratio_lo, qlp.ratio_hi)
        assert torch.equal(ks.key_inner_prod(*args), ks.key_inner_prod_plain(*args))


def _rotation_outputs(c, ct, gk):
    return [ev.rotate(c, ct, 1, gk), ev.rotate(c, ct, 3, gk), ev.conjugate(c, ct, gk),
            ho.hoisted_rotation_sum(c, ct, (0, 1, -1, 4), gk)]


def _rotations_equal_cpu(gpu_ctx, word):
    """rotate (keyed and NAF-composed), conjugate and a hoisted sum on the
    card equal the same calls on a CPU context, with one key set."""
    cpu = FheContext(gpu_ctx.params, device="cpu")
    keys = galois_key_to_np(SecretKey(cpu, seed=3).galois_key([1, -1, 4], include_conj=True))
    rng = np.random.default_rng(6)
    qs = np.array(cpu.level(1).base.values, dtype=np.uint64)[:, None]
    c2 = (rng.integers(0, 2**62, size=(2, len(qs), cpu.n), dtype=np.uint64) % qs).astype(word)
    outs = []
    for c in (cpu, gpu_ctx):
        ct = ciphertext_from_np(c, c2, 1, 2.0 ** 40)
        outs.append([to_numpy(o.data) for o in
                     _rotation_outputs(c, ct, galois_key_from_np(c, keys))])
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(got, want)


def test_rotations_equal_cpu(ctx):
    _rotations_equal_cpu(ctx, np.uint64)


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
    kst = level.ks
    qlp = kst.qlp_mod
    t = _res(ctx, qlp.q, kst.beta)
    evk = _res(ctx, ctx.key_level.mod.q, 3, 2)
    args = (kst.qlp_key_rows, qlp.q, qlp.ratio_lo, qlp.ratio_hi)
    with pytest.raises(ValueError):                              # wrong word
        ks.key_inner_prod(t.to(torch.int32), evk, *args)
    with pytest.raises(ValueError):                              # key on the CPU
        ks.key_inner_prod(t, evk.cpu(), *args)
    with pytest.raises(ValueError, match="beta"):                # beta > 64
        ks.key_inner_prod(t[:1].expand(65, -1, -1).contiguous(), evk, *args)
    with pytest.raises(ValueError):                              # key of another N
        ks.key_inner_prod(t, evk[..., :-1].contiguous(), *args)
    with pytest.raises(ValueError):                              # fold of the wrong shape
        ks.key_inner_prod32(t.to(torch.int32), evk.to(torch.int32), kst.qlp_key_rows,
                            qlp.q.to(torch.int32), torch.zeros((5, 1, 1), dtype=torch.int64,
                                                               device=ctx.device))


# -- the q32 plan ------------------------------------------------------------

@pytest.fixture(scope="module", params=[1024, 4096])
def ctx32(gpu, request):
    n = request.param
    return FheContext(EncryptionParameters(
        SchemeType.ckks, n, tuple(CoeffModulus.create_composite(n, **COMPOSITE)),
        special_modulus_size=COMPOSITE["special_count"], composite_degree=2,
        allow_insecure=True), device=gpu)


def _res32(ctx, q, *lead, seed=0):
    return _res(ctx, q.to(torch.int64), *lead, seed=seed).to(torch.int32)


def test_q32_ntt_kernels_equal_plain(ctx32):
    """K4, K5 (with and without a scale) and K6 (with and without pre)."""
    level = ctx32.level(1)
    assert ctx32.is_q32 and level.ntt.is_q32
    x = _res32(ctx32, level.mod.q, 2)
    assert torch.equal(ntt.forward_ntt(x, level.ntt), ntt.forward_ntt_plain(x, level.ntt))
    assert torch.equal(ntt.inverse_ntt(x, level.ntt), ntt.inverse_ntt_plain(x, level.ntt))
    kst = level.ks
    s = (kst.part_qhatinv, kst.part_qhatinv_shoup)
    assert torch.equal(ntt.inverse_ntt_scaled(x, level.ntt, *s),
                       ntt.inverse_ntt_plain(x, level.ntt, *s))
    sub = _res32(ctx32, level.mod.q, 2, seed=1)
    post = (kst.big_pinv_mod_q, kst.big_pinv_mod_q_shoup)
    for pre in ((None, None), post):
        assert torch.equal(ntt.forward_ntt_sub_scale(x, sub, level.ntt, *post, *pre),
                           ntt.forward_ntt_sub_scale_plain(x, sub, level.ntt, *post, *pre))
    view = kst.digits[1].comp_ntt                # a limb-mapped view
    y = _res32(ctx32, view.q, seed=2)
    assert torch.equal(ntt.forward_ntt(y, view), ntt.forward_ntt_plain(y, view))


def test_q32_ntt_equals_u64_ntt(ctx32):
    """K4 and K5 compute K1's and K2's function: the same 30-bit moduli
    through int64 tables give the same residues."""
    level = ctx32.level(1)
    wide = build_device_ntt_tables(
        [make_ntt_tables(ctx32.params.log_n, v) for v in level.base.values], ctx32.device,
        q32=False)
    x = _res32(ctx32, level.mod.q, 2)
    x64 = x.to(torch.int64)
    assert torch.equal(ntt.forward_ntt(x, level.ntt).to(torch.int64),
                       ntt.forward_ntt(x64, wide))
    assert torch.equal(ntt.inverse_ntt(x, level.ntt).to(torch.int64),
                       ntt.inverse_ntt(x64, wide))


def test_q32_bconv_and_inner_product_equal_plain(ctx32):
    """K13 on every modup digit and on moddown's conversion, then K10."""
    level = ctx32.level(1)
    kst = level.ks
    for dt in kst.digits:
        s = _res32(ctx32, level.mod.q[dt.start:dt.end], 2)
        tab = (dt.qhat_mod_p, dt.comp_mod.q, dt.comp_mod.fold, dt.qhat_mod_p_diag)
        assert torch.equal(bconv.bconv_matmul32(s, *tab), bconv.bconv_matmul32_plain(s, *tab))
    s = _res32(ctx32, kst.p_mod.q, 2, seed=3)
    tab = (kst.p_hat_mod_q, level.mod.q, level.mod.fold, kst.p_hat_mod_q_diag)
    assert torch.equal(bconv.bconv_matmul32(s, *tab), bconv.bconv_matmul32_plain(s, *tab))
    # 40 inputs: five K steps of the kernel's product, the last one ragged
    primes = [m.value for m in CoeffModulus.create(ctx32.n, [30] * 48)]
    q_in, q_out = (torch.tensor(v, dtype=torch.int32, device=ctx32.device).reshape(-1, 1)
                   for v in (primes[:40], primes[40:]))
    s = _res32(ctx32, q_in, 2, seed=4)
    g = torch.Generator(device=ctx32.device).manual_seed(5)
    table = (torch.randint(0, 1 << 30, (8, 40), generator=g, dtype=torch.int64,
                           device=ctx32.device) % q_out.to(torch.int64)).to(torch.int32)
    fold = torch.from_numpy(mm.q32_mul_consts(primes[40:]).astype(np.int64).reshape(5, 8, 1))
    tab = (table, q_out, fold.to(ctx32.device), bconv.digit_matrix32(table))
    assert torch.equal(bconv.bconv_matmul32(s, *tab), bconv.bconv_matmul32_plain(s, *tab))
    kq = ctx32.key_level.mod
    evk = _res32(ctx32, kq.q, 2, 2)
    evk_s = mm.shoup32_of(evk, kq.q)
    t = _res32(ctx32, kst.qlp_mod.q, kst.beta)
    args = (t, evk, evk_s, kst.qlp_key_rows, kst.qlp_mod.q)
    assert torch.equal(ks.key_inner_prod_shoup(*args), ks.key_inner_prod_shoup_plain(*args))


def test_q32_inner_product_without_shoup_equals_plain(ctx32):
    """K9 at chain index 1 (QlP is all 10 key rows) and 2 (9 of them), then
    with 40 digits of a synthetic key, whose 96-bit sums use the carry
    word."""
    kq = ctx32.key_level.mod
    evk = _res32(ctx32, kq.q, 2, 2)
    for ci in (1, 2):
        kst = ctx32.level(ci).ks
        qlp = kst.qlp_mod
        t = _res32(ctx32, qlp.q, kst.beta, seed=ci)
        args = (t, evk, kst.qlp_key_rows, qlp.q, qlp.fold)
        assert torch.equal(ks.key_inner_prod32(*args), ks.key_inner_prod32_plain(*args))
    kst = ctx32.level(1).ks
    qlp = kst.qlp_mod
    big = _res32(ctx32, kq.q, 40, 2, seed=9)
    t = _res32(ctx32, qlp.q, 40, seed=10)
    args = (t, big, kst.qlp_key_rows, qlp.q, qlp.fold)
    assert torch.equal(ks.key_inner_prod32(*args), ks.key_inner_prod32_plain(*args))


@pytest.mark.parametrize("batch", [1, 2, 3, 5, 16])
def test_batched_inner_products_equal_plain(ctx, ctx32, batch):
    """K7-K10 over a batch (B, beta, QlP, N) of digit sets sharing a key:
    one launch, equal to the plain version and to the one-set kernel on
    each set (per-thread batches of 1, 2 and 4, a ragged last one, grid.z
    of 4)."""
    for c, res in ((ctx, _res), (ctx32, _res32)):
        kst, kq = c.level(1).ks, c.key_level.mod
        qlp, rows = kst.qlp_mod, kst.qlp_key_rows
        dnum = -(-c.params.size_Q // c.params.size_P)
        evk = res(c, kq.q, dnum, 2)
        if c.is_q32:
            evk_s = mm.shoup32_of(evk, kq.q)
            no_shoup = (ks.key_inner_prod32, ks.key_inner_prod32_plain, (rows, qlp.q, qlp.fold))
        else:
            evk_s = mm.shoup_of(evk, kq.q, kq.ratio_lo, kq.ratio_hi)
            no_shoup = (ks.key_inner_prod, ks.key_inner_prod_plain,
                         (rows, qlp.q, qlp.ratio_lo, qlp.ratio_hi))
        t = res(c, qlp.q, batch, kst.beta, seed=batch)
        forms = [(ks.key_inner_prod_shoup, ks.key_inner_prod_shoup_plain,
                  (evk, evk_s, rows, qlp.q)), (no_shoup[0], no_shoup[1], (evk,) + no_shoup[2])]
        for kernel, plain, args in forms:
            before = sum(k.launches for k in (ks.KS, ks.KS32, ks.KS_SHOUP, ks.KS_SHOUP32))
            got = kernel(t, *args)
            after = sum(k.launches for k in (ks.KS, ks.KS32, ks.KS_SHOUP, ks.KS_SHOUP32))
            assert after - before == 1
            assert got.shape == (batch, 2) + t.shape[-2:]
            assert torch.equal(got, plain(t, *args))
            assert torch.equal(got, torch.stack([kernel(t[b], *args) for b in range(batch)]))


def test_q32_rotations_equal_cpu(ctx32):
    _rotations_equal_cpu(ctx32, np.uint32)


def test_q32_relinearize_rescale_composite_equal_cpu(ctx32):
    """The q32 slice on the card equals the q32 slice on the CPU."""
    cpu = FheContext(ctx32.params, device="cpu")
    sk = SecretKey(cpu, seed=3)
    data, shoup = relin_key_to_np(sk.relin_key())
    assert data.dtype == shoup.dtype == np.uint32
    rng = np.random.default_rng(4)
    qs = np.array(cpu.level(1).base.values, dtype=np.uint64)[:, None]
    c3 = (rng.integers(0, 2**62, size=(3, len(qs), ctx32.n), dtype=np.uint64) % qs)
    outs = []
    for c in (cpu, ctx32):
        ct = ciphertext_from_np(c, c3.astype(np.uint32), 1, 2.0 ** 116)
        relin = ev.relinearize(c, ct, relin_key_from_np(c, data, shoup))
        outs.append(to_numpy(ev.rescale_composite(c, relin).data))
    np.testing.assert_array_equal(outs[0], outs[1])


# -- K13 and K4 as redesigned for the card ------------------------------------

_PRIMES30 = {}


class _Dev:
    """The two fields _res reads from a context."""

    def __init__(self, device, n):
        self.device, self.n = device, n


def _primes30(n: int, count: int) -> list[int]:
    """`count` distinct 30-bit NTT primes for ring size n (at most 128)."""
    if (n, count) not in _PRIMES30:
        _PRIMES30[n, count] = [m.value for m in CoeffModulus.create(n, [30] * count)]
    return _PRIMES30[n, count]


@pytest.mark.parametrize("m", [1, 7, 59, 60, 89])
@pytest.mark.parametrize("k", [1, 29, 30, 40, 90])
def test_q32_bconv_tensor_core_equals_plain(gpu, k, m):
    """K13's int8 tensor-core kernel against its plain version: every k
    (ragged K steps, up to 12 of them) and m (odd m leaves half an M tile),
    batch 2, at N = 2^10 and 2^15; moduli of 30 bits."""
    primes = _primes30(1 << 15, 128)
    q_in = [primes[(m + i) % 128] for i in range(k)]
    q_out = primes[:m]
    g = torch.Generator(device=gpu).manual_seed(100 * k + m)
    qo = torch.tensor(q_out, dtype=torch.int64, device=gpu).reshape(-1, 1)
    table = (torch.randint(0, 1 << 30, (m, k), generator=g, dtype=torch.int64, device=gpu)
             % qo).to(torch.int32)
    fold = torch.from_numpy(mm.q32_mul_consts(q_out).astype(np.int64).reshape(5, m, 1))
    tab = (table, qo.to(torch.int32), fold.to(gpu), bconv.digit_matrix32(table))
    qi = torch.tensor(q_in, dtype=torch.int64, device=gpu).reshape(-1, 1)
    for n in (1 << 10, 1 << 15):
        s = (torch.randint(0, 1 << 62, (2, k, n), generator=g, dtype=torch.int64, device=gpu)
             % qi).to(torch.int32)
        assert torch.equal(bconv.bconv_matmul32(s, *tab), bconv.bconv_matmul32_plain(s, *tab))


def test_q32_bconv_long_sum_and_ragged_n(gpu):
    """More than one launch's 512 inputs (the second adds mod p in its
    landing), and N not a multiple of the 64-coefficient tile."""
    primes = _primes30(1 << 10, 64)
    k, m, n = 600, 5, 1000
    q_in = [primes[i % 64] for i in range(k)]
    g = torch.Generator(device=gpu).manual_seed(7)
    qo = torch.tensor(primes[:m], dtype=torch.int64, device=gpu).reshape(-1, 1)
    table = (torch.randint(0, 1 << 30, (m, k), generator=g, dtype=torch.int64, device=gpu)
             % qo).to(torch.int32)
    fold = torch.from_numpy(mm.q32_mul_consts(primes[:m]).astype(np.int64).reshape(5, m, 1))
    tab = (table, qo.to(torch.int32), fold.to(gpu), bconv.digit_matrix32(table))
    qi = torch.tensor(q_in, dtype=torch.int64, device=gpu).reshape(-1, 1)
    s = (torch.randint(0, 1 << 62, (k, n), generator=g, dtype=torch.int64, device=gpu)
         % qi).to(torch.int32)
    assert torch.equal(bconv.bconv_matmul32(s, *tab), bconv.bconv_matmul32_plain(s, *tab))


@pytest.mark.parametrize("log_n", [10, 13, 14, 15, 16, 17])
def test_q32_ntt_fwd_cluster_equals_plain_and_u64(gpu, log_n):
    """K4 (one launch; clusters of 1, 1, 2, 4, 4 and 8 blocks) against its
    plain version and against K1 on the same 30-bit moduli, through the
    full tables, a level slice and a digit complement (a non-identity
    limb_map), with 2 x L rows."""
    n = 1 << log_n
    qs = _primes30(n, 6)
    key = build_device_ntt_tables([make_ntt_tables(log_n, q) for q in qs], gpu, q32=True)
    wide = build_device_ntt_tables([make_ntt_tables(log_n, q) for q in qs], gpu, q32=False)
    for idx in (list(range(6)), [0, 1, 2, 3], [4, 1, 3]):
        view, view64 = key.slice_limbs(idx), wide.slice_limbs(idx)
        x = _res32(_Dev(gpu, n), view.q, 2, seed=log_n)
        got = ntt.forward_ntt(x, view)
        assert torch.equal(got, ntt.forward_ntt_plain(x, view))
        assert torch.equal(got.to(torch.int64), ntt.forward_ntt(x.to(torch.int64), view64))


# -- K1 and K5 as one cluster launch per limb ---------------------------------

_BITS64 = [60, 50, 50, 60, 50, 60]


@pytest.mark.parametrize("log_n", [10, 11, 12, 13, 14, 15, 16, 17])
def test_ntt_fwd_cluster_equals_plain(gpu, log_n):
    """K1 (one launch; clusters of 1, 1, 1, 2, 4, 4, 8 and 8 blocks) against
    its plain version through the full tables, a level slice and a digit
    complement (a non-identity limb_map), with 2 x L rows."""
    n = 1 << log_n
    qs = [m.value for m in CoeffModulus.create(n, _BITS64)]
    key = build_device_ntt_tables([make_ntt_tables(log_n, q) for q in qs], gpu)
    for idx in (list(range(6)), [0, 1, 2, 3], [4, 1, 3]):
        view = key.slice_limbs(idx)
        x = _res(_Dev(gpu, n), view.q, 2, seed=log_n)
        assert torch.equal(ntt.forward_ntt(x, view), ntt.forward_ntt_plain(x, view))


def test_ntt_fwd_cluster_2_17_full_width(gpu):
    """K1's shape at 2^17, 8 blocks of 128 KB per limb (one block per SM),
    at the u64 plan's keyswitch width: 2 x 30 limbs, 480 blocks in several
    waves."""
    n = 1 << 17
    qs = [m.value for m in CoeffModulus.create(n, [60] + [50] * 29)]
    t = build_device_ntt_tables([make_ntt_tables(17, q) for q in qs], gpu)
    x = _res(_Dev(gpu, n), t.q, 2, seed=17)
    assert torch.equal(ntt.forward_ntt(x, t), ntt.forward_ntt_plain(x, t))


@pytest.mark.parametrize("log_n", [10, 11, 12, 13, 14, 15, 16, 17])
def test_q32_ntt_inv_cluster_equals_plain_and_u64(gpu, log_n):
    """K5 (one launch) against its plain version with and without a scale,
    through three limb maps with 2 x L rows and at rescale's shapes (1 limb
    x 2 rows, 2 limbs x 2 rows), and against K2 on the same 30-bit moduli."""
    n = 1 << log_n
    qs = _primes30(n, 6)
    key = build_device_ntt_tables([make_ntt_tables(log_n, q) for q in qs], gpu, q32=True)
    wide = build_device_ntt_tables([make_ntt_tables(log_n, q) for q in qs], gpu, q32=False)
    for idx in (list(range(6)), [0, 1, 2, 3], [4, 1, 3], [5], [2, 0]):
        view, view64 = key.slice_limbs(idx), wide.slice_limbs(idx)
        x = _res32(_Dev(gpu, n), view.q, 2, seed=log_n)
        s = _res32(_Dev(gpu, 1), view.q, seed=log_n + 1).reshape(-1)
        for sc in ((None, None), (s, mm.shoup32_of(s, view.q.reshape(-1)))):
            assert torch.equal(ntt.inverse_ntt_scaled(x, view, *sc),
                               ntt.inverse_ntt_plain(x, view, *sc))
        assert torch.equal(ntt.inverse_ntt(x, view).to(torch.int64),
                           ntt.inverse_ntt(x.to(torch.int64), view64))


# -- K6 and K2 as one cluster launch per limb ---------------------------------

def _scale32(gpu, q, seed):
    """A per-limb constant and its Shoup32 word for moduli q (L, 1)."""
    s = _res32(_Dev(gpu, 1), q, seed=seed).reshape(-1)
    return s, mm.shoup32_of(s, q.reshape(-1))


@pytest.mark.parametrize("log_n", [10, 11, 12, 13, 14, 15, 16, 17])
def test_q32_ntt_fwd_landing_cluster_equals_plain(gpu, log_n):
    """K6 (K4's launch with the landing epilogue) against its plain version
    with and without pre, through the full tables, rescale_composite's
    shape (2 rows of Ql - 2 = 4 of 6 limbs) and a digit complement (a
    non-identity limb_map), with 2 x L rows."""
    n = 1 << log_n
    key = build_device_ntt_tables([make_ntt_tables(log_n, q) for q in _primes30(n, 6)], gpu,
                                  q32=True)
    for idx in (list(range(6)), [0, 1, 2, 3], [4, 1, 3]):
        view = key.slice_limbs(idx)
        x = _res32(_Dev(gpu, n), view.q, 2, seed=log_n)
        sub = _res32(_Dev(gpu, n), view.q, 2, seed=log_n + 1)
        post = _scale32(gpu, view.q, log_n + 2)
        for pre in ((None, None), _scale32(gpu, view.q, log_n + 3)):
            assert torch.equal(ntt.forward_ntt_sub_scale(x, sub, view, *post, *pre),
                               ntt.forward_ntt_sub_scale_plain(x, sub, view, *post, *pre))


def test_q32_ntt_fwd_landing_full_width(gpu):
    """K6 at moddown's full-width shape on the q32 plan: (2, 59, 2^15), 472
    blocks in two waves, with and without pre."""
    n = 1 << 15
    t = build_device_ntt_tables([make_ntt_tables(15, q) for q in _primes30(n, 59)], gpu,
                                q32=True)
    x = _res32(_Dev(gpu, n), t.q, 2, seed=15)
    sub = _res32(_Dev(gpu, n), t.q, 2, seed=16)
    post = _scale32(gpu, t.q, 17)
    for pre in ((None, None), _scale32(gpu, t.q, 18)):
        assert torch.equal(ntt.forward_ntt_sub_scale(x, sub, t, *post, *pre),
                           ntt.forward_ntt_sub_scale_plain(x, sub, t, *post, *pre))


_BITS64_15 = _BITS64 * 2 + [60, 50, 60]          # 15 limbs: moddown's P part


def _shoup64(s, q):
    """floor(s * 2^64 / q) per limb as int64 bit patterns."""
    return mm.u64_tensor(np.concatenate([shoup_np([v], m) for v, m in zip(s.tolist(),
                                                                           q.tolist())]),
                         s.device)


@pytest.mark.parametrize("log_n", [10, 11, 12, 13, 14, 15, 16, 17])
def test_ntt_inv_cluster_equals_plain(gpu, log_n):
    """K2 (one launch on u64 words) against its plain version with and
    without a scale: moddown's shape (2 rows of 15 limbs), a level slice, a
    digit complement (a non-identity limb_map) and rescale's shapes (1 limb
    x 2 rows, 2 limbs x 2 rows)."""
    n = 1 << log_n
    qs = [m.value for m in CoeffModulus.create(n, _BITS64_15)]
    key = build_device_ntt_tables([make_ntt_tables(log_n, q) for q in qs], gpu)
    for idx in (list(range(15)), [0, 1, 2, 3], [4, 1, 3], [5], [2, 0]):
        view = key.slice_limbs(idx)
        x = _res(_Dev(gpu, n), view.q, 2, seed=log_n)
        s = _res(_Dev(gpu, 1), view.q, seed=log_n + 1).reshape(-1)
        ss = _shoup64(s, view.q.reshape(-1))
        for sc in ((None, None), (s, ss)):
            assert torch.equal(ntt.inverse_ntt_scaled(x, view, *sc),
                               ntt.inverse_ntt_plain(x, view, *sc))


def test_ntt_inv_cluster_2_17_full_width(gpu):
    """K2's shape at 2^17, 8 blocks of 128 KB per limb (one block per SM),
    scaled, at the u64 plan's keyswitch width: 2 x 30 limbs, 480 blocks in
    several waves."""
    n = 1 << 17
    qs = [m.value for m in CoeffModulus.create(n, [60] + [50] * 29)]
    t = build_device_ntt_tables([make_ntt_tables(17, q) for q in qs], gpu)
    x = _res(_Dev(gpu, n), t.q, 2, seed=17)
    s = _res(_Dev(gpu, 1), t.q, seed=18).reshape(-1)
    sc = (s, _shoup64(s, t.q.reshape(-1)))
    assert torch.equal(ntt.inverse_ntt_scaled(x, t, *sc), ntt.inverse_ntt_plain(x, t, *sc))


# -- K3 as one cluster launch per limb, K12 on the tensor cores -------------

def _scale64(gpu, q, seed):
    """A per-limb constant and its Shoup word for moduli q (L, 1)."""
    s = _res(_Dev(gpu, 1), q, seed=seed).reshape(-1)
    return s, _shoup64(s, q.reshape(-1))


@pytest.mark.parametrize("log_n", [10, 11, 12, 13, 14, 15, 16, 17])
def test_ntt_fwd_landing_cluster_equals_plain(gpu, log_n):
    """K3 (K1's launch with the landing epilogue) against its plain version
    with and without pre, with 2 x L rows: moddown's shape (every limb of a
    level), rescale's (the level's limbs but the last), and a digit
    complement (a non-identity limb_map)."""
    n = 1 << log_n
    qs = [m.value for m in CoeffModulus.create(n, _BITS64)]
    key = build_device_ntt_tables([make_ntt_tables(log_n, q) for q in qs], gpu)
    for idx in (list(range(6)), [0, 1, 2, 3, 4], [4, 1, 3]):
        view = key.slice_limbs(idx)
        x = _res(_Dev(gpu, n), view.q, 2, seed=log_n)
        sub = _res(_Dev(gpu, n), view.q, 2, seed=log_n + 1)
        post = _scale64(gpu, view.q, log_n + 2)
        for pre in ((None, None), _scale64(gpu, view.q, log_n + 3)):
            assert torch.equal(ntt.forward_ntt_sub_scale(x, sub, view, *post, *pre),
                               ntt.forward_ntt_sub_scale_plain(x, sub, view, *post, *pre))


def test_ntt_fwd_landing_full_width(gpu):
    """K3 at moddown's full-width shape on the u64 plan: (2, 30, 2^15), 240
    blocks of 64 KB, with and without pre."""
    n = 1 << 15
    qs = [m.value for m in CoeffModulus.create(n, [60] + [50] * 29)]
    t = build_device_ntt_tables([make_ntt_tables(15, q) for q in qs], gpu)
    x = _res(_Dev(gpu, n), t.q, 2, seed=15)
    sub = _res(_Dev(gpu, n), t.q, 2, seed=16)
    post = _scale64(gpu, t.q, 17)
    for pre in ((None, None), _scale64(gpu, t.q, 18)):
        assert torch.equal(ntt.forward_ntt_sub_scale(x, sub, t, *post, *pre),
                           ntt.forward_ntt_sub_scale_plain(x, sub, t, *post, *pre))


def _bconv64_case(gpu, k: int, m: int, seed: int, worst: bool = False):
    """Random (or worst-case) u64 base-conversion tables k -> m on 60-bit
    moduli: (table, p, ratio_lo, ratio_hi) and the input moduli (k, 1)."""
    q_in, q_out = (CoeffModulus.create(1 << 10, [60] * c) for c in (k, m))
    p, rlo, rhi = (mm.u64_tensor(np.array([[f(mo)] for mo in q_out], dtype=np.uint64), gpu)
                   for f in (lambda mo: mo.value, lambda mo: mo.const_ratio[0],
                             lambda mo: mo.const_ratio[1]))
    qi = mm.u64_tensor(np.array([[mo.value] for mo in q_in], dtype=np.uint64), gpu)
    if worst:
        table = (p - 1).expand(m, k).contiguous()
    else:
        g = torch.Generator(device=gpu).manual_seed(seed)
        table = torch.randint(0, 1 << 62, (m, k), generator=g, dtype=torch.int64,
                              device=gpu) % p
    return (table, p, rlo, rhi), qi


@pytest.mark.parametrize("m", [1, 16, 30, 45])
@pytest.mark.parametrize("k", [1, 15, 32, 63])
def test_bconv_tensor_core_equals_plain(gpu, k, m):
    """K12's int8 tensor-core kernel against its plain version: k inputs
    (1 to 4 K steps of 16, ragged) into m outputs (odd m leaves part of an
    M tile), batch 1 and 2, at N = 2^15 and ragged N = 1000 and 999; every launch
    is K12's."""
    tab, qi = _bconv64_case(gpu, k, m, 100 * k + m)
    diag = bconv.digit_matrix(tab[0])
    g = torch.Generator(device=gpu).manual_seed(k + m)
    for lead, n in (((), 1 << 15), ((2,), 1 << 15), ((2,), 1000), ((1,), 999)):
        s = torch.randint(0, 1 << 62, lead + (k, n), generator=g, dtype=torch.int64,
                          device=gpu) % qi
        bconv.BCONV_MXU.launches = bconv.BCONV.launches = 0
        got = bconv.bconv_matmul(s, *tab, diag)
        assert (bconv.BCONV_MXU.launches, bconv.BCONV.launches) == (1, 0)
        assert torch.equal(got, bconv.bconv_matmul_plain(s, *tab))


def test_bconv_tensor_core_worst_case(gpu):
    """K12 at its bound: 63 inputs of 60-bit moduli each at q - 1, every
    table entry at p - 1 (a row sum near 63 2^120), batch 2."""
    k, m = 63, 30
    tab, qi = _bconv64_case(gpu, k, m, 0, worst=True)
    s = (qi - 1).expand(2, k, 1 << 12).contiguous()
    got = bconv.bconv_matmul(s, *tab, bconv.digit_matrix(tab[0]))
    assert torch.equal(got, bconv.bconv_matmul_plain(s, *tab))


def test_bconv_k64_goes_to_simt_kernel(gpu):
    """At k = 64 (beyond K12's 128-bit bound) the wrapper launches K11's
    kernel, exact, with the table's digit matrix, and raises without it or
    with one of another table: K11 is K12's form in chunks."""
    k, m = 64, 7
    tab, qi = _bconv64_case(gpu, k, m, 64)
    g = torch.Generator(device=gpu).manual_seed(64)
    s = torch.randint(0, 1 << 62, (2, k, 1 << 12), generator=g, dtype=torch.int64,
                      device=gpu) % qi
    bconv.BCONV_MXU.launches = bconv.BCONV.launches = 0
    assert torch.equal(bconv.bconv_matmul(s, *tab, bconv.digit_matrix(tab[0])),
                       bconv.bconv_matmul_plain(s, *tab))
    assert (bconv.BCONV_MXU.launches, bconv.BCONV.launches) == (0, 1)
    for diag in (None, bconv.digit_matrix(tab[0][:, :48].contiguous())):
        with pytest.raises(ValueError, match="digit matrix"):
            bconv.bconv_matmul(s, *tab, diag)
    assert bconv.BCONV.launches == 1


def _k11_case(gpu, k: int, m: int, seed: int):
    """u64 tables k -> m on 60-bit output moduli, and input moduli (k, 1) of
    32 60-bit primes repeated (a chain holds at most 64 above 30 bits)."""
    q_out = CoeffModulus.create(1 << 10, [60] * m)
    p, rlo, rhi = (mm.u64_tensor(np.array([[f(mo)] for mo in q_out], dtype=np.uint64), gpu)
                   for f in (lambda mo: mo.value, lambda mo: mo.const_ratio[0],
                             lambda mo: mo.const_ratio[1]))
    qi = mm.u64_tensor(np.array([[mo.value] for mo in CoeffModulus.create(1 << 10, [59] * 32)],
                                dtype=np.uint64), gpu).repeat(-(-k // 32), 1)[:k]
    g = torch.Generator(device=gpu).manual_seed(seed)
    table = torch.randint(0, 1 << 62, (m, k), generator=g, dtype=torch.int64, device=gpu) % p
    return (table, p, rlo, rhi), qi


@pytest.mark.parametrize("m", [1, 30, 63])
@pytest.mark.parametrize("k", [64, 65, 127, 128, 190, 400])
def test_bconv_k11_equals_plain(gpu, k, m):
    """K11 against its plain version through the wrapper: one 64-input chunk
    (64), ragged last chunks (65, 127, 190), whole ones (128), and 400
    inputs, more than one launch stages (384), so the second launch adds
    to the first mod p; batch 1 to 3 at N = 2^12 and a ragged N = 1000;
    ceil(k / 384) launches, all K11's."""
    tab, qi = _k11_case(gpu, k, m, 1000 * k + m)
    diag = bconv.digit_matrix(tab[0])
    g = torch.Generator(device=gpu).manual_seed(k - m)
    for lead, n in (((), 1 << 12), ((2,), 1 << 12), ((3,), 1 << 12), ((2,), 1000)):
        s = torch.randint(0, 1 << 62, lead + (k, n), generator=g, dtype=torch.int64,
                          device=gpu) % qi
        bconv.BCONV_MXU.launches = bconv.BCONV.launches = 0
        got = bconv.bconv_matmul(s, *tab, diag)
        assert (bconv.BCONV_MXU.launches, bconv.BCONV.launches) == (0, -(-k // 384))
        assert torch.equal(got, bconv.bconv_matmul_plain(s, *tab))


def test_bconv_k11_direct_call_below_64(gpu):
    """K11's entry point takes any k: called directly at 15 -> 30 (where the
    wrapper takes K12) it equals the plain version and K12."""
    from tpu_fhe_torch.ops._build import ptr

    k, m, n = 15, 30, 1 << 12
    tab, qi = _k11_case(gpu, k, m, 15)
    diag = bconv.digit_matrix(tab[0])
    s = _res(_Dev(gpu, n), qi, seed=15)
    out = torch.empty((m, n), dtype=torch.int64, device=gpu)
    bconv.BCONV(ptr(s), ptr(out), ptr(diag), *(ptr(c) for c in tab[1:]), 1, k, m, n, 0, k, 0)
    assert torch.equal(out, bconv.bconv_matmul_plain(s, *tab))
    assert torch.equal(out, bconv.bconv_matmul(s, *tab, diag))


def _k9_case(gpu, n: int, batch: int, beta: int, seed: int):
    """K9's operands on 30-bit primes: a key of beta + 1 digits over 12 key
    rows, and t (batch, beta, 9, n) over 9 of them picked out of order (a
    non-identity limb map)."""
    key_rows, rows = 12, [0, 2, 3, 5, 6, 11, 10, 8, 9]
    qs = _primes30(n, key_rows)
    kq = mm.u32_tensor(np.array(qs, dtype=np.uint64).reshape(-1, 1), gpu)
    limb_map = torch.tensor(rows, dtype=torch.int64, device=gpu)
    q = kq[limb_map].contiguous()
    fold = torch.from_numpy(mm.q32_mul_consts([qs[r] for r in rows]).astype(np.int64)
                            .reshape(5, len(rows), 1)).to(gpu)
    dev = _Dev(gpu, n)
    evk = _res32(dev, kq, beta + 1, 2, seed=seed)
    t = _res32(dev, q, *((batch,) if batch > 1 else ()), beta, seed=seed + 1)
    return t, evk, limb_map, q, fold


def _k9_holds(args) -> None:
    before = ks.KS32.launches
    got = ks.key_inner_prod32(*args)
    assert ks.KS32.launches - before == 1
    assert torch.equal(got, ks.key_inner_prod32_plain(*args))


@pytest.mark.parametrize("beta", [1, 2, 3, 4, 40])
@pytest.mark.parametrize("batch", [1, 2, 3, 5, 16, 17])
def test_k9_stream_equals_plain(gpu, batch, beta):
    """K9 against its plain version at N = 2^12: batches that are and are
    not a multiple of the two ciphertexts a thread takes at once, beta 1-4
    (the unrolled digit loops, the key in registers) and 40 (the runtime
    loop, whose 96-bit sums use the carry word), a key of more digits than
    beta, a limb map out of order; one launch each."""
    _k9_holds(_k9_case(gpu, 1 << 12, batch, beta, 100 * batch + beta))


@pytest.mark.parametrize("log_n", [10, 11, 12, 13, 14, 15, 16])
def test_k9_stream_ring_sizes(gpu, log_n):
    """K9 at every ring size from 2^10 (one block a limb) to 2^16, a batch
    of 3, beta 2 (every q32 path's)."""
    _k9_holds(_k9_case(gpu, 1 << log_n, 3, 2, log_n))


def test_k9_refuses_misaligned_input(gpu):
    """K9 takes 4 coefficients a thread with 16-byte accesses: on the card
    N not a multiple of 4, or a t or key view that is not 16-byte aligned,
    raises; it never routes to the plain version."""
    t, evk, limb_map, q, fold = _k9_case(gpu, 1 << 10, 2, 2, 7)
    odd = (t[..., :1022].contiguous(), evk[..., :1022].contiguous(), limb_map, q, fold)
    flat = torch.empty(t.numel() + 1, dtype=torch.int32, device=gpu)
    shifted = flat[1:].view(t.shape)
    shifted.copy_(t)
    kflat = torch.empty(evk.numel() + 1, dtype=torch.int32, device=gpu)
    kshifted = kflat[1:].view(evk.shape)
    kshifted.copy_(evk)
    before = ks.KS32.launches
    for args in (odd, (shifted, evk, limb_map, q, fold), (t, kshifted, limb_map, q, fold)):
        assert args[0].is_contiguous() and args[1].is_contiguous()
        with pytest.raises(ValueError, match="multiple of 4|aligned"):
            ks.key_inner_prod32(*args)
    assert ks.KS32.launches == before


def test_bconv_refuses_missing_digit_matrix(gpu):
    """On a CUDA tensor with k < 64, bconv_matmul raises without the
    table's digit matrix (or with one of another table, or on the CPU): it
    never gives way to K11 or to the plain version."""
    k, m = 15, 30
    tab, qi = _bconv64_case(gpu, k, m, 1)
    s = _res(_Dev(gpu, 1 << 10), qi)
    for diag in (None, bconv.digit_matrix(tab[0][:16].contiguous()),
                 bconv.digit_matrix(tab[0]).cpu()):
        with pytest.raises(ValueError, match="digit matrix"):
            bconv.bconv_matmul(s, *tab, diag)


def test_cluster_transforms_are_one_launch(gpu):
    """A profile of one call of K1 (u64), K2 (u64, scaled), K3 (u64, with
    pre), K5 (q32, scaled) and K6 (q32, with pre) at 2^15 sees one device
    kernel each: the cluster kernel, K3's and K6's with the landing
    epilogue."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = 1 << 15
    t64 = build_device_ntt_tables([make_ntt_tables(15, q) for q in
                                   (m.value for m in CoeffModulus.create(n, _BITS64))], gpu)
    t32 = build_device_ntt_tables([make_ntt_tables(15, q) for q in _primes30(n, 6)], gpu,
                                  q32=True)
    x64, x32 = _res(_Dev(gpu, n), t64.q, seed=1), _res32(_Dev(gpu, n), t32.q, seed=2)
    sub32 = _res32(_Dev(gpu, n), t32.q, seed=3)
    s = x32[:, 0].contiguous()
    ss = mm.shoup32_of(s, t32.q.reshape(-1))
    s64 = x64[:, 0].contiguous()
    ss64 = _shoup64(s64, t64.q.reshape(-1))
    sub64 = _res(_Dev(gpu, n), t64.q, seed=4)
    for fn, names in ((lambda: ntt.forward_ntt(x64, t64), ("fwd_cluster",)),
                      (lambda: ntt.inverse_ntt_scaled(x64, t64, s64, ss64), ("inv_cluster",)),
                      (lambda: ntt.forward_ntt_sub_scale(x64, sub64, t64, s64, ss64, s64, ss64),
                       ("fwd_cluster", "Landing")),
                      (lambda: ntt.inverse_ntt_scaled(x32, t32, s, ss), ("inv_cluster",)),
                      (lambda: ntt.forward_ntt_sub_scale(x32, sub32, t32, s, ss, s, ss),
                       ("fwd_cluster", "Landing"))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        assert [e.count for e in kernels] == [1]
        assert all(name in kernels[0].key for name in names)


def test_cluster_wrappers_refuse_misaligned_input(gpu):
    """K3 and K6 read `sub` and K2 its data in 16-byte runs: the wrappers
    raise on a tensor that is not 16-byte aligned."""
    n = 1 << 10
    t32 = build_device_ntt_tables([make_ntt_tables(10, q) for q in _primes30(n, 2)], gpu,
                                  q32=True)
    x = _res32(_Dev(gpu, n), t32.q, 2)
    post = _scale32(gpu, t32.q, 1)
    flat32 = torch.zeros(2 * 2 * n + 1, dtype=torch.int32, device=gpu)
    with pytest.raises(ValueError, match="16-byte"):
        ntt.forward_ntt_sub_scale(x, flat32[1:].reshape(2, 2, n), t32, *post)
    qs = [m.value for m in CoeffModulus.create(n, _BITS64[:2])]
    t64 = build_device_ntt_tables([make_ntt_tables(10, q) for q in qs], gpu)
    flat64 = torch.zeros(2 * n + 1, dtype=torch.int64, device=gpu)
    with pytest.raises(ValueError, match="16-byte"):
        ntt.inverse_ntt(flat64[1:].reshape(2, n), t64)
    x64 = _res(_Dev(gpu, n), t64.q, seed=2)
    post64 = _scale64(gpu, t64.q, 3)
    with pytest.raises(ValueError, match="16-byte"):
        ntt.forward_ntt_sub_scale(x64, flat64[1:].reshape(2, n), t64, *post64)


def test_cluster_shape_matches_cpu_model(gpu):
    """The blocks per ring that ClusterShape (csrc/ntt.cu) gives each word
    at 2^10 .. 2^17: the list that tests/test_torch_ntt_cluster.py holds its
    CPU model of the shape to, so the two change together."""
    fn = _build.load("ntt.cu").tfhe_ntt_cluster_blocks
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    for word, want in {4: [1, 1, 1, 1, 2, 4, 4, 8], 8: [1, 1, 1, 2, 4, 4, 8, 8]}.items():
        assert [fn(word, log_n) for log_n in range(10, 18)] == want


def test_q32_redesigned_wrappers_refuse_bad_input(gpu):
    primes = _primes30(1 << 10, 16)
    g = torch.Generator(device=gpu).manual_seed(1)
    qo = torch.tensor(primes[:3], dtype=torch.int32, device=gpu).reshape(-1, 1)
    table = torch.randint(0, 1 << 29, (3, 8), generator=g, dtype=torch.int32, device=gpu)
    fold = torch.from_numpy(mm.q32_mul_consts(primes[:3]).astype(np.int64).reshape(5, 3, 1))
    fold = fold.to(gpu)
    s = torch.randint(0, 1 << 29, (8, 1024), generator=g, dtype=torch.int32, device=gpu)
    with pytest.raises(ValueError, match="digit matrix"):        # no digit matrix
        bconv.bconv_matmul32(s, table, qo, fold)
    with pytest.raises(ValueError, match="digit matrix"):        # a 40-input table's
        bconv.bconv_matmul32(s, table, qo, fold, bconv.digit_matrix32(table.repeat(1, 5)))
    with pytest.raises(ValueError, match="digit matrix"):        # on the CPU
        bconv.bconv_matmul32(s, table, qo, fold, bconv.digit_matrix32(table).cpu())
    with pytest.raises(ValueError):                              # u64 residues
        bconv.bconv_matmul32(s.to(torch.int64), table, qo, fold, bconv.digit_matrix32(table))
    key = build_device_ntt_tables([make_ntt_tables(10, q) for q in primes[:2]], gpu, q32=True)
    x = _res32(_Dev(gpu, 1024), key.q, 2)
    with pytest.raises(TypeError):                               # int64 data, int32 tables
        ntt.forward_ntt(x.to(torch.int64), key)
    with pytest.raises(ValueError, match="contiguous"):
        ntt.forward_ntt(x.transpose(0, 1).contiguous().transpose(0, 1), key)
    with pytest.raises(ValueError):                              # N of other tables
        ntt.forward_ntt(x[..., :512].contiguous(), key)
    flat = torch.zeros(2 * 1024 + 1, dtype=torch.int32, device=gpu)
    with pytest.raises(ValueError, match="16-byte"):             # K5's vector loads
        ntt.inverse_ntt(flat[1:].reshape(2, 1024), key)


# -- the evaluation layer: the graph Evaluator, auto, Chebyshev ---------------

FULL_BITS = [60] + [50] * 29 + [60] * 15                 # chip_smoke.py's u64 plan
FULL_COMPOSITE = dict(scale_bits=58, levels=29, degree=2, anchor_bits=30, special_bits=30,
                      special_count=30)                  # and its q32 plan


def _draw(c, rng, ci, *lead):
    qs = np.array(c.level(ci).base.values, dtype=np.uint64)[:, None]
    x = rng.integers(0, 2**62, size=lead + (len(qs), c.n), dtype=np.uint64) % qs
    return x.astype(np.uint32 if c.is_q32 else np.uint64)


def _graph_case(c, seed):
    """Random operands at chain index 1 and the port's keys on context c."""
    rng = np.random.default_rng(seed)
    scale = auto.default_scale(c)
    a, b, c3, c3b = (ciphertext_from_np(c, _draw(c, rng, 1, s), 1, scale)
                     for s in (2, 2, 3, 3))
    sk = SecretKey(c, seed=seed)
    return dict(a=a, b=b, c3=c3, c3b=c3b, pt=plaintext_from_np(c, _draw(c, rng, 1), 1, scale),
                rlk=sk.relin_key(), gk=sk.galois_key([1], include_conj=True))


def _evaluator_calls(c, x):
    """Every Evaluator method with the eager module call it must equal."""
    a, b, c3, pt, rlk, gk = (x[k] for k in ("a", "b", "c3", "pt", "rlk", "gk"))
    elt = galois_elt_from_step(1, c.n)
    return {
        "add": (lambda E: E.add(a, b), lambda: ev.add(c, a, b)),
        "sub": (lambda E: E.sub(a, b), lambda: ev.sub(c, a, b)),
        "negate": (lambda E: E.negate(a), lambda: ev.negate(c, a)),
        "add_plain": (lambda E: E.add_plain(a, pt), lambda: ev.add_plain(c, a, pt)),
        "sub_plain": (lambda E: E.sub_plain(a, pt), lambda: ev.sub_plain(c, a, pt)),
        "multiply": (lambda E: E.multiply(a, b), lambda: ev.multiply(c, a, b)),
        "multiply_plain": (lambda E: E.multiply_plain(a, pt),
                           lambda: ev.multiply_plain(c, a, pt)),
        "square": (lambda E: E.square(a), lambda: ev.square(c, a)),
        "relinearize": (lambda E: E.relinearize(c3, rlk), lambda: ev.relinearize(c, c3, rlk)),
        "multiply_relin": (lambda E: E.multiply_relin(a, b, rlk),
                           lambda: ev.relinearize(c, ev.multiply(c, a, b), rlk)),
        "square_relin": (lambda E: E.square_relin(a, rlk),
                         lambda: ev.relinearize(c, ev.square(c, a), rlk)),
        "rescale": (lambda E: E.rescale(a), lambda: ev.rescale_to_next(c, a)),
        "mod_drop": (lambda E: E.mod_drop(a), lambda: ev.mod_drop_to_next(c, a)),
        "rotate": (lambda E: E.rotate(a, 1, gk),
                   lambda: ev.apply_galois_with_key(c, a, elt, gk.key_for_elt(elt))),
        "conjugate": (lambda E: E.conjugate(a, gk), lambda: ev.conjugate(c, a, gk)),
    }


def _graphs_equal_eager(c, names=None) -> Evaluator:
    """The capture-and-replay call and a second replay of each method equal
    the eager op, data and metadata."""
    x = _graph_case(c, 7)
    E = Evaluator(c)
    calls = _evaluator_calls(c, x)
    for name in names or calls:
        via, direct = calls[name]
        want = direct()
        for got in (via(E), via(E)):
            assert (got.chain_index, got.scale, got.noise_scale_deg) == (
                want.chain_index, want.scale, want.noise_scale_deg), name
            assert torch.equal(got.data, want.data), name
    return E


def test_evaluator_graphs_equal_eager(ctx):
    assert _graphs_equal_eager(ctx).num_graphs == 15


def test_q32_evaluator_graphs_equal_eager(ctx32):
    assert _graphs_equal_eager(ctx32).num_graphs == 15


@pytest.mark.parametrize("word", ["u64", "q32"])
def test_evaluator_graphs_full_width(gpu, word):
    """relinearize and rotate through their graphs at N = 2^15 on
    chip_smoke.py's two chains."""
    n = 1 << 15
    if word == "u64":
        params = EncryptionParameters(SchemeType.ckks, n, tuple(CoeffModulus.create(n, FULL_BITS)),
                                      special_modulus_size=15, allow_insecure=True)
    else:
        params = EncryptionParameters(
            SchemeType.ckks, n, tuple(CoeffModulus.create_composite(n, **FULL_COMPOSITE)),
            special_modulus_size=30, composite_degree=2, allow_insecure=True)
    c = FheContext(params, device=gpu)
    assert _graphs_equal_eager(c, ["relinearize", "rotate"]).num_graphs == 2


def test_evaluator_replay_leaves_earlier_results(ctx):
    """Results are clones: a replay on new inputs does not touch them."""
    x = _graph_case(ctx, 8)
    E = Evaluator(ctx)
    first = E.relinearize(x["c3"], x["rlk"])
    kept = first.data.clone()
    second = E.relinearize(x["c3b"], x["rlk"])
    assert E.num_graphs == 1
    assert torch.equal(first.data, kept)
    assert torch.equal(first.data, ev.relinearize(ctx, x["c3"], x["rlk"]).data)
    assert torch.equal(second.data, ev.relinearize(ctx, x["c3b"], x["rlk"]).data)


def _auto_outputs(c, ct, rlk):
    """The FLEXIBLEAUTO ops across levels and depths, raise_mod from the
    anchor level and a degree-13 Chebyshev series (PS, recursing)."""
    deeper = auto.mod_reduce(c, auto.mult_const_core(c, ct, 2.0), 1)
    anchor = auto.mod_switch_level(c, ct, len(c.q_values) // auto.composite_degree(c) - 1)
    coeffs = cheb.eval_chebyshev_coefficients(lambda t: math.sin(2 * t) * math.exp(-t * t),
                                              -1.0, 1.0, 13)
    return [auto.mult_const(c, ct, 0.75), auto.add_const(c, ct, -0.5),
            auto.sub_const(c, ct, 0.25), deeper,
            auto.eval_mult_auto(c, ct, deeper, rlk), auto.eval_add_auto(c, deeper, ct),
            auto.eval_square_auto(c, auto.mult_const_core(c, ct, 0.5), rlk),
            auto.mult_by_monomial(c, ct, 5), auto.mult_by_integer(c, ct, 3),
            auto.raise_mod(c, anchor),
            cheb.eval_chebyshev_series(c, ct, rlk, coeffs, -1.0, 1.0)]


def _auto_equal_cpu(gpu_ctx):
    cpu = FheContext(gpu_ctx.params, device="cpu")
    data, shoup = relin_key_to_np(SecretKey(cpu, seed=3).relin_key())
    c2 = _draw(cpu, np.random.default_rng(11), 1, 2)
    outs = []
    for c in (cpu, gpu_ctx):
        ct = ciphertext_from_np(c, c2, 1, auto.default_scale(c))
        outs.append([to_numpy(o.data) for o in
                     _auto_outputs(c, ct, relin_key_from_np(c, data, shoup))])
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(got, want)


def test_auto_and_chebyshev_equal_cpu(ctx):
    _auto_equal_cpu(ctx)


def test_q32_auto_and_chebyshev_equal_cpu(gpu):
    """On a composite chain deep enough for the series (an anchor pair and
    five data pairs)."""
    n = 1024
    cfg = dict(COMPOSITE, levels=5)
    _auto_equal_cpu(FheContext(EncryptionParameters(
        SchemeType.ckks, n, tuple(CoeffModulus.create_composite(n, **cfg)),
        special_modulus_size=cfg["special_count"], composite_degree=2, allow_insecure=True),
        device=gpu))


@pytest.mark.parametrize("word", ["u64", "q32"])
def test_encode_ext_batch_equals_cpu(gpu, word):
    """The encoder's QlP plaintexts (encode_ext_batch and encode_ext, full
    and sparse slot vectors) on the card equal the same on the CPU."""
    from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder

    n = 4096
    if word == "q32":
        params = EncryptionParameters(
            SchemeType.ckks, n, tuple(CoeffModulus.create_composite(n, **COMPOSITE)),
            special_modulus_size=COMPOSITE["special_count"], composite_degree=2,
            allow_insecure=True)
    else:
        params = EncryptionParameters(SchemeType.ckks, n, tuple(CoeffModulus.create(n, BITS)),
                                      special_modulus_size=2, allow_insecure=True)
    rng = np.random.default_rng(5)
    vecs = [rng.uniform(-1, 1, s) + 1j * rng.uniform(-1, 1, s) for s in (n // 2, 64, 16, n // 2)]
    outs = []
    for dev in ("cpu", gpu):
        enc = CkksEncoder(FheContext(params, device=dev))
        pts = enc.encode_ext_batch(vecs, 2.0 ** 40, chain_index=2)
        pts.append(enc.encode_ext(vecs[1], 2.0 ** 40, chain_index=1))
        outs.append([to_numpy(p.data) for p in pts])
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(got, want)


def _boot_params(word, n):
    """examples/bootstrap_ckks.py's context at ring size n with the default
    sine set and level budget (2, 2): depth 1 + 14 + 4 + 2 (one level after,
    the sine's depth 8 + 6, the budget, 2)."""
    depth = 21
    if word == "q32":
        return EncryptionParameters(
            SchemeType.ckks, n, tuple(CoeffModulus.create_composite(
                n, 58, depth, degree=2, anchor_bits=30, special_bits=30,
                special_count=depth + 1)),
            special_modulus_size=depth + 1, composite_degree=2, allow_insecure=True)
    size_p = (depth + 2) // 2
    return EncryptionParameters(
        SchemeType.ckks, n, tuple(CoeffModulus.create(n, [60] + [59] * depth + [60] * size_p)),
        special_modulus_size=size_p, allow_insecure=True)


@pytest.mark.parametrize("word", ["u64", "q32"])
def test_bootstrap_kernels_equal_plain(gpu, word, monkeypatch):
    """One N = 2^12 dense bootstrap (the default sine set: the sparse set's
    K = 28 is too small for a uniform ternary secret at this ring) through
    the kernels equals the same with the evaluator's and auto's kernel
    wrappers swapped for the plain versions, bit for bit, and decodes to more
    than 10 bits of mean precision."""
    from tpu_fhe_torch.boot.bootstrap import CkksBootstrapper, precision_bits
    from tpu_fhe_torch.ops._build import CudaKernel
    from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder

    c = FheContext(_boot_params(word, 4096), device=gpu)
    sk, enc = SecretKey(c, seed=4), CkksEncoder(c)
    boot = CkksBootstrapper(c, enc)
    boot.setup(level_budget=(2, 2))
    boot.keygen(sk)
    x = np.random.default_rng(6).uniform(-0.8, 0.8, c.n // 2)
    ct = sk.encrypt_symmetric(enc.encode(x, auto.default_scale(c)))
    while c.level(ct.chain_index).size > 2 * c.params.composite_degree:
        ct = ev.mod_drop_to_next(c, ct)
    got = boot.eval_bootstrap(ct)
    assert precision_bits(enc.decode(sk.decrypt(got)).real, x) > 10
    swaps = dict(forward_ntt=ntt.forward_ntt_plain, inverse_ntt=ntt.inverse_ntt_plain,
                 inverse_ntt_scaled=ntt.inverse_ntt_plain,
                 forward_ntt_sub_scale=ntt.forward_ntt_sub_scale_plain,
                 bconv_matmul=bconv.bconv_matmul_plain,
                 bconv_matmul32=bconv.bconv_matmul32_plain,
                 key_inner_prod=ks.key_inner_prod_plain,
                 key_inner_prod32=ks.key_inner_prod32_plain,
                 key_inner_prod_shoup=ks.key_inner_prod_shoup_plain)
    for mod in (ev, auto):
        for name, fn in swaps.items():
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, fn)
    kernels = [k for mod in (ntt, bconv, ks) for k in vars(mod).values()
               if isinstance(k, CudaKernel)]
    for k in kernels:
        k.launches = 0
    want = boot.eval_bootstrap(ct)
    torch.cuda.synchronize()
    assert {k.name: k.launches for k in kernels if k.launches} == {}, \
        "the run through the plain versions launched kernels"
    assert (got.chain_index, got.scale) == (want.chain_index, want.scale)
    assert torch.equal(got.data, want.data)


@pytest.mark.parametrize("word", ["u64", "q32"])
def test_dnn_conv_and_batch_norm_kernels_equal_plain(gpu, word, monkeypatch):
    """One conv (device-encoded masks, stride 1) and one batch_norm of a
    2-channel 4 x 4 tensor at N = 2^10 through the kernels equal the same
    with the kernel wrappers of the evaluator, auto, the DNN layers and the
    encoder swapped for the plain versions, bit for bit, with the same
    metadata; the plain run launches nothing."""
    from tpu_fhe_torch.models import dnn
    from tpu_fhe_torch.ops._build import CudaKernel
    from tpu_fhe_torch.scheme import ckks_encoder

    n = 1024
    if word == "q32":
        params = EncryptionParameters(
            SchemeType.ckks, n, tuple(CoeffModulus.create_composite(
                n, 58, 6, degree=2, anchor_bits=30, special_bits=30, special_count=7)),
            special_modulus_size=7, composite_degree=2, allow_insecure=True)
    else:
        params = EncryptionParameters(
            SchemeType.ckks, n, tuple(CoeffModulus.create(n, [60] + [59] * 6 + [60] * 3)),
            special_modulus_size=3, allow_insecure=True)
    c = FheContext(params, device=gpu)
    sk, enc = SecretKey(c, seed=8), ckks_encoder.CkksEncoder(c)
    model = dnn.DNN(c, enc)
    model.build_galois_key(sk, dnn.DNN.conv_rotation_indices(4, 3, 0))
    model.relin_keygen(sk)
    rng = np.random.default_rng(9)
    x = model.enc_tensor(rng.uniform(-0.5, 0.5, (4, 4, 2)), sk=sk)
    w = rng.normal(0.0, 0.3, (3, 3, 2, 2))
    bn = [rng.uniform(0.7, 1.3, 2) for _ in range(4)]

    def run():
        return model.conv(x, w, 1).cts + model.batch_norm(x, *bn).cts

    got = run()
    swaps = dict(forward_ntt=ntt.forward_ntt_plain, inverse_ntt=ntt.inverse_ntt_plain,
                 inverse_ntt_scaled=ntt.inverse_ntt_plain,
                 forward_ntt_sub_scale=ntt.forward_ntt_sub_scale_plain,
                 bconv_matmul=bconv.bconv_matmul_plain,
                 bconv_matmul32=bconv.bconv_matmul32_plain,
                 key_inner_prod=ks.key_inner_prod_plain,
                 key_inner_prod32=ks.key_inner_prod32_plain,
                 key_inner_prod_shoup=ks.key_inner_prod_shoup_plain)
    for mod in (ev, auto, dnn, ckks_encoder):
        for name, fn in swaps.items():
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, fn)
    kernels = [k for mod in (ntt, bconv, ks) for k in vars(mod).values()
               if isinstance(k, CudaKernel)]
    for k in kernels:
        k.launches = 0
    want = run()
    torch.cuda.synchronize()
    assert {k.name: k.launches for k in kernels if k.launches} == {}, \
        "the run through the plain versions launched kernels"
    for g, wt in zip(got, want):
        assert (g.chain_index, g.scale, g.noise_scale_deg) == \
            (wt.chain_index, wt.scale, wt.noise_scale_deg)
        assert torch.equal(g.data, wt.data)


def _dnn_params(word: str, n: int) -> EncryptionParameters:
    """test_dnn_conv_and_batch_norm_kernels_equal_plain's stack on `word`."""
    if word == "q32":
        return EncryptionParameters(
            SchemeType.ckks, n, tuple(CoeffModulus.create_composite(
                n, 58, 6, degree=2, anchor_bits=30, special_bits=30, special_count=7)),
            special_modulus_size=7, composite_degree=2, allow_insecure=True)
    return EncryptionParameters(
        SchemeType.ckks, n, tuple(CoeffModulus.create(n, [60] + [59] * 6 + [60] * 3)),
        special_modulus_size=3, allow_insecure=True)


# each kernel wrapper's plain version, by the name the modules call it
_PLAIN = dict(forward_ntt=ntt.forward_ntt_plain, inverse_ntt=ntt.inverse_ntt_plain,
              inverse_ntt_scaled=ntt.inverse_ntt_plain,
              forward_ntt_sub_scale=ntt.forward_ntt_sub_scale_plain,
              bconv_matmul=bconv.bconv_matmul_plain, bconv_matmul32=bconv.bconv_matmul32_plain,
              key_inner_prod=ks.key_inner_prod_plain, key_inner_prod32=ks.key_inner_prod32_plain,
              key_inner_prod_shoup=ks.key_inner_prod_shoup_plain)


@pytest.mark.parametrize("word", ["u64", "q32"])
def test_packed_conv_and_fc_kernels_equal_plain(gpu, word, monkeypatch):
    """The packed convolution 5 -> 3 at 6 x 6 (the output channels in
    chunks of 2) and the diagonal FC layer at rows 4, cols 16 at N = 2^10
    through the kernels equal the same with the evaluator's and the
    encoder's kernel wrappers swapped for the plain versions, bit for bit,
    with the same metadata; the plain run launches nothing."""
    from tpu_fhe_torch.models.conv_packed import (PackedConv, fc_rotation_indices,
                                                  fc_weight_encode, fully_connected)
    from tpu_fhe_torch.ops._build import CudaKernel
    from tpu_fhe_torch.scheme import ckks_encoder

    c = FheContext(_dnn_params(word, 1024), device=gpu)
    sk, enc = SecretKey(c, seed=8), ckks_encoder.CkksEncoder(c)
    scale = 2.0 ** 40 if word == "q32" else 2.0 ** 59
    pc = PackedConv(c, enc, scale=scale, channel_batch=2)
    lay = pc.layout(6, 3)
    slots = c.n // 2
    gk = sk.galois_key(sorted(set(pc.rotation_indices(lay))
                              | set(fc_rotation_indices(4, 16, slots))))
    rng = np.random.default_rng(9)
    filt = rng.uniform(-0.5, 0.5, (3, 5, 3, 3))
    din = pc.zero_pad_encode(rng.uniform(-1, 1, (5, 6, 6)), lay, sk)
    weight = rng.uniform(-1, 1, (4, 16))
    ct = sk.encrypt_symmetric(enc.encode(np.pad(rng.uniform(-1, 1, 16), (0, slots - 16)),
                                         scale, slots=slots))

    def run():
        return pc.eval_convolution(filt, gk, din, lay) + [
            fully_connected(c, gk, ct, fc_weight_encode(enc, weight, scale), 16)]

    got = run()
    for mod in (ev, ckks_encoder):
        for name, fn in _PLAIN.items():
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, fn)
    kernels = [k for mod in (ntt, bconv, ks) for k in vars(mod).values()
               if isinstance(k, CudaKernel)]
    for k in kernels:
        k.launches = 0
    want = run()
    torch.cuda.synchronize()
    assert {k.name: k.launches for k in kernels if k.launches} == {}, \
        "the run through the plain versions launched kernels"
    for g, wt in zip(got, want):
        assert (g.chain_index, g.scale, g.noise_scale_deg) == \
            (wt.chain_index, wt.scale, wt.noise_scale_deg)
        assert torch.equal(g.data, wt.data)


def test_batched_k9_at_the_packed_chunk_shape(gpu):
    """K9 on t (16, 2, 89, 2^16): a chunk of 16 output channels of the
    packed convolution's collapse rotations, after its first rescale
    (chain index 2), on chip_smoke.py's phase-15 context
    (create_composite(2^16, 58, 29, ...): 60 + 30 limbs, dnum 2), in one
    launch, equal to its plain version."""
    n = 1 << 16
    c = FheContext(EncryptionParameters(
        SchemeType.ckks, n, tuple(CoeffModulus.create_composite(
            n, 58, 29, degree=2, anchor_bits=30, special_bits=30, special_count=30)),
        special_modulus_size=30, composite_degree=2, allow_insecure=True), device=gpu)
    kst, kq = c.level(2).ks, c.key_level.mod
    qlp = kst.qlp_mod
    assert (c.level(2).size, kst.beta, qlp.q.shape[0]) == (59, 2, 89)
    evk = _res32(c, kq.q, 2, 2, seed=1)
    t = _res32(c, qlp.q, 16, kst.beta, seed=2)
    args = (t, evk, kst.qlp_key_rows, qlp.q, qlp.fold)
    before = ks.KS32.launches
    got = ks.key_inner_prod32(*args)
    assert ks.KS32.launches - before == 1
    assert got.shape == (16, 2, 89, n)
    assert torch.equal(got, ks.key_inner_prod32_plain(*args))


@pytest.mark.parametrize("case", ["bfv behz", "bfv hps", "bgv behz"])
def test_bfv_bgv_kernels_equal_plain(gpu, case, monkeypatch):
    """At N = 2^12 on [60] + [54]*6 + [60]: a BFV multiply (BEHZ, or HPS
    with its K12 at k + m = 15) with relinearize, and a BGV multiply,
    relinearize (K3 with its `pre` operand) and mod_switch_to_next, through
    the kernels equal the same with every module's kernel wrappers swapped
    for the plain versions, bit for bit, metadata included; the plain run
    launches nothing, and the decryptions are the cleartext products."""
    from tpu_fhe_torch.core.modulus import PlainModulus
    from tpu_fhe_torch.core.params import MulTech
    from tpu_fhe_torch.eval import bfv_eval, bgv_eval
    from tpu_fhe_torch.ops._build import CudaKernel
    from tpu_fhe_torch.scheme import batch_encoder, bfv, bgv, keys

    scheme, tech = case.split()
    n = 4096
    c = FheContext(EncryptionParameters(
        getattr(SchemeType, scheme), n, tuple(CoeffModulus.create(n, [60] + [54] * 6 + [60])),
        special_modulus_size=1, plain_modulus=PlainModulus.batching(n, 20),
        mul_tech=getattr(MulTech, tech), allow_insecure=True), device=gpu)
    sk = SecretKey(c, seed=10)
    rlk = sk.relin_key()
    enc = batch_encoder.BatchEncoder(c)
    tools = (bfv.BfvTools if scheme == "bfv" else bgv.BgvTools)(c)
    t = tools.t.value
    rng = np.random.default_rng(11)
    a, b = (rng.integers(0, t, size=n, dtype=np.uint64) for _ in range(2))
    ca, cb = (tools.encrypt_symmetric(sk, enc.encode(v)) for v in (a, b))

    def run():
        if scheme == "bfv":
            prod = bfv_eval.multiply(tools, ca, cb)
            return [prod, bfv_eval.relinearize(tools, prod, rlk)]
        prod = bgv_eval.multiply(tools, ca, cb)
        lin = bgv_eval.relinearize(c, prod, rlk)
        return [prod, lin, bgv_eval.mod_switch_to_next(tools, lin)]

    got = run()
    want_slots = (a.astype(object) * b.astype(object)) % t
    for ct in got:
        np.testing.assert_array_equal(enc.decode(tools.decrypt(sk, ct)), want_slots)
    swaps = dict(forward_ntt=ntt.forward_ntt_plain, inverse_ntt=ntt.inverse_ntt_plain,
                 inverse_ntt_scaled=ntt.inverse_ntt_plain,
                 forward_ntt_sub_scale=ntt.forward_ntt_sub_scale_plain,
                 bconv_matmul=bconv.bconv_matmul_plain,
                 key_inner_prod=ks.key_inner_prod_plain,
                 key_inner_prod_shoup=ks.key_inner_prod_shoup_plain)
    for mod in (ev, bfv_eval, bgv_eval, bfv, bgv, batch_encoder, keys, bconv):
        for name, fn in swaps.items():
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, fn)
    kernels = [k for mod in (ntt, bconv, ks) for k in vars(mod).values()
               if isinstance(k, CudaKernel)]
    for k in kernels:
        k.launches = 0
    want = run()
    torch.cuda.synchronize()
    assert {k.name: k.launches for k in kernels if k.launches} == {}, \
        "the run through the plain versions launched kernels"
    for g, wt in zip(got, want):
        assert (g.chain_index, g.scale, g.noise_scale_deg, g.correction_factor, g.is_ntt_form,
                g.is_asymmetric) == (wt.chain_index, wt.scale, wt.noise_scale_deg,
                                     wt.correction_factor, wt.is_ntt_form, wt.is_asymmetric)
        assert torch.equal(g.data, wt.data)


@pytest.mark.parametrize("slots", [1 << 15, 1024])
def test_device_embedding_on_card_matches_host(gpu, slots):
    """DeviceEmbedding on the card against the host's float64 embedding
    (numpy) on a chunk's 16 rows: the full slot set of N = 2^16 and the
    DNN's sparse 1024 slots (ResNet-20's 32 x 32 image); inverse within
    1e-10, forward within 1e-9."""
    from tpu_fhe_torch.ops.special_fft import DeviceEmbedding
    from tpu_fhe_torch.scheme.ckks_encoder import _host_embed_inverse

    emb = DeviceEmbedding(slots, gpu)
    rng = np.random.default_rng(11)
    z = rng.uniform(-1, 1, (16, slots)) + 1j * rng.uniform(-1, 1, (16, slots))
    two_n = 4 * slots
    rot = np.empty(slots, dtype=np.int64)
    cur = 1
    for j in range(slots):
        rot[j], cur = cur, cur * 5 % two_n
    want = np.stack([_host_embed_inverse(v, 2 * slots, rot) for v in z])
    got = emb.embed_inverse(torch.from_numpy(z).to(gpu))
    assert got.device.type == "cuda" and got.dtype == torch.float64
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0, atol=1e-10)
    padded = np.zeros((16, two_n), dtype=np.complex128)
    padded[:, :2 * slots] = want
    back = emb.embed_forward(torch.from_numpy(want).to(gpu)).cpu().numpy()
    np.testing.assert_allclose(back, (np.fft.ifft(padded, axis=-1) * two_n)[:, rot],
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("word", ["u64", "q32"])
def test_device_embed_encode_on_card(gpu, word):
    """A device-embedding encode on the card (full and sparse slots): its
    rounded coefficients within one of the host path's, its plaintext the
    host path's residues of those same coefficients, bit for bit, and its
    encryption decoding within 1e-6 through either encoder."""
    from tpu_fhe_torch.ops.ntt import forward_ntt
    from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder

    c = FheContext(_dnn_params(word, 4096), device=gpu)
    enc_dev, enc_host = CkksEncoder(c, device_embed=True), CkksEncoder(c)
    sk = SecretKey(c, seed=12)
    level = c.level(1)
    scale = 2.0 ** 40
    rng = np.random.default_rng(12)
    for slots in (c.n // 2, 64):
        x = rng.uniform(-1, 1, slots).astype(np.complex128)
        dev = enc_dev._embed_inverse_slots(x, slots) * scale
        assert dev.device.type == "cuda"
        host = np.rint(enc_host._embed_inverse_slots(x, slots) * scale)
        assert np.max(np.abs(torch.round(dev).cpu().numpy() - host)) <= 1
        pt = enc_dev.encode(x, scale, slots=slots)
        want = forward_ntt(enc_host._residues(dev.cpu().numpy(), level.base), level.ntt)
        assert torch.equal(pt.data, want)
        ct = sk.encrypt_symmetric(pt)
        for enc in (enc_dev, enc_host):
            got = enc.decode(sk.decrypt(ct), slots=slots)
            np.testing.assert_allclose(got.real, x.real, atol=1e-6)


def test_evaluator_raises_when_capture_fails(ctx, monkeypatch):
    """A capture that fails raises; the Evaluator never runs the op eagerly
    instead.  (Last in the file: the failed capture is the test.)"""
    x = _graph_case(ctx, 9)
    negate = ev.negate

    def synchronizing(c, a):
        torch.cuda.synchronize()          # not permitted while a stream captures
        return negate(c, a)

    monkeypatch.setattr(ev, "negate", synchronizing)
    E = Evaluator(ctx)
    with pytest.raises(RuntimeError, match="capture failed"):
        E.negate(x["a"])
    assert E.num_graphs == 0


def test_limb_sharded_relinearize_in_two_ranks_on_the_card(gpu, tmp_path):
    """Two gloo ranks on the card (every CUDA tensor of a collective through
    host memory): a limb-sharded relinearize at N = 2^12 through the kernels
    equals the one-process relinearize in each rank."""
    import sys
    from pathlib import Path

    from tpu_fhe_torch.parallel.sharding import run_ranks

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_parallel_ranks as R

    assert run_ranks(R.relinearize_rank, 2, ("cuda", 4096), init_file=str(tmp_path / "init"),
                     backend="gloo", timeout_s=300) == [True, True]
