"""The port's CUDA kernels against their plain torch versions, on the card:
the u64 plan's (K1-K3, K7, K8, K11) on a 50/60-bit chain, the q32 plan's
(K4-K6, K9, K10, K13) on a composite chain of 30-bit primes, the
one-cluster-launch transforms (K1, K4, K5) at every ring size from 2^10 to
2^17, and each slice
(relinearize and rescale; rotate, conjugate and the hoisted rotation sum)
on the card against the same slice on the CPU.

A CUDA kernel has no interpret mode, so these tests need an NVIDIA GPU and
nvcc; without a card they skip.  They import neither jax nor tpu_fhe, so
they run where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import ctypes

import numpy as np
import pytest
import torch

from tpu_fhe_torch.core.modulus import CoeffModulus
from tpu_fhe_torch.core.ntt_tables import make_ntt_tables
from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
from tpu_fhe_torch.eval import evaluator as ev, hoisting as ho
from tpu_fhe_torch.ops import _build, bconv, ks, modarith as mm, ntt
from tpu_fhe_torch.ops.ntt import build_device_ntt_tables
from tpu_fhe_torch.scheme.context import FheContext
from tpu_fhe_torch.scheme.keys import SecretKey
from tpu_fhe_torch.utils.convert import (
    ciphertext_from_np, galois_key_from_np, galois_key_to_np, relin_key_from_np,
    relin_key_to_np, to_numpy,
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
        tab = (dt.qhat_mod_p, dt.comp_mod.q, dt.comp_mod.ratio_lo, dt.comp_mod.ratio_hi)
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


def test_cluster_transforms_are_one_launch(gpu):
    """A profile of one call of K1 (u64) and of K5 (q32, scaled) at 2^15
    sees one device kernel each: the cluster kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = 1 << 15
    t64 = build_device_ntt_tables([make_ntt_tables(15, q) for q in
                                   (m.value for m in CoeffModulus.create(n, _BITS64))], gpu)
    t32 = build_device_ntt_tables([make_ntt_tables(15, q) for q in _primes30(n, 6)], gpu,
                                  q32=True)
    x64, x32 = _res(_Dev(gpu, n), t64.q, seed=1), _res32(_Dev(gpu, n), t32.q, seed=2)
    s = x32[:, 0].contiguous()
    ss = mm.shoup32_of(s, t32.q.reshape(-1))
    for fn, name in ((lambda: ntt.forward_ntt(x64, t64), "fwd_cluster"),
                     (lambda: ntt.inverse_ntt_scaled(x32, t32, s, ss), "inv_cluster")):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        assert [e.count for e in kernels] == [1] and name in kernels[0].key


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
