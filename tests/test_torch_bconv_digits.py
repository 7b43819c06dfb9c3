"""The tensor-core base conversions' digit-plane arithmetic on the CPU: the
port's balanced digits, digit planes and digit matrices against the
reference's host functions (tpu_fhe/ops/bconv_mxu.py _balanced_digits_host,
tpu_fhe/ops/bconv_mxu_pallas.py _diag_matrix_jk and _diag_matrix_jk32, all
numpy), the kernels' fragment orders of the digit matrices, and the
kernels' arithmetic (digit planes, s32 diagonal products, the reassembly
and the landing) against the plain versions, bit for bit: K13's
``bconv_matmul32_digits_plain`` against ``bconv_matmul32_plain`` and K12's
and K11's ``bconv_matmul_digits_plain`` against ``bconv_matmul_plain``.
One case holds the port against the reference's XLA form of K12
(tpu_fhe/ops/bconv_mxu.py bconv_matmul_mxu) on the same inputs, and the
k >= 64 cases (K11's chunks of 64 inputs) against the reference's
bconv_matmul, whose chunked 128-bit XLA sum serves k >= 64 on the CPU."""

import functools

import numpy as np
import pytest
import torch

from tpu_fhe.ops.bconv import bconv_matmul as ref_bconv_matmul
from tpu_fhe.ops.bconv_mxu import _balanced_digits_host, bconv_matmul_mxu
from tpu_fhe.ops.bconv_mxu_pallas import _diag_matrix_jk, _diag_matrix_jk32
from tpu_fhe.ops.w64 import W64

from tpu_fhe_torch.core.modulus import CoeffModulus
from tpu_fhe_torch.ops import bconv, modarith as mm

N = 64


def _moduli(rng, count: int) -> list[int]:
    """`count` distinct primes of 29 or 30 bits (NTT-friendly at N)."""
    bits = rng.choice([29, 30], size=count).tolist()
    return [m.value for m in CoeffModulus.create(N, bits)]


def _table(rng, q_out, k: int) -> np.ndarray:
    q = np.asarray(q_out, dtype=np.uint64)[:, None]
    return rng.integers(0, 2**62, size=(len(q_out), k), dtype=np.uint64) % q


def test_balanced_digits_match_reference():
    rng = np.random.default_rng(1)
    edges = np.array([0, 127, 128, 255, 256, 0x7F7F7F7F, 0x80808080, 2**30 - 1, 2**61 - 1],
                     dtype=np.uint64)
    v = np.concatenate([edges, rng.integers(0, 2**61, size=500, dtype=np.uint64)])
    np.testing.assert_array_equal(bconv.balanced_digits(v), _balanced_digits_host(v))
    with pytest.raises(ValueError):
        bconv.balanced_digits(np.array([2**63], dtype=np.uint64))


def test_digit_planes32_match_reference():
    """The kernel's extraction ((x + 0x80808080) ^ 0x80808080, byte by
    byte) gives the reference's 4 balanced planes of residues < 2^30."""
    rng = np.random.default_rng(2)
    x = np.concatenate([np.array([0, 127, 128, 2**30 - 1, 0x3F808080], dtype=np.uint64),
                        rng.integers(0, 2**30, size=(3000,), dtype=np.uint64)])
    got = bconv.digit_planes32(torch.from_numpy(x.astype(np.int32))).numpy()
    want = _balanced_digits_host(x)
    np.testing.assert_array_equal(np.moveaxis(got, -1, 0), want[:4])
    assert not want[4:].any()


@pytest.mark.parametrize("k,m", [(1, 7), (30, 59), (40, 7), (5, 1)])
def test_digit_matrix_matches_reference(k, m):
    """diag_matrix_jk32 equals the reference's matrix; its block (s, p) is
    the table's digit plane s - p (zero outside 0..3), and the kernel's
    fragment-ordered words (digit_matrix32) hold exactly those planes,
    with every padding entry zero."""
    rng = np.random.default_rng(k * 100 + m)
    tab = _table(rng, _moduli(rng, m), k)
    m_pad = max(8, -(-m // 8) * 8)
    want = _diag_matrix_jk32(tab.tobytes(), m, k, m_pad)
    np.testing.assert_array_equal(bconv.diag_matrix_jk32(tab, m_pad), want)

    frag = bconv.digit_matrix32(mm.u32_tensor(tab, "cpu"))
    assert frag.dtype == torch.int32 and frag.shape == (-(-m // 16), 4, -(-k // 32), 32, 4)
    planes = bconv._unfragment32(frag, m, k).numpy()                   # (4, m, k)
    np.testing.assert_array_equal(planes, _balanced_digits_host(tab)[:4])
    blocks = want.reshape(7, m_pad, 4, k)[:, :m]
    for s in range(7):
        for p in range(4):
            expect = planes[s - p] if 0 <= s - p <= 3 else 0
            np.testing.assert_array_equal(blocks[s, :, p], expect)
    assert np.count_nonzero(frag.numpy().view(np.int8)) == np.count_nonzero(planes)


@pytest.mark.parametrize("m", [7, 59])
@pytest.mark.parametrize("k", [1, 30, 40])
def test_digits_plain_equals_plain(k, m):
    """The kernel's digit-plane arithmetic equals K13's int64 plain version
    at N = 64, batch 2, on random 29-30-bit moduli."""
    rng = np.random.default_rng(7 * k + m)
    primes = _moduli(rng, k + m)
    q_in, q_out = primes[:k], primes[k:]
    s = rng.integers(0, 2**62, size=(2, k, N), dtype=np.uint64) % np.asarray(
        q_in, dtype=np.uint64)[:, None]
    scaled = mm.u32_tensor(s, "cpu")
    table = mm.u32_tensor(_table(rng, q_out, k), "cpu")
    p = mm.u32_tensor(np.asarray(q_out, dtype=np.uint64).reshape(-1, 1), "cpu")
    fold = torch.from_numpy(mm.q32_mul_consts(q_out).astype(np.int64).reshape(5, m, 1))
    diag = bconv.digit_matrix32(table)
    want = bconv.bconv_matmul32_plain(scaled, table, p, fold, diag)
    got = bconv.bconv_matmul32_digits_plain(scaled, table, p, fold, diag)
    assert got.dtype == torch.int32 and got.shape == (2, m, N)
    assert torch.equal(got, want)


# -- K12: u64 residues, 8 digit planes a side ---------------------------------

def _moduli64(count: int, bits: int = 59) -> tuple[np.ndarray, ...]:
    """`count` distinct primes of `bits` bits with their Barrett words,
    each (count, 1) uint64."""
    mods = CoeffModulus.create(N, [bits] * count)
    return tuple(np.array([[f(mo)] for mo in mods], dtype=np.uint64) for f in
                 (lambda mo: mo.value, lambda mo: mo.const_ratio[0],
                  lambda mo: mo.const_ratio[1]))


def _tensors(*arrays):
    return [mm.u64_tensor(a, "cpu") for a in arrays]


def test_digit_planes_u64_match_reference():
    """The kernel's extraction (bytes of x + 0x8080808080808080, each xor
    0x80) gives the reference's 8 balanced planes of residues < 2^61."""
    rng = np.random.default_rng(3)
    edges = np.array([0, 1, 127, 128, 255, 256, 0x7F7F7F7F7F7F7F, 0x80808080, 0x80808080808080,
                      0x1F80808080808080, 2**61 - 1], dtype=np.uint64)
    x = np.concatenate([edges, rng.integers(0, 2**61, size=3000, dtype=np.uint64)])
    got = bconv.digit_planes(mm.u64_tensor(x, "cpu")).numpy()
    np.testing.assert_array_equal(np.moveaxis(got, -1, 0), _balanced_digits_host(x))
    np.testing.assert_array_equal(bconv.balanced_digits(x), _balanced_digits_host(x))


@pytest.mark.parametrize("k,m", [(1, 1), (15, 30), (17, 7), (63, 45)])
def test_digit_matrix_u64_matches_reference(k, m):
    """diag_matrix_jk equals the reference's 8-plane matrix, whose block
    (s, p) is the table's digit plane s - p; the kernel's fragments
    (digit_matrix) are the MMA operands A_d = [plane d | plane d - 1] of
    exactly those planes, 16 inputs a K step, with every padding entry
    zero, and they go back to the planes they were built from."""
    rng = np.random.default_rng(k * 100 + m)
    q = _moduli64(m)[0]
    tab = rng.integers(0, 2**62, size=(m, k), dtype=np.uint64) % q
    m_pad = max(8, -(-m // 8) * 8)
    want = _diag_matrix_jk(tab.tobytes(), m, k, m_pad)
    np.testing.assert_array_equal(bconv.diag_matrix_jk(tab, m_pad), want)
    planes = _balanced_digits_host(tab)                                  # (8, m, k)
    blocks = want.reshape(15, m_pad, 8, k)[:, :m]
    for s in range(15):
        for p in range(8):
            expect = planes[s - p] if 0 <= s - p <= 7 else 0
            np.testing.assert_array_equal(blocks[s, :, p], expect)

    frag = bconv.digit_matrix(mm.u64_tensor(tab, "cpu"))
    mg, ch = -(-m // 16), -(-k // 16)
    assert frag.dtype == torch.int32 and frag.shape == (mg, 9, ch, 32, 4)
    a = bconv.fragment_blocks(frag).numpy().reshape(9, 16 * mg, ch, 2, 16)  # [d, j, c, kh, i]
    padded = np.zeros((10, 16 * mg, 16 * ch), dtype=np.int8)             # planes -1 .. 8
    padded[1:9, :m, :k] = planes
    for d in range(9):
        for kh in range(2):
            np.testing.assert_array_equal(a[d, :, :, kh].reshape(16 * mg, 16 * ch),
                                          padded[d + 1 - kh])
    assert np.count_nonzero(frag.numpy().view(np.int8)) == 2 * np.count_nonzero(planes)


def _digits_case(rng, k: int, m: int, worst: bool):
    q_in = _moduli64(k, 60 if worst else 59)[0]
    p, rlo, rhi = _moduli64(m, 60)
    if worst:     # every residue at q - 1, every table entry at p - 1
        s = np.broadcast_to(q_in - np.uint64(1), (2, k, N)).copy()
        tab = np.broadcast_to(p - np.uint64(1), (m, k)).copy()
    else:
        s = rng.integers(0, 2**62, size=(2, k, N), dtype=np.uint64) % q_in
        tab = rng.integers(0, 2**62, size=(m, k), dtype=np.uint64) % p
    return _tensors(s, tab, p, rlo, rhi)


@pytest.mark.parametrize("k,m,worst", [(k, m, False) for k in (1, 15, 63) for m in (1, 30, 45)]
                         + [(63, 45, True)])
def test_digits_plain_u64_equals_plain(k, m, worst):
    """K12's digit-plane arithmetic equals its plain version at N = 64,
    batch 2; `worst` takes 60-bit moduli with every residue at q - 1 and
    every table entry at p - 1 (at k = 63 the row sum is near 63 2^120,
    the largest the u64 plan's moduli give)."""
    rng = np.random.default_rng(11 * k + m)
    scaled, table, p, rlo, rhi = _digits_case(rng, k, m, worst)
    diag = bconv.digit_matrix(table)
    want = bconv.bconv_matmul_plain(scaled, table, p, rlo, rhi, diag)
    got = bconv.bconv_matmul_digits_plain(scaled, table, p, rlo, rhi, diag)
    assert got.dtype == torch.int64 and got.shape == (2, m, N)
    assert torch.equal(got, want)


def test_digits_u64_match_reference_xla_form():
    """The reference's XLA form of K12 (bconv_matmul_mxu, one call) at
    15 -> 30, N = 128, against the port's plain and digit-plane versions on
    the same inputs."""
    rng = np.random.default_rng(2026)
    k, m, n = 15, 30, 128
    q_in = _moduli64(k)[0]
    p, rlo, rhi = _moduli64(m, 60)
    s = rng.integers(0, 2**62, size=(k, n), dtype=np.uint64) % q_in
    tab = rng.integers(0, 2**62, size=(m, k), dtype=np.uint64) % p
    want = bconv_matmul_mxu(W64.from_np(s), tab, p, rlo, rhi).to_np()
    scaled, table, pt, rlot, rhit = _tensors(s, tab, p, rlo, rhi)
    diag = bconv.digit_matrix(table)
    for fn in (bconv.bconv_matmul_plain, bconv.bconv_matmul_digits_plain):
        got = fn(scaled, table, pt, rlot, rhit, diag)
        np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


# -- K11: k >= 64 inputs in chunks of 64 ---------------------------------------

K11_M = 63      # every case's outputs are the first m of 63 rows and moduli


@functools.lru_cache(maxsize=None)
def _k11_case(k: int):
    """Batch-2 inputs below 59-bit input primes (32 primes repeated: a chain
    holds at most 64 above 30 bits), a (63, k) table below 60-bit output
    primes with their Barrett words, and the reference's bconv_matmul of
    them (its XLA route: 128-bit sums in chunks of 63), all numpy."""
    rng = np.random.default_rng(1000 + k)
    q_in = np.tile(_moduli64(32)[0], (-(-k // 32), 1))[:k]
    p, rlo, rhi = _moduli64(K11_M, 60)
    s = rng.integers(0, 2**62, size=(2, k, N), dtype=np.uint64) % q_in
    tab = rng.integers(0, 2**62, size=(K11_M, k), dtype=np.uint64) % p
    want = ref_bconv_matmul(W64.from_np(s), tab, p, rlo, rhi).to_np()
    return s, tab, p, rlo, rhi, want


@pytest.mark.parametrize("m", [1, 30, 63])
@pytest.mark.parametrize("k", [64, 65, 100, 127, 130])
def test_digits_plain_k11_equals_plain_and_reference(k, m):
    """K11's arithmetic (digit planes, each 64-input chunk's diagonal sums
    reassembled into 128 bits and landed, the chunks summed mod p) equals
    bconv_matmul_plain and the reference's bconv_matmul bit for bit at
    N = 64, batch 2: k one chunk (64), a chunk and one input (65), ragged
    last chunks (100, 127) and three chunks (130), into m = 1, 30 and 63."""
    s, tab, p, rlo, rhi, want = _k11_case(k)
    scaled, table, pt, rlot, rhit = _tensors(s, tab[:m], p[:m], rlo[:m], rhi[:m])
    diag = bconv.digit_matrix(table)
    assert diag.shape == bconv.digit_matrix_shape(m, k)
    got = bconv.bconv_matmul_digits_plain(scaled, table, pt, rlot, rhit, diag)
    assert got.dtype == torch.int64 and got.shape == (2, m, N)
    assert torch.equal(got, bconv.bconv_matmul_plain(scaled, table, pt, rlot, rhit))
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want[:, :m])


def test_digits_plain_k11_chunk_at_its_bound():
    """Two chunks of 64 inputs at the kernel's range: every input and table
    entry 2^61 - 1, so each chunk's row sum is 64 (2^61 - 1)^2, just below
    2^128; the chunked arithmetic equals the exact sum mod p (Python
    integers)."""
    k, m, n = 128, 2, 8
    p, rlo, rhi = _moduli64(m, 60)
    top = np.uint64(2**61 - 1)
    s = np.full((k, n), top, dtype=np.uint64)
    tab = np.full((m, k), top, dtype=np.uint64)
    scaled, table, pt, rlot, rhit = _tensors(s, tab, p, rlo, rhi)
    got = bconv.bconv_matmul_digits_plain(scaled, table, pt, rlot, rhit,
                                          bconv.digit_matrix(table))
    want = [k * (2**61 - 1) ** 2 % int(q) for q in p[:, 0]]
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  np.array(want, dtype=np.uint64)[:, None].repeat(n, 1))
