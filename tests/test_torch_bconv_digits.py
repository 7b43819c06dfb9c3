"""K13's digit-plane arithmetic on the CPU: the port's balanced digits and
digit matrix against the reference's host functions
(tpu_fhe/ops/bconv_mxu.py _balanced_digits_host,
tpu_fhe/ops/bconv_mxu_pallas.py _diag_matrix_jk32, both numpy), the
kernel's fragment order of the digit matrix, and
``bconv_matmul32_digits_plain`` (the kernel's arithmetic: digit planes, an
s32 diagonal product, the 96-bit reassembly and the landing) against
``bconv_matmul32_plain``, bit for bit.  No JAX program runs here."""

import numpy as np
import pytest
import torch

from tpu_fhe.ops.bconv_mxu import _balanced_digits_host
from tpu_fhe.ops.bconv_mxu_pallas import _diag_matrix_jk32

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
