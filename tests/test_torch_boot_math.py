"""The port's copy of the bootstrap's host combinatorics
(tpu_fhe_torch/boot/boot_math.py) against tpu_fhe/boot/boot_math.py: every
function equal, integers exactly and complex128 vectors with
np.array_equal, for slots 4 to 1024, level budgets 1 to 4 (those that fit
log2(slots)), dim1 0 and 8, and both flag_i settings.  Both modules are
numpy only."""

import math

import numpy as np
import pytest

from tpu_fhe.boot import boot_math as ref

from tpu_fhe_torch.boot import boot_math as bm

SLOTS = [1 << k for k in range(2, 11)]
CASES = [(s, b) for s in SLOTS for b in range(1, 5) if b <= int(math.log2(s))]


def _group(slots):
    """setup's rotation group and roots of unity for `slots` slots."""
    m = 4 * slots
    rot_group = np.array([pow(5, i, m) for i in range(slots)], dtype=np.int64)
    ksi = np.exp(2j * math.pi * np.arange(m + 1) / m)
    ksi[m] = ksi[0]
    return ksi, rot_group


def _equal_vectors(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.complex128
        assert np.array_equal(g, w)


@pytest.mark.parametrize("dim1", [0, 8])
@pytest.mark.parametrize("slots,budget", CASES)
def test_layers_and_collapsed_fft_params(slots, budget, dim1):
    log_slots = int(math.log2(slots))
    assert bm.select_layers(log_slots, budget) == ref.select_layers(log_slots, budget)
    assert (bm.get_collapsed_fft_params(slots, budget, dim1)
            == ref.get_collapsed_fft_params(slots, budget, dim1))


@pytest.mark.parametrize("flag_i", [False, True])
@pytest.mark.parametrize("slots,budget", CASES)
def test_collapse(slots, budget, flag_i):
    ksi, rot_group = _group(slots)
    for name in ("coeff_encoding_collapse", "coeff_decoding_collapse"):
        got = getattr(bm, name)(ksi, rot_group, budget, flag_i)
        want = getattr(ref, name)(ksi, rot_group, budget, flag_i)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal_vectors(g, w)


@pytest.mark.parametrize("encoding", [False, True])
@pytest.mark.parametrize("flag_i", [False, True])
@pytest.mark.parametrize("slots", SLOTS)
def test_coeff_one_level(slots, flag_i, encoding):
    ksi, rot_group = _group(slots)
    _equal_vectors(bm._coeff_one_level(ksi, rot_group, flag_i, encoding),
                   ref._coeff_one_level(ksi, rot_group, flag_i, encoding))


@pytest.mark.parametrize("slots", SLOTS)
def test_rotation_helpers(slots):
    rng = np.random.default_rng(slots)
    for index in range(-3 * slots, 3 * slots + 1):
        assert bm.reduce_rotation(index, slots) == ref.reduce_rotation(index, slots)
    vec = rng.standard_normal(slots) + 1j * rng.standard_normal(slots)
    for index in (-slots - 1, -1, 0, 1, slots // 2, slots, slots + 3, 5 * slots):
        assert np.array_equal(bm.rotate_vec(vec, index), ref.rotate_vec(vec, index))
    assert np.array_equal(bm.fill_vec(vec[:3], slots), ref.fill_vec(vec[:3], slots))
    mat = rng.standard_normal((4, slots)) + 1j * rng.standard_normal((4, slots))
    for index in (0, 1, slots - 1, slots + 2):
        assert np.array_equal(bm.extract_shifted_diagonal(mat, index),
                              ref.extract_shifted_diagonal(mat, index))
    # a non-power-of-two modulus takes the other branch of reduce_rotation
    assert [bm.reduce_rotation(i, 12) for i in range(-30, 30)] == \
        [ref.reduce_rotation(i, 12) for i in range(-30, 30)]
