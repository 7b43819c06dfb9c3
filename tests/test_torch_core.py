"""The port's host layer (tpu_fhe_torch.core) and context tables against
tpu_fhe's: primes, NTT twiddle tables, RNS and keyswitch constants."""

import numpy as np
import pytest
import torch

from tpu_fhe.core import numth as jnumth
from tpu_fhe.core.modulus import CoeffModulus as JCoeffModulus
from tpu_fhe.core.ntt_tables import make_ntt_tables as j_make_ntt_tables
from tpu_fhe.core.params import EncryptionParameters as JParams, SchemeType as JScheme
from tpu_fhe.core.rns import KeySwitchDigits as JDigits, RNSBase as JBase
from tpu_fhe.scheme.context import FheContext as JContext

from tpu_fhe_torch.core import numth
from tpu_fhe_torch.core.modulus import CoeffModulus
from tpu_fhe_torch.core.ntt_tables import golden_forward_ntt, make_ntt_tables
from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
from tpu_fhe_torch.core.rns import KeySwitchDigits, RNSBase
from tpu_fhe_torch.scheme.context import FheContext
from tpu_fhe_torch.utils.convert import to_numpy

# The suite runs in several worker processes at once: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

BITS = [60, 50, 50, 50, 50, 60, 60]


@pytest.mark.parametrize("n,bits,count", [(1024, 60, 3), (4096, 50, 4), (1 << 15, 61, 2)])
def test_primes_equal_reference(n, bits, count):
    assert numth.get_primes(n, bits, count) == jnumth.get_primes(n, bits, count)


@pytest.mark.parametrize("n", [1024, 4096])
def test_coeff_modulus_equal_reference(n):
    ours = CoeffModulus.create(n, BITS)
    ref = JCoeffModulus.create(n, BITS)
    assert [m.value for m in ours] == [m.value for m in ref]
    assert [m.const_ratio for m in ours] == [m.const_ratio for m in ref]


@pytest.mark.parametrize("log_n", [10, 12])
def test_ntt_tables_equal_reference(log_n):
    q = jnumth.get_primes(1 << log_n, 59, 1)[0]
    ours, ref = make_ntt_tables(log_n, q), j_make_ntt_tables(log_n, q)
    assert (ours.root, ours.inv_root, ours.inv_degree) == (ref.root, ref.inv_root, ref.inv_degree)
    np.testing.assert_array_equal(ours.root_powers, np.array(ref.root_powers, dtype=np.uint64))
    np.testing.assert_array_equal(ours.inv_root_powers,
                                  np.array(ref.inv_root_powers, dtype=np.uint64))


def test_golden_ntt_equals_reference():
    from tpu_fhe.core.ntt_tables import golden_forward_ntt as j_golden

    q = jnumth.get_primes(64, 50, 1)[0]
    x = np.random.default_rng(0).integers(0, q, size=64, dtype=np.uint64)
    assert golden_forward_ntt(x, make_ntt_tables(6, q)) == j_golden(
        [int(v) for v in x], j_make_ntt_tables(6, q))


def test_rns_constants_equal_reference():
    mods = CoeffModulus.create(1024, BITS)
    jmods = JCoeffModulus.create(1024, BITS)
    ours = KeySwitchDigits(RNSBase(tuple(mods[:5])), RNSBase(tuple(mods[5:])), alpha=2)
    ref = JDigits(JBase(tuple(jmods[:5])), JBase(tuple(jmods[5:])), alpha=2)
    assert ours.beta == ref.beta == 3
    for d in range(3):
        assert ours.digit_indices(d) == ref.digit_indices(d)
        assert ours.converters[d].q_hat_mod_p == ref.converters[d].q_hat_mod_p
        assert ours.digit_bases[d].q_hat_inv_mod_q == ref.digit_bases[d].q_hat_inv_mod_q
        assert (ours.digit_bases[d].q_hat_inv_mod_q_shoup
                == ref.digit_bases[d].q_hat_inv_mod_q_shoup)


def _np(x):
    return np.asarray(x, dtype=np.uint64).reshape(-1)


def test_context_tables_equal_reference():
    n = 1024
    tctx = FheContext(EncryptionParameters(
        SchemeType.ckks, n, tuple(CoeffModulus.create(n, BITS)),
        special_modulus_size=2, allow_insecure=True), device="cpu")
    jctx = JContext(JParams(
        scheme=JScheme.ckks, poly_modulus_degree=n,
        coeff_modulus=tuple(JCoeffModulus.create(n, BITS)),
        special_modulus_size=2, allow_insecure=True))
    assert len(tctx.chain) == len(jctx.chain)
    for tl, jl in zip(tctx.chain[1:], jctx.chain[1:]):
        for name in ("q", "ratio_lo", "ratio_hi"):
            np.testing.assert_array_equal(to_numpy(getattr(tl.mod, name)).reshape(-1),
                                          _np(getattr(jl.mod, name)))
        if jl.inv_q_last_mod_q is not None:
            np.testing.assert_array_equal(to_numpy(tl.inv_q_last_mod_q).reshape(-1),
                                          _np(jl.inv_q_last_mod_q))
            np.testing.assert_array_equal(to_numpy(tl.inv_q_last_mod_q_shoup).reshape(-1),
                                          _np(jl.inv_q_last_mod_q_shoup))
        tk, jk = tl.ks, jl.ks
        assert (tk.alpha, tk.beta) == (jk.alpha, jk.beta)
        for name in ("part_qhatinv", "part_qhatinv_shoup", "p_hatinv", "p_hatinv_shoup",
                     "p_hat_mod_q", "big_pinv_mod_q", "big_pinv_mod_q_shoup"):
            np.testing.assert_array_equal(to_numpy(getattr(tk, name)).reshape(-1),
                                          _np(getattr(jk, name)))
        for td, jd in zip(tk.digits, jk.digits):
            assert (td.start, td.end) == (jd.start, jd.end)
            np.testing.assert_array_equal(to_numpy(td.qhat_mod_p).reshape(-1),
                                          _np(jd.qhat_mod_p))
            np.testing.assert_array_equal(to_numpy(td.comp_mod.q).reshape(-1),
                                          _np(jd.comp_mod.q))
            # the digit complement's twiddles are the reference's rows
            rows = to_numpy(td.comp_ntt.roots)[td.comp_ntt.limb_map.numpy()]
            np.testing.assert_array_equal(rows, np.asarray(jd.comp_ntt.roots))
    jk = jctx.key_ntt
    tk = tctx.key_ntt
    for name in ("roots", "roots_shoup", "inv_roots", "inv_roots_shoup"):
        np.testing.assert_array_equal(to_numpy(getattr(tk, name)), np.asarray(getattr(jk, name)))
    np.testing.assert_array_equal(to_numpy(tk.inv_degree_shoup), _np(jk.inv_degree_shoup))


def test_entry_points_default_to_cuda(monkeypatch):
    from tpu_fhe_torch.scheme.context import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        FheContext(EncryptionParameters(
            SchemeType.ckks, 1024, tuple(CoeffModulus.create(1024, BITS)),
            special_modulus_size=2, allow_insecure=True))
    assert resolve_device("cpu").type == "cpu"
