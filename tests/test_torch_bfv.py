"""The port's BFV path on the CPU against tpu_fhe, bit for bit per limb and
per metadata field, on the reference's own fixtures (tests/test_bfv.py):
N = 256, t the 20-bit batching prime, (50, 50, 60) for BEHZ and
(50, 50, 50, 60) for each HPS form.

The reference programs (keygen, encode, both encryptions, every op of
eval/bfv_eval.py, decryption, the noise budget and find_levels_to_drop)
take minutes of JAX compilation on the CPU, so tools/bfv_bgv_golden.py runs
them once and keeps their state and results in
tests/data/torch_bfv_bgv_golden.npz.  Their secret key, keys and
ciphertexts go to the port through utils/convert.py, and the port's ops
must give the same residues and metadata.  The ops-level cases hold
frac_alpha, bconv_hps and scale_and_round_hps against the live reference on
random inputs from a numpy seed, on both sides of k + m = 64.  A chain of
30-bit primes, which the reference runs as a q32 context, gives the same
values on the port's u64 plan."""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_fhe.ops import bconv as jbconv, w64

from tpu_fhe_torch.core import numth
from tpu_fhe_torch.core.modulus import CoeffModulus, Modulus, PlainModulus
from tpu_fhe_torch.core.params import EncryptionParameters, MulTech, SchemeType
from tpu_fhe_torch.eval import bfv_eval as bv
from tpu_fhe_torch.ops import bconv, modarith as mm
from tpu_fhe_torch.scheme.batch_encoder import BatchEncoder
from tpu_fhe_torch.scheme.bfv import BfvTools
from tpu_fhe_torch.scheme.bgv import BgvTools
from tpu_fhe_torch.scheme.ciphertext import Ciphertext
from tpu_fhe_torch.scheme.context import FheContext
from tpu_fhe_torch.utils.convert import (
    ciphertext_from_np, galois_key_from_np, plaintext_from_np, relin_key_from_np,
    secret_key_from_np, to_numpy,
)

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_bfv_bgv_golden.npz"
T_BITS = 20
CASES = ["behz", "hps", "hps_overq", "hps_overq_leveled"]
ROT_STEPS = (1, 2)


def _unpack(tree, arrays):
    if isinstance(tree, dict):
        if "__array" in tree:
            return arrays[tree["__array"]]
        if "__list" in tree:
            return [_unpack(v, arrays) for v in tree["__list"]]
        return {k: _unpack(v, arrays) for k, v in tree.items()}
    return tree


@functools.lru_cache(maxsize=None)
def golden(program: str) -> dict:
    """One reference program's state and results (tools/bfv_bgv_golden.py)."""
    with np.load(GOLDEN) as f:
        arrays = {k: f[k] for k in f.files}
    return _unpack(json.loads(str(arrays.pop("__tree"))), arrays)[program]


def meta(ct) -> list:
    return [ct.chain_index, ct.scale, ct.correction_factor, ct.noise_scale_deg,
            ct.is_ntt_form, ct.is_asymmetric]


@functools.lru_cache(maxsize=None)
def port(program: str) -> dict:
    """The port's context, tools and the reference's injected state for one
    reference program: its primes, its secret key, relin key (and Galois
    keys), plaintexts and input ciphertexts."""
    ref = golden(program)
    scheme = getattr(SchemeType, ref["scheme"])
    n = ref["n"]
    bits = [p.bit_length() for p in ref["primes"]]
    mods = CoeffModulus.create(n, bits)
    t = PlainModulus.batching(n, T_BITS)
    assert [q.value for q in mods] == ref["primes"] and t.value == ref["t"]
    ctx = FheContext(EncryptionParameters(
        scheme, n, tuple(mods), special_modulus_size=1, plain_modulus=t,
        mul_tech=getattr(MulTech, ref["mul_tech"]), allow_insecure=True), device="cpu")
    sk = secret_key_from_np(ctx, ref["s_ntt"], seed=3)

    def ct(name: str, where=None) -> Ciphertext:
        d = (where or ref)[name]
        chain, scale, cf, deg, ntt, asym = d["meta"]
        return ciphertext_from_np(ctx, d["data"], chain, scale=scale, noise_scale_deg=deg,
                                  correction_factor=cf, is_ntt_form=ntt, is_asymmetric=asym)

    rlk = ref["rlk"]
    if ref["is_q32"]:
        # the reference's q32 key carries 32-bit Shoup words: the port's u64
        # plan makes its own 64-bit ones for the same key
        rlk = relin_key_from_np(ctx, rlk["data"])
        rlk = type(rlk)(rlk.data, sk.evk_shoup(rlk.data))
    else:
        rlk = relin_key_from_np(ctx, rlk["data"], rlk["shoup"])
    gk = galois_key_from_np(ctx, {e: (k["data"], k["shoup"]) for e, k in ref["gk"].items()}) \
        if "gk" in ref else None
    tools = (BfvTools if scheme == SchemeType.bfv else BgvTools)(ctx)
    return dict(ref=ref, ctx=ctx, sk=sk, ct=ct, rlk=rlk, gk=gk, enc=BatchEncoder(ctx), tools=tools,
                pt=[plaintext_from_np(ctx, v, 1, is_ntt_form=False) for v in ref["plain"]])


def assert_same(got: Ciphertext, want: dict):
    np.testing.assert_array_equal(to_numpy(got.data), want["data"])
    assert meta(got) == want["meta"]


def run_op(case: str, op: str) -> Ciphertext:
    p = port("bfv_" + case)
    ctx, rlk, gk, tools = p["ctx"], p["rlk"], p["gk"], p["tools"]
    ca, cb, pm = p["ct"]("ca"), p["ct"]("cb"), p["pt"][2]
    return {
        "multiply": lambda: bv.multiply(tools, ca, cb),
        "square": lambda: bv.square(tools, ca),
        "relinearize": lambda: bv.relinearize(tools, p["ct"]("multiply", p["ref"]["ops"]), rlk),
        "rotate_rows": lambda: bv.rotate_rows(tools, ca, ROT_STEPS[0], gk),
        "rotate_rows_2": lambda: bv.rotate_rows(tools, ca, ROT_STEPS[1], gk),
        "rotate_columns": lambda: bv.rotate_columns(tools, ca, gk),
        "add": lambda: bv.add(ctx, ca, cb), "sub": lambda: bv.sub(ctx, ca, cb),
        "negate": lambda: bv.negate(ctx, ca),
        "add_plain": lambda: bv.add_plain(tools, ca, pm),
        "sub_plain": lambda: bv.sub_plain(tools, ca, pm),
        "multiply_plain": lambda: bv.multiply_plain(tools, ca, pm),
        "mod_switch_to_next": lambda: bv.mod_switch_to_next(tools, ca),
    }[op]()


MUL_OPS = [(case, op) for case in CASES for op in ("multiply", "square", "relinearize")]
BEHZ_OPS = ["rotate_rows", "rotate_rows_2", "rotate_columns", "add", "sub", "negate",
            "add_plain", "sub_plain", "multiply_plain", "mod_switch_to_next"]


@pytest.mark.parametrize("case,op", MUL_OPS + [("behz", op) for op in BEHZ_OPS])
def test_op_matches_reference(case, op):
    assert_same(run_op(case, op), golden("bfv_" + case)["ops"][op])


@pytest.mark.parametrize("case", CASES)
def test_decrypt_and_noise_budget_match_reference(case):
    p = port("bfv_" + case)
    ref, sk, tools = p["ref"], p["sk"], p["tools"]
    cts = {"ca": p["ct"]("ca"), "cb": p["ct"]("cb"), "multiply": p["ct"]("multiply", ref["ops"])}
    for name, want in ref["decrypt"].items():
        got = tools.decrypt(sk, cts[name])
        assert not got.is_ntt_form and got.chain_index == 1
        np.testing.assert_array_equal(to_numpy(got.data), want)
    for name, want in ref["budget"].items():
        assert tools.invariant_noise_budget(sk, cts[name]) == want
    a, b, _ = ref["values"]
    np.testing.assert_array_equal(p["enc"].decode(tools.decrypt(sk, cts["multiply"])),
                                  (a.astype(object) * b.astype(object)) % ref["t"])


@pytest.mark.parametrize("case", ["behz", "hps_overq_leveled"])
def test_find_levels_to_drop_matches_reference(case):
    p = port("bfv_" + case)
    tools = p["tools"]
    for d, ks, asym, want in p["ref"]["levels_to_drop"]:
        assert tools.find_levels_to_drop(d, ks, asym) == want


def test_hps_overq_leveled_with_a_dropped_level_matches_reference():
    """The leveled multiply with one data prime dropped: Q -> Ql scale and
    round, then the re-expansion by [QlDrop]_q with a zero limb."""
    p = port("bfv_hps_overq_leveled")
    tools = p["tools"]
    got = bv._hps_product(tools.hps(1, 1), MulTech.hps_overq_leveled, p["ct"]("ca").data,
                          p["ct"]("cb").data)
    np.testing.assert_array_equal(to_numpy(got), p["ref"]["dropped"])


def test_encode_decode_and_encrypt_match_reference():
    """The batch encoder's NTT route against the reference's golden NTT, the
    encryption's Delta-scaling step on the reference's own encryption of
    zero, and the port's own keygen and encryption decrypting exactly."""
    p = port("bfv_behz")
    ref, ctx, enc, sk, tools = p["ref"], p["ctx"], p["enc"], p["sk"], p["tools"]
    for vals, want in zip(ref["values"], ref["plain"]):
        pt = enc.encode(vals)
        assert pt.data.shape == (1, ctx.n) and not pt.is_ntt_form
        np.testing.assert_array_equal(to_numpy(pt.data), want)
        np.testing.assert_array_equal(enc.decode(pt), vals)
    zero = torch.from_numpy(ref["zero"].view(np.int64))
    got = tools._finish_encrypt(ctx.level(1), zero, p["pt"][2].data)
    np.testing.assert_array_equal(to_numpy(got), ref["finish_encrypt"])
    # the port's own keys: symmetric and public-key encryption, multiply,
    # relinearize and rotate decrypt to the cleartext results
    a, b, _ = ref["values"]
    t = ref["t"]
    ca = tools.encrypt_symmetric(sk, enc.encode(a))
    cb = tools.encrypt_asymmetric(sk.public_key(), enc.encode(b),
                                  torch.Generator().manual_seed(9))
    assert cb.is_asymmetric and not ca.is_asymmetric
    prod = bv.relinearize(tools, bv.multiply(tools, ca, cb), sk.relin_key())
    np.testing.assert_array_equal(enc.decode(tools.decrypt(sk, prod)),
                                  (a.astype(object) * b.astype(object)) % t)
    assert tools.invariant_noise_budget(sk, prod) > 0
    rot = bv.rotate_rows(tools, ca, 2, sk.galois_key([2]))
    np.testing.assert_array_equal(enc.decode(tools.decrypt(sk, rot)).reshape(2, -1),
                                  np.roll(a.reshape(2, -1), -2, axis=1))


def test_q32_sized_chain_runs_as_in_the_reference():
    """A BFV chain of 30-bit primes at N = 64: the reference runs it as a
    q32 context, the port on its u64 plan with the same residues."""
    p = port("bfv_q32")
    ref, ctx, sk, tools = p["ref"], p["ctx"], p["sk"], p["tools"]
    assert ref["is_q32"] and not ctx.is_q32 and ctx.dtype == torch.int64
    ca = p["ct"]("ca")
    got = tools.decrypt(sk, ca)
    np.testing.assert_array_equal(to_numpy(got.data), ref["decrypt"]["ca"])
    np.testing.assert_array_equal(p["enc"].decode(got), ref["values"][0])
    assert_same(bv.square(tools, ca), ref["ops"]["square"])


# --------------------------------------------------------------------------
# ops level: frac_alpha, bconv_hps, scale_and_round_hps
# --------------------------------------------------------------------------

OPS_N = 64


def _primes(bits: int, count: int, below: int | None = None) -> list[int]:
    if below is not None:
        return numth.get_primes_below(OPS_N, below, count)
    return numth.get_primes(OPS_N, bits, count)


def _mod_cols(primes):
    mods = [Modulus(p) for p in primes]
    col = lambda v: np.asarray(v, dtype=np.uint64).reshape(-1, 1)  # noqa: E731
    return (col([m.value for m in mods]), col([m.const_ratio[0] for m in mods]),
            col([m.const_ratio[1] for m in mods]))


def _t(a: np.ndarray) -> torch.Tensor:
    return mm.u64_tensor(a, "cpu")


@pytest.mark.parametrize("k", [3, 31, 63, 64])
def test_frac_alpha_matches_reference(k):
    rng = np.random.default_rng(k)
    s = rng.integers(0, 2**61, size=(2, k, OPS_N), dtype=np.uint64)
    fh = rng.integers(0, 2**64, size=(k, 1), dtype=np.uint64)
    fl = rng.integers(0, 2**64, size=(k, 1), dtype=np.uint64)
    # fractions in [0, 1/k) keep the true sum below 2^64, the contract
    fh //= np.uint64(2 * k)
    want = jbconv.frac_alpha(w64.as_w64(s), fh, fl).to_np()
    got = bconv.frac_alpha(_t(s), _t(fh), _t(fl))
    np.testing.assert_array_equal(to_numpy(got), want)


@pytest.mark.parametrize("k,m", [(3, 4), (30, 31)])
def test_bconv_hps_matches_reference(k, m):
    from tpu_fhe_torch.core.rns import BaseConverter, RNSBase

    qs = _primes(50, k)
    ps = _primes(0, m, below=min(qs))
    ib, ob = RNSBase(tuple(Modulus(q) for q in qs)), RNSBase(tuple(Modulus(p) for p in ps))
    conv = BaseConverter(ib, ob)
    rng = np.random.default_rng(k + m)
    x = rng.integers(0, 2**62, size=(2, k, OPS_N), dtype=np.uint64) % \
        np.asarray(qs, dtype=np.uint64)[:, None]
    col = lambda v: np.asarray([int(e) for e in v], dtype=np.uint64).reshape(-1, 1)  # noqa
    qhatinv = col(ib.q_hat_inv_mod_q)
    qhatinv_shoup = col(ib.q_hat_inv_mod_q_shoup)
    fix = [((1 << 128) // q) for q in qs]
    qinv_hi, qinv_lo = col([f >> 64 for f in fix]), col([f & (2**64 - 1) for f in fix])
    qhat_mod_p = np.asarray(conv.q_hat_mod_p, dtype=np.uint64)
    alpha_q = np.asarray(conv.alpha_q_mod_p, dtype=np.uint64)
    p, rlo, rhi = _mod_cols(ps)
    want = jbconv.bconv_hps(w64.as_w64(x), qhatinv, qhatinv_shoup, col(qs), qinv_hi, qinv_lo,
                            qhat_mod_p, alpha_q, p, rlo, rhi).to_np()
    got = bconv.bconv_hps(*(_t(v) for v in (x, qhatinv, qhatinv_shoup, col(qs), qinv_hi,
                                            qinv_lo, qhat_mod_p, alpha_q, p, rlo, rhi)))
    np.testing.assert_array_equal(to_numpy(got), want)


@pytest.mark.parametrize("k,m", [(3, 4), (31, 32), (32, 32), (40, 30), (70, 6)])
def test_scale_and_round_hps_matches_reference(k, m):
    """Both sides of k + m = 64: the narrow branch converts [x_a; x_b]
    through [cross | diag(diag)], the wide one cross alone (k < 64 or k >= 64)
    plus the diagonal product."""
    ps = _primes(60, m)
    p, rlo, rhi = _mod_cols(ps)
    rng = np.random.default_rng(100 * k + m)
    pv = np.asarray(ps, dtype=np.uint64)
    x_a = rng.integers(0, 2**60, size=(3, k, OPS_N), dtype=np.uint64)
    x_b = rng.integers(0, 2**62, size=(3, m, OPS_N), dtype=np.uint64) % pv[:, None]
    cross = rng.integers(0, 2**62, size=(m, k), dtype=np.uint64) % pv[:, None]
    diag = rng.integers(0, 2**62, size=(m, 1), dtype=np.uint64) % pv[:, None]
    fh = rng.integers(0, 2**64, size=(k, 1), dtype=np.uint64) // np.uint64(2 * k)
    fl = rng.integers(0, 2**64, size=(k, 1), dtype=np.uint64)
    want = jbconv.scale_and_round_hps(w64.as_w64(x_a), w64.as_w64(x_b), cross, diag, fh, fl,
                                      p, rlo, rhi).to_np()
    table = bconv.sr_table(_t(cross), _t(diag))
    assert table.shape[1] == (k + m if k + m < 64 else k)
    got = bconv.scale_and_round_hps(_t(x_a), _t(x_b), table, _t(diag), _t(fh), _t(fl), _t(p),
                                    _t(rlo), _t(rhi))
    np.testing.assert_array_equal(to_numpy(got), want)


def test_core_additions_match_reference():
    """The host layer BFV/BGV add: MulTech, the plain modulus and the
    parameter checks, PlainModulus.batching, get_primes_below, RNSBase's
    extend by one modulus, drop, decompose and compose, and HPS's
    alpha*Q mod p and Q mod p rows, against tpu_fhe's."""
    from tpu_fhe.core import numth as jnumth
    from tpu_fhe.core.modulus import CoeffModulus as JCoeffModulus, PlainModulus as JPlain
    from tpu_fhe.core.params import MulTech as JMulTech
    from tpu_fhe.core.rns import BaseConverter as JConv, RNSBase as JBase

    from tpu_fhe_torch.core.rns import BaseConverter, RNSBase

    assert [(m.name, m.value) for m in MulTech] == [(m.name, m.value) for m in JMulTech]
    for n, bits in ((256, 20), (4096, 30), (1 << 16, 20)):
        assert PlainModulus.batching(n, bits).value == JPlain.batching(n, bits).value
    assert numth.get_primes_below(256, 2**50 - 7, 5) == jnumth.get_primes_below(256, 2**50 - 7, 5)
    mods = CoeffModulus.create(256, [50, 50, 60])
    jmods = JCoeffModulus.create(256, [50, 50, 60])
    t = PlainModulus.batching(256, 20)
    base, jbase = RNSBase(tuple(mods[:2])), JBase(tuple(jmods[:2]))
    ext, jext = base.extend(mods[2]), jbase.extend(jmods[2])
    assert ext.values == jext.values and ext.drop(2).values == jext.drop(2).values
    rng = np.random.default_rng(3)
    for v in [0, 1, ext.big_modulus - 1] + [int(x) for x in rng.integers(0, 2**62, 4)]:
        assert ext.decompose(v) == jext.decompose(v)
        assert ext.compose(ext.decompose(v)) == jext.compose(jext.decompose(v)) == v
    conv = BaseConverter(base, RNSBase((mods[2], t)))
    jconv = JConv(jbase, JBase((jmods[2], JPlain.batching(256, 20))))
    assert conv.alpha_q_mod_p == jconv.alpha_q_mod_p and conv.big_q_mod_p == jconv.big_q_mod_p
    with pytest.raises(ValueError, match="plain modulus"):
        EncryptionParameters(SchemeType.bgv, 256, tuple(mods), allow_insecure=True)
    with pytest.raises(ValueError, match="non-coprime"):
        ext.extend(mods[0])
