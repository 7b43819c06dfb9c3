"""The port's CKKS bootstrap (tpu_fhe_torch/boot/bootstrap.py) against
tpu_fhe's, bit for bit per RNS limb, on both plans at N = 64.

tpu_fhe's bootstrap takes minutes eagerly on a CPU (more than 290 s for
the dense N = 64 one), so its results come from golden files,
tests/data/torch_boot_golden_{u64,q32}.npz, which tools/boot_golden.py
writes from live runs of tpu_fhe's CkksBootstrapper: the u64 plan on
tests/test_bootstrap.py's parameters (16 data primes of 59-60 bits, 3
special primes), the q32 plan on tests/test_boot_composite.py's (an anchor
pair and 15 pairs of 28-30-bit primes, 4 special primes), both with the
sparse sine set K = 28, r = 3, degree 44 and level budget (2, 2); cases
dense (32 slots), sparse (8 slots) and, on the u64 plan, a two-iteration
Meta-BTS (on two more data primes, which Meta-BTS needs to do any work).
The file holds the reference's secret key, input and output ciphertexts,
precision, setup results (parameters, rotation indices, stage plans and a
digest of every limb of every C2S/S2C plaintext) and, for the dense case,
the input and output of one C2S BSGS level and of apply_double_angle.

Per case the port sets up a bootstrapper on the same parameters and makes
its keys with its own keygen under the reference's secret, from the seed
the golden run used to make the keys the reference bootstrapped with; a
digest holds the two key sets equal.  Then its setup, one BSGS level, the
double angles and the whole eval_bootstrap must equal the reference's, with
the same chain index, scale, noise-scale degree and decoded precision.
The slow-marked test reruns the reference live (the golden tool's own
run_case) and compares it with the port."""

import functools
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_fhe_torch.boot.bootstrap import CkksBootstrapper, precision_bits
from tpu_fhe_torch.core.modulus import CoeffModulus
from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType
from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder
from tpu_fhe_torch.scheme.context import FheContext
from tpu_fhe_torch.utils.convert import (
    ciphertext_from_np, galois_key_to_np, relin_key_to_np, secret_key_from_np, to_numpy,
)

# The suite runs in several worker processes at once: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DATA = Path(__file__).resolve().parent / "data"
_spec = importlib.util.spec_from_file_location("boot_golden", ROOT / "tools" / "boot_golden.py")
bg = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bg)

CASES = [(plan, case[0]) for plan in bg.CASES for case in bg.CASES[plan]]
DENSE = [(plan, "dense") for plan in bg.CASES]


@functools.lru_cache(maxsize=None)
def golden(plan):
    with np.load(DATA / f"torch_boot_golden_{plan}.npz") as f:
        arrays = {k: f[k] for k in f.files}
    return arrays, json.loads(str(arrays.pop("meta")))


@functools.lru_cache(maxsize=None)
def port(plan, case):
    """The port's bootstrapper for one golden case, set up on its parameters,
    with keys from the port's keygen under the reference's secret."""
    arrays, doc = golden(plan)
    meta = doc["cases"][case]
    ctx = FheContext(bg.params(plan, CoeffModulus, EncryptionParameters, SchemeType,
                               meta["extra_levels"]), device="cpu")
    enc = CkksEncoder(ctx)
    boot = CkksBootstrapper(ctx, enc)
    boot.set_sine_params(*doc["sine"])
    boot.setup(level_budget=tuple(doc["level_budget"]), slots=meta["slots"])
    sk = secret_key_from_np(ctx, arrays[f"{case}/secret"], seed=meta["key_seed"])
    boot.keygen(sk, meta["slots"])
    return ctx, enc, sk, boot


def ciphertext(plan, case, name):
    """A golden ciphertext: "input", "output", or a stage's "<stage>_in" or
    "<stage>_out", on the port's context."""
    arrays, doc = golden(plan)
    meta = doc["cases"][case]
    if name in ("input", "output"):
        m = meta[name]
    else:
        stage, part = name.rsplit("_", 1)
        m = meta[stage][("in", "out").index(part)]
    return ciphertext_from_np(port(plan, case)[0], arrays[f"{case}/{name}"], m["chain_index"],
                              m["scale"], m["noise_scale_deg"])


def assert_same(got, want):
    """Same metadata, and every limb of every component equal."""
    assert (got.chain_index, got.scale, got.noise_scale_deg) == \
        (want.chain_index, want.scale, want.noise_scale_deg)
    assert got.data.shape == want.data.shape and got.data.dtype == want.data.dtype
    diff = (got.data != want.data).any(dim=-1)
    assert not diff.any(), f"(component, limb) pairs that differ: {diff.nonzero().tolist()}"


def port_setup_record(plan, case):
    ctx, _, _, boot = port(plan, case)
    return bg.setup_record(boot, golden(plan)[1]["cases"][case]["slots"], lambda pt: (
        pt.chain_index, pt.scale, pt.noise_scale_deg, to_numpy(pt.data)))


@pytest.mark.parametrize("plan,case", CASES)
def test_setup_parameters(plan, case):
    got = port_setup_record(plan, case)
    want = golden(plan)[1]["cases"][case]["setup"]
    for field in ("correction_factor", "params_enc", "params_dec", "depth",
                  "rotation_indices", "c2s_plans", "s2c_plans"):
        assert got[field] == want[field], field


@pytest.mark.parametrize("plan,case", CASES)
def test_setup_plaintexts(plan, case):
    """Every C2S/S2C plaintext (encode_ext_batch, and encode_ext for the
    S2C remainder level) equal per limb, with its chain index and scale."""
    got = port_setup_record(plan, case)
    want = golden(plan)[1]["cases"][case]["setup"]
    for direction in ("c2s", "s2c"):
        assert len(got[direction]) == len(want[direction])
        for s, (g_stage, w_stage) in enumerate(zip(got[direction], want[direction])):
            assert len(g_stage) == len(w_stage)
            for i, (g, w) in enumerate(zip(g_stage, w_stage)):
                where = f"{direction}[{s}][{i}]"
                assert (g is None) == (w is None), where
                if g is None:
                    continue
                for field in ("chain_index", "scale", "noise_scale_deg"):
                    assert g[field] == w[field], f"{where} {field}"
                bad = [k for k, (a, b) in enumerate(zip(g["limbs"], w["limbs"])) if a != b]
                assert len(g["limbs"]) == len(w["limbs"]) and not bad, f"{where} limbs {bad}"


@pytest.mark.parametrize("plan,case", CASES)
def test_keys_are_the_golden_keys(plan, case):
    """The port's keygen under the golden secret and seed makes the keys the
    reference bootstrapped with, in the same form (Shoup words on q32)."""
    boot = port(plan, case)[3]
    meta = golden(plan)[1]["cases"][case]
    assert boot.key_shoup == meta["key_shoup"] == (plan == "q32")
    got = bg.key_digest(galois_key_to_np(boot.galois_keys), relin_key_to_np(boot.mul_key))
    assert got == meta["key_digest"]


@pytest.mark.parametrize("plan,case", DENSE)
def test_bsgs_level(plan, case):
    """The first C2S level (_bsgs_level) on the reference's input to it."""
    ctx, _, _, boot = port(plan, case)
    meta = golden(plan)[1]["cases"][case]
    rot_in, rot_out, b, g, num_rot = meta["bsgs"][2]
    si, *plan0 = boot.c2s_stage_plans(meta["slots"])[0][:6]
    assert [list(plan0[0]), list(plan0[1]), *plan0[2:]] == [rot_in, rot_out, b, g, num_rot]
    got = boot._bsgs_level(ciphertext(plan, case, "bsgs_in"),
                           boot.precom[meta["slots"]].a_c2s[si],
                           boot._keys_for(rot_in, rot_out), tuple(rot_in), tuple(rot_out),
                           b, g, num_rot)
    assert_same(got, ciphertext(plan, case, "bsgs_out"))


@pytest.mark.parametrize("plan,case", DENSE)
def test_apply_double_angle(plan, case):
    boot = port(plan, case)[3]
    got = boot.apply_double_angle(ciphertext(plan, case, "double_angle_in"), boot.r_iters)
    assert_same(got, ciphertext(plan, case, "double_angle_out"))


def port_bootstrap(plan, case):
    _, doc = golden(plan)
    meta = doc["cases"][case]
    boot = port(plan, case)[3]
    precision = doc["meta_precision"] if meta["iterations"] > 1 else 0
    return boot.eval_bootstrap(ciphertext(plan, case, "input"), meta["slots"],
                               meta["iterations"], precision)


@pytest.mark.parametrize("plan,case", CASES)
def test_eval_bootstrap(plan, case):
    """The whole bootstrap equals the reference's, decodes to the same
    precision, and leaves the same number of levels."""
    ctx, enc, sk, _ = port(plan, case)
    meta = golden(plan)[1]["cases"][case]
    got = port_bootstrap(plan, case)
    assert_same(got, ciphertext(plan, case, "output"))
    x = np.random.default_rng(meta["input_seed"]).uniform(-0.8, 0.8, meta["slots"])
    decoded = enc.decode(sk.decrypt(got), slots=meta["slots"]).real
    assert precision_bits(decoded, x) == pytest.approx(meta["precision"], rel=1e-12)
    d = ctx.params.composite_degree
    assert (len(ctx.chain) - 1 - got.chain_index) // d == meta["levels_after"] >= 1


@pytest.mark.slow
@pytest.mark.parametrize("plan,case", CASES)
def test_eval_bootstrap_live_reference(plan, case):
    """tools/boot_golden.py's run of the reference, live, against the port:
    the way the golden files are remade, minutes per case."""
    case_args = next(c for c in bg.CASES[plan] if c[0] == case)
    arrays, meta = bg.run_case(plan, case_args)
    ctx = port(plan, case)[0]
    out = meta["output"]
    want = ciphertext_from_np(ctx, arrays[f"{case}/output"], out["chain_index"], out["scale"],
                              out["noise_scale_deg"])
    assert_same(port_bootstrap(plan, case), want)
