"""The port's BGV path on the CPU against tpu_fhe, bit for bit per limb and
per metadata field (the correction factor among them), on the reference's
own fixture (tests/test_bgv.py): N = 256, (50, 50, 50, 60), t the 20-bit
batching prime.

As in test_torch_bfv.py, tools/bfv_bgv_golden.py ran the reference program
once (keygen, both encryptions, multiply, relinearize through the
t-preserving moddown, rotate and conjugate, modulus switching with its
correction factor, additions that balance two factors, the plain ops with
and without a factor, a depth-2 chain, decryption, and the moddown in both
forms on fixed inputs) and kept its state and results in
tests/data/torch_bfv_bgv_golden.npz; the port, handed the same secret key,
keys and ciphertexts, must give the same residues and metadata.  The
port's own keygen and encryptions carry t-scaled errors and decrypt
exactly."""

import numpy as np
import pytest
import torch

from tpu_fhe_torch.eval import bgv_eval as bg, evaluator as ev
from tpu_fhe_torch.ops.ntt import inverse_ntt
from tpu_fhe_torch.utils.convert import to_numpy, word_tensor

from test_torch_bfv import ROT_STEPS, assert_same, port

torch.set_num_threads(1)


def run_op(op: str):
    p = port("bgv")
    ctx, tools, rlk, gk = p["ctx"], p["tools"], p["rlk"], p["gk"]
    ops = p["ref"]["ops"]
    ca, cb, pm = p["ct"]("ca"), p["ct"]("cb"), p["pt"][2]
    ms_a = p["ct"]("mod_switch_to_next", ops)
    ms_prod = p["ct"]("ms_prod", ops)
    sq = p["ct"]("square_ms", ops)
    return {
        "multiply": lambda: bg.multiply(tools, ca, cb),
        "relinearize": lambda: bg.relinearize(ctx, p["ct"]("multiply", ops), rlk),
        "rotate": lambda: bg.rotate(ctx, ca, ROT_STEPS[0], gk),
        "rotate_cf": lambda: bg.rotate(ctx, ms_a, ROT_STEPS[1], gk),
        "conjugate": lambda: bg.conjugate(ctx, ca, gk),
        "mod_switch_to_next": lambda: bg.mod_switch_to_next(tools, ca),
        "mod_switch_b": lambda: bg.mod_switch_to_next(tools, cb),
        "mod_switch_twice": lambda: bg.mod_switch_to_next(tools, ms_a),
        "ms_prod": lambda: bg.relinearize(
            ctx, bg.multiply(tools, ms_a, p["ct"]("mod_switch_b", ops)), rlk),
        "add": lambda: bg.add(tools, ca, cb), "sub": lambda: bg.sub(tools, ca, cb),
        "add_balanced": lambda: bg.add(tools, ms_a, ms_prod),
        "sub_balanced": lambda: bg.sub(tools, ms_prod, ms_a),
        "add_plain": lambda: bg.add_plain(tools, ca, pm),
        "sub_plain": lambda: bg.sub_plain(tools, ca, pm),
        "multiply_plain": lambda: bg.multiply_plain(tools, ca, pm),
        "add_plain_cf": lambda: bg.add_plain(tools, ms_a, pm),
        "sub_plain_cf": lambda: bg.sub_plain(tools, ms_a, pm),
        "multiply_plain_cf": lambda: bg.multiply_plain(tools, ms_a, pm),
        "square_ms": lambda: bg.mod_switch_to_next(
            tools, bg.relinearize(ctx, bg.multiply(tools, ca, ca), rlk)),
        "depth2": lambda: bg.relinearize(ctx, bg.multiply(tools, sq, sq), rlk),
    }[op]()


OPS = ["multiply", "relinearize", "rotate", "rotate_cf", "conjugate", "mod_switch_to_next",
       "mod_switch_b", "mod_switch_twice", "ms_prod", "add", "sub", "add_balanced",
       "sub_balanced", "add_plain", "sub_plain", "multiply_plain", "add_plain_cf",
       "sub_plain_cf", "multiply_plain_cf", "square_ms", "depth2"]


@pytest.mark.parametrize("op", OPS)
def test_op_matches_reference(op):
    assert_same(run_op(op), port("bgv")["ref"]["ops"][op])


def test_correction_factors_are_nontrivial():
    """The fixture reaches the factor-carrying paths: a switched ciphertext's
    factor is not 1, the balanced addition starts from two different
    factors, and a rotation keeps its input's."""
    ops = port("bgv")["ref"]["ops"]
    cf = {k: ops[k]["meta"][2] for k in ops}
    assert cf["mod_switch_to_next"] != 1
    assert cf["ms_prod"] != cf["mod_switch_to_next"]
    assert cf["rotate_cf"] == cf["mod_switch_to_next"]


def test_decrypt_matches_reference():
    p = port("bgv")
    ref, tools, sk = p["ref"], p["tools"], p["sk"]
    for name, want in ref["decrypt"].items():
        ct = p["ct"](name) if name in ("ca", "cb") else p["ct"](name, ref["ops"])
        got = tools.decrypt(sk, ct)
        assert not got.is_ntt_form and got.chain_index == ct.chain_index
        np.testing.assert_array_equal(to_numpy(got.data), want)
    a, b, _ = ref["values"]
    t = ref["t"]
    enc = p["enc"]
    dec = {k: enc.decode(tools.decrypt(sk, p["ct"](k, ref["ops"])))
           for k in ("relinearize", "add_balanced", "depth2")}
    ab = (a.astype(object) * b.astype(object)) % t
    np.testing.assert_array_equal(dec["relinearize"], ab)
    np.testing.assert_array_equal(dec["add_balanced"], (a.astype(object) + ab) % t)
    np.testing.assert_array_equal(dec["depth2"], (a.astype(object) ** 4) % t)


def test_lifted_plaintext_matches_reference():
    p = port("bgv")
    got = p["tools"]._lifted_plaintext(p["pt"][0])
    assert got.is_ntt_form and got.chain_index == 1
    np.testing.assert_array_equal(to_numpy(got.data), p["ref"]["lifted"])


@pytest.mark.parametrize("output_ntt", [True, False])
def test_moddown_matches_reference(output_ntt):
    """The keyswitch's t-preserving moddown into NTT form (K3 with its `pre`
    operand, t mod q) and into coefficient form, on fixed inputs."""
    p = port("bgv")
    ctx, ref = p["ctx"], p["ref"]
    cx = word_tensor(ctx, ref["moddown_in"])
    got = ev.moddown_from_ntt(ctx, ctx.level(1), cx, output_ntt=output_ntt)
    np.testing.assert_array_equal(to_numpy(got),
                                  ref["moddown_ntt" if output_ntt else "moddown_coeff"])


def test_port_keys_carry_t_scaled_errors():
    """The port's own BGV keygen and encryptions: b + a*s of the public key is
    -t*e (its centered coefficients are multiples of t), and both
    encryptions, multiply, relinearize and rotate decrypt exactly."""
    p = port("bgv")
    ctx, tools, sk, enc = p["ctx"], p["tools"], p["sk"], p["enc"]
    t = p["ref"]["t"]
    kl = ctx.key_level
    pk = sk.public_key()
    e = inverse_ntt(ctx.key_level.mod.mul(pk.data[1], sk.s_ntt), kl.ntt)
    e = (to_numpy(inverse_ntt(pk.data[0].contiguous(), kl.ntt)).astype(object)
         + to_numpy(e).astype(object))
    q0 = kl.base.values[0]
    centered = [(int(v) % q0) - q0 if int(v) % q0 > q0 // 2 else int(v) % q0 for v in e[0]]
    assert all(c % t == 0 for c in centered) and any(centered)
    a, b, _ = p["ref"]["values"]
    ca = tools.encrypt_symmetric(sk, enc.encode(a))
    cb = tools.encrypt_asymmetric(pk, enc.encode(b), torch.Generator().manual_seed(4))
    assert cb.is_asymmetric
    prod = bg.relinearize(ctx, bg.multiply(tools, ca, cb), sk.relin_key())
    np.testing.assert_array_equal(enc.decode(tools.decrypt(sk, prod)),
                                  (a.astype(object) * b.astype(object)) % t)
    rot = bg.rotate(ctx, bg.mod_switch_to_next(tools, ca), 1, sk.galois_key([1]))
    np.testing.assert_array_equal(enc.decode(tools.decrypt(sk, rot)).reshape(2, -1),
                                  np.roll(a.reshape(2, -1), -1, axis=1))


def test_q32_sized_chain_runs_as_in_the_reference():
    """A BGV chain of 30-bit primes at N = 64: the reference runs it as a
    q32 context, the port on its u64 plan with the same residues."""
    p = port("bgv_q32")
    ref, ctx, tools = p["ref"], p["ctx"], p["tools"]
    assert ref["is_q32"] and not ctx.is_q32
    ca, cb = p["ct"]("ca"), p["ct"]("cb")
    np.testing.assert_array_equal(to_numpy(tools.decrypt(p["sk"], ca).data),
                                  ref["decrypt"]["ca"])
    prod = bg.multiply(tools, ca, cb)
    assert_same(prod, ref["ops"]["multiply"])
    assert_same(bg.relinearize(ctx, prod, p["rlk"]), ref["ops"]["relinearize"])
