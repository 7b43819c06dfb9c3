"""The port's additive ops (negate, add_plain, sub_plain) against tpu_fhe,
bit for bit per RNS limb, and the graph-replaying ``Evaluator``
(eval/jit.py) on a CPU context, where every method must equal the module
function it wraps, on both plans at N = 128 (tests/test_torch_auto.py's
chains).  Also the context's cached NTT views, which let a rescale run
while a CUDA graph is captured, and ``first_data_level``.

The graphs themselves need a card: tests/test_torch_cuda.py holds every
method through the graph against the eager op there."""

import numpy as np
import pytest
import torch

from tpu_fhe.core.modulus import CoeffModulus as JCoeffModulus
from tpu_fhe.core.params import EncryptionParameters as JParams, SchemeType as JScheme
from tpu_fhe.eval import evaluator as jev
from tpu_fhe.ops.w64 import W64
from tpu_fhe.scheme.ciphertext import Ciphertext as JCiphertext, Plaintext as JPlaintext
from tpu_fhe.scheme.context import FheContext as JContext

from test_torch_auto import N, PLANS, _params, _port_ctx
from tpu_fhe_torch.eval import auto, evaluator as ev
from tpu_fhe_torch.eval.jit import Evaluator
from tpu_fhe_torch.ops.galois import conj_elt, galois_elt_from_step
from tpu_fhe_torch.scheme.ciphertext import Ciphertext, Plaintext
from tpu_fhe_torch.scheme.keys import SecretKey
from tpu_fhe_torch.utils.convert import to_numpy, word_tensor

torch.set_num_threads(1)


def _uniform(rng, ctx, ci, lead):
    q = np.asarray(ctx.level(ci).base.values, dtype=np.uint64)[:, None]
    return rng.integers(0, 2**62, size=lead + (len(q), N), dtype=np.uint64) % q


@pytest.fixture(scope="module", params=PLANS)
def plan(request):
    ctx = _port_ctx(request.param)
    sk = SecretKey(ctx, seed=3)
    rng = np.random.default_rng(31)
    scale = auto.default_scale(ctx)
    a, b, c3 = (Ciphertext(word_tensor(ctx, _uniform(rng, ctx, 1, (s,))), 1, scale)
                for s in (2, 2, 3))
    pt = Plaintext(word_tensor(ctx, _uniform(rng, ctx, 1, ())), 1, scale)
    jctx = JContext(_params(request.param, JCoeffModulus, JParams, JScheme))
    return dict(name=request.param, ctx=ctx, jctx=jctx, a=a, b=b, c3=c3, pt=pt,
                rlk=sk.relin_key(), gk=sk.galois_key([1, -2], include_conj=True))


@pytest.mark.parametrize("op", ["negate", "add_plain", "sub_plain"])
def test_additive_ops_match_reference(plan, op):
    ctx, jctx = plan["ctx"], plan["jctx"]
    a, pt = plan["a"], plan["pt"]
    ja = JCiphertext(W64.from_np(to_numpy(a.data).astype(np.uint64)), 1, a.scale)
    jpt = JPlaintext(W64.from_np(to_numpy(pt.data).astype(np.uint64)), 1, pt.scale)
    if op == "negate":
        got, want = ev.negate(ctx, a), jev.negate(jctx, ja)
    else:
        got, want = getattr(ev, op)(ctx, a, pt), getattr(jev, op)(jctx, ja, jpt)
    assert got.data.dtype == ctx.dtype and got.chain_index == want.chain_index
    np.testing.assert_array_equal(to_numpy(got.data).astype(np.uint64), want.data.to_np())


# every Evaluator method with the module function it wraps
METHODS = {
    "add": (lambda E, x: E.add(x["a"], x["b"]), lambda c, x: ev.add(c, x["a"], x["b"])),
    "sub": (lambda E, x: E.sub(x["a"], x["b"]), lambda c, x: ev.sub(c, x["a"], x["b"])),
    "negate": (lambda E, x: E.negate(x["a"]), lambda c, x: ev.negate(c, x["a"])),
    "add_plain": (lambda E, x: E.add_plain(x["a"], x["pt"]),
                  lambda c, x: ev.add_plain(c, x["a"], x["pt"])),
    "sub_plain": (lambda E, x: E.sub_plain(x["a"], x["pt"]),
                  lambda c, x: ev.sub_plain(c, x["a"], x["pt"])),
    "multiply": (lambda E, x: E.multiply(x["a"], x["b"]),
                 lambda c, x: ev.multiply(c, x["a"], x["b"])),
    "multiply_plain": (lambda E, x: E.multiply_plain(x["a"], x["pt"]),
                       lambda c, x: ev.multiply_plain(c, x["a"], x["pt"])),
    "square": (lambda E, x: E.square(x["a"]), lambda c, x: ev.square(c, x["a"])),
    "relinearize": (lambda E, x: E.relinearize(x["c3"], x["rlk"]),
                    lambda c, x: ev.relinearize(c, x["c3"], x["rlk"])),
    "multiply_relin": (lambda E, x: E.multiply_relin(x["a"], x["b"], x["rlk"]),
                       lambda c, x: ev.relinearize(c, ev.multiply(c, x["a"], x["b"]),
                                                   x["rlk"])),
    "square_relin": (lambda E, x: E.square_relin(x["a"], x["rlk"]),
                     lambda c, x: ev.relinearize(c, ev.square(c, x["a"]), x["rlk"])),
    "rescale": (lambda E, x: E.rescale(x["a"]), lambda c, x: ev.rescale_to_next(c, x["a"])),
    "mod_drop": (lambda E, x: E.mod_drop(x["a"]), lambda c, x: ev.mod_drop_to_next(c, x["a"])),
    "rotate": (lambda E, x: E.rotate(x["a"], -2, x["gk"]),
               lambda c, x: ev.apply_galois_with_key(
                   c, x["a"], galois_elt_from_step(-2, N), x["gk"].key_for_elt(
                       galois_elt_from_step(-2, N)))),
    "conjugate": (lambda E, x: E.conjugate(x["a"], x["gk"]),
                  lambda c, x: ev.conjugate(c, x["a"], x["gk"])),
}


@pytest.mark.parametrize("method", list(METHODS))
def test_evaluator_on_cpu_equals_module_functions(plan, method):
    via, direct = METHODS[method]
    ctx = plan["ctx"]
    E = Evaluator(ctx)
    got, want = via(E, plan), direct(ctx, plan)
    assert (got.chain_index, got.scale, got.noise_scale_deg) == (
        want.chain_index, want.scale, want.noise_scale_deg)
    assert torch.equal(got.data, want.data)
    assert E.num_graphs == 0          # the CPU path captures nothing


def test_evaluator_rotate_identity_and_missing_key(plan):
    E = Evaluator(plan["ctx"])
    a = plan["a"]
    assert E.rotate(a, 0, plan["gk"]) is a           # elt == 1: the input itself
    assert E.rotate(a, N // 2, plan["gk"]) is a
    with pytest.raises(ValueError, match="no Galois key"):
        E.rotate(a, 3, plan["gk"])                     # no NAF composition here
    assert conj_elt(N) in plan["gk"].keys


def test_ntt_views_are_cached(plan):
    """rescale_to_next's one-limb view of the level's tables is built once
    per (tables, limbs), so a later rescale copies nothing to the device;
    its values are those of slice_limbs."""
    ctx = plan["ctx"]
    level = ctx.level(1)
    view = ctx.ntt_view(level.ntt, (level.size - 1,))
    assert ctx.ntt_view(level.ntt, (level.size - 1,)) is view
    fresh = level.ntt.slice_limbs([level.size - 1])
    assert torch.equal(view.q, fresh.q) and torch.equal(view.limb_map, fresh.limb_map)
    before = len(ctx._ntt_views)
    ev.rescale_to_next(ctx, plan["a"])
    ev.rescale_to_next(ctx, plan["a"])
    assert len(ctx._ntt_views) == before
    assert ctx.first_data_level is ctx.level(1)
    assert ctx.first_data_level.base.values == plan["jctx"].first_data_level.base.values
