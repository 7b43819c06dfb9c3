"""Encrypted DNN layer library (PPML): convolution, batch norm, Chebyshev
and sign-composite ReLU, softmax, average pool with the fully connected
layer, over sparse-packed per-channel CKKS ciphertexts.

Port of ``tpu_fhe/models/dnn.py``.  Layout: channel k is one ciphertext
holding the w x w image row-major in (w << slotstr)^2 slots; a stride-2
convolution leaves the data in place and doubles the slot stride
(slotstr + 1), so rotation steps are premultiplied by 2^slotstr and the
bootstrap runs at (w << slotstr)^2 slots.

Channels run through the evaluation layer (``eval/auto.py``,
``eval/chebyshev.py``, ``eval/hoisting.py``) and the bootstrapper in
chunks of ``channel_batch`` channels stacked with ``stack_cts`` (the
reference's default channel batching): the bootstrap, the Chebyshev ReLU,
the sign stages of the composite ReLU and the residual add run once per
chunk, so on a CUDA context every NTT, base conversion and key inner
product is one launch of the port's kernel for the whole chunk.  A batch
of 1 runs the channels one at a time.  Where a layer applies per-channel
constants (batch norm, the fully connected layer, the convolution's
weights), their CRT lifts go to the device in one copy per layer and one
modular multiply serves the stacked channels.

The convolution is hoisted: one modup per input channel serves every tap,
the taps accumulate at the extended basis QlP, and one moddown lands each
output channel.  Its masks are built on the device by default
(``device_encode=True``, the reference's default path): per geometry the
fixed-point embeddings e = rint(emb * 2^30) + 2^31, per (output channel,
tap) c = rint(weight * scale / 2^30) + 2^31, and per QlP limb the exact
(e - 2^31)(c - 2^31) = e c - 2^31 e - 2^31 c_int mod q, then the masks'
forward NTT at QlP.  A weight with |c_int| >= 2^31 (|weight| >= about 8 at
the working scale), or an embedding outside the fixed-point range, takes
the host-encode path, where the reference raises.  The reference's stage
jits have no counterpart: they served a TPU's compiler.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..eval import auto, chebyshev as cheb, hoisting as hoist
from ..eval.evaluator import apply_galois_with_key
from ..ops import modarith as mm
from ..ops.galois import galois_elt_from_step
from ..ops.ntt import forward_ntt
from ..scheme.ciphertext import Ciphertext, stack_cts, unstack_cts
from ..scheme.context import FheContext
from ..scheme.keys import GaloisKey, PublicKey, RelinKey, SecretKey, encrypt_asymmetric
from ..utils import timer
from ..utils.convert import ciphertext_from_np, to_numpy


@dataclass
class TensorCT:
    """One ciphertext per channel."""

    cts: list[Ciphertext]
    width: int
    slotstr: int = 0

    @property
    def num_ch(self) -> int:
        return len(self.cts)

    @property
    def num_slots(self) -> int:
        return (self.width << self.slotstr) ** 2


def tensor_ct_from_np(ctx: FheContext, data: list, meta: list, width: int,
                      slotstr: int) -> TensorCT:
    """A TensorCT from per-channel ciphertext arrays (size, L, N) and their
    metadata dicts (chain_index, scale, noise_scale_deg), as
    ``utils/convert.py`` carries single ciphertexts."""
    return TensorCT([ciphertext_from_np(ctx, d, m["chain_index"], m["scale"],
                                        m["noise_scale_deg"]) for d, m in zip(data, meta)],
                    width, slotstr)


def tensor_ct_to_np(t: TensorCT) -> tuple[list, list, int, int]:
    """-> (per-channel arrays, their metadata dicts, width, slotstr)."""
    return ([to_numpy(c.data) for c in t.cts],
            [dict(chain_index=int(c.chain_index), scale=float(c.scale),
                  noise_scale_deg=int(c.noise_scale_deg)) for c in t.cts],
            t.width, t.slotstr)


# The 3-stage minimax sign composite: odd degree-15 Chebyshev series and
# their input ranges (the reference's src/dnn.cu:170-191).
_SIGN_COEFFS = [
    [0, 0.667972070856, 0, -0.223989523020, 0, 0.136121229346, 0,
     -0.099160550898, 0, 0.079224867308, 0, -0.067250088206, 0,
     0.059852569462, 0, -0.503955481350],
    [0, 0.955669291788, 0, -0.317870998995, 0, 0.189953989728, 0,
     -0.134924463410, 0, 0.104260767625, 0, -0.084798113265, 0,
     0.071534728674, 0, -0.282024623439],
    [0, 1.254717353059, 0, -0.371638622338, 0, 0.175181567419, 0,
     -0.085946606966, 0, 0.039326533561, 0, -0.015616729371, 0,
     0.004903749402, 0, -0.000987938705],
]
_SIGN_RANGES = [(-1.0, 1.0), (-1.908, 1.908), (-1.332, 1.332)]



def relu_composite_clear(x: np.ndarray) -> np.ndarray:
    """The float64 value of what relu_composite computes:
    x (p3(p2(p1(0.1 x))) + 1) / 2, each p_k the sign stage's Chebyshev
    series on its range."""
    s = 0.1 * np.asarray(x, dtype=np.float64)
    for coeffs, (a, b) in zip(_SIGN_COEFFS, _SIGN_RANGES):
        s = np.polynomial.chebyshev.chebval((2.0 * s - (a + b)) / (b - a), coeffs)
    return x * (s + 1.0) / 2.0


CONV_FP_BITS = 30               # fixed-point bits of the device-encoded masks
CONV_CACHE_BYTES = 512 * 10**6  # finished-plaintext cache budget of a conv layer
MAX_CHANNEL_BATCH = 64
CPU_BATCH_BUDGET = 2500 * 10**6  # the reference's default channel-batch budget
CUDA_BATCH_SHARE = 0.1          # of the card's memory, the channel-batch budget there


def _degree_one(ctx: FheContext, cts: list[Ciphertext]) -> list[Ciphertext]:
    """Operands at noise-scale degree 1 (EvalMultAuto semantics up front)."""
    return [auto.mod_reduce(ctx, c, 1) if c.noise_scale_deg == 2 else c for c in cts]


def _residues(ctx: FheContext, arr: np.ndarray) -> torch.Tensor:
    """Residues (uint64 numpy) as one tensor in the context's word."""
    return (mm.u32_tensor if ctx.is_q32 else mm.u64_tensor)(arr, ctx.device)


def batch_budget(ctx: FheContext) -> int:
    """Bytes a channel batch may take: CUDA_BATCH_SHARE of the card's
    memory on a CUDA context, the reference's CPU_BATCH_BUDGET on the
    CPU."""
    dev = ctx.device
    if dev.type == "cuda":
        return int(CUDA_BATCH_SHARE * torch.cuda.get_device_properties(dev).total_memory)
    return CPU_BATCH_BUDGET


def channel_batch(ctx: FheContext, n_ch: int, forced: int | None = None) -> int:
    """Channels per chunk: `forced` (at most n_ch), else the largest power
    of two <= min(n_ch, 64, budget // (10 (size_Ql + size_P) N 8)), the
    reference's rule (about 10 extended-basis copies of a channel in a
    hoisted BSGS level).  The DNN's layers and the packed convolution's
    output channels take it."""
    if forced is not None:
        return max(1, min(n_ch, int(forced)))
    per_ch = 10 * (ctx.level(1).size + ctx.params.size_P) * ctx.n * 8
    b = max(1, min(n_ch, MAX_CHANNEL_BATCH, batch_budget(ctx) // per_ch))
    return 1 << (b.bit_length() - 1)


class DNN:
    """Encrypted-inference layer library bound to one context and encoder."""

    def __init__(self, ctx: FheContext, encoder, scale: float | None = None,
                 channel_batch: int | None = None):
        """`channel_batch` forces the channels per chunk (1 runs them one at
        a time); None takes channel_batch()'s memory rule."""
        self.ctx = ctx
        self.encoder = encoder
        sf, _ = auto.scaling_factors(ctx)
        self.scale = scale if scale is not None else sf[0]
        self.gk: GaloisKey | None = None
        self.mul_key: RelinKey | None = None
        self.forced_batch = channel_batch
        self._pt_cache: dict = {}

    def batch_budget(self) -> int:
        return batch_budget(self.ctx)

    def channel_batch(self, n_ch: int) -> int:
        return channel_batch(self.ctx, n_ch, self.forced_batch)

    def _map_cts(self, fn, *lists: list[Ciphertext]) -> list[Ciphertext]:
        """fn over the channels of equal-length lists, one chunk of
        channel_batch channels at a time (each list's chunk stacked), or one
        channel at a time when that is 1."""
        n = len(lists[0])
        b = self.channel_batch(n)
        if b <= 1:
            return [fn(*xs) for xs in zip(*lists)]
        out = []
        for lo in range(0, n, b):
            chunk = [stack_cts(cts[lo:lo + b]) for cts in lists]
            out.extend(unstack_cts(fn(*chunk), chunk[0].data.shape[0]))
        return out

    def _map(self, t: TensorCT, fn) -> TensorCT:
        return TensorCT(self._map_cts(fn, t.cts), t.width, t.slotstr)

    # -- key management ---------------------------------------------------
    @staticmethod
    def conv_rotation_indices(input_width: int, kernel_h: int, slotstr: int) -> list[int]:
        """The rotation steps of one conv layer (ComputeRotationIndices)."""
        large_l = input_width * (1 << slotstr)
        c = kernel_h // 2
        out = set()
        for j in range(kernel_h):
            for i in range(kernel_h):
                out.add(((i - c) * large_l + (j - c)) << slotstr)
        return sorted(out)

    @staticmethod
    def avgpool_rotation_indices(input_width: int, slotstr: int) -> list[int]:
        """The rotation steps of the log-rotation image sum: columns 2^i
        apart (2^i << slotstr slots) and rows 2^j apart ((2^j << slotstr)
        times the row length in slots, input_width << slotstr).  The
        reference steps rows by (2^j << slotstr) * input_width, which is
        one data row only at slot stride 0."""
        log_l = int(math.log2(input_width))
        pow_s = 1 << slotstr
        large_l = input_width * pow_s
        return ([pow_s << i for i in range(log_l)]
                + [(pow_s << j) * large_l for j in range(log_l)])

    def build_galois_key(self, sk: SecretKey, rotation_indices: list[int]):
        self.gk = sk.galois_key(sorted({r for r in rotation_indices if r != 0}))

    def relin_keygen(self, sk: SecretKey):
        self.mul_key = sk.relin_key()

    # -- encode / encrypt -----------------------------------------------------
    def enc_tensor(self, image: np.ndarray, pk: PublicKey | None = None,
                   sk: SecretKey | None = None,
                   generator: torch.Generator | None = None, slotstr: int = 0,
                   scale: float | None = None) -> TensorCT:
        """image (w, w, ch) -> one sparse-packed ciphertext per channel at
        chain index 1 and `scale` (default the DNN's): under `pk` (drawing
        from `generator`, by default one seeded with 0 on the context's
        device), else under `sk`.  At slot stride `slotstr` the (i, j)
        pixel lies in slot (i (w << slotstr) + j) << slotstr of (w <<
        slotstr)^2, the layout a stride-2 convolution leaves, and the slots
        between hold 0."""
        image = np.asarray(image, dtype=np.float64)
        w, _, ch = image.shape
        big_w, pow_s = w << slotstr, 1 << slotstr
        if pk is not None and generator is None:
            generator = torch.Generator(device=self.ctx.device).manual_seed(0)
        cts = []
        for k in range(ch):
            vals = np.zeros((big_w, big_w))
            vals[::pow_s, ::pow_s] = image[:, :, k]
            pt = self.encoder.encode(vals.reshape(-1), scale or self.scale, chain_index=1,
                                     slots=big_w * big_w)
            cts.append(encrypt_asymmetric(self.ctx, pk, pt, generator) if pk is not None
                       else sk.encrypt_symmetric(pt))
        return TensorCT(cts=cts, width=w, slotstr=slotstr)

    def dec_tensor(self, t: TensorCT, sk: SecretKey) -> np.ndarray:
        """-> (w, w, ch) real array."""
        stride = 1 << t.slotstr
        big_w = t.width * stride
        out = np.zeros((t.width, t.width, t.num_ch))
        for k, ct in enumerate(t.cts):
            vals = self.encoder.decode(sk.decrypt(ct), slots=big_w * big_w).real
            out[:, :, k] = vals.reshape(big_w, big_w)[::stride, ::stride]
        return out

    def _mask_embedding(self, w: int, slotstr: int, kh: int, i: int, j: int) -> np.ndarray:
        """The unscaled embedding of the (i, j) tap's zero-padding mask, kept
        for the DNN's lifetime; weights and scales fold in linearly."""
        key = ("emb", w, slotstr, kh, i, j)
        got = self._pt_cache.get(key)
        if got is not None:
            return got
        pow_s = 1 << slotstr
        large_l = w * pow_s
        c = kh // 2
        m = np.zeros(large_l * large_l)
        for ip in range(w):
            for jp in range(w):
                if 0 <= ip + i - c <= w - 1 and 0 <= jp + j - c <= w - 1:
                    m[(ip * large_l + jp) * pow_s] = 1.0
        got = self._pt_cache[key] = self.encoder.embed_for_slots(m, large_l * large_l)
        return got

    # -- layers -------------------------------------------------------------
    def conv(self, t: TensorCT, weight: np.ndarray, stride: int = 1,
             cache_key: str | None = None, device_encode: bool = True) -> TensorCT:
        """SISO rotate-mask-accumulate convolution, zero padding; weight is
        (kh, kw, in_ch, out_ch).  Stride 2 doubles the slot stride instead
        of moving data.  `device_encode` builds the masks on the device
        (the default); else they are encoded on the host, and `cache_key`
        (a layer name) keeps the finished plaintexts of a layer that fits
        CONV_CACHE_BYTES."""
        ctx = self.ctx
        if stride not in (1, 2):
            raise ValueError("conv stride must be 1 or 2")
        kh, kw, in_ch, out_ch = weight.shape
        if kh != kw or in_ch != t.num_ch:
            raise ValueError("conv weight shape does not match the tensor")
        w = t.width
        pow_s = 1 << t.slotstr
        large_l = w * pow_s
        c = kh // 2
        cts = _degree_one(ctx, t.cts)
        ci = cts[0].chain_index
        sf, _ = auto.scaling_factors(ctx)
        scale = sf[auto._level(cts[0], ctx)]

        taps = [(i, j) for j in range(kh) for i in range(kh)]
        rot_steps = [((i - c) * large_l + (j - c)) * pow_s for (i, j) in taps]
        rot_keys = {}
        for rot in rot_steps:
            if rot != 0:
                elt = galois_elt_from_step(rot, ctx.n)
                rot_keys[elt] = self.gk.key_for_elt(elt)

        def rotations(ct: Ciphertext) -> Ciphertext:
            """Every tap's rotation at QlP, from one modup: (T, 2, QlP, N)."""
            pre = hoist.fast_rotation_precompute(ctx, ct)
            outs = []
            for rot in rot_steps:
                if rot == 0:
                    outs.append(hoist.keyswitch_ext(ctx, ct))
                else:
                    elt = galois_elt_from_step(rot, ctx.n)
                    outs.append(hoist.fast_rotation_ext(ctx, ct, pre, elt, rot_keys[elt],
                                                        add_first=True))
            return stack_cts(outs)

        out = None
        if device_encode:
            out = self._conv_device_encode(t, cts, weight, rotations, taps, kh, scale, ci)
        if out is None:
            out = self._conv_host_encode(t, cts, weight, rotations, taps, kh, scale, ci,
                                         cache_key)
        return TensorCT(cts=out, width=w // stride,
                        slotstr=t.slotstr + 1 if stride == 2 else t.slotstr)

    def _conv_host_encode(self, t, cts, weight, rotations, taps, kh, scale, ci, cache_key):
        """The masks encoded on the host per (input, output) channel pair
        (encode_coeff_rows at QlP), multiplied into the rotations with
        eval_mult_ext; a fully pruned output channel is an explicit zero."""
        ctx = self.ctx
        in_ch, out_ch = weight.shape[2], weight.shape[3]
        level = ctx.level(ci)
        mask_bytes = (level.size + ctx.params.size_P) * ctx.n * (4 if ctx.is_q32 else 8)
        cacheable = (cache_key is not None
                     and int(np.count_nonzero(weight)) * mask_bytes <= CONV_CACHE_BYTES)
        pts_key = ("pts", cache_key, ci, float(scale), t.width, t.slotstr) if cacheable \
            else None
        cached = None if pts_key is None else self._pt_cache.get(pts_key)
        tap_of = {tap: idx for idx, tap in enumerate(taps)}

        acc: list[Ciphertext | None] = [None] * out_ch
        for k in range(in_ch):
            rot = unstack_cts(rotations(cts[k]), len(taps))
            for h in range(out_ch):
                live = [(i, j) for (i, j) in taps if float(weight[i, j, k, h]) != 0.0]
                if not live:
                    continue
                if cached is not None:
                    pts = [cached[(i, j, k, h)] for (i, j) in live]
                else:
                    rows = (self._mask_embedding(t.width, t.slotstr, kh, i, j)
                            * float(weight[i, j, k, h]) for (i, j) in live)
                    pts = self.encoder.encode_coeff_rows(rows, scale, ci, ext=True)
                    if pts_key is not None:
                        store = self._pt_cache.setdefault(pts_key, {})
                        for (i, j), pt in zip(live, pts):
                            store[(i, j, k, h)] = pt
                term = None
                for tap, pt in zip(live, pts):
                    m = hoist.eval_mult_ext(ctx, rot[tap_of[tap]], pt)
                    term = m if term is None else hoist.eval_add_ext(ctx, term, m)
                acc[h] = term if acc[h] is None else hoist.eval_add_ext(ctx, acc[h], term)
        templ = next((a for a in acc if a is not None), None)
        if templ is None:
            raise ValueError("conv weight tensor is identically zero")
        out = []
        for h in range(out_ch):
            a = acc[h] if acc[h] is not None else templ.with_data(torch.zeros_like(templ.data))
            acc[h] = None       # free the QlP accumulator
            out.append(hoist.keyswitch_down(ctx, a))
        return out

    def _conv_embedding_residues(self, w: int, slotstr: int, kh: int, taps, ci: int):
        """Per geometry and chain index: the masks' fixed-point embeddings
        E = rint(emb * 2^F) + 2^31 (T, N) reduced into every QlP limb, and
        (E * 2^31) mod q, each (T, QlP, N) in the context's word; None when
        an embedding leaves the fixed-point range."""
        key = ("embq", w, slotstr, kh, ci)
        if key in self._pt_cache:
            return self._pt_cache[key]
        ctx = self.ctx
        emb = np.stack([self._mask_embedding(w, slotstr, kh, i, j) for (i, j) in taps])
        got = None
        if float(np.max(np.abs(emb))) < 1.99:
            e = np.rint(emb * float(1 << CONV_FP_BITS)).astype(np.int64) + (1 << 31)
            e = torch.from_numpy(e).to(ctx.device)[:, None, :]             # [0, 2^32)
            q = ctx.level(ci).ks.qlp_mod.q.to(torch.int64)
            got = (torch.remainder(e, q).to(ctx.dtype),
                   torch.remainder(e << 31, q).to(ctx.dtype))
        self._pt_cache[key] = got
        return got

    def _conv_device_encode(self, t, cts, weight, rotations, taps, kh, scale, ci):
        """The masks built on the device from the fixed-point embeddings and
        per-(output channel, tap) weight scalars; None when a weight or an
        embedding leaves the fixed-point range (the caller then encodes on
        the host).  The output channels take the first rotated tap's
        metadata with the scale times `scale` and one more noise-scale
        degree."""
        ctx = self.ctx
        in_ch, out_ch = weight.shape[2], weight.shape[3]
        lam = np.array([[[float(weight[i, j, k, h]) for (i, j) in taps] for h in range(out_ch)]
                        for k in range(in_ch)], dtype=np.float64)          # (in, out, T)
        c_round = np.rint(lam * (scale / float(1 << CONV_FP_BITS)))
        if float(np.max(np.abs(c_round))) >= float(1 << 31):
            return None
        emb = self._conv_embedding_residues(t.width, t.slotstr, kh, taps, ci)
        if emb is None:
            return None
        e_res, e31 = emb
        # per QlP limb, with exact integers: C = c_int + 2^31 mod q and
        # D = -2^31 c_int mod q (|2^31 c_int| < 2^62), copied once per layer
        c_int = c_round.astype(np.int64)
        qlp = ctx.level(ci).ks.qlp_mod
        qs = [int(v) for v in qlp.q.reshape(-1).tolist()]
        c_res = np.empty(c_int.shape + (len(qs),), dtype=np.uint64)
        d_res = np.empty_like(c_res)
        for l, q in enumerate(qs):
            c_res[..., l] = ((c_int + (1 << 31)) % np.int64(q)).astype(np.uint64)
            d_res[..., l] = ((-(c_int << 31)) % np.int64(q)).astype(np.uint64)
        c_res = _residues(ctx, c_res)[..., None]                           # (in, out, T, QlP, 1)
        d_res = _residues(ctx, d_res)[..., None]
        ext_ntt = self.encoder._ext_tables(ci)[1]

        acc = None
        templ = None
        for k in range(in_ch):
            rot = rotations(cts[k])
            if templ is None:
                templ = unstack_cts(rot, 1)[0]
            outs = []
            for h in range(out_ch):
                r = qlp.mul(e_res, c_res[k, h])
                r = mm.add_mod(mm.sub_mod(r, e31, qlp.q), d_res[k, h], qlp.q)
                prod = qlp.mul(rot.data, forward_ntt(r, ext_ntt)[:, None])   # (T, 2, QlP, N)
                term = prod[0]
                for e in range(1, len(taps)):
                    term = mm.add_mod(term, prod[e], qlp.q)
                outs.append(term)
            outs = torch.stack(outs)
            acc = outs if acc is None else mm.add_mod(acc, outs, qlp.q)
        out = []
        for h in range(out_ch):
            ct_h = replace(templ, data=acc[h], scale=templ.scale * scale,
                           noise_scale_deg=templ.noise_scale_deg + 1)
            out.append(hoist.keyswitch_down(ctx, ct_h))
        return out

    def batch_norm(self, t: TensorCT, weight, bias, mean, var, eps: float = 1e-5) -> TensorCT:
        """The folded affine a x + b per channel: the CRT lifts of every
        channel's a and b in one copy, one modular multiply over the stacked
        channels, then b on c0."""
        ctx = self.ctx
        cts = _degree_one(ctx, t.cts)
        level = ctx.level(cts[0].chain_index)
        sf, _ = auto.scaling_factors(ctx)
        scf = sf[auto._level(cts[0], ctx)]
        qs = level.base.values
        deg_out = cts[0].noise_scale_deg + 1
        int_scf = int(round(scf))
        ac = np.zeros((len(cts), len(qs)), dtype=np.uint64)
        bc = np.zeros_like(ac)
        for c_idx in range(len(cts)):
            a = float(weight[c_idx]) / math.sqrt(float(var[c_idx]) + eps)
            b = float(bias[c_idx]) - a * float(mean[c_idx])
            big = int(round(a * scf))
            ac[c_idx] = [big % q for q in qs]
            cb = int(round(b * scf))
            for _ in range(1, deg_out):
                cb *= int_scf
            bc[c_idx] = [cb % q for q in qs]
        consts = _residues(ctx, np.stack([ac, bc]))[..., None]           # (2, ch, L, 1)
        stk = stack_cts(cts)
        data = level.mod.mul(stk.data, consts[0][:, None])
        c0 = mm.add_mod(data[:, 0], consts[1], level.mod.q)
        stk = replace(stk, data=torch.cat([c0[:, None], data[:, 1:]], dim=1),
                      noise_scale_deg=stk.noise_scale_deg + 1, scale=stk.scale * scf)
        return TensorCT(unstack_cts(stk, len(cts)), t.width, t.slotstr)

    def _each(self, t: TensorCT, fn) -> TensorCT:
        return TensorCT([fn(ct) for ct in t.cts], t.width, t.slotstr)

    def relu(self, t: TensorCT, a: float, b: float, deg: int) -> TensorCT:
        """Chebyshev approximation of max(0, x) on [a, b]."""
        coeffs = cheb.eval_chebyshev_coefficients(lambda x: max(0.0, x), a, b, deg)
        return self._map(t, lambda ct: cheb.eval_chebyshev_series(
            self.ctx, ct, self.mul_key, coeffs, a, b))

    def _sign_ct(self, ct: Ciphertext, k: int) -> Ciphertext:
        a, b = _SIGN_RANGES[k]
        return cheb.eval_chebyshev_series(self.ctx, ct, self.mul_key, _SIGN_COEFFS[k], a, b)

    def sign(self, t: TensorCT, k: int) -> TensorCT:
        """Stage k of the 3-stage minimax sign composite."""
        return self._map(t, lambda ct: self._sign_ct(ct, k))

    def _boot_one(self, bootstrapper, ct: Ciphertext, slots: int) -> Ciphertext:
        """One bootstrap of a channel or a chunk, under the 'Bootstrap' timer
        bucket."""
        with timer.section("Bootstrap"):
            return bootstrapper.eval_bootstrap(ct, slots=slots)

    def bootstrap(self, t: TensorCT, bootstrapper) -> TensorCT:
        """EvalBootstrap of every channel at (w << slotstr)^2 slots, one
        chunk at a time."""
        return self._map(t, lambda ct: self._boot_one(bootstrapper, ct, t.num_slots))

    def relu_composite(self, t: TensorCT, bootstrapper) -> TensorCT:
        """ReLU(x) = x (sign(sign(sign(0.1 x))) + 1) / 2 with a bootstrap
        after each stage: per chunk of channel_batch channels, stage 0, a
        bootstrap, stage 1, a bootstrap, stage 2 with the last multiply, a
        bootstrap; the sign stages and the last multiply under the 'Relu'
        timer bucket, each bootstrap under 'Bootstrap'.  A batch of 1 runs
        _relu_composite_seq."""
        if self.channel_batch(t.num_ch) <= 1:
            return self._relu_composite_seq(t, bootstrapper)
        ctx = self.ctx
        slots = t.num_slots

        def chunk(x: Ciphertext) -> Ciphertext:
            with timer.section("Relu"):
                s = self._sign_ct(auto.mult_const(ctx, x, 0.1), 0)
            s = self._boot_one(bootstrapper, s, slots)
            with timer.section("Relu"):
                s = self._sign_ct(s, 1)
            s = self._boot_one(bootstrapper, s, slots)
            with timer.section("Relu"):
                s = self._sign_ct(s, 2)
                s = auto.eval_mult_auto(ctx, auto.add_const(ctx, s, 1.0),
                                        auto.mult_const(ctx, x, 0.5), self.mul_key)
            return self._boot_one(bootstrapper, s, slots)

        return self._map(t, chunk)

    def _relu_composite_seq(self, t: TensorCT, bootstrapper) -> TensorCT:
        """The composite ReLU channel by channel, each stage over every
        channel before the next (batching disabled)."""
        ctx = self.ctx
        with timer.section("Relu"):
            s = self.sign(self._each(t, lambda ct: auto.mult_const(ctx, ct, 0.1)), 0)
        s = self.bootstrap(s, bootstrapper)
        with timer.section("Relu"):
            s = self.sign(s, 1)
        s = self.bootstrap(s, bootstrapper)
        with timer.section("Relu"):
            s = self.sign(s, 2)
            out = [auto.eval_mult_auto(ctx, auto.add_const(ctx, si, 1.0),
                                       auto.mult_const(ctx, xi, 0.5), self.mul_key)
                   for si, xi in zip(s.cts, t.cts)]
        return self.bootstrap(TensorCT(out, t.width, t.slotstr), bootstrapper)

    def softmax(self, t: TensorCT, bound_b: int = 64, bound_r: int = 64,
                gumbel_lambda: int = 4, goldschmidt_d: int = 4) -> TensorCT:
        """Gumbel softmax: exp by a Chebyshev series and repeated squaring,
        1 / the channel sum by Goldschmidt's iteration."""
        ctx = self.ctx
        rlk = self.mul_key
        coeffs = cheb.eval_chebyshev_coefficients(math.exp, -1.0, 1.0, 12)
        squarings = int(math.log2(bound_b)) - int(math.log2(gumbel_lambda))

        def exp(ct):
            x = auto.mult_const(ctx, ct, 1.0 / bound_b)
            x = cheb.eval_chebyshev_series(ctx, x, rlk, coeffs, -1.0, 1.0)
            for _ in range(squarings):
                x = auto.eval_square_auto(ctx, x, rlk)
            return x

        exp_t = self._each(t, exp)
        stk = stack_cts(exp_t.cts)
        q = ctx.level(stk.chain_index).mod.q
        total = stk.data[0]
        for i in range(1, t.num_ch):
            total = mm.add_mod(total, stk.data[i], q)
        s = exp_t.cts[0].with_data(total)
        s = auto.add_const(ctx, auto.mult_const(ctx, s, -1.0 / bound_r), 2.0)
        tmp = auto.add_const(ctx, s, -1.0)
        for _ in range(goldschmidt_d):
            tmp = auto.eval_square_auto(ctx, tmp, rlk)
            s = auto.eval_mult_auto(ctx, s, auto.add_const(ctx, tmp, 1.0), rlk)
        return self._each(exp_t, lambda ct: auto.eval_mult_auto(ctx, ct, s, rlk))

    def avg_pool_full_con(self, t: TensorCT, weight: np.ndarray,
                          bias: np.ndarray) -> TensorCT:
        """The log-rotation sum of each channel's image (it lands in slot 0,
        not averaged, as in the reference; the steps of
        avgpool_rotation_indices), then the fully connected layer, weight
        (T, channels), as a modular matvec over the stacked channels with
        the weights' and biases' CRT lifts copied once, one class at a
        time."""
        ctx = self.ctx
        T, tc = weight.shape
        if tc != t.num_ch:
            raise ValueError("fully connected weight does not match the channels")
        steps = self.avgpool_rotation_indices(t.width, t.slotstr)
        keys = {}
        for s_ in steps:
            elt = galois_elt_from_step(s_, ctx.n)
            keys[elt] = self.gk.key_for_elt(elt)
        cts = _degree_one(ctx, t.cts)

        def pool(ct):
            acc = ct
            for s_ in steps:
                elt = galois_elt_from_step(s_, ctx.n)
                acc = auto.eval_add_auto(ctx, apply_galois_with_key(ctx, acc, elt, keys[elt]),
                                         acc)
            return acc

        summed = stack_cts([pool(ct) for ct in cts])
        level = ctx.level(cts[0].chain_index)
        sf, _ = auto.scaling_factors(ctx)
        scf = sf[auto._level(cts[0], ctx)]
        qs = level.base.values
        wc = np.zeros((T, tc, len(qs)), dtype=np.uint64)
        for u in range(T):
            for k in range(tc):
                big = int(round(float(weight[u, k]) * scf))
                wc[u, k] = [big % q for q in qs]
        deg_out = cts[0].noise_scale_deg + 1
        int_scf = int(round(scf))
        bc = np.zeros((T, len(qs)), dtype=np.uint64)
        for u in range(T):
            cb = int(round(float(bias[u]) * scf))
            for _ in range(1, deg_out):
                cb *= int_scf
            bc[u] = [cb % q for q in qs]
        wc = _residues(ctx, wc)[:, :, None, :, None]                      # (T, tc, 1, L, 1)
        bc = _residues(ctx, bc)[..., None]                                # (T, L, 1)
        q = level.mod.q
        # one class at a time: on a q32 context mul_mod_q32 holds up to seven
        # int64 arrays of the product's shape at once (the product, its low
        # and high words, s0 and three temporaries of s1), so all classes at
        # once would take 7 * T * tc * 2 * L * N * 8 bytes: 114 GiB at
        # ResNet-20's 10 x 64 x 2 x 26 x 2^16, more than an 80-GB card holds
        rows = []
        for u in range(T):
            prod = level.mod.mul(summed.data, wc[u])
            row = prod[0]
            for k in range(1, tc):
                row = mm.add_mod(row, prod[k], q)
            rows.append(row)
        del prod
        acc = torch.stack(rows)                                          # (T, 2, L, N)
        c0 = mm.add_mod(acc[:, 0], bc, q)
        out = replace(summed, data=torch.cat([c0[:, None], acc[:, 1:]], dim=1),
                      noise_scale_deg=summed.noise_scale_deg + 1, scale=summed.scale * scf)
        return TensorCT(unstack_cts(out, T), t.width, t.slotstr)

    def add(self, a: TensorCT, b: TensorCT) -> TensorCT:
        """The residual add, one chunk at a time (eval_add_auto's level and
        depth adjustment branches on metadata, which a chunk shares)."""
        if (a.num_ch, a.width, a.slotstr) != (b.num_ch, b.width, b.slotstr):
            raise ValueError("TensorCT dimension mismatch in add")
        return TensorCT(self._map_cts(lambda x, y: auto.eval_add_auto(self.ctx, x, y),
                                      a.cts, b.cts), a.width, a.slotstr)
