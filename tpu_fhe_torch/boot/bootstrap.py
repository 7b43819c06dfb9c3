"""CKKS bootstrapping (OpenFHE FLEXIBLEAUTO semantics) on the port.

Port of ``tpu_fhe/boot/bootstrap.py`` on both plans (the u64 plan and the
q32 plan of composite scaling):

  setup      -- correction factor, collapsed-FFT parameters, the C2S/S2C
                plaintexts at the extended basis QlP (boot_math, then the
                encoder's ``encode_ext_batch``);
  keygen     -- fused Galois keys for every BSGS rotation and conjugation,
                and the relin key;
  bootstrap  -- prelude (ModReduce, AdjustCiphertext, RaiseMod, the
                pre-scale) -> CoeffsToSlots (hoisted BSGS levels) -> the
                conjugate split (or, sparse, the partial sum before and the
                fold after) -> EvalMod (Chebyshev sine, ModReduce, double
                angles) -> recombine -> SlotsToCoeffs -> the correction
                multiply; Meta-BTS runs it twice.

Each stage of ``eval_bootstrap`` is a method of its own, so that a caller
can time them one by one.  The data work runs through ``eval/auto.py``,
``eval/hoisting.py`` and the evaluator, so on a CUDA context the NTTs,
base conversions and inner products are the port's kernels and the glue
is plain torch.  The reference's stage and glue jits, its per-stage
completion barriers, its q32 compaction wrappers and its ``TPU_FHE_BOOT_*``
switches have no counterpart here: they served a TPU's compiler and
memory, not the computation.  Every stage takes a batch of ciphertexts
stacked with ``stack_cts`` ((B, 2, L, N)) as well as one, so one launch of
each kernel serves the batch; Meta-BTS over a batch runs the channels one at
a time and restacks them, as the reference does.

The sine's Chebyshev coefficients are generated, not tabulated: the
reference tables are the Chebyshev interpolation of
(2 pi)^(-1/2^r) cos(2 pi / 2^r (K x - 1/4)) on [-1, 1].
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..eval import auto, chebyshev as cheb, evaluator as ev, hoisting as hst
from ..ops import modarith as mm
from ..ops.galois import apply_galois_ntt, conj_elt, galois_elt_from_step
from ..scheme.ciphertext import Ciphertext, Plaintext, stack_cts, unstack_cts
from ..scheme.context import FheContext
from ..scheme.keys import GaloisKey, RelinKey, SecretKey
from . import boot_math as bm

K_SPARSE = 28
K_UNIFORM = 512
R_SPARSE = 3
R_UNIFORM = 6
# the memory budget keygen's key-form rule assumes without a CUDA device
CPU_BUDGET_BYTES = 15 * 2**30
ENCODE_CHUNK = 16          # plaintexts per encode_ext_batch call in setup


def gen_sine_coefficients(k: float, r: int, degree: int) -> list[float]:
    """Chebyshev coefficients of (2pi)^(-1/2^r) cos(2pi/2^r (k x - 1/4))."""
    scale = (2 * math.pi) ** (-1.0 / (1 << r))

    def f(x):
        return scale * math.cos(2 * math.pi / (1 << r) * (k * x - 0.25))

    return cheb.eval_chebyshev_coefficients(f, -1.0, 1.0, degree)


def precision_bits(result, expected) -> float:
    """Mean -log2 |error| of decoded values against the expected ones (an
    exact value counts as 1e-30 off), the bootstrap's precision measure."""
    err = np.abs(np.asarray(result) - np.asarray(expected))
    err = np.where(err == 0, 1e-30, err)
    return float(np.mean(-np.log2(err)))


def double_angle_constant(j: int, r: int) -> float:
    """The constant of double angle j of r: y <- 2 y^2 - (2 pi)^(-2^(j - r))."""
    return -1.0 / math.pow(2.0 * math.pi, math.pow(2.0, j - r))


def apply_double_angle(ctx: FheContext, ct: Ciphertext, r: int, rlk: RelinKey) -> Ciphertext:
    """r double angles y <- 2 y^2 + double_angle_constant(j, r)."""
    for j in range(1, r + 1):
        ct = auto.eval_square_auto(ctx, ct, rlk)
        ct = auto.eval_add_auto(ctx, ct, ct)
        ct = auto.add_const(ctx, ct, double_angle_constant(j, r))
    return ct


def eval_mod(ctx: FheContext, ct: Ciphertext, rlk: RelinKey, coefficients: list[float],
             r: int, step=None) -> Ciphertext:
    """The bootstrap's approximate modular reduction: the Chebyshev series on
    [-1, 1], one ModReduce, then r double angles.  `step(name)`, when given,
    is called after each of the three."""
    step = step or (lambda name: None)
    out = cheb.eval_chebyshev_series(ctx, ct, rlk, coefficients, -1.0, 1.0)
    step("Chebyshev series")
    out = auto.mod_reduce(ctx, out, 1)
    step("mod_reduce")
    out = apply_double_angle(ctx, out, r, rlk)
    step("double angle")
    return out


@dataclass
class BootPrecom:
    slots: int
    params_enc: list[int]
    params_dec: list[int]
    a_c2s: list[list[Plaintext | None]] | None = None
    a_s2c: list[list[Plaintext | None]] | None = None


class CkksBootstrapper:
    def __init__(self, ctx: FheContext, encoder):
        self.ctx = ctx
        self.encoder = encoder
        self.precom: dict[int, BootPrecom] = {}
        self.galois_keys: GaloisKey | None = None
        self.mul_key: RelinKey | None = None
        self.key_shoup: bool | None = None    # keygen's choice of Galois-key form
        self.correction_factor = 0
        # dense ternary secret default (the reference's uniform case)
        self.k_bound = K_UNIFORM
        self.r_iters = R_UNIFORM
        self.poly_degree_sine = 88

    # ------------------------------------------------------------------
    def sine_coefficients(self) -> list[float]:
        return gen_sine_coefficients(self.k_bound, self.r_iters, self.poly_degree_sine)

    def get_bootstrap_depth(self, level_budget: tuple[int, int]) -> int:
        approx = cheb.get_mult_depth_by_coeff_vector(self.sine_coefficients(),
                                                     normalized=False)
        return approx + self.r_iters + level_budget[0] + level_budget[1]

    def set_sine_params(self, k: float, r: int, degree: int):
        """Override the sine approximation (e.g. the sparse-secret set K = 28,
        r = 3, degree 44)."""
        self.k_bound = k
        self.r_iters = r
        self.poly_degree_sine = degree

    # ------------------------------------------------------------------
    def setup(self, level_budget: tuple[int, int] = (2, 2), dim1: tuple[int, int] = (0, 0),
              slots: int = 0, correction_factor: int = 0, precompute: bool = True,
              c2s_stage: int | None = None):
        """The transforms' plans and plaintexts for `slots`.  With
        c2s_stage given, only the plaintexts of that hoisted C2S level
        (``c2s_stage_plans(slots)[c2s_stage]``) are made, the same as the
        whole setup's, and none of S2C's: enough to run that one level."""
        ctx = self.ctx
        n = ctx.n
        M = 2 * n
        slots = slots or n // 2
        if correction_factor == 0:
            tmp = round(-0.265 * (2 * math.log2(M / 2) + math.log2(slots)) + 19.1)
            self.correction_factor = min(13, max(7, int(tmp)))
        else:
            self.correction_factor = correction_factor

        log_slots = max(1, int(math.log2(slots)))
        budget = [min(max(level_budget[0], 1), log_slots),
                  min(max(level_budget[1], 1), log_slots)]
        pre = BootPrecom(
            slots=slots,
            params_enc=bm.get_collapsed_fft_params(slots, budget[0], dim1[0]),
            params_dec=bm.get_collapsed_fft_params(slots, budget[1], dim1[1]),
        )
        self.precom[slots] = pre
        if not precompute:
            return

        m = 4 * slots
        sparse = m != M
        rot_group = np.empty(slots, dtype=np.int64)
        five = 1
        for i in range(slots):
            rot_group[i] = five
            five = (five * 5) % m
        ksi = np.exp(2j * math.pi * np.arange(m + 1) / m)
        ksi[m] = ksi[0]

        # The sine's argument must advance by exactly 1 per q0 overflow: the
        # net factor through the prelude and C2S is (q0 2^-deg / sf[0])
        # scale_enc, so scale_enc = sf[0] 2^deg / q0 exactly (folding
        # q0 / 2^round(log2 q0) instead equals it only for primes near powers
        # of two, not for the composite chain's prime products).
        q0 = self._anchor_product()
        sf_ladder, _ = auto.scaling_factors(ctx)
        pow_p = 2.0 ** round(math.log2(sf_ladder[0]))
        deg_pow = round(math.log2(q0 / pow_p))
        scale_enc = sf_ladder[0] * (2.0 ** deg_pow) / q0
        scale_dec = 1.0 / scale_enc

        depth_bt = self.get_bootstrap_depth((budget[0], budget[1]))
        # one BSGS level consumes one logical level (composite_degree limbs)
        L0 = ctx.params.size_Q // auto.composite_degree(ctx)
        l_enc = L0 - budget[0] - 1
        l_dec = L0 - depth_bt

        only = None if c2s_stage is None else self.c2s_stage_plans(slots)[c2s_stage][0]
        pre.a_c2s = self._coeffs_to_slots_precompute(pre, ksi, rot_group, False, scale_enc,
                                                     l_enc, sparse, only)
        if c2s_stage is None:
            pre.a_s2c = self._slots_to_coeffs_precompute(pre, ksi, rot_group, False, scale_dec,
                                                         l_dec, sparse)

    # ------------------------------------------------------------------
    def _anchor_product(self) -> float:
        """q0 generalized to composite scaling: the product of the anchor
        logical level's primes."""
        prod = 1.0
        for v in self.ctx.q_values[:auto.composite_degree(self.ctx)]:
            prod *= float(v)
        return prod

    def _encode_ext_many(self, entries, scale_val, chain_index):
        """encode_ext of [(index, vector)] in chunks of ENCODE_CHUNK vectors
        (one host-to-device copy and one batched NTT each)."""
        out = []
        for c0 in range(0, len(entries), ENCODE_CHUNK):
            chunk = entries[c0:c0 + ENCODE_CHUNK]
            pts = self.encoder.encode_ext_batch([v for _, v in chunk], scale_val, chain_index)
            out.extend(zip((i for i, _ in chunk), pts))
        return out

    def _collapse(self, pre: BootPrecom, encode: bool, ksi, rot_group, flag_i, sparse):
        """The level budget's collapsed coefficient vectors and a picker of
        (stage, index): on the sparse path each vector is followed by its
        i-multiplied twin, so that re and im share one real branch."""
        p = pre.params_enc if encode else pre.params_dec
        collapse = bm.coeff_encoding_collapse if encode else bm.coeff_decoding_collapse
        coeff = collapse(ksi, rot_group, p[bm.LEVEL_BUDGET], flag_i)
        coeff_i = collapse(ksi, rot_group, p[bm.LEVEL_BUDGET], True) if sparse else None

        def pick(s, idx):
            if sparse:
                return np.concatenate([coeff[s][idx], coeff_i[s][idx]])
            return coeff[s][idx]
        return p, pick

    def _coeffs_to_slots_precompute(self, pre: BootPrecom, ksi, rot_group, flag_i, scale, L,
                                    sparse=False, only: int | None = None):
        """EvalCoeffsToSlotsPrecompute; on the sparse path rotations are
        reduced mod N/2 and each plaintext holds 2 * slots values.  With
        `only`, the plaintexts of that level (its a_index) alone."""
        ctx = self.ctx
        sf, _ = auto.scaling_factors(ctx)
        p, pick = self._collapse(pre, True, ksi, rot_group, flag_i, sparse)
        level_budget, layers, rem = p[bm.LEVEL_BUDGET], p[bm.LAYERS_COLL], p[bm.LAYERS_REM]
        num_rot, b, g = p[bm.NUM_ROTATIONS], p[bm.BABY_STEP], p[bm.GIANT_STEP]
        num_rot_rem, b_rem, g_rem = (p[bm.NUM_ROTATIONS_REM], p[bm.BABY_STEP_REM],
                                     p[bm.GIANT_STEP_REM])
        stop = 0 if rem else -1
        flag_rem = 1 if rem else 0

        d = auto.composite_degree(ctx)
        towers_to_drop = 0      # logical levels below the full chain
        chain_idx = 1
        if L != 0:
            towers_to_drop = ctx.params.size_Q // d - L - level_budget
        chain_idx += towers_to_drop * d
        level0 = towers_to_drop + level_budget - 1

        chain_vector = [0] * (level_budget - stop)
        ci = chain_idx
        for s in range(level_budget - 1, stop - 1, -1):
            chain_vector[s - stop] = ci
            ci += d
        rot_mod = (2 * ctx.n) // 4 if sparse else pre.slots

        result: list[list[Plaintext | None]] = [
            [None] * (num_rot_rem if (flag_rem and i == 0) else num_rot)
            for i in range(level_budget)]
        for s in range(level_budget - 1, stop, -1):
            if only is not None and s != only:
                continue
            entries = []
            for i in range(b):
                for j in range(g):
                    if g * i + j != num_rot:
                        rot = bm.reduce_rotation(
                            -g * i * (1 << ((s - flag_rem) * layers + rem)), rot_mod)
                        vec = pick(s, g * i + j)
                        if flag_rem == 0 and s == stop + 1:
                            vec = vec * scale
                        entries.append((g * i + j, bm.rotate_vec(vec, rot)))
            for idx, pt in self._encode_ext_many(entries, sf[level0 - s],
                                                 chain_vector[s - stop]):
                result[s][idx] = pt
        if flag_rem and only in (None, stop):
            entries = []
            for i in range(b_rem):
                for j in range(g_rem):
                    if g_rem * i + j != num_rot_rem:
                        rot = bm.reduce_rotation(-g_rem * i, rot_mod)
                        vec = pick(stop, g_rem * i + j) * scale
                        entries.append((g_rem * i + j, bm.rotate_vec(vec, rot)))
            for idx, pt in self._encode_ext_many(entries, sf[level0], chain_vector[0]):
                result[stop][idx] = pt
        return result

    def _slots_to_coeffs_precompute(self, pre: BootPrecom, ksi, rot_group, flag_i, scale, L,
                                    sparse=False):
        """EvalSlotsToCoeffsPrecompute; the sparse path as for C2S."""
        ctx = self.ctx
        sf, _ = auto.scaling_factors(ctx)
        p, pick = self._collapse(pre, False, ksi, rot_group, flag_i, sparse)
        level_budget, layers, rem = p[bm.LEVEL_BUDGET], p[bm.LAYERS_COLL], p[bm.LAYERS_REM]
        num_rot, b, g = p[bm.NUM_ROTATIONS], p[bm.BABY_STEP], p[bm.GIANT_STEP]
        num_rot_rem, b_rem, g_rem = (p[bm.NUM_ROTATIONS_REM], p[bm.BABY_STEP_REM],
                                     p[bm.GIANT_STEP_REM])
        flag_rem = 1 if rem else 0

        d = auto.composite_degree(ctx)
        towers_to_drop = 0      # logical levels below the full chain
        chain_idx = 1
        if L != 0:
            towers_to_drop = ctx.params.size_Q // d - L - level_budget
        chain_idx += towers_to_drop * d
        level0 = towers_to_drop
        chain_vector = [chain_idx + d * s for s in range(level_budget - flag_rem + 1)]
        rot_mod = (2 * ctx.n) // 4 if sparse else pre.slots

        result: list[list[Plaintext | None]] = [
            [None] * (num_rot_rem if (flag_rem and i == level_budget - 1) else num_rot)
            for i in range(level_budget)]
        for s in range(level_budget - flag_rem):
            entries = []
            for i in range(b):
                for j in range(g):
                    if g * i + j != num_rot:
                        rot = bm.reduce_rotation(-g * i * (1 << (s * layers)), rot_mod)
                        vec = pick(s, g * i + j)
                        if flag_rem == 0 and s == level_budget - flag_rem - 1:
                            vec = vec * scale
                        entries.append((g * i + j, bm.rotate_vec(vec, rot)))
            for idx, pt in self._encode_ext_many(entries, sf[level0 + s], chain_vector[s]):
                result[s][idx] = pt
        if flag_rem:
            s = level_budget - flag_rem
            for i in range(b_rem):
                for j in range(g_rem):
                    if g_rem * i + j != num_rot_rem:
                        rot = bm.reduce_rotation(-g_rem * i * (1 << (s * layers)), rot_mod)
                        vec = pick(s, g_rem * i + j) * scale
                        result[s][g_rem * i + j] = self.encoder.encode_ext(
                            bm.rotate_vec(vec, rot), sf[level0 + s],
                            chain_index=chain_vector[s])
        return result

    # ------------------------------------------------------------------
    def find_rotation_indices(self, slots: int) -> list[int]:
        """FindBootstrapRotationIndices."""
        M = 2 * self.ctx.n
        out = self._fft_rotation_indices(slots, encode=True)
        out += self._fft_rotation_indices(slots, encode=False)
        out = sorted(set(out))
        return [v for v in out if v != 0 and v != M // 4]

    def _fft_rotation_indices(self, slots: int, encode: bool) -> list[int]:
        M = 2 * self.ctx.n
        plans = self.c2s_stage_plans(slots) if encode else self.s2c_stage_plans(slots)
        out = []
        for (_, rot_in, rot_out, _, _, _, _) in plans:
            out += list(rot_in) + list(rot_out)
        if slots * 4 != M:
            j = 1
            while j < M // (slots * 4):
                out.append(j * slots)
                j <<= 1
        return out

    def _key_bytes(self, steps: list[int]) -> int:
        """The reference's estimate of the resident Galois and relin keys
        without Shoup words: (distinct automorphisms + conjugation + relin)
        keys of dnum digits x 2 components x size_QP limbs of N words of 4
        bytes."""
        ctx = self.ctx
        dnum = ctx.level(1).ks.beta
        elts = {galois_elt_from_step(s, ctx.n) for s in steps if s % (ctx.n // 2) != 0}
        return (len(elts) + 2) * dnum * 2 * ctx.key_level.size * ctx.n * 4

    def memory_budget(self) -> int:
        """The device's memory (its total on a CUDA device; CPU_BUDGET_BYTES
        on the CPU)."""
        dev = self.ctx.device
        if dev.type == "cuda":
            return torch.cuda.get_device_properties(dev).total_memory
        return CPU_BUDGET_BYTES

    def keygen(self, sk: SecretKey, slots: int = 0):
        """EvalBootstrapKeyGen + EvalMultKeyGen.  Galois keys carry Shoup
        words on a q32 context while twice the key estimate fits 40% of the
        device's memory (so the inner product is K10, else K9), never on the
        u64 plan (K7); ``key_shoup`` records the choice."""
        ctx = self.ctx
        slots = slots or ctx.n // 2
        steps = self.find_rotation_indices(slots)
        self.key_shoup = bool(ctx.is_q32 and
                              2 * self._key_bytes(steps) <= int(0.4 * self.memory_budget()))
        self.galois_keys = sk.galois_key(steps, include_conj=True, shoup=self.key_shoup)
        self.mul_key = sk.relin_key()

    # ------------------------------------------------------------------
    def adjust_ciphertext(self, ct: Ciphertext, correction: float) -> Ciphertext:
        """AdjustCiphertext: scale to sf[0] 2^-correction and ModReduce."""
        ctx = self.ctx
        sf, _ = auto.scaling_factors(ctx)
        target_sf = sf[0]
        source_sf = ct.scale
        mod_to_drop = auto.level_group_product(ctx, ctx.level(ct.chain_index).size)
        adjustment = ((target_sf / source_sf) * (mod_to_drop / source_sf)
                      * math.pow(2.0, -correction))
        ct = auto.mult_const(ctx, ct, adjustment)
        ct = auto.mod_reduce(ctx, ct, 1)
        return replace(ct, scale=target_sf)

    def apply_double_angle(self, ct: Ciphertext, num_iter: int,
                           mul_key: RelinKey | None = None) -> Ciphertext:
        return apply_double_angle(self.ctx, ct, num_iter,
                                  mul_key if mul_key is not None else self.mul_key)

    # ------------------------------------------------------------------
    def _keys_for(self, rot_in, rot_out) -> dict[int, RelinKey]:
        """The Galois keys one BSGS level (or partial sum) needs, by element."""
        n = self.ctx.n
        keys: dict[int, RelinKey] = {}
        for step in list(rot_in) + list(rot_out):
            if step != 0:
                elt = galois_elt_from_step(step, n)
                keys[elt] = self.galois_keys.key_for_elt(elt)
        return keys

    def _bsgs_level(self, result: Ciphertext, A_level: list[Plaintext | None],
                    keys: dict[int, RelinKey], rot_in: tuple[int, ...],
                    rot_out: tuple[int, ...], b: int, g: int, num_rot: int) -> Ciphertext:
        """One hoisted BSGS level (the loop body shared by CoeffsToSlots and
        SlotsToCoeffs): g baby-step rotations from one modup, b giant-step
        inner sums at QlP, each giant step rotated after a moddown, one
        moddown at the end.  Every step builds new tensors."""
        ctx = self.ctx
        n = ctx.n
        digits = hst.fast_rotation_precompute(ctx, result)
        fast_rot: list[Ciphertext] = []
        for j in range(g):
            if rot_in[j] != 0:
                elt = galois_elt_from_step(rot_in[j], n)
                fast_rot.append(hst.fast_rotation_ext(ctx, result, digits, elt, keys[elt], True))
            else:
                fast_rot.append(hst.keyswitch_ext(ctx, result))

        level = ctx.level(result.chain_index)
        q, q_ext = level.mod.q, level.ks.qlp_mod.q
        first = None    # c0 of the sum at Ql, as a (..., Ql, N) tensor
        outer = None
        for i in range(b):
            G = g * i
            inner = hst.eval_mult_ext(ctx, fast_rot[0], A_level[G])
            for j in range(1, g):
                if (G + j) != num_rot:
                    inner = hst.eval_add_ext(
                        ctx, inner, hst.eval_mult_ext(ctx, fast_rot[j], A_level[G + j]))
            if i == 0:
                first = hst.keyswitch_down_first(ctx, inner).data[..., 0, :, :]
                outer = hst.reset_poly_ext(ctx, inner, 0)
            elif rot_out[i] != 0:
                elt = galois_elt_from_step(rot_out[i], n)
                inner_dn = hst.keyswitch_down(ctx, inner)
                first = mm.add_mod(first, apply_galois_ntt(inner_dn.data[..., 0, :, :], elt, n),
                                   q)
                inner_digits = hst.fast_rotation_precompute(ctx, inner_dn)
                outer = hst.eval_add_ext(
                    ctx, outer,
                    hst.fast_rotation_ext(ctx, inner_dn, inner_digits, elt, keys[elt], False))
            else:
                down = hst.keyswitch_down_first(ctx, inner).data[..., 0, :, :]
                first = mm.add_mod(first, down, q)
                # only c1 is added at the extended basis
                c1 = mm.add_mod(outer.data[..., 1, :, :], inner.data[..., 1, :, :], q_ext)
                outer = outer.with_data(torch.stack([outer.data[..., 0, :, :], c1], dim=-3))
        res = hst.keyswitch_down(ctx, outer)
        return ev.with_c0(res, mm.add_mod(res.data[..., 0, :, :], first, q))

    def c2s_stage_plans(self, slots: int) -> list[tuple]:
        """The rotation plans of the hoisted C2S levels, in execution order:
        [(a_index, rot_in, rot_out, b, g, num_rot, modred_first), ...], where
        modred_first says a ModReduce precedes the level."""
        M = 2 * self.ctx.n
        p = self.precom[slots].params_enc
        level_budget = p[bm.LEVEL_BUDGET]
        layers, rem = p[bm.LAYERS_COLL], p[bm.LAYERS_REM]
        num_rot, b, g = p[bm.NUM_ROTATIONS], p[bm.BABY_STEP], p[bm.GIANT_STEP]
        num_rot_rem, b_rem, g_rem = (p[bm.NUM_ROTATIONS_REM], p[bm.BABY_STEP_REM],
                                     p[bm.GIANT_STEP_REM])
        flag_rem = 1 if rem else 0
        stop = 0 if rem else -1
        plans = []
        for si in range(level_budget - 1, stop, -1):
            stride = 1 << ((si - flag_rem) * layers + rem)
            rot_in = tuple(bm.reduce_rotation((j - (num_rot + 1) // 2 + 1) * stride, slots)
                           for j in range(g))
            rot_out = tuple(bm.reduce_rotation((g * i) * stride, M // 4) for i in range(b))
            plans.append((si, rot_in, rot_out, b, g, num_rot, si != level_budget - 1))
        if flag_rem:
            rot_in = tuple(bm.reduce_rotation(j - (num_rot_rem + 1) // 2 + 1, slots)
                           for j in range(g_rem))
            rot_out = tuple(bm.reduce_rotation(g_rem * i, M // 4) for i in range(b_rem))
            plans.append((stop, rot_in, rot_out, b_rem, g_rem, num_rot_rem, True))
        return plans

    def s2c_stage_plans(self, slots: int) -> list[tuple]:
        """The rotation plans of the S2C levels (see c2s_stage_plans)."""
        M = 2 * self.ctx.n
        p = self.precom[slots].params_dec
        level_budget = p[bm.LEVEL_BUDGET]
        layers, rem = p[bm.LAYERS_COLL], p[bm.LAYERS_REM]
        num_rot, b, g = p[bm.NUM_ROTATIONS], p[bm.BABY_STEP], p[bm.GIANT_STEP]
        num_rot_rem, b_rem, g_rem = (p[bm.NUM_ROTATIONS_REM], p[bm.BABY_STEP_REM],
                                     p[bm.GIANT_STEP_REM])
        flag_rem = 1 if rem else 0
        plans = []
        for si in range(level_budget - flag_rem):
            stride = 1 << (si * layers)
            rot_in = tuple(bm.reduce_rotation((j - (num_rot + 1) // 2 + 1) * stride, M // 4)
                           for j in range(g))
            rot_out = tuple(bm.reduce_rotation((g * i) * stride, M // 4) for i in range(b))
            plans.append((si, rot_in, rot_out, b, g, num_rot, si != 0))
        if flag_rem:
            si = level_budget - flag_rem
            stride = 1 << (si * layers)
            rot_in = tuple(bm.reduce_rotation((j - (num_rot_rem + 1) // 2 + 1) * stride,
                                              M // 4) for j in range(g_rem))
            rot_out = tuple(bm.reduce_rotation((g_rem * i) * stride, M // 4)
                            for i in range(b_rem))
            plans.append((si, rot_in, rot_out, b_rem, g_rem, num_rot_rem, True))
        return plans

    def _linear_transform(self, ct: Ciphertext, plans, plaintexts) -> Ciphertext:
        for (si, rot_in, rot_out, b, g, num_rot, modred) in plans:
            if modred:
                ct = auto.mod_reduce(self.ctx, ct, 1)
            ct = self._bsgs_level(ct, plaintexts[si], self._keys_for(rot_in, rot_out),
                                  rot_in, rot_out, b, g, num_rot)
        return ct

    def coeffs_to_slots(self, ct: Ciphertext, slots: int) -> Ciphertext:
        return self._linear_transform(ct, self.c2s_stage_plans(slots), self.precom[slots].a_c2s)

    def slots_to_coeffs(self, ct: Ciphertext, slots: int) -> Ciphertext:
        return self._linear_transform(ct, self.s2c_stage_plans(slots), self.precom[slots].a_s2c)

    # -- the stages of eval_bootstrap, in order ----------------------------
    def _correction(self) -> tuple[int, float]:
        """(correction, 2^deg) with deg = log2(q0 / 2^round(log2 sf[0])): the
        reference's 2^59 generalized to the working scale."""
        q0 = self._anchor_product()
        sf0, _ = auto.scaling_factors(self.ctx)
        deg = round(math.log2(q0 / 2.0 ** round(math.log2(sf0[0]))))
        if deg > self.correction_factor:
            raise ValueError(f"log2(q0/2^59) = {deg} must be <= correction factor "
                             f"{self.correction_factor}")
        return self.correction_factor - deg, 2.0 ** deg

    def prelude(self, ct: Ciphertext, slots: int) -> Ciphertext:
        """ModReduce to noise degree 1, AdjustCiphertext, (composite chain)
        the drop to the anchor group, RaiseMod, the pre-scale by
        2^-deg / (K N), and on full packing one more ModReduce."""
        ctx = self.ctx
        correction, post = self._correction()
        r = auto.mod_reduce(ctx, ct, ct.noise_scale_deg - 1) if ct.noise_scale_deg > 1 else ct
        r = self.adjust_ciphertext(r, correction)
        d = auto.composite_degree(ctx)
        if d > 1:
            # composite RaiseMod composes the anchor group: drop to it first
            while ctx.level(r.chain_index).size > d:
                r = ev.mod_drop_to_next(ctx, r)
        r = auto.raise_mod(ctx, r)
        r = auto.mult_const(ctx, r, (1.0 / post) * (1.0 / (self.k_bound * ctx.n)))
        if slots == ctx.n // 2:
            r = auto.mod_reduce(ctx, r, 1)
        return r

    def partial_sum(self, ct: Ciphertext, slots: int) -> Ciphertext:
        """Sparse packing: project onto the sub-ring (the raise broke the
        stride-replicated structure) by rotations of slots, 2 slots, ...
        below N/2, then ModReduce."""
        ctx = self.ctx
        steps = []
        j = 1
        while j < ctx.n // (2 * slots):
            steps.append(j * slots)
            j <<= 1
        keys = self._keys_for(steps, [])
        for step in steps:
            elt = galois_elt_from_step(step, ctx.n)
            ct = auto.eval_add_auto(ctx, ct, ev.apply_galois_with_key(ctx, ct, elt, keys[elt]))
        return auto.mod_reduce(ctx, ct, 1)

    def _conjugate(self, ct: Ciphertext) -> Ciphertext:
        elt = conj_elt(self.ctx.n)
        return ev.apply_galois_with_key(self.ctx, ct, elt, self.galois_keys.key_for_elt(elt))

    def conj_split(self, enc: Ciphertext) -> tuple[Ciphertext, Ciphertext]:
        """Full packing: the real and imaginary parts of C2S's output as two
        ciphertexts (enc + conj, and (enc - conj) x^(3N/2))."""
        ctx = self.ctx
        conj = self._conjugate(enc)
        enc_i = auto.eval_sub_auto(ctx, enc, conj)
        enc = auto.eval_add_auto(ctx, enc, conj)
        enc_i = auto.mult_by_monomial(ctx, enc_i, 3 * ctx.n // 2)
        if enc.noise_scale_deg == 2:
            enc = auto.mod_reduce(ctx, enc, 1)
            enc_i = auto.mod_reduce(ctx, enc_i, 1)
        return enc, enc_i

    def conj_fold(self, enc: Ciphertext) -> Ciphertext:
        """Sparse packing: enc + conj (the C2S plaintexts pack [re, im])."""
        enc = auto.eval_add_auto(self.ctx, enc, self._conjugate(enc))
        if enc.noise_scale_deg == 2:
            enc = auto.mod_reduce(self.ctx, enc, 1)
        return enc

    def eval_mod(self, ct: Ciphertext, step=None) -> Ciphertext:
        """EvalMod with this bootstrapper's sine set and relin key."""
        return eval_mod(self.ctx, ct, self.mul_key, self.sine_coefficients(), self.r_iters,
                        step)

    def recombine(self, enc: Ciphertext, enc_i: Ciphertext) -> Ciphertext:
        """Full packing: enc + enc_i x^(N/2), times 2^deg, ModReduce."""
        ctx = self.ctx
        enc_i = auto.mult_by_monomial(ctx, enc_i, ctx.n // 2)
        enc = auto.eval_add_auto(ctx, enc, enc_i)
        return self.post_sine(enc)

    def post_sine(self, enc: Ciphertext) -> Ciphertext:
        """Times 2^deg, then ModReduce."""
        _, post = self._correction()
        enc = auto.mult_by_integer(self.ctx, enc, int(round(post)))
        return auto.mod_reduce(self.ctx, enc, 1)

    def rot_fold(self, dec: Ciphertext, slots: int) -> Ciphertext:
        """Sparse packing: fold the [re, im] halves of S2C's output (dec plus
        its rotation by `slots`)."""
        ctx = self.ctx
        elt = galois_elt_from_step(slots, ctx.n)
        rot = ev.apply_galois_with_key(ctx, dec, elt, self.galois_keys.key_for_elt(elt))
        return auto.eval_add_auto(ctx, dec, rot)

    def correct(self, dec: Ciphertext) -> Ciphertext:
        """The correction multiply by 2^correction."""
        correction, _ = self._correction()
        return auto.mult_by_integer(self.ctx, dec, 1 << round(correction))

    # ------------------------------------------------------------------
    def eval_bootstrap_jit(self, ct: Ciphertext, slots: int = 0) -> Ciphertext:
        """The single-iteration bootstrap (the reference's name for it)."""
        return self.eval_bootstrap(ct, slots or self.ctx.n // 2, 1, 0)

    def eval_bootstrap(self, ct: Ciphertext, slots: int = 0, num_iterations: int = 1,
                       precision: int = 0) -> Ciphertext:
        """EvalBootstrap: the dense path (slots = N/2), the sparse path, and
        with num_iterations > 1 Meta-BTS, of one ciphertext or of a batch
        stacked with stack_cts.  Returns `ct` itself when the bootstrap would
        leave no more limbs than it had (a batch shares its level, so the
        whole batch or none)."""
        ctx = self.ctx
        slots = slots or ctx.n // 2
        init_size_q = ctx.level(ct.chain_index).size
        if num_iterations > 1 and ct.data.dim() == 4:
            # Meta-BTS runs the channels one at a time and restacks them
            return stack_cts([self.eval_bootstrap(c, slots, num_iterations, precision)
                              for c in unstack_cts(ct, ct.data.shape[0])])
        if num_iterations > 1:
            return self._meta_bootstrap(ct, slots, num_iterations, precision, init_size_q)

        d = auto.composite_degree(ctx)
        # (noise_scale_deg - 1) ModReduces to reach degree 1, plus
        # AdjustCiphertext's one before RaiseMod
        need = (1 + max(0, ct.noise_scale_deg - 1)) + 1
        if ctx.level(ct.chain_index).size < need * d:
            raise ValueError(
                f"bootstrap input at noise degree {ct.noise_scale_deg} must keep at least "
                f"{need} logical levels (ModReduce to degree 1 + AdjustCiphertext's rescale "
                "before RaiseMod)")
        if slots not in self.precom:
            raise KeyError(f"no setup for {slots} slots")

        raised = self.prelude(ct, slots)
        if slots == ctx.n // 2:
            enc, enc_i = self.conj_split(self.coeffs_to_slots(raised, slots))
            enc = self.recombine(self.eval_mod(enc), self.eval_mod(enc_i))
            dec = self.slots_to_coeffs(enc, slots)
        else:
            enc = self.coeffs_to_slots(self.partial_sum(raised, slots), slots)
            enc = self.post_sine(self.eval_mod(self.conj_fold(enc)))
            dec = self.rot_fold(self.slots_to_coeffs(enc, slots), slots)
        dec = self.correct(dec)
        if ctx.level(dec.chain_index).size <= init_size_q:
            return ct
        return dec

    def _meta_bootstrap(self, ct: Ciphertext, slots: int, num_iterations: int,
                        precision: int, init_size_q: int) -> Ciphertext:
        """Meta-BTS: bootstrap, then bootstrap the scaled-up error and subtract."""
        ctx = self.ctx
        power = 1 << precision
        ct_scaled_up = auto.mult_by_integer(ctx, ct, power)
        ct_init = self.eval_bootstrap(ct, slots, num_iterations - 1, precision)
        ct_init = auto.mod_reduce(ctx, ct_init, 1)
        ct_init_up = auto.mult_by_integer(ctx, ct_init, power)
        boot_size_q = ctx.level(ct_init_up.chain_index).size
        if boot_size_q <= init_size_q:
            return ct
        ct_down = auto.mod_switch_level(ctx, ct_init_up,
                                        (boot_size_q - init_size_q) // auto.composite_degree(ctx))
        ct_err = auto.eval_sub_auto(ctx, ct_down, ct_scaled_up)
        ct_err_boot = auto.mod_reduce(ctx, self.eval_bootstrap(ct_err, slots, 1, 0), 1)
        final = auto.eval_sub_auto(ctx, ct_init_up, ct_err_boot)
        return auto.mult_const(ctx, final, 1.0 / power)
