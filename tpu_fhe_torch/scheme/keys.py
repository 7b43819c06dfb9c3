"""Key generation, encryption, decryption (CKKS RLWE core).

Port of ``tpu_fhe/scheme/keys.py`` for the secret, public, relin and Galois
keys: ternary secret in NTT form at the key level; public key
pk = (-(a s + e), a); hybrid key-switching keys with dnum digits where
digit d's first component carries + P * target on the digit's limbs (the
relin key's target is s^2).  Galois keys take the fused form: the key of
sigma_g encrypts P * s under sigma_g^-1(s), so a rotation keyswitches the
unrotated c1 and applies sigma_g to the output, and one modup serves many
rotations (hoisting).  The relin key carries Shoup companion words of every
limb by default, so its inner product takes the Shoup kernel (K8/K10);
Galois keys carry none by default, because a rotation-key set dominates
memory, and take K7/K9 (ops/ks.py).  The words are computed here, with
the plain torch ``shoup_of`` (or ``shoup32_of`` on a q32 context) on the
key's device.  On a q32 context every key, ciphertext and plaintext is
int32, the counterpart of the reference's compact u32 storage
(tpu_fhe/scheme/keys.py:165-170, :306, :392).  On a BGV context every
error is scaled by t (b = -(a s + t e)), in keygen and in both encryptions,
so that decryption mod t removes it (tpu_fhe/scheme/keys.py:91-97,
:376-383).

All sampling draws from the secret key's ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import modarith as mm
from ..ops.galois import apply_galois_ntt, galois_elt_from_step
from ..ops.ntt import forward_ntt
from . import prng
from .ciphertext import Ciphertext, Plaintext
from .context import FheContext, SchemeType


@dataclass(frozen=True)
class PublicKey:
    data: torch.Tensor  # (2, size_QP, N): [b, a]


@dataclass(frozen=True)
class RelinKey:
    """Hybrid KS key: data[d] = (b_d, a_d) at the key level, d < dnum.
    shoup: floor(data * 2^64 / q) per limb (same shape), or None; on a q32
    context both are int32 and the words are floor(data * 2^32 / q)."""

    data: torch.Tensor  # (dnum, 2, size_QP, N)
    shoup: torch.Tensor | None = None


@dataclass(frozen=True)
class GaloisKey:
    """Map from automorphism element to its switching key (fused form)."""

    keys: dict[int, RelinKey]

    def key_for_elt(self, elt: int) -> RelinKey:
        try:
            return self.keys[elt]
        except KeyError:
            raise ValueError(
                f"no Galois key for automorphism element {elt}; generate it "
                f"with SecretKey.galois_key([...]) for the required steps") from None


def _t_scaled_error(context: FheContext, gen: torch.Generator, level) -> torch.Tensor:
    """A fresh error e at `level` in coefficient form, times t on a BGV
    context."""
    e = prng.sample_cbd_error(gen, level.mod.q, context.n)
    if context.scheme != SchemeType.bgv:
        return e
    t = context.params.plain_modulus.value
    t_mod_q = torch.tensor([[t % q] for q in level.base.values], dtype=e.dtype,
                           device=e.device)
    return level.mod.mul(e, t_mod_q)


def _generator(seed: int | torch.Generator, device: torch.device) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


class SecretKey:
    """Holds the ternary secret (NTT form, key level) and key factories.

    `seed` seeds a new generator on the context's device (or is one);
    `s_ntt`, when given, is used as the secret instead of sampling one."""

    def __init__(self, context: FheContext, seed: int | torch.Generator = 0,
                 s_ntt: torch.Tensor | None = None):
        self.context = context
        self.generator = _generator(seed, context.device)
        kl = context.key_level
        if s_ntt is None:
            s_ntt = forward_ntt(
                prng.sample_ternary(self.generator, kl.mod.q, context.n), kl.ntt)
        expected = (kl.size, context.n)
        if tuple(s_ntt.shape) != expected or s_ntt.device != context.device \
                or s_ntt.dtype != context.dtype:
            raise ValueError(f"secret must be {expected} {context.dtype} on {context.device}")
        self.s_ntt = s_ntt

    # -- switching keys ---------------------------------------------------
    def _enc_zero_under(self, secret_ntt: torch.Tensor) -> torch.Tensor:
        """(b, a) with b = -(a * secret + e) at the key level (NTT form)."""
        ctx = self.context
        kl = ctx.key_level
        q = kl.mod.q
        a = prng.sample_uniform(self.generator, q, ctx.n)
        e = forward_ntt(_t_scaled_error(ctx, self.generator, kl), kl.ntt)
        b = mm.neg_mod(mm.add_mod(kl.mod.mul(a, secret_ntt), e, q), q)
        return torch.stack([b, a])

    def public_key(self) -> PublicKey:
        return PublicKey(self._enc_zero_under(self.s_ntt))

    def _kswitch_key(self, target_ntt: torch.Tensor, under_ntt: torch.Tensor | None = None,
                     shoup: bool = False) -> RelinKey:
        """Digit d = Enc_under(P * target * 1_{digit d}); `under` defaults
        to s (Galois keys encrypt under the inverse-rotated secret)."""
        ctx = self.context
        if under_ntt is None:
            under_ntt = self.s_ntt
        kl = ctx.key_level
        size_P, size_Q = ctx.params.size_P, ctx.params.size_Q
        dnum = (size_Q + size_P - 1) // size_P
        big_p = ctx.base_P.big_modulus
        p_mod_q = torch.tensor([[big_p % m.value] for m in ctx.key_modulus],
                               dtype=ctx.dtype, device=ctx.device)
        keys = []
        for d in range(dnum):
            pk = self._enc_zero_under(under_ntt)
            sl = slice(d * size_P, min((d + 1) * size_P, size_Q))
            mod = kl.mod.rows(sl)
            chunk = mod.mul(target_ntt[sl], p_mod_q[sl])
            pk[0, sl] = mm.add_mod(pk[0, sl], chunk, mod.q)
            keys.append(pk)
        data = torch.stack(keys)
        return RelinKey(data, self.evk_shoup(data) if shoup else None)

    def evk_shoup(self, data: torch.Tensor) -> torch.Tensor:
        """Shoup companion words of a switching key's limbs."""
        kl = self.context.key_level
        if self.context.is_q32:
            return mm.shoup32_of(data, kl.mod.q)
        return mm.shoup_of(data, kl.mod.q, kl.mod.ratio_lo, kl.mod.ratio_hi)

    def relin_key(self, shoup: bool = True) -> RelinKey:
        """The relinearization key; `shoup` (default on) attaches the Shoup
        companion words the inner-product kernel reads."""
        s2 = self.context.key_level.mod.mul(self.s_ntt, self.s_ntt)
        return self._kswitch_key(s2, shoup=shoup)

    def galois_key(self, steps: list[int], include_conj: bool = False,
                   shoup: bool = False) -> GaloisKey:
        """Switching keys for rotations by the given slot steps, one per
        automorphism element (and conjugation with `include_conj`).
        `shoup` attaches Shoup words, doubling each key's memory; off by
        default, so the inner product takes K7/K9."""
        n = self.context.n
        elts = [galois_elt_from_step(s, n) for s in steps]
        if include_conj:
            elts.append(2 * n - 1)
        return GaloisKey({elt: self._galois_key_for_elt(elt, shoup)
                          for elt in dict.fromkeys(elts)})

    def galois_key_power_of_2(self, include_conj: bool = False,
                              shoup: bool = False) -> GaloisKey:
        """The O(log N) key set: rotations by +-2^i slots for every
        2^i < N/2.  Any other step rotates through its NAF decomposition
        (evaluator.rotate)."""
        steps: list[int] = []
        p = 1
        while p < self.context.n // 2:
            steps.extend([p, -p])
            p <<= 1
        return self.galois_key(steps, include_conj=include_conj, shoup=shoup)

    def _galois_key_for_elt(self, elt: int, shoup: bool = False) -> RelinKey:
        """Fused-form key Enc_{sigma_elt^-1(s)}(P * s)."""
        n = self.context.n
        s_inv_rot = apply_galois_ntt(self.s_ntt, pow(elt, -1, 2 * n), n)
        return self._kswitch_key(self.s_ntt, under_ntt=s_inv_rot, shoup=shoup)

    # -- encryption / decryption ------------------------------------------
    def encrypt_symmetric(self, pt: Plaintext) -> Ciphertext:
        """c = (b + m, a) with fresh (b, a) at the plaintext's level."""
        ctx = self.context
        level = ctx.level(pt.chain_index)
        q = level.mod.q
        a = prng.sample_uniform(self.generator, q, ctx.n)
        e = forward_ntt(_t_scaled_error(ctx, self.generator, level), level.ntt)
        b = mm.neg_mod(mm.add_mod(level.mod.mul(a, self.s_ntt[: level.size]), e, q), q)
        return Ciphertext(
            data=torch.stack([mm.add_mod(b, pt.data, q), a]),
            chain_index=pt.chain_index,
            scale=pt.scale,
            noise_scale_deg=pt.noise_scale_deg,
        )

    def encrypt_zero_symmetric(self, chain_index: int) -> Ciphertext:
        """A fresh NTT-form encryption (b, a) of zero at the level."""
        level = self.context.level(chain_index)
        zero = torch.zeros((level.size, self.context.n), dtype=self.context.dtype,
                           device=self.context.device)
        return self.encrypt_symmetric(Plaintext(zero, chain_index=chain_index))

    def decrypt(self, ct: Ciphertext) -> Plaintext:
        """NTT-form decrypt: m = sum_i c_i s^i."""
        level = self.context.level(ct.chain_index)
        s = self.s_ntt[: level.size]
        acc = ct.data[ct.size - 1]
        for i in range(ct.size - 2, -1, -1):
            acc = mm.add_mod(level.mod.mul(acc, s), ct.data[i], level.mod.q)
        return Plaintext(data=acc, chain_index=ct.chain_index, scale=ct.scale,
                         noise_scale_deg=ct.noise_scale_deg)


def encrypt_asymmetric(context: FheContext, pk: PublicKey, pt: Plaintext,
                       gen: torch.Generator) -> Ciphertext:
    """c = (u*pk0 + e0 + m, u*pk1 + e1) at the plaintext's level."""
    level = context.level(pt.chain_index)
    q, mul = level.mod.q, level.mod.mul
    n = context.n
    u = forward_ntt(prng.sample_ternary(gen, q, n), level.ntt)
    e0 = forward_ntt(_t_scaled_error(context, gen, level), level.ntt)
    e1 = forward_ntt(_t_scaled_error(context, gen, level), level.ntt)
    pk0, pk1 = pk.data[0, : level.size], pk.data[1, : level.size]
    c0 = mm.add_mod(mm.add_mod(mul(u, pk0), e0, q), pt.data, q)
    c1 = mm.add_mod(mul(u, pk1), e1, q)
    return Ciphertext(
        data=torch.stack([c0, c1]),
        chain_index=pt.chain_index,
        scale=pt.scale,
        noise_scale_deg=pt.noise_scale_deg,
        is_asymmetric=True,
    )
