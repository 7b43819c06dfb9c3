"""Key generation, encryption, decryption (CKKS RLWE core).

Port of ``tpu_fhe/scheme/keys.py`` for the secret, public and relin keys:
ternary secret in NTT form at the key level; public key
pk = (-(a s + e), a); hybrid key-switching keys with dnum digits where
digit d's first component carries + P * s^2 on the digit's limbs.  The
relin key carries Shoup companion words of every limb by default, so the
keyswitch inner product takes the Shoup kernel (ops/ks.py); they are
computed once here, with the plain torch ``shoup_of`` on the key's device.
Galois keys belong to a later slice.

All sampling draws from the secret key's ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import modarith as mm
from ..ops.ntt import forward_ntt
from . import prng
from .ciphertext import Ciphertext, Plaintext
from .context import FheContext


@dataclass(frozen=True)
class PublicKey:
    data: torch.Tensor  # (2, size_QP, N): [b, a]


@dataclass(frozen=True)
class RelinKey:
    """Hybrid KS key: data[d] = (b_d, a_d) at the key level, d < dnum.
    shoup: floor(data * 2^64 / q) per limb (same shape), or None."""

    data: torch.Tensor  # (dnum, 2, size_QP, N)
    shoup: torch.Tensor | None = None


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
        if tuple(s_ntt.shape) != expected or s_ntt.device != context.device:
            raise ValueError(f"secret must be {expected} on {context.device}")
        self.s_ntt = s_ntt

    # -- switching keys ---------------------------------------------------
    def _enc_zero_under(self, secret_ntt: torch.Tensor) -> torch.Tensor:
        """(b, a) with b = -(a * secret + e) at the key level (NTT form)."""
        ctx = self.context
        kl = ctx.key_level
        q, rlo, rhi = kl.mod.q, kl.mod.ratio_lo, kl.mod.ratio_hi
        a = prng.sample_uniform(self.generator, q, ctx.n)
        e = forward_ntt(prng.sample_cbd_error(self.generator, q, ctx.n), kl.ntt)
        b = mm.neg_mod(mm.add_mod(mm.mul_mod(a, secret_ntt, q, rlo, rhi), e, q), q)
        return torch.stack([b, a])

    def public_key(self) -> PublicKey:
        return PublicKey(self._enc_zero_under(self.s_ntt))

    def _kswitch_key(self, target_ntt: torch.Tensor, shoup: bool) -> RelinKey:
        """Digit d = Enc_s(P * target * 1_{digit d})."""
        ctx = self.context
        kl = ctx.key_level
        size_P, size_Q = ctx.params.size_P, ctx.params.size_Q
        dnum = (size_Q + size_P - 1) // size_P
        big_p = ctx.base_P.big_modulus
        p_mod_q = torch.tensor([[big_p % m.value] for m in ctx.key_modulus],
                               dtype=torch.int64, device=ctx.device)
        q, rlo, rhi = kl.mod.q, kl.mod.ratio_lo, kl.mod.ratio_hi
        keys = []
        for d in range(dnum):
            pk = self._enc_zero_under(self.s_ntt)
            sl = slice(d * size_P, min((d + 1) * size_P, size_Q))
            chunk = mm.mul_mod(target_ntt[sl], p_mod_q[sl], q[sl], rlo[sl], rhi[sl])
            pk[0, sl] = mm.add_mod(pk[0, sl], chunk, q[sl])
            keys.append(pk)
        data = torch.stack(keys)
        return RelinKey(data, self.evk_shoup(data) if shoup else None)

    def evk_shoup(self, data: torch.Tensor) -> torch.Tensor:
        """Shoup companion words of a switching key's limbs."""
        kl = self.context.key_level
        return mm.shoup_of(data, kl.mod.q, kl.mod.ratio_lo, kl.mod.ratio_hi)

    def relin_key(self, shoup: bool = True) -> RelinKey:
        """The relinearization key; `shoup` (default on) attaches the Shoup
        companion words the inner-product kernel reads."""
        kl = self.context.key_level
        s2 = mm.mul_mod(self.s_ntt, self.s_ntt, kl.mod.q, kl.mod.ratio_lo, kl.mod.ratio_hi)
        return self._kswitch_key(s2, shoup)

    # -- encryption / decryption ------------------------------------------
    def encrypt_symmetric(self, pt: Plaintext) -> Ciphertext:
        """c = (b + m, a) with fresh (b, a) at the plaintext's level."""
        ctx = self.context
        level = ctx.level(pt.chain_index)
        q, rlo, rhi = level.mod.q, level.mod.ratio_lo, level.mod.ratio_hi
        a = prng.sample_uniform(self.generator, q, ctx.n)
        e = forward_ntt(prng.sample_cbd_error(self.generator, q, ctx.n), level.ntt)
        s = self.s_ntt[: level.size]
        b = mm.neg_mod(mm.add_mod(mm.mul_mod(a, s, q, rlo, rhi), e, q), q)
        return Ciphertext(
            data=torch.stack([mm.add_mod(b, pt.data, q), a]),
            chain_index=pt.chain_index,
            scale=pt.scale,
            noise_scale_deg=pt.noise_scale_deg,
        )

    def decrypt(self, ct: Ciphertext) -> Plaintext:
        """NTT-form decrypt: m = sum_i c_i s^i."""
        level = self.context.level(ct.chain_index)
        s = self.s_ntt[: level.size]
        q, rlo, rhi = level.mod.q, level.mod.ratio_lo, level.mod.ratio_hi
        acc = ct.data[ct.size - 1]
        for i in range(ct.size - 2, -1, -1):
            acc = mm.add_mod(mm.mul_mod(acc, s, q, rlo, rhi), ct.data[i], q)
        return Plaintext(data=acc, chain_index=ct.chain_index, scale=ct.scale,
                         noise_scale_deg=ct.noise_scale_deg)


def encrypt_asymmetric(context: FheContext, pk: PublicKey, pt: Plaintext,
                       gen: torch.Generator) -> Ciphertext:
    """c = (u*pk0 + e0 + m, u*pk1 + e1) at the plaintext's level."""
    level = context.level(pt.chain_index)
    q, rlo, rhi = level.mod.q, level.mod.ratio_lo, level.mod.ratio_hi
    n = context.n
    u = forward_ntt(prng.sample_ternary(gen, q, n), level.ntt)
    e0 = forward_ntt(prng.sample_cbd_error(gen, q, n), level.ntt)
    e1 = forward_ntt(prng.sample_cbd_error(gen, q, n), level.ntt)
    pk0, pk1 = pk.data[0, : level.size], pk.data[1, : level.size]
    c0 = mm.add_mod(mm.add_mod(mm.mul_mod(u, pk0, q, rlo, rhi), e0, q), pt.data, q)
    c1 = mm.add_mod(mm.mul_mod(u, pk1, q, rlo, rhi), e1, q)
    return Ciphertext(
        data=torch.stack([c0, c1]),
        chain_index=pt.chain_index,
        scale=pt.scale,
        noise_scale_deg=pt.noise_scale_deg,
    )
