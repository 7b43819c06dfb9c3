"""CKKS encoder: canonical embedding over the 5^j rotation group.

Port of ``tpu_fhe/scheme/ckks_encoder.py``.  On the default host path the
complex transform runs on the host in float64 through an FFT of size 2N;
the rounded coefficients are copied to the context's device once and
reduced mod each prime there (exact Python integers on the host past
2^62), and the forward NTT runs on the device.  Plaintexts are in the context's word:
int32 on a q32 context (the reference's compact plaintexts,
``tpu_fhe/scheme/ckks_encoder.py:198-203``), int64 otherwise.  Decode is the inverse chain, with the
CRT composition in exact Python integers (seconds at N = 2^15 and 30 limbs).
Sparse packing (2 <= slots < N/2) embeds the slot vector at ring degree
2 * slots and scatters the result at coefficient stride N / (2 * slots),
as the reference does (``tpu_fhe/scheme/ckks_encoder.py:62-99``): the
values equal those of the slot vector tiled across the full slot set, but
the smaller transform rounds differently, and the port's encode is
bit-identical to the reference's.

``encode_ext`` and ``encode_ext_batch`` encode at the extended basis QlP
(Ql followed by the special primes P) for the bootstrap's plaintexts that
multiply hoisted ciphertexts; the QlP NTT view is the context's cached
``ntt_view`` of the key-level tables.

``embed_for_slots`` and ``encode_coeff_rows`` split an encode in two for
the DNN's convolution masks: the unscaled embedding of a slot vector, kept
per mask, and the scale-round-decompose-NTT of such rows (weight-multiplied
or not), batched like ``encode_ext_batch``.  ``embed_rows`` embeds a stack
of rows at once (the packed layers' masks), on the device with the device
embedding.

``CkksEncoder(context, device_embed=True)`` runs the reference's device
branches (``tpu_fhe/scheme/ckks_encoder.py:51-135``): the embedding is
``ops/special_fft.py``'s ``DeviceEmbedding`` on the context's device, in
float64 (the sparse path embeds at 2 * slots and scatters at stride
N / (2 * slots) there), and the scale, the bound check, the round and the
residues follow on the device without a copy to the host; decode composes
on the host as always, then runs the forward transform on the device.  It
is off by default, as in the reference; the device transform rounds
differently from the host's FFT, so a rounded coefficient may differ from
the host path's by one.  ``embed_for_slots`` returns a float64 numpy
array in both modes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.rns import RNSBase
from ..ops.modarith import u32_tensor, u64_tensor
from ..ops.ntt import forward_ntt, inverse_ntt
from ..ops.special_fft import DeviceEmbedding
from .ciphertext import Plaintext
from .context import FheContext


class CkksEncoder:
    def __init__(self, context: FheContext, device_embed: bool = False):
        """`device_embed` embeds on the context's device (DeviceEmbedding)
        instead of the host's float64 FFT; rings of fewer than 2 slots
        always embed on the host, as in the reference."""
        self.context = context
        self.n = context.n
        self.slots = self.n // 2
        self.device_embed = device_embed and self.slots >= 2
        self._rot_cache: dict[int, np.ndarray] = {}
        self._dev_cache: dict[int, DeviceEmbedding] = {}
        self._ext_cache: dict = {}
        self._q_cache: dict = {}
        self.rot_group = self._rot_group_for(self.n)

    def _rot_group_for(self, n_ring: int) -> np.ndarray:
        """The rotation-group exponents 5^j mod 2 n_ring, j < n_ring / 2."""
        got = self._rot_cache.get(n_ring)
        if got is None:
            two_n = 2 * n_ring
            got = np.empty(n_ring // 2, dtype=np.int64)
            cur = 1
            for j in range(n_ring // 2):
                got[j] = cur
                cur = (cur * 5) % two_n
            self._rot_cache[n_ring] = got
        return got

    @property
    def device_embedding(self) -> DeviceEmbedding:
        """The special FFT of the full slot set on the context's device."""
        return self.device_embedding_for(self.slots)

    def device_embedding_for(self, slots: int) -> DeviceEmbedding:
        """The special FFT of `slots` slots (ring degree 2 * slots) on the
        context's device, built once per slot count."""
        got = self._dev_cache.get(slots)
        if got is None:
            got = self._dev_cache[slots] = DeviceEmbedding(slots, self.context.device)
        return got

    def _embed_inverse_slots(self, values, slots: int):
        """A `slots`-slot vector (or a stack of them) -> real coefficient
        rows (..., N): a float64 numpy array on the host path, a float64
        tensor on the context's device with device_embed.  Full packing
        (and slots < 2) tiles the vector to N/2 slots; otherwise the
        ring-degree-2*slots embedding is scattered at stride
        N / (2 * slots), the reference's sparse path."""
        if slots > self.slots:
            raise ValueError(f"too many values for ring degree: {slots} slots > "
                             f"{self.slots} available (N={self.n})")
        dev = self.device_embed
        if dev:
            values = torch.as_tensor(values).to(self.context.device).to(torch.complex128)
        if slots == self.slots or slots < 2:
            reps = self.slots // max(slots, 1)
            return self._embed_inverse(values.tile((reps,)) if dev else np.tile(values, reps))
        if dev:
            small = self.device_embedding_for(slots).embed_inverse(values)
            out = small.new_zeros(values.shape[:-1] + (self.n,))
        else:
            small = _host_embed_inverse(values, 2 * slots, self._rot_group_for(2 * slots))
            out = np.zeros(values.shape[:-1] + (self.n,), dtype=np.float64)
        out[..., ::self.n // (2 * slots)] = small
        return out

    def _embed_inverse(self, values):
        """slots (complex, len N/2) -> real coefficient vector (len N), in
        the form of _embed_inverse_slots; on the host m_t = (2/N) Re(sum_j
        z_j zeta^{-e_j t}), one FFT of size 2N."""
        if self.device_embed:
            return self.device_embedding.embed_inverse(values)
        return _host_embed_inverse(values, self.n, self.rot_group)

    def _embed_forward(self, coeffs: np.ndarray) -> np.ndarray:
        """real coefficients (len N) -> slot values (complex, len N/2)."""
        if self.device_embed:
            return self.device_embedding.embed_forward(coeffs).cpu().numpy()
        two_n = 2 * self.n
        padded = np.zeros(two_n, dtype=np.complex128)
        padded[: self.n] = coeffs
        evals = np.fft.ifft(padded) * two_n
        return evals[self.rot_group % two_n]

    def _ext_tables(self, chain_index: int):
        """(QlP RNS base, QlP NTT view) at `chain_index`, built once."""
        got = self._ext_cache.get(chain_index)
        if got is None:
            ctx = self.context
            level = ctx.level(chain_index)
            size_Q = ctx.params.size_Q
            rows = tuple(range(level.size)) + tuple(range(size_Q, size_Q + ctx.params.size_P))
            got = self._ext_cache[chain_index] = (level.base.extend(ctx.base_P),
                                                  ctx.ntt_view(ctx.key_ntt, rows))
        return got

    def encode(self, values, scale: float, chain_index: int = 1,
               slots: int | None = None) -> Plaintext:
        """Encode complex/real values (len <= N/2) at the given scale/level."""
        level = self.context.level(chain_index)
        values = np.asarray(values, dtype=np.complex128).ravel()
        slots = slots if slots is not None else len(values)
        if len(values) < slots:
            values = np.pad(values, (0, slots - len(values)))
        if slots & (slots - 1):
            raise ValueError("slot count must be a power of two")
        if slots > self.slots:
            raise ValueError("too many values for ring degree")
        coeffs = self._embed_inverse_slots(values, slots) * scale
        if int(_amax(coeffs)).bit_length() + 2 >= level.base.big_modulus.bit_length():
            raise ValueError("encoded values are too large for the modulus")
        return Plaintext(data=forward_ntt(self._residues(coeffs, level.base), level.ntt),
                         chain_index=chain_index, scale=scale)

    def _residues(self, coeffs, base: RNSBase) -> torch.Tensor:
        """round(float64 coeffs) (..., N) -> their (..., L, N) residues mod
        each prime of `base`, in the context's word on its device.  A
        float64's integer value is exact, so for |c| < 2^62 the round lands
        exactly in int64: numpy coefficients are rounded on the host and
        copied to the device once, a tensor's are rounded where they lie;
        then floor-mod on the device.  Larger coefficients take
        _round_decompose's exact Python integers on the host."""
        ctx = self.context
        if _amax(coeffs) >= float(1 << 62):
            if isinstance(coeffs, torch.Tensor):
                coeffs = coeffs.cpu().numpy()
            flat = coeffs.reshape(-1, coeffs.shape[-1])
            planes = np.stack([_round_decompose(c, base) for c in flat])
            word = u32_tensor if ctx.is_q32 else u64_tensor
            return word(planes.reshape(coeffs.shape[:-1] + planes.shape[1:]), ctx.device)
        primes = self._q_cache.get(base.values)
        if primes is None:
            primes = self._q_cache[base.values] = torch.tensor(
                base.values, dtype=torch.int64, device=ctx.device).unsqueeze(-1)
        if isinstance(coeffs, torch.Tensor):
            x = torch.round(coeffs).to(torch.int64)   # half to even, as np.rint
        else:
            x = torch.from_numpy(np.rint(coeffs).astype(np.int64)).to(ctx.device)
        res = torch.remainder(x.unsqueeze(-2), primes)
        return res.to(torch.int32) if ctx.is_q32 else res

    def encode_ext(self, values, scale: float, chain_index: int = 1,
                   slots: int | None = None, noise_scale_deg: int = 1) -> Plaintext:
        """Encode at the extended basis QlP of `chain_index` (the reference's
        encode_ext): a plaintext that multiplies hoisted ciphertexts."""
        return self.encode_ext_batch([values], scale, chain_index, slots, noise_scale_deg)[0]

    def encode_ext_batch(self, values_list, scale: float, chain_index: int = 1,
                         slots: int | None = None,
                         noise_scale_deg: int = 1) -> list[Plaintext]:
        """encode_ext of every vector of `values_list`, with one batched
        forward NTT for the lot (and one host-to-device copy on the host
        path)."""
        rows = []
        for values in values_list:
            values = np.asarray(values, dtype=np.complex128).ravel()
            s = slots if slots is not None else len(values)
            if s & (s - 1):
                raise ValueError("slot count must be a power of two")
            rows.append(self._embed_inverse_slots(values, s))
        if self.device_embed:
            rows = torch.stack(rows)
        return self.encode_coeff_rows(rows, scale, chain_index, ext=True,
                                      noise_scale_deg=noise_scale_deg)

    def embed_for_slots(self, values, slots: int) -> np.ndarray:
        """The inverse embedding of a `slots`-slot vector, unscaled: the
        coefficient rows ``encode`` would scale and round, as a float64
        numpy array in both modes.  It is linear, so encode(w * v, s) ==
        round(embed_for_slots(v, slots) * (w * s))."""
        values = np.asarray(values, dtype=np.complex128).ravel()
        if len(values) < slots:
            values = np.pad(values, (0, slots - len(values)))
        if slots & (slots - 1):
            raise ValueError("slot count must be a power of two")
        if slots > self.slots:
            raise ValueError("too many values for ring degree")
        got = self._embed_inverse_slots(values, slots)
        return got.cpu().numpy() if self.device_embed else got

    def embed_rows(self, values, slots: int):
        """``embed_for_slots`` of each row of `values` (R, slots), in the
        encoder's form, for ``encode_coeff_poly``: with device_embed one
        DeviceEmbedding pass over the rows, an (R, N) float64 tensor on the
        context's device; on the host path each row's embedding, an (R, N)
        float64 numpy array."""
        if slots & (slots - 1):
            raise ValueError("slot count must be a power of two")
        if self.device_embed:
            return self._embed_inverse_slots(values, slots)
        return np.stack([self.embed_for_slots(v, slots) for v in np.asarray(values)])

    def encode_coeff_rows(self, rows, scale: float, chain_index: int, ext: bool = False,
                          noise_scale_deg: int = 1) -> list[Plaintext]:
        """Plaintexts of pre-embedded coefficient rows (``embed_for_slots``
        outputs, optionally weight-multiplied, or ``embed_rows``' rows):
        scale, round, RNS-decompose and forward-NTT, all rows in one batched
        NTT.  With `ext` at the extended basis QlP (for multiplying hoisted
        ciphertexts), else at the level's basis."""
        poly = self.encode_coeff_poly(rows, scale, chain_index, ext)
        return [Plaintext(data=poly[i], chain_index=chain_index, scale=scale,
                          noise_scale_deg=noise_scale_deg) for i in range(poly.shape[0])]

    def encode_coeff_poly(self, rows, scale: float, chain_index: int,
                          ext: bool = False) -> torch.Tensor:
        """encode_coeff_rows' planes as one (R, L, N) NTT-form tensor, row r
        the plaintext data of rows[r].  `rows` are numpy rows, scaled and
        rounded on the host and copied once, or an (R, N) float64 tensor on
        the context's device, scaled and rounded there."""
        if ext:
            base, ntt = self._ext_tables(chain_index)
        else:
            level = self.context.level(chain_index)
            base, ntt = level.base, level.ntt
        if isinstance(rows, torch.Tensor):
            coeffs = rows * scale
        else:
            coeffs = np.stack([np.asarray(r) * scale for r in rows])
        return forward_ntt(self._residues(coeffs, base), ntt)

    def decode(self, pt: Plaintext, slots: int | None = None) -> np.ndarray:
        level = self.context.level(pt.chain_index)
        data = pt.data.contiguous()
        if pt.is_ntt_form:
            data = inverse_ntt(data, level.ntt)
        residues = data.cpu().numpy().astype(np.int64).view(np.uint64)
        coeffs = _compose_signed(residues, level.base)
        vals = self._embed_forward(np.asarray(coeffs, dtype=np.float64) / pt.scale)
        return vals if slots is None else vals[:slots]


def _amax(coeffs) -> float:
    """max |c| of a numpy array or a tensor."""
    return float(abs(coeffs).max())


def _host_embed_inverse(values: np.ndarray, n_ring: int,
                        rot_group: np.ndarray) -> np.ndarray:
    """The inverse embedding at ring degree `n_ring`: a scatter of the slot
    values onto the rotation group's exponents, then one FFT of size
    2 n_ring."""
    two_n = 2 * n_ring
    spec = np.zeros(two_n, dtype=np.complex128)
    np.add.at(spec, rot_group % two_n, np.asarray(values, np.complex128))
    return (2.0 / n_ring) * np.fft.fft(spec)[:n_ring].real


def _round_decompose(coeffs: np.ndarray, base: RNSBase) -> np.ndarray:
    """round(float64 coeffs) -> (L, N) uint64 residue planes, in exact
    Python integers: the encoder's path for coefficients of 2^62 and more,
    which int64 cannot hold."""
    rounded = np.array([int(round(float(c))) for c in coeffs], dtype=object)
    out = np.empty((len(base), len(coeffs)), dtype=np.uint64)
    for i, q in enumerate(base.values):
        out[i] = (rounded % q).astype(np.uint64)
    return out


def _compose_signed(residues: np.ndarray, base: RNSBase) -> list[int]:
    """(L, N) residues -> centered big ints (Python integers)."""
    big_q = base.big_modulus
    half = big_q // 2
    acc = np.zeros(residues.shape[1], dtype=object)
    for i in range(len(base)):
        mult = (base.q_hat_inv_mod_q[i] * base.punctured_products[i]) % big_q
        acc = (acc + residues[i].astype(object) * mult) % big_q
    return [int(v) - big_q if v > half else int(v) for v in acc]
