"""Save and load ciphertexts, plaintexts and keys.

Port of ``tpu_fhe/utils/serialize.py`` in its file format, so that each
package reads the other's files: ``np.savez`` of the payload arrays and a
``__meta__`` entry (JSON bytes with the magic ``tpu-fhe-v1`` and the
object's kind and metadata).  A payload of the u64 plan is stored as two
uint32 planes ``lo`` and ``hi``; a q32 ciphertext or switching key compact,
as ``lo`` alone; a plaintext, a public key and a secret key always carry
both planes (``hi`` zero on a q32 context), as the reference writes them
(but for its compact q32 plaintexts, whose ``hi`` it stores as None: such
a file loads here with ``lo`` alone).
Loads return the port's objects in the context's word on its device.
Shoup words are never stored: a loaded switching key gets them from the
context's rule (``keys.evk_shoup``) when asked to.

The seed-compressed symmetric form stores c0 and a seed from which c1 = a
is drawn again on load.  The port draws a from torch's CPU generator
(``SecretKey.encrypt_symmetric_seeded``) and marks its files so; a seeded
file of the reference, whose a comes from JAX's threefry, cannot be read
here and raises ValueError.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..scheme.ciphertext import Ciphertext, Plaintext
from ..scheme.context import FheContext
from ..scheme.keys import GaloisKey, PublicKey, RelinKey, SecretKey, evk_shoup, seeded_uniform
from .convert import to_numpy, word_tensor

MAGIC = "tpu-fhe-v1"
SEED_PRNG = "torch-cpu"      # the generator of the port's seeded form


def _planes(x: torch.Tensor, compact: bool) -> dict:
    """{"lo": ..., "hi": ...} uint32 planes of a tensor of residues; on a
    q32 tensor only "lo" when `compact`, else "hi" zero."""
    arr = to_numpy(x)
    if arr.dtype == np.uint32:
        return {"lo": arr} if compact else {"lo": arr, "hi": np.zeros_like(arr)}
    return {"lo": (arr & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            "hi": (arr >> np.uint64(32)).astype(np.uint32)}


def _tensor(ctx: FheContext, lo: np.ndarray, hi: np.ndarray | None) -> torch.Tensor:
    """The context's tensor of the planes (lo, hi or None)."""
    arr = np.asarray(lo).astype(np.uint64)
    if hi is not None:
        arr |= np.asarray(hi).astype(np.uint64) << np.uint64(32)
    return word_tensor(ctx, arr)


def _dump(fp, meta: dict, arrays: dict):
    arrays = dict(arrays)
    arrays["__meta__"] = np.frombuffer(json.dumps({"magic": MAGIC, **meta}).encode(),
                                       dtype=np.uint8)
    np.savez(fp, **arrays)


def _arrays(npz) -> dict:
    """The file's arrays but an object array: the reference stores a compact
    (q32) plaintext's absent hi plane as None, which np.load does not
    unpickle; the plane is then absent."""
    out = {}
    for name in npz.files:
        with npz.zip.open(f"{name}.npy") as f:
            major, _ = np.lib.format.read_magic(f)
            header = (np.lib.format.read_array_header_1_0 if major == 1
                      else np.lib.format.read_array_header_2_0)(f)
        if not header[2].hasobject:
            out[name] = npz[name]
    return out


def _load(fp, kind: str) -> tuple[dict, dict]:
    with np.load(fp) as npz:
        arrays = _arrays(npz)
    meta = json.loads(bytes(arrays.pop("__meta__")).decode())
    if meta.get("magic") != MAGIC:
        raise ValueError("not a tpu-fhe serialized object")
    if meta["kind"] != kind:
        raise ValueError(f"expected {kind}, found {meta['kind']}")
    return meta, arrays


# -- ciphertexts ----------------------------------------------------------------

def _ct_meta(ct: Ciphertext, kind: str) -> dict:
    return dict(kind=kind, chain_index=ct.chain_index, scale=ct.scale,
                correction_factor=ct.correction_factor, noise_scale_deg=ct.noise_scale_deg,
                is_ntt_form=ct.is_ntt_form, is_asymmetric=ct.is_asymmetric)


def _ct_of(meta: dict, data: torch.Tensor) -> Ciphertext:
    return Ciphertext(data=data, chain_index=meta["chain_index"], scale=meta["scale"],
                      noise_scale_deg=meta["noise_scale_deg"],
                      correction_factor=meta["correction_factor"],
                      is_ntt_form=meta["is_ntt_form"],
                      is_asymmetric=meta.get("is_asymmetric", False))


def save_ciphertext(ct: Ciphertext, fp):
    """A ciphertext, or a batch of them ((B, size, L, N) data)."""
    _dump(fp, _ct_meta(ct, "ciphertext"), _planes(ct.data, compact=True))


def load_ciphertext(ctx: FheContext, fp) -> Ciphertext:
    meta, data = _load(fp, "ciphertext")
    return _ct_of(meta, _tensor(ctx, data["lo"], data.get("hi")))


def save_ciphertext_symmetric(ct: Ciphertext, seed: int, fp):
    """The seed-compressed form of a fresh symmetric encryption: c0 and the
    seed SecretKey.encrypt_symmetric_seeded returned with it."""
    if ct.size != 2 or ct.data.dim() != 3:
        raise ValueError("seed compression applies to one fresh size-2 ciphertext")
    _dump(fp, dict(_ct_meta(ct, "ciphertext_sym"), prng=SEED_PRNG),
          {**_planes(ct.data[0], compact=True), "seed": np.array([seed], dtype=np.uint64)})


def load_ciphertext_symmetric(ctx: FheContext, fp) -> Ciphertext:
    """c0 and c1 = a drawn again from the stored seed."""
    meta, data = _load(fp, "ciphertext_sym")
    if meta.get("prng") != SEED_PRNG:
        raise ValueError("this seeded ciphertext was written by tpu_fhe, whose a is drawn from "
                         "JAX's threefry generator; the port draws a from torch's generator "
                         "and cannot regenerate it (save the full ciphertext instead)")
    level = ctx.level(meta["chain_index"])
    c0 = _tensor(ctx, data["lo"], data.get("hi"))
    a = seeded_uniform(ctx, level, int(data["seed"][0]))
    return _ct_of(meta, torch.stack([c0, a]))


# -- plaintexts -------------------------------------------------------------------

def save_plaintext(pt: Plaintext, fp):
    _dump(fp, dict(kind="plaintext", chain_index=pt.chain_index, scale=pt.scale,
                   noise_scale_deg=pt.noise_scale_deg, is_ntt_form=pt.is_ntt_form),
          _planes(pt.data, compact=False))


def load_plaintext(ctx: FheContext, fp) -> Plaintext:
    meta, data = _load(fp, "plaintext")
    return Plaintext(_tensor(ctx, data["lo"], data.get("hi")), chain_index=meta["chain_index"],
                     scale=meta["scale"], noise_scale_deg=meta["noise_scale_deg"],
                     is_ntt_form=meta["is_ntt_form"])


# -- keys ---------------------------------------------------------------------------

def save_public_key(pk: PublicKey, fp):
    _dump(fp, {"kind": "public_key"}, _planes(pk.data, compact=False))


def load_public_key(ctx: FheContext, fp) -> PublicKey:
    _, data = _load(fp, "public_key")
    return PublicKey(_tensor(ctx, data["lo"], data.get("hi")))


def _key(ctx: FheContext, lo, hi, shoup: bool) -> RelinKey:
    data = _tensor(ctx, lo, hi)
    return RelinKey(data, evk_shoup(ctx, data) if shoup else None)


def save_relin_key(rk: RelinKey, fp):
    """The key's data (its Shoup words are not stored)."""
    _dump(fp, {"kind": "relin_key"}, _planes(rk.data, compact=True))


def load_relin_key(ctx: FheContext, fp, shoup: bool = True) -> RelinKey:
    """`shoup` (the relin key's default) attaches Shoup words."""
    _, data = _load(fp, "relin_key")
    return _key(ctx, data["lo"], data.get("hi"), shoup)


def save_galois_key(gk: GaloisKey, fp):
    elts = sorted(gk.keys)
    arrays = {}
    for elt in elts:
        for name, arr in _planes(gk.keys[elt].data, compact=True).items():
            arrays[f"{name}_{elt}"] = arr
    _dump(fp, {"kind": "galois_key", "elts": elts}, arrays)


def load_galois_key(ctx: FheContext, fp, shoup: bool = False) -> GaloisKey:
    """`shoup` attaches Shoup words to every key (off, the Galois keys'
    default)."""
    meta, data = _load(fp, "galois_key")
    return GaloisKey({int(elt): _key(ctx, data[f"lo_{elt}"], data.get(f"hi_{elt}"), shoup)
                      for elt in meta["elts"]})


def save_secret_key(sk: SecretKey, fp):
    """The NTT-form secret at the key level."""
    _dump(fp, {"kind": "secret_key"}, _planes(sk.s_ntt, compact=False))


def load_secret_key(ctx: FheContext, fp, seed: int | torch.Generator = 0) -> SecretKey:
    """A SecretKey around the stored secret; `seed` seeds its generator."""
    _, data = _load(fp, "secret_key")
    return SecretKey(ctx, seed=seed, s_ntt=_tensor(ctx, data["lo"], data.get("hi")))
