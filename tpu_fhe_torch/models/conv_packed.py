"""Packed multi-channel convolution and the diagonal fully-connected layer.

Port of ``tpu_fhe/models/conv_packed.py``.  Many input channels share one
ciphertext in a zero-padded layout: channel c sits in block c % n_i of
ciphertext c // n_i, each block the (h + 2p)^2 padded image rounded up to
a power of two slots.  The convolution rotates each input ciphertext by
each filter tap, multiplies the taps by per-channel weight masks and sums
them, collapses the blocks with log2(n_i) rotate-adds, and selects the sum
into block k % n_i of output ciphertext k // n_i.  The FC layer encodes the
weight matrix by diagonals, diag_i[j] = W[(i + j) % rows][j], and sums
rotations of the products, then folds the columns in log steps.

Every output channel takes the same tap ciphertexts and the same collapse
steps, so the output channels go through in chunks of ``channel_batch``
(the DNN's memory rule) as one (B, 2, L, N) batch: the mask products,
their sum, both rescales, the collapse rotations (one keyswitch, one
launch of each kernel, for the whole chunk) and the select run once per
chunk; ``channel_batch=1`` runs a batch of one.  The residues are those of
the reference's channel-at-a-time loop: modular addition is exact in any
order, a tap whose mask is zero for one channel of a chunk adds an exact
zero, and a tap that is zero for every channel of the chunk is skipped, as
the reference skips it.  The chunk's masks of one tap are built as one
(B, slots) tensor and encoded together (``embed_rows``, then one
``encode_coeff_poly``), which rounds as ``encode`` does, and multiplied
before the next tap's are encoded: a chunk holds the masks of at most two
taps, B each, so the memory rule bounds it whatever the layer's number of
input ciphertexts.  With an encoder that embeds on the device
(``CkksEncoder(ctx, device_embed=True)``) the masks are built on the
card and never leave it: one DeviceEmbedding pass embeds a tap's B masks;
a host encoder gets them on the host and embeds each there, as the
reference does.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..eval import evaluator as ev
from ..scheme.ciphertext import Ciphertext, Plaintext, unstack_cts
from ..scheme.context import FheContext
from ..scheme.keys import GaloisKey, SecretKey
from .dnn import channel_batch


def _next_pow2(v: int) -> int:
    return 1 << (v - 1).bit_length()


@dataclass(frozen=True)
class PackedLayout:
    """Slot layout for channel-packed padded images."""

    in_h: int          # unpadded image height/width
    f_h: int           # filter height/width (odd)
    block: int         # padded+aligned slots per channel
    n_i: int           # channels per ciphertext
    wpp: int           # padded width

    @property
    def pad(self) -> int:
        return (self.f_h - 1) // 2


class PackedConv:
    def __init__(self, ctx: FheContext, encoder, scale: float | None = None,
                 channel_batch: int | None = None):
        """`channel_batch` forces the output channels per chunk (1 runs
        them one at a time, as the reference does); None takes the DNN's
        memory rule."""
        self.ctx = ctx
        self.encoder = encoder
        self.scale = scale if scale is not None else 2.0 ** 40
        self.slots = ctx.n // 2
        self.forced_batch = channel_batch
        self._mask_host = 0.0          # host-clock seconds of mask encoding
        self._mask_events: list = []   # CUDA event pairs around mask encoding

    @property
    def mask_seconds(self) -> float:
        """Seconds spent encoding masks since the last `mask_seconds = 0.0`
        (see timing_masks); reading it waits for the last masks."""
        if self._mask_events:
            self._mask_events[-1][1].synchronize()
        return self._mask_host + sum(a.elapsed_time(b) for a, b in self._mask_events) / 1e3

    @mask_seconds.setter
    def mask_seconds(self, value: float):
        self._mask_host, self._mask_events = value, []

    @contextlib.contextmanager
    def timing_masks(self):
        """Adds the enclosed mask encoding to mask_seconds: on a CUDA
        context the time between CUDA events recorded around it on the
        current stream, since the work is asynchronous (no synchronize),
        else the host clock."""
        if self.ctx.device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            yield
            end.record()
            self._mask_events.append((start, end))
        else:
            t0 = time.perf_counter()
            yield
            self._mask_host += time.perf_counter() - t0

    def channel_batch(self, n_ch: int) -> int:
        return channel_batch(self.ctx, n_ch, self.forced_batch)

    def layout(self, in_h: int, f_h: int) -> PackedLayout:
        pad = (f_h - 1) // 2
        wpp = in_h + 2 * pad
        block = _next_pow2(wpp * wpp)
        n_i = self.slots // block
        if n_i < 1:
            raise NotImplementedError(
                "image larger than the slot count (unsupported in the "
                "reference as well; use a larger ring degree)"
            )
        return PackedLayout(in_h=in_h, f_h=f_h, block=block, n_i=n_i, wpp=wpp)

    def _rows(self, lay: PackedLayout) -> np.ndarray:
        """The slot offset of each image row within a block."""
        return (np.arange(lay.in_h) + lay.pad) * lay.wpp + lay.pad

    # -- packing ------------------------------------------------------------
    def zero_pad_encode(self, images: np.ndarray, lay: PackedLayout,
                        sk: SecretKey) -> list[Ciphertext]:
        """images (C, h, h) -> ceil(C/n_i) ciphertexts, channel c in block
        c % n_i of ct c // n_i."""
        c_in, h, _ = images.shape
        assert h == lay.in_h
        num_ct = -(-c_in // lay.n_i)
        offs = self._rows(lay)
        cts = []
        for i in range(num_ct):
            vec = np.zeros(self.slots)
            for b in range(min(lay.n_i, c_in - i * lay.n_i)):
                for r, off in enumerate(offs):
                    base = b * lay.block + off
                    vec[base:base + h] = images[i * lay.n_i + b, r]
            pt = self.encoder.encode(vec, self.scale, slots=self.slots)
            cts.append(sk.encrypt_symmetric(pt))
        return cts

    def decode_outputs(self, cts: list[Ciphertext], lay: PackedLayout, c_out: int,
                       sk: SecretKey) -> np.ndarray:
        """-> (c_out, h, h) from the packed output layout."""
        h = lay.in_h
        offs = self._rows(lay)
        out = np.zeros((c_out, h, h))
        for i, ct in enumerate(cts):
            vals = self.encoder.decode(sk.decrypt(ct), slots=self.slots).real
            for b in range(min(lay.n_i, c_out - i * lay.n_i)):
                for r, off in enumerate(offs):
                    base = b * lay.block + off
                    out[i * lay.n_i + b, r] = vals[base:base + h]
        return out

    # -- rotations needed --------------------------------------------------
    def _tap_steps(self, lay: PackedLayout) -> list[tuple[int, int, int]]:
        """(di, dj, rotation step) of each filter tap, row-major."""
        p = lay.pad
        return [(di, dj, (di - p) * lay.wpp + (dj - p))
                for di in range(lay.f_h) for dj in range(lay.f_h)]

    def rotation_indices(self, lay: PackedLayout) -> list[int]:
        steps = {s for _, _, s in self._tap_steps(lay) if s}
        b = lay.block
        while b < lay.n_i * lay.block:
            steps.add(b)
            b <<= 1
        return sorted(steps)

    # -- convolution ----------------------------------------------------------
    def eval_convolution(self, filt: np.ndarray, gk: GaloisKey, din: list[Ciphertext],
                         lay: PackedLayout) -> list[Ciphertext]:
        """Conv with 'same' zero padding of filt (c_out, c_in, f, f); the
        outputs packed n_i per ciphertext."""
        ctx = self.ctx
        c_out, c_in, f_h, _ = filt.shape
        assert f_h == lay.f_h
        interior = np.zeros(lay.block)
        for off in self._rows(lay):
            interior[off:off + lay.in_h] = 1.0
        # the masks are built where the encoder embeds them
        interior = torch.from_numpy(interior).to(
            ctx.device if self.encoder.device_embed else "cpu")

        # the tap rotations of each input ct, shared by every output channel
        taps = self._tap_steps(lay)
        rotated = [[ev.rotate(ctx, ct, s, gk) if s else ct for _, _, s in taps] for ct in din]

        out_cts: list[Ciphertext | None] = [None] * -(-c_out // lay.n_i)
        batch = self.channel_batch(c_out)
        for lo in range(0, c_out, batch):
            ks = list(range(lo, min(lo + batch, c_out)))
            acc = None
            for (i, t), pt in self._tap_masks(filt, ks, rotated, lay, interior):
                term = ev.multiply_plain(ctx, rotated[i][t], pt)
                acc = term if acc is None else ev.add(ctx, acc, term)
            acc = ev.rescale_to_next(ctx, acc)
            # collapse the per-channel blocks: every block ends up with the
            # full sum (power-of-two aligned rotate-add)
            span = lay.block
            while span < lay.n_i * lay.block:
                acc = ev.add(ctx, ev.rotate(ctx, acc, span, gk), acc)
                span <<= 1
            # select block k % n_i of each channel's sum into its output ct
            sel = np.zeros((len(ks), lay.n_i))
            sel[np.arange(len(ks)), np.asarray(ks) % lay.n_i] = 1.0
            term = ev.rescale_to_next(ctx, ev.multiply_plain(
                ctx, acc, self._mask_plain(self._block_masks(sel, interior), acc.chain_index)))
            for k, tk in zip(ks, unstack_cts(term, len(ks))):
                o = k // lay.n_i
                out_cts[o] = tk if out_cts[o] is None else ev.add(ctx, out_cts[o], tk)
        return out_cts

    def _tap_masks(self, filt, ks, rotated, lay, interior):
        """Yields ((input ct, tap), plaintext) for each tap of each input ct
        that is nonzero for some channel of `ks`: the (B, L, N) plaintext of
        the masks of the B channels of `ks` (block b of input ct i carries
        filt[k, i n_i + b, di, dj] on the interior), encoded when it is
        asked for."""
        c_in = filt.shape[1]
        chain_index = rotated[0][0].chain_index
        filt = np.asarray(filt, dtype=np.float64)[ks]
        found = False
        for i in range(len(rotated)):
            chans = list(range(i * lay.n_i, min((i + 1) * lay.n_i, c_in)))
            for t, (di, dj, _) in enumerate(self._tap_steps(lay)):
                w = filt[:, chans, di, dj]
                if not w.any():
                    continue
                found = True
                yield (i, t), self._mask_plain(self._block_masks(w, interior), chain_index)
        if not found:
            # every filter of these channels is zero: their sum is an exact
            # zero, from the first tap times zero masks (the reference's
            # loop has no term to rescale and raises)
            yield (0, 0), self._mask_plain(
                self._block_masks(np.zeros((len(ks), 1)), interior), chain_index)

    def _block_masks(self, w: np.ndarray, interior: torch.Tensor) -> torch.Tensor:
        """(B, slots) float64 masks on interior's device: row r carries
        w[r, b] * interior in block b, zeros past the last block of w."""
        masks = (torch.from_numpy(w).to(interior.device)[:, :, None] * interior)
        return torch.nn.functional.pad(masks.reshape(len(w), -1),
                                       (0, self.slots - w.shape[1] * len(interior)))

    def _mask_plain(self, masks: torch.Tensor, chain_index: int) -> Plaintext:
        """The (B, slots) masks embedded with one embed_rows and encoded at
        the mask scale with one encode_coeff_poly, as one (B, L, N)
        plaintext."""
        with self.timing_masks():
            rows = self.encoder.embed_rows(masks, self.slots)
            poly = self.encoder.encode_coeff_poly(rows, self.scale, chain_index)
        return Plaintext(data=poly, chain_index=chain_index, scale=self.scale)


# --------------------------------------------------------------------------
# fully-connected layer (diagonal encoding + BSGS fold)
# --------------------------------------------------------------------------

def fc_weight_encode(encoder, weight: np.ndarray, scale: float,
                     chain_index: int = 1) -> list[Plaintext]:
    """Diagonal plaintexts diag_i[j] = W[(i+j) % rows][j], every row in one
    embed_rows and one encode_coeff_rows; rows/cols powers of 2, cols <=
    numSlots."""
    rows, cols = weight.shape
    i, j = np.arange(rows)[:, None], np.arange(cols)
    diags = np.zeros((rows, encoder.slots))
    diags[:, :cols] = np.asarray(weight, dtype=np.float64)[(i + j) % rows, j]
    return encoder.encode_coeff_rows(encoder.embed_rows(diags, encoder.slots), scale,
                                     chain_index)


def fc_rotation_indices(rows: int, cols: int, slots: int) -> list[int]:
    steps = set()
    for i in range(1, rows):
        steps.add(-i)
        if cols != slots:
            steps.add(cols - i)
    i = cols // 2
    while i >= rows:
        steps.add(i)
        i //= 2
    return sorted(steps)


def fully_connected(ctx: FheContext, gk: GaloisKey, din: Ciphertext,
                    diag_pts: list[Plaintext], cols: int,
                    bias_pt: Plaintext | None = None) -> Ciphertext:
    """y[j] = sum_k W[j,k] x[k] for j < rows, via rotation accumulation and
    a log-fold.  Each row's rotations take their own keys, so they run one
    at a time."""
    slots = ctx.n // 2
    rows = len(diag_pts)
    prev = ev.rescale_to_next(ctx, ev.multiply_plain(ctx, din, diag_pts[0]))
    double_rotate = cols != slots
    for i in range(1, rows):
        tmp = ev.rescale_to_next(ctx, ev.multiply_plain(ctx, din, diag_pts[i]))
        if double_rotate:
            prev = ev.add(ctx, prev, ev.rotate(ctx, tmp, cols - i, gk))
        prev = ev.add(ctx, prev, ev.rotate(ctx, tmp, -i, gk))
    dout = prev
    i = cols // 2
    while i >= rows:
        prev = ev.rotate(ctx, prev, i, gk)
        dout = ev.add(ctx, dout, prev)
        prev = dout
        i //= 2
    if bias_pt is not None:
        dout = ev.add_plain(ctx, dout, bias_pt)
    return dout
