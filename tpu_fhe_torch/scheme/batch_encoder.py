"""Batch encoder for BFV/BGV: CRT slot packing over the plain modulus t.

Port of ``tpu_fhe/scheme/batch_encoder.py``: t is an NTT-friendly prime
(t = 1 mod 2N), so R_t splits into N slots, and a length-N integer vector
maps to the polynomial whose evaluations at the primitive 2N-th roots are
the vector's entries.  The slot order follows the 5^j rotation group: row
0 slot j lives at the root with exponent 5^j mod 2N, row 1 slot j at
-(5^j) mod 2N, so ``rotate_rows(step)`` is sigma_{5^step} and
``rotate_columns`` is sigma_{2N-1}.

The reference transforms on the host with its golden Python-int NTT
(tpu_fhe/scheme/batch_encoder.py:69-93), seconds per call at N = 2^16.
The port transforms with its own NTT wrappers on a one-limb table for t,
on the context's device (K1 and K2 on a CUDA context): their outputs equal
the golden transform's bit for bit (``ops/ntt.py``), so encode and decode
give the reference's plaintexts and slots.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import numth
from ..core.ntt_tables import make_ntt_tables
from ..ops.ntt import build_device_ntt_tables, forward_ntt, inverse_ntt
from .ciphertext import Plaintext
from .context import FheContext


class BatchEncoder:
    def __init__(self, context: FheContext):
        params = context.params
        t = params.plain_modulus
        if t is None:
            raise ValueError("batch encoder requires a plain modulus")
        n = context.n
        if t.value % (2 * n) != 1 or not t.is_prime:
            raise ValueError("plain modulus must be an NTT-friendly prime (t = 1 mod 2N) "
                             "for batching; use PlainModulus.batching")
        self.context = context
        self.t = t
        self.n = n
        self.slots = n
        self.ntt = build_device_ntt_tables([make_ntt_tables(params.log_n, t.value)],
                                           context.device, q32=False)
        # the NTT stores f(psi^(2*br(i)+1)) at index i (ops/galois.py): slot j
        # goes to the index of its root's exponent
        two_n = 2 * n
        e = 2 * numth.bit_reverse_perm(params.log_n) + 1
        pos_of_e = np.zeros(two_n, dtype=np.int64)
        pos_of_e[e] = np.arange(n)
        half = n // 2
        exps = np.empty(n, dtype=np.int64)
        cur = 1
        for j in range(half):
            exps[j] = cur
            exps[half + j] = two_n - cur
            cur = (cur * 5) % two_n
        self.slot_to_index = torch.from_numpy(pos_of_e[exps]).to(context.device)

    def encode(self, values, chain_index: int = 1) -> Plaintext:
        """Integer vector (len <= N, entries taken mod t) -> a coefficient-form
        Plaintext (1, N) mod t."""
        vals = np.asarray(values, dtype=object).ravel()
        if vals.size > self.slots:
            raise ValueError("too many values for the slot count")
        reduced = torch.from_numpy((vals % self.t.value).astype(np.int64))
        evals = torch.zeros((1, self.n), dtype=torch.int64, device=self.context.device)
        evals[0, self.slot_to_index[: vals.size]] = reduced.to(self.context.device)
        return Plaintext(data=inverse_ntt(evals, self.ntt), chain_index=chain_index,
                         is_ntt_form=False)

    def decode(self, pt: Plaintext) -> np.ndarray:
        """Plaintext (coefficient form mod t) -> length-N uint64 vector."""
        coeffs = pt.data.reshape(1, -1)[:, : self.n].contiguous()
        evals = forward_ntt(coeffs, self.ntt)[0].index_select(0, self.slot_to_index)
        return evals.cpu().numpy().astype(np.uint64)
