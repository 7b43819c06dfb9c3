"""tpu_fhe_torch: the PyTorch/CUDA port of tpu_fhe (RNS CKKS on an NVIDIA H100).

The JAX package ``tpu_fhe`` is the reference this package is held against.
The port imports neither JAX nor anything of ``tpu_fhe``: it keeps its own
copy of the host layer (``core/``).  Residues are ``torch.int64`` tensors
holding canonical values in ``[0, q)`` with ``q < 2^61``; the CUDA kernels
under ``csrc/`` read the same memory as ``uint64_t``.

Entry points (``FheContext``, key generation, the evaluator) run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
