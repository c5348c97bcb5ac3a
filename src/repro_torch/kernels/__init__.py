"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version:

  paged_attention  — paged GQA decode over a block-table KV pool
                     (csrc/paged_decode.cu)
  ragged_prefill   — packed variable-length prefill, segment and causal
                     masked (csrc/ragged_prefill.cu)

Sources are CUDA C++ for sm_90a with a plain C entry point, built by
``nvcc`` at first use and loaded through ctypes (:mod:`._build`).  The
other six Pallas kernels of the JAX package are still to be ported
(ROADMAP, section B).
"""
from . import paged_attention, ragged_prefill
from ._build import build_all

ALL_KERNELS = (paged_attention.KERNEL, ragged_prefill.KERNEL)

__all__ = ["paged_attention", "ragged_prefill", "build_all", "ALL_KERNELS"]
