"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version:

  paged_attention  — paged GQA decode over a block-table KV pool
                     (csrc/paged_decode.cu)
  ragged_prefill   — packed variable-length prefill, segment and causal
                     masked (csrc/ragged_prefill.cu)
  gemm             — C = A·B with an f32 accumulator, split-K and
                     stagger-K, behind the ARGUS gate (csrc/gemm.cu)

Sources are CUDA C++ for sm_90a with a plain C entry point, built by
``nvcc`` at first use and loaded through ctypes (:mod:`._build`).  The
other five Pallas kernels of the JAX package are still to be ported
(ROADMAP, section B).
"""
from . import gemm, paged_attention, ragged_prefill
from ._build import build_all

ALL_KERNELS = (paged_attention.KERNEL, ragged_prefill.KERNEL, gemm.KERNEL)

__all__ = ["paged_attention", "ragged_prefill", "gemm", "build_all",
           "ALL_KERNELS"]
