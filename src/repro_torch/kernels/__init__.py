"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version:

  paged_attention  — paged GQA decode over a block-table KV pool
                     (csrc/paged_decode.cu)
  ragged_prefill   — packed variable-length prefill, segment and causal
                     masked (csrc/ragged_prefill.cu)
  gemm             — C = A·B with an f32 accumulator, split-K and
                     stagger-K, behind the ARGUS gate (csrc/gemm.cu)
  flash_attention  — GQA flash-attention prefill (csrc/flash_attention.cu)
                     and split-KV decode (csrc/flash_decode.cu), behind
                     the ARGUS gate
  moe              — the grouped expert FFN (gate/up with SwiGLU, then
                     down with the router gate; csrc/grouped_ffn.cu),
                     behind the ARGUS gate

Sources are CUDA C++ for sm_90a with a plain C entry point, built by
``nvcc`` at first use and loaded through ctypes (:mod:`._build`).  The
other two Pallas kernels of the JAX package, ``quant_gemm`` and
``ssd_chunk_scan``, are still to be ported (ROADMAP, section B).
"""
from . import flash_attention, gemm, moe, paged_attention, ragged_prefill
from ._build import build_all

ALL_KERNELS = (paged_attention.KERNEL, ragged_prefill.KERNEL, gemm.KERNEL,
               flash_attention.KERNEL, flash_attention.DECODE_KERNEL,
               moe.KERNEL)

__all__ = ["paged_attention", "ragged_prefill", "gemm", "flash_attention",
           "moe", "build_all", "ALL_KERNELS"]
