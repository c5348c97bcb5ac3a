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
  quant_gemm       — int8 A·B with per-group float32 scales applied to
                     each K block's int32 partial before it is
                     accumulated (csrc/quant_gemm.cu), behind the gate
  ssd              — the Mamba-2 SSD chunk scan, the (N, P) state
                     carried across chunks inside a CTA
                     (csrc/ssd_chunk_scan.cu), behind the gate

That is all eight Pallas kernels of the JAX package; none is left to
port.  Sources are CUDA C++ for sm_90a with a plain C entry point, built
by ``nvcc`` at first use and loaded through ctypes (:mod:`._build`).
"""
from . import (flash_attention, gemm, moe, paged_attention, quant_gemm,
               ragged_prefill, ssd)
from ._build import build_all

ALL_KERNELS = (paged_attention.KERNEL, ragged_prefill.KERNEL, gemm.KERNEL,
               flash_attention.KERNEL, flash_attention.DECODE_KERNEL,
               moe.KERNEL, quant_gemm.KERNEL, ssd.KERNEL)

__all__ = ["paged_attention", "ragged_prefill", "gemm", "flash_attention",
           "moe", "quant_gemm", "ssd", "build_all", "ALL_KERNELS"]
