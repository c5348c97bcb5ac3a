"""Quantized GEMM: the wrapper of the hand-written CUDA kernel
``csrc/quant_gemm.cu``, which replaces the JAX package's Pallas TPU
kernel ``kernels/quant_gemm/quant_gemm.py`` (``quant_gemm``).

The choice of implementation follows the tensors' device: on CUDA
tensors the wrapper launches the kernel (and counts the call in
``KERNEL.launches``, once, though the wgmma instance's entry point runs
two kernels on the stream: the transpose of B into scratch from the
caching allocator, then the GEMM) or raises; on CPU tensors it runs the
plain PyTorch version :func:`~.ref.quant_gemm_ref`.  There is no
fallback from one to the other.  Which instance runs (int8 wgmma fed by
TMA, or mma.sync) is decided by
:func:`~repro_torch.core.families.quant_gemm.is_wgmma` from the config
and the problem, and the pointers' 16-byte alignment.  The config is not
checked against the ARGUS gate here: :func:`~.ops.quant_matmul` does
that before it calls this.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ...core.families.quant_gemm import (QuantGemmConfig, QuantGemmProblem,
                                         cta_tile, is_wgmma, vector_path)
from ...core.kernelspec import cdiv
from .._build import CudaKernel, ptr, stream_handle
from .ref import quant_gemm_ref

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = CudaKernel(
    "quant_gemm", Path(__file__).parent / "csrc" / "quant_gemm.cu",
    "quant_gemm_launch", [_P] * 6 + [_I] * 12 + [_P])

_OUT = (torch.float32, torch.bfloat16)


def quant_gemm(a: torch.Tensor, b: torch.Tensor, sa: torch.Tensor,
               sb: torch.Tensor, *, group: int,
               cfg: QuantGemmConfig = QuantGemmConfig(),
               out_dtype=torch.float32) -> torch.Tensor:
    """a: (M, K) int8; b: (K, N) int8; sa: (M, ceil(K/group)) f32;
    sb: (ceil(K/group), N) f32.  Returns the dequantized (M, N) product
    in ``out_dtype`` (float32 or bfloat16): each bk-deep K block's int32
    partial scaled by its group's (sa row, sb column) pair before it is
    accumulated in float32.  ``bk`` must divide ``group``."""
    if group % cfg.bk:
        raise ValueError(f"bk {cfg.bk} must divide the scale group {group}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"quant_gemm: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not multiply")
    m, k = a.shape
    n = b.shape[1]
    ng = cdiv(k, group)
    if tuple(sa.shape) != (m, ng) or tuple(sb.shape) != (ng, n):
        raise ValueError(f"quant_gemm: scales {tuple(sa.shape)} and "
                         f"{tuple(sb.shape)}, want {(m, ng)} and {(ng, n)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"quant_gemm takes int8 A and B (the TPU kernel "
                        f"and its oracle take no other), got {a.dtype} "
                        f"and {b.dtype}")
    if out_dtype not in _OUT:
        raise TypeError(f"quant_gemm writes float32 or bfloat16, not "
                        f"{out_dtype}")
    if not a.is_cuda:
        return quant_gemm_ref(a, b, sa, sb, group=group, out_dtype=out_dtype)
    if sa.dtype != torch.float32 or sb.dtype != torch.float32:
        raise TypeError(f"quant_gemm kernel takes float32 scales, got "
                        f"{sa.dtype} and {sb.dtype}")
    ts = (a, b, sa, sb)
    if any(t.device != a.device for t in ts):
        raise ValueError("quant_gemm: A, B and the scales must be on one "
                         "device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("quant_gemm: A, B and the scales must be "
                         "contiguous (row-major)")
    if min(cfg.bm, cfg.bn, cfg.bk) < 1:
        raise ValueError(f"quant_gemm: bad config {cfg}")
    out = torch.empty(m, n, dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    prob = QuantGemmProblem(m, n, k, group)
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    vec = vector_path(cfg, prob) and aligned
    wgmma = is_wgmma(cfg, prob) and aligned and sb.data_ptr() % 16 == 0
    tm, tn = cta_tile(cfg, prob if wgmma else None)
    # Bᵀ (n, k): wgmma takes 8-bit operands K-major only
    bt = torch.empty(n, k, dtype=torch.int8, device=a.device) if wgmma \
        else None
    KERNEL.launch(ptr(a), ptr(b), ptr(sa), ptr(sb), ptr(out),
                  ptr(bt) if wgmma else None, m, n, k, group, cfg.bm,
                  cfg.bn, cfg.bk, tm, tn, int(out_dtype == torch.bfloat16),
                  int(vec), int(wgmma), stream_handle(a.device))
    return out
