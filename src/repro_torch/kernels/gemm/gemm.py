"""GEMM: the wrapper of the hand-written CUDA kernel ``csrc/gemm.cu``,
which replaces the JAX package's Pallas TPU kernel
``kernels/gemm/gemm.py`` (``gemm``).

The choice of implementation follows the tensors' device: on CUDA
tensors the wrapper launches the kernel (and counts the launch in
``KERNEL.launches``) or raises; on CPU tensors it runs the plain
PyTorch version :func:`~.ref.matmul_ref`.  There is no fallback from
one to the other.  The config is not checked against the ARGUS gate
here: :func:`~.ops.matmul` does that before it calls this.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ...core.families.gemm import (GemmConfig, GemmProblem, cta_tile,
                                   is_wgmma, mma_tile, vector_path)
from ...core.kernelspec import cdiv
from .._build import CudaKernel, ptr, stream_handle
from .ref import matmul_ref

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = CudaKernel(
    "gemm", Path(__file__).parent / "csrc" / "gemm.cu", "gemm_launch",
    [_P, _P, _P] + [_I] * 14 + [_P])

_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}

def gemm(a: torch.Tensor, b: torch.Tensor, *,
         cfg: GemmConfig = GemmConfig(), out_dtype=None) -> torch.Tensor:
    """C = A @ B for A (m, k), B (k, n), with the f32 accumulator, in
    ``out_dtype`` (default A's dtype).  ``split_k`` must divide the
    number of bk-deep K blocks."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not multiply")
    m, k = a.shape
    n = b.shape[1]
    out_dtype = out_dtype or a.dtype
    if cfg.split_k > 1 and cdiv(k, cfg.bk) % cfg.split_k:
        raise ValueError("split_k must divide the K block count")
    if not a.is_cuda:
        return matmul_ref(a, b, out_dtype=out_dtype)
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"gemm kernel takes bf16 or f32 A and B of one "
                        f"type, got {a.dtype} and {b.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"gemm kernel writes bf16 or f32, not {out_dtype}")
    if b.device != a.device:
        raise ValueError("gemm: A and B must be on one device")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("gemm: A and B must be contiguous (row-major)")
    if min(cfg.bm, cfg.bn, cfg.bk, cfg.split_k) < 1:
        raise ValueError(f"gemm: bad config {cfg}")
    split = max(cfg.split_k, 1)
    if m == 0 or n == 0 or k == 0:
        return torch.zeros(m, n, dtype=out_dtype, device=a.device)
    prob = GemmProblem(m, n, k, _DTYPES[a.dtype])
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    vec = vector_path(cfg, prob) and aligned
    wgmma = is_wgmma(cfg, prob) and aligned
    tm, tn = cta_tile(cfg, prob) if wgmma else mma_tile(cfg)
    if split > 1:
        out = torch.empty(split * m, n, dtype=torch.float32, device=a.device)
    else:
        out = torch.empty(m, n, dtype=out_dtype, device=a.device)
    KERNEL.launch(ptr(a), ptr(b), ptr(out), m, n, k, cfg.bm, cfg.bn,
                  cfg.bk, split, int(cfg.stagger_k), tm, tn,
                  int(a.dtype == torch.bfloat16),
                  int(out.dtype == torch.bfloat16), int(vec), int(wgmma),
                  stream_handle(a.device))
    if split > 1:
        out = out.view(split, m, n).sum(0, dtype=torch.float32)
        out = out.to(out_dtype)
    return out
