"""Ragged-prefill attention: the wrapper of the hand-written CUDA kernel
``csrc/ragged_prefill.cu``, which replaces the JAX package's Pallas TPU
kernel ``kernels/ragged_prefill/ragged_prefill.py`` (``ragged_prefill``).

The choice of implementation follows the tensors' device: on CUDA
tensors the wrapper launches the kernel (and counts the launch in
``KERNEL.launches``) or raises; on CPU tensors it runs the plain
PyTorch version :func:`~.ref.ragged_prefill_ref`.  There is no fallback
from one to the other.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ...core.families.ragged_prefill import (RaggedPrefillConfig,
                                             RaggedPrefillProblem, is_wgmma)
from .._build import CudaKernel, dtype_name, ptr, stream_handle
from .ref import ragged_prefill_ref

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = CudaKernel(
    "ragged_prefill", Path(__file__).parent / "csrc" / "ragged_prefill.cu",
    "ragged_prefill_launch",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float,
     _I, _P])

__all__ = ["KERNEL", "RaggedPrefillConfig", "ragged_prefill"]


def ragged_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   seg_q: torch.Tensor, pos_q: torch.Tensor,
                   seg_k: torch.Tensor, pos_k: torch.Tensor, *,
                   cfg: RaggedPrefillConfig = RaggedPrefillConfig(),
                   scale=None) -> torch.Tensor:
    """q: (Hq, TQ, D) packed queries; k, v: (Hkv, TK, D) packed KV;
    seg/pos: (TQ,) and (TK,) int32 per-token metadata (seg -1 on
    padding).  Returns (Hq, TQ, D) in q's dtype."""
    Hq, TQ, D = q.shape
    Hkv, TK, _ = k.shape
    if TQ % cfg.block_q or TK % cfg.block_kv:
        raise ValueError(
            f"blocks ({cfg.block_q}, {cfg.block_kv}) must tile the packed "
            f"buffers (TQ={TQ}, TK={TK}) — pad before packing")
    if Hq % Hkv or v.shape != k.shape or k.shape[2] != D:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if not q.is_cuda:
        return ragged_prefill_ref(q, k, v, seg_q, pos_q, seg_k, pos_k,
                                  scale=scale)
    scale = float(scale if scale is not None else D ** -0.5)
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"ragged_prefill kernel takes bf16 or f32 q, k, v "
                        f"of one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    meta = (seg_q, pos_q, seg_k, pos_k)
    if tuple(seg_q.shape) != (TQ,) or tuple(pos_q.shape) != (TQ,) \
            or tuple(seg_k.shape) != (TK,) or tuple(pos_k.shape) != (TK,):
        raise ValueError("ragged_prefill: seg/pos must be (TQ,) and (TK,)")
    if any(t.dtype != torch.int32 for t in meta):
        raise TypeError("ragged_prefill: seg/pos must be int32")
    tensors = (q, k, v) + meta
    if any(t.device != q.device for t in tensors):
        raise ValueError("ragged_prefill: all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ragged_prefill: tensors must be contiguous")
    prob = RaggedPrefillProblem(1, TK, Hq, Hkv, D, dtype_name(q.dtype))
    align = 16 if is_wgmma(prob) else q.element_size()
    if any(t.data_ptr() % align for t in (q, k, v)):
        raise ValueError(f"ragged_prefill: q, k and v must be {align}-byte "
                         f"aligned (the bf16 on-grain kernel loads them by "
                         f"TMA)")
    out = torch.empty_like(q)
    if TQ == 0 or TK == 0:
        return out.zero_()
    KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(seg_q), ptr(pos_q),
                  ptr(seg_k), ptr(pos_k), ptr(out), Hq, Hkv, TQ, TK, D,
                  scale, int(q.dtype == torch.bfloat16),
                  stream_handle(q.device))
    return out
