"""Flash attention (prefill): the wrapper of the hand-written CUDA kernel
``csrc/flash_attention.cu``, which replaces the JAX package's Pallas TPU
kernel ``kernels/flash_attention/flash_attention.py``
(``flash_attention``).

The choice of implementation follows the tensors' device: on CUDA
tensors the wrapper launches the kernel (and counts the launch in
``KERNEL.launches``) or raises; on CPU tensors it runs the plain
PyTorch version :func:`~.ref.mha_ref`.  There is no fallback from one to
the other.  The config is not checked against the ARGUS gate here:
:func:`~.ops.mha` does that before it calls this.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ...core.families.flash_attention import (FlashAttentionConfig,
                                              route_tile)
from ...core.kernelspec import cdiv, on_grain
from .._build import CudaKernel, dtype_name, ptr, stream_handle
from .ref import mha_ref

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = CudaKernel(
    "flash_attention",
    Path(__file__).parent / "csrc" / "flash_attention.cu",
    "flash_attention_launch",
    [_P, _P, _P, _P] + [_I] * 10 + [ctypes.c_float, _I, _P])

_DTYPES = (torch.bfloat16, torch.float32)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    cfg: FlashAttentionConfig = FlashAttentionConfig(),
                    causal: bool = True, scale=None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D).  Returns (B, Hq, Sq, D)
    in q's dtype.  ``cfg.block_q`` sets the query blocks (clamped to the
    sequence, as the TPU kernel clamps it) and ``causal_block_skip`` the
    early stop of each CTA's key walk under ``causal``."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, Dk = k.shape
    if k.shape[0] != B or Dk != D or Hq % Hkv:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} and "
                         f"k {tuple(k.shape)} do not match")
    if not q.is_cuda:
        return mha_ref(q, k, v, causal=causal, scale=scale)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes bf16 or f32 q, k, v "
                        f"of one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    # the on-grain instances copy 16-byte vectors (TMA, cp.async); the
    # panel route any head_dim at the element's alignment
    align = 16 if on_grain(D, q.element_size()) else q.element_size()
    if any(t.data_ptr() % align for t in (q, k, v)):
        raise ValueError(f"flash_attention: q, k, v must be {align}-byte "
                         f"aligned at head_dim {D} in {q.dtype}")
    bq = min(cfg.block_q, max(Sq, 8))
    if bq < 1:
        raise ValueError(f"flash_attention: bad config {cfg}")
    tile = route_tile(bq, D, dtype_name(q.dtype))
    if cdiv(Sq, bq) * cdiv(bq, tile) > 65535:
        raise ValueError(f"flash_attention: {cdiv(Sq, bq)} query blocks of "
                         f"{bq} exceed one launch's grid")
    scale = float(scale if scale is not None else D ** -0.5)
    out = torch.empty_like(q)
    if B == 0 or Hq == 0 or Sq == 0:
        return out
    if Skv == 0:
        return out.zero_()
    KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(out), B, Hq, Hkv, Sq, Skv, D,
                  bq, tile, int(causal),
                  int(bool(causal and cfg.causal_block_skip)), scale,
                  int(q.dtype == torch.bfloat16), stream_handle(q.device))
    return out
