"""Paged-attention decode: the wrapper of the hand-written CUDA kernel
``csrc/paged_decode.cu``, which replaces the JAX package's Pallas TPU
kernel ``kernels/paged_attention/paged_attention.py`` (``paged_decode``).
The kernel splits each row's page walk into spans, one CTA per (span, KV
head, row), and merges the spans' float32 partials in a second kernel on
the same stream; the span count comes from the shapes alone
(``core/families/paged_attention.py::span_pages``), so the wrapper never
reads the lengths and the grid is fixed for a decode geometry.  One call
is one launch in ``KERNEL.launches``.

The choice of implementation follows the tensors' device: on CUDA
tensors the wrapper launches the kernel (and counts the launch in
``KERNEL.launches``) or raises; on CPU tensors it runs the plain
PyTorch version :func:`~.ref.paged_decode_ref`.  There is no fallback
from one to the other.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ...core.families.paged_attention import (MIN_PAGE,
                                              PagedAttentionConfig,
                                              pages_per_step, span_pages,
                                              tile_tokens)
from ...core.kernelspec import on_grain
from .._build import CudaKernel, ptr, stream_handle
from .ref import paged_decode_ref

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = CudaKernel(
    "paged_decode", Path(__file__).parent / "csrc" / "paged_decode.cu",
    "paged_decode_launch",
    [_P] * 9 + [_I] * 8 + [ctypes.c_float, _I, _P])

__all__ = ["KERNEL", "PagedAttentionConfig", "paged_decode", "tile_tokens",
           "pages_per_step", "span_pages"]


def _check(q, k_pages, v_pages, table, lengths, cfg):
    B, Hq, one, D = q.shape
    P, Hkv, PS, Dk = k_pages.shape
    NP = table.shape[1]
    if one != 1 or Dk != D or v_pages.shape != k_pages.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k_pages.shape)}"
                         f", v {tuple(v_pages.shape)} do not match")
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} KV heads")
    if table.shape[0] != B or (lengths is not None
                               and tuple(lengths.shape) != (B,)):
        raise ValueError("table / lengths rows do not match the batch")
    if NP % cfg.block_pages:
        raise ValueError(f"block_pages {cfg.block_pages} must divide the "
                         f"{NP} pages per sequence")


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, table: torch.Tensor,
                 lengths: torch.Tensor = None, *,
                 cfg: PagedAttentionConfig = PagedAttentionConfig(),
                 scale=None) -> torch.Tensor:
    """q: (B, Hq, 1, D); k_pages/v_pages: (P, Hkv, PS, D) pools;
    table: (B, NP) int32 logical→physical page map; lengths: (B,) int32
    logical tokens per sequence (None ⇒ every sequence spans NP·PS).
    Returns (B, Hq, 1, D) in q's dtype."""
    _check(q, k_pages, v_pages, table, lengths, cfg)
    if not q.is_cuda:
        return paged_decode_ref(q, k_pages, v_pages, table, lengths,
                                scale=scale)
    B, Hq, _, D = q.shape
    P, Hkv, PS, _ = k_pages.shape
    NP = table.shape[1]
    scale = float(scale if scale is not None else D ** -0.5)
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_decode kernel takes bf16 or f32 q and pools "
                        f"of one type, got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    sz = q.element_size()
    if not pages_per_step(PS, D, sz):
        raise ValueError(f"paged_decode kernel takes pages of at least "
                         f"{MIN_PAGE} tokens; got PS={PS}")
    if lengths is None:
        lengths = torch.full((B,), NP * PS, dtype=torch.int32,
                             device=q.device)
    tensors = (q, k_pages, v_pages, table, lengths)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_decode: all tensors must be on one device")
    if table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_decode: table and lengths must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode: tensors must be contiguous")
    # the on-grain instances copy 16-byte vectors and TMA boxes; the
    # panel route any head_dim at the element's alignment
    align = 16 if on_grain(D, sz) else sz
    if any(t.data_ptr() % align for t in (q, k_pages, v_pages)):
        raise ValueError(f"paged_decode: q and the pools must be "
                         f"{align}-byte aligned at head_dim {D} in "
                         f"{q.dtype}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    sp = span_pages(B, Hkv, NP, PS, D, sz, Hq // Hkv)
    ns = -(-NP // sp)
    o_part = torch.empty(B * Hq, ns, D, dtype=torch.float32,
                         device=q.device)
    ml = torch.empty(2, B * Hq, ns, dtype=torch.float32, device=q.device)
    KERNEL.launch(ptr(q), ptr(k_pages), ptr(v_pages), ptr(table),
                  ptr(lengths), ptr(o_part), ptr(ml[0]), ptr(ml[1]),
                  ptr(out), B, Hq, Hkv, P, D, PS, NP, sp, scale,
                  int(q.dtype == torch.bfloat16), stream_handle(q.device))
    return out
