"""Paged-attention decode: the wrapper of the hand-written CUDA kernel
``csrc/paged_decode.cu``, which replaces the JAX package's Pallas TPU
kernel ``kernels/paged_attention/paged_attention.py`` (``paged_decode``).

The choice of implementation follows the tensors' device: on CUDA
tensors the wrapper launches the kernel (and counts the launch in
``KERNEL.launches``) or raises; on CPU tensors it runs the plain
PyTorch version :func:`~.ref.paged_decode_ref`.  There is no fallback
from one to the other.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path

import torch

from .._build import CudaKernel, ptr, stream_handle
from .ref import paged_decode_ref

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = CudaKernel(
    "paged_decode", Path(__file__).parent / "csrc" / "paged_decode.cu",
    "paged_decode_launch",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I,
     _P])

MAX_GROUP = 8        # query heads per KV head the kernel serves
HEAD_DIMS = (16, 32, 64, 128)


def tile_tokens(head_dim: int, itemsize: int) -> int:
    """Tokens of K (and of V) the kernel stages per step: a 16 KB tile,
    at most 64 tokens.  A page must fit in one tile."""
    return min(64, 16384 // (head_dim * itemsize))


@dataclass(frozen=True)
class PagedAttentionConfig:
    """The JAX family's tunable knob, kept so configs carry across.
    The TPU kernel gathers ``block_pages`` pages per grid step; the CUDA
    kernel walks up to 64 tokens of pages per step whatever the value,
    so here it only has to divide the table width, as it must there."""

    block_pages: int = 2

    def name(self) -> str:
        return f"paged[bp={self.block_pages}]"


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
    tile = tile_tokens(D, q.element_size()) if D in HEAD_DIMS else 0
    if Hq // Hkv > MAX_GROUP or D not in HEAD_DIMS or PS > tile:
        raise ValueError(f"paged_decode kernel takes G <= {MAX_GROUP}, "
                         f"D in {HEAD_DIMS}, a page within one {tile}-token "
                         f"tile; got G={Hq // Hkv}, D={D}, PS={PS}")
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
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_decode: pools must be 16-byte aligned "
                         "(the kernel reads them in 16-byte vectors)")
    out = torch.empty_like(q)
    if B == 0:
        return out
    KERNEL.launch(ptr(q), ptr(k_pages), ptr(v_pages), ptr(table),
                  ptr(lengths), ptr(out), B, Hq, Hkv, D, PS, NP, scale,
                  int(q.dtype == torch.bfloat16), stream_handle(q.device))
    return out
