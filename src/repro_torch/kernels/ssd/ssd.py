"""SSD chunk scan: the wrapper of the hand-written CUDA kernel
``csrc/ssd_chunk_scan.cu``, which replaces the JAX package's Pallas TPU
kernel ``kernels/ssd/ssd.py`` (``ssd_chunk_scan``).

The choice of implementation follows the tensors' device: on CUDA
tensors the wrapper launches the kernel (and counts the call in
``KERNEL.launches``, once, though its entry point runs three kernels on
the stream: the chunk states, the pass over them in chunk order, and the
chunk scan) or raises; on CPU tensors it runs the plain PyTorch version
:func:`~.ref.ssd_ref`.  There is no fallback from one to the other.  The
wrapper allocates the kernel's scratch from the caching allocator: the
(BH, S / chunk, N, P) float32 states and the (BH, S / chunk) cumulative
decays at each chunk's end
(:func:`~repro_torch.core.families.ssd.scratch_bytes`).  The config is
not checked against the ARGUS gate here: :func:`~.ops.ssd` does that
before it calls this.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ...core.families.ssd import SSDConfig
from .._build import CudaKernel, ptr, stream_handle
from .ref import ssd_ref

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = CudaKernel(
    "ssd_chunk_scan", Path(__file__).parent / "csrc" / "ssd_chunk_scan.cu",
    "ssd_chunk_scan_launch", [_P] * 7 + [_I] * 6 + [_P])

_DTYPES = (torch.float32, torch.bfloat16)


def ssd_chunk_scan(x: torch.Tensor, da: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, *, cfg: SSDConfig = SSDConfig()
                   ) -> torch.Tensor:
    """x: (BH, S, P); da: (BH, S) log-decays; Bm, Cm: (BH, S, N) ->
    y (BH, S, P) in x's dtype, computed in float32 with the (N, P)
    state carried across ``cfg.chunk``-long chunks.  S must be a
    multiple of the chunk."""
    if x.dim() != 3 or Bm.dim() != 3:
        raise ValueError(f"ssd: shapes x {tuple(x.shape)}, B "
                         f"{tuple(Bm.shape)}")
    BH, S, P = x.shape
    N = Bm.shape[-1]
    q = cfg.chunk
    if (tuple(da.shape) != (BH, S) or tuple(Bm.shape) != (BH, S, N)
            or Cm.shape != Bm.shape):
        raise ValueError(f"ssd: shapes x {tuple(x.shape)}, da "
                         f"{tuple(da.shape)}, B {tuple(Bm.shape)}, C "
                         f"{tuple(Cm.shape)} do not match")
    if q < 1 or S % q:
        raise ValueError(f"S={S} must divide chunk {q}")
    if not x.is_cuda:
        return ssd_ref(x, da, Bm, Cm, q)[0]
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd kernel takes float32 or bfloat16 x, B and C "
                        f"of one type, got {x.dtype}, {Bm.dtype}, "
                        f"{Cm.dtype}")
    ts = (x, da, Bm, Cm)
    if any(t.device != x.device for t in ts):
        raise ValueError("ssd: x, da, B and C must be on one device")
    if not all(t.is_contiguous() for t in (x, Bm, Cm)):
        raise ValueError("ssd: x, B and C must be contiguous")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    # the decays are read as float32 (BH·S values, next to nothing)
    da = da.to(torch.float32).contiguous()
    nc = S // q
    states = torch.empty(BH * nc * N * P, dtype=torch.float32,
                         device=x.device)
    cs_end = torch.empty(BH * nc, dtype=torch.float32, device=x.device)
    KERNEL.launch(ptr(x), ptr(da), ptr(Bm), ptr(Cm), ptr(y), ptr(states),
                  ptr(cs_end), BH, S, P, N, q,
                  int(x.dtype == torch.bfloat16), stream_handle(x.device))
    return y
