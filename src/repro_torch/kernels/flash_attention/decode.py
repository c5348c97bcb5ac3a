"""Split-KV flash decode: the wrapper of the hand-written CUDA kernel
``csrc/flash_decode.cu``, which replaces the JAX package's Pallas TPU
kernel ``kernels/flash_attention/decode.py`` (``flash_decode``).

The kernel writes each span's float32 partials (o, m, l) and, from the
same C entry point, merges them on the card (the log-sum-exp combine,
the JAX package's XLA epilogue) into the output in q's dtype;
:func:`combine` is the plain version of that merge.  The choice of
implementation follows the tensors' device: on CUDA tensors the wrapper
launches the kernel (and counts the launch in ``KERNEL.launches``) or
raises; on CPU tensors it runs the plain PyTorch version
``mha_ref(..., causal=False, kv_len=kv_len)``.  There is no fallback
from one to the other.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ...core.families.flash_decode import FlashDecodeConfig
from ...core.kernelspec import MAX_HEAD_DIM, head_blocks, head_dim_ok
from .._build import CudaKernel, ptr, stream_handle
from .ref import mha_ref

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = CudaKernel(
    "flash_decode", Path(__file__).parent / "csrc" / "flash_decode.cu",
    "flash_decode_launch",
    [_P] * 8 + [_I] * 6 + [ctypes.c_float, _I, _P])

_DTYPES = (torch.bfloat16, torch.float32)


def combine(o: torch.Tensor, m: torch.Tensor,
            l: torch.Tensor) -> torch.Tensor:
    """Log-sum-exp merge of the spans' partials o (BH, ns, D), m and l
    (BH, ns, 1) into (BH, 1, D) float32."""
    m_g = m.amax(dim=1, keepdim=True)
    w = torch.exp(m - m_g)
    l_g = (l * w).sum(dim=1, keepdim=True)
    l_g = torch.where(l_g == 0.0, torch.ones_like(l_g), l_g)
    return (o * w).sum(dim=1, keepdim=True) / l_g


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len,
                 *, cfg: FlashDecodeConfig = FlashDecodeConfig(),
                 scale=None) -> torch.Tensor:
    """q: (B, Hq, 1, D); k, v: (B, Hkv, S, D) cache; kv_len: the valid
    length shared by every row (an int, or an int32 tensor, read on the
    device without a host sync).  Returns (B, Hq, 1, D) in q's dtype."""
    B, Hq, one, D = q.shape
    _, Hkv, S, Dk = k.shape
    if one != 1 or Dk != D or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    ns = cfg.kv_splits
    if ns < 1 or S % ns:
        raise ValueError(f"kv_splits {ns} must tile the cache ({S})")
    if not q.is_cuda:
        out = mha_ref(q, k, v, causal=False, scale=scale, kv_len=kv_len)
        # no valid position: every span's l is 0 and the kernel writes
        # zeros, where the plain softmax would average V
        return out.zero_() if int(kv_len) == 0 else out
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_decode kernel takes bf16 or f32 q, k, v of "
                        f"one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not head_dim_ok(D, q.element_size()):
        raise ValueError(f"flash_decode kernel takes head_dim up to "
                         f"{MAX_HEAD_DIM} in rows of whole 16-byte vectors;"
                         f" got head_dim {D} in {q.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_decode: q, k, v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_decode: q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_decode: q, k and v must be 16-byte aligned "
                         "(the kernel copies them in 16-byte rows)")
    if B > 65535 or Hkv * head_blocks(Hq // Hkv) > 65535:
        raise ValueError("flash_decode: batch or KV heads exceed one "
                         "launch's grid")
    if isinstance(kv_len, torch.Tensor):
        kl = kv_len.to(device=q.device, dtype=torch.int32).reshape(())
    else:
        kl = torch.tensor(int(kv_len), dtype=torch.int32, device=q.device)
    scale = float(scale if scale is not None else D ** -0.5)
    out = torch.empty_like(q)
    if B * Hq == 0:
        return out
    # float32 scratch for the spans' partials o (BH, ns, D), m and l
    # (BH, ns): one allocation
    BHs = B * Hq * ns
    part = torch.empty(BHs * (D + 2), dtype=torch.float32, device=q.device)
    o, m, l = part[:BHs * D], part[BHs * D:BHs * (D + 1)], part[BHs * (D + 1):]
    KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(kl), ptr(o), ptr(m), ptr(l),
                  ptr(out), B, Hq, Hkv, S, D, ns, scale,
                  int(q.dtype == torch.bfloat16), stream_handle(q.device))
    return out

