"""Fused MoE FFN: the wrapper of the hand-written CUDA kernel
``csrc/grouped_ffn.cu``, which replaces the JAX package's Pallas TPU
kernel ``kernels/moe/moe.py`` (``grouped_ffn``), and the capacity-based
routing tables (``compute_dispatch``), plain tensor code as in the JAX
package.

The choice of implementation follows the tensors' device: on CUDA
tensors the wrapper launches the kernel (and counts the launch in
``KERNEL.launches``: one per call, the gate/up and the down launch
together) or raises; on CPU tensors it runs the plain PyTorch version
:func:`~.ref.grouped_ffn_ref`.  There is no fallback from one to the
other.  Which instance runs on the card, wgmma fed by TMA on a
persistent grid or the mma.sync / FMA tiles, follows
``core/families/moe.py::is_wgmma`` of the config and the widths.  The
config is not checked against the ARGUS gate here:
:func:`~.ops.moe_ffn` does that before it calls this.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from ...core.families.moe import (MoEConfig, MoEProblem, cta_tiles,
                                  is_wgmma)
from .._build import CudaKernel, dtype_name, ptr, stream_handle
from .ref import grouped_ffn_ref

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = CudaKernel(
    "grouped_ffn", Path(__file__).parent / "csrc" / "grouped_ffn.cu",
    "grouped_ffn_launch", [_P] * 7 + [_I] * 11 + [_P])

_DTYPES = (torch.bfloat16, torch.float32)


def grouped_ffn(x_routed: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor, gates_routed: Optional[torch.Tensor] = None,
                *, cfg: MoEConfig = MoEConfig()) -> torch.Tensor:
    """x_routed: (E, C, DM); wg, wu: (E, DM, DF); wd: (E, DF, DM);
    gates_routed: optional (E, C, 1) float32, applied in the epilogue when
    ``cfg.fuse_gate`` is set.  Returns (E, C, DM) in x's dtype.
    ``C % block_t == 0`` and ``DF % block_f == 0`` are required."""
    if x_routed.dim() != 3 or wg.dim() != 3:
        raise ValueError(f"grouped_ffn: shapes x {tuple(x_routed.shape)}, "
                         f"wg {tuple(wg.shape)}")
    E, C, DM = x_routed.shape
    DF = wg.shape[-1]
    if (tuple(wg.shape) != (E, DM, DF) or wu.shape != wg.shape
            or tuple(wd.shape) != (E, DF, DM)):
        raise ValueError(f"grouped_ffn: shapes x {tuple(x_routed.shape)}, "
                         f"wg {tuple(wg.shape)}, wu {tuple(wu.shape)}, "
                         f"wd {tuple(wd.shape)} do not match")
    bt, bf = cfg.block_t, cfg.block_f
    if min(bt, bf) < 1 or C % bt or DF % bf:
        raise ValueError(f"capacity {C} / d_ff {DF} must divide blocks "
                         f"({bt}, {bf})")
    fuse = cfg.fuse_gate and gates_routed is not None
    if fuse and tuple(gates_routed.shape) != (E, C, 1):
        raise ValueError(f"grouped_ffn: gates {tuple(gates_routed.shape)}, "
                         f"want {(E, C, 1)}")
    if not x_routed.is_cuda:
        return grouped_ffn_ref(x_routed, wg, wu, wd,
                               gates_routed if fuse else None)
    dt = x_routed.dtype
    if dt not in _DTYPES or any(w.dtype != dt for w in (wg, wu, wd)):
        raise TypeError(f"grouped_ffn kernel takes bf16 or f32 x and "
                        f"weights of one type, got {dt}, {wg.dtype}, "
                        f"{wu.dtype}, {wd.dtype}")
    ts = (x_routed, wg, wu, wd)
    if any(t.device != x_routed.device for t in ts):
        raise ValueError("grouped_ffn: x and the weights must be on one "
                         "device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("grouped_ffn: x and the weights must be contiguous")
    if any(t.data_ptr() % x_routed.element_size() for t in ts):
        raise ValueError("grouped_ffn: x and the weights must be aligned "
                         "to their element")
    y = torch.empty_like(x_routed)
    g = None
    if fuse:
        if gates_routed.device != x_routed.device:
            raise ValueError("grouped_ffn: gates on another device")
        g = gates_routed.reshape(E, C).to(torch.float32).contiguous()
    act = torch.empty(E, C, DF, dtype=dt, device=x_routed.device)
    # the wgmma instance's TMA needs 16-byte-aligned tensors; a narrow
    # problem (rows off the 16-byte grain) is never routed there
    wgmma = (is_wgmma(cfg, instance_problem(x_routed, wg))
             and not any(t.data_ptr() % 16 for t in ts))
    tm, tu, td = cta_tiles(cfg, DM, wgmma)
    KERNEL.launch(ptr(x_routed), ptr(wg), ptr(wu), ptr(wd),
                  ptr(g) if g is not None else _P(None), ptr(act), ptr(y),
                  E, C, DM, DF, bt, bf, tm, tu, td, int(dt == torch.bfloat16),
                  int(wgmma), stream_handle(x_routed.device))
    return y


def instance_problem(x_routed: torch.Tensor, wg: torch.Tensor) -> MoEProblem:
    """The family problem of a grouped call, for routing by
    :func:`~repro_torch.core.families.moe.is_wgmma` (which reads its
    widths and dtype): its E x C capacity rows as tokens, one slot each."""
    E, C, DM = x_routed.shape
    return MoEProblem(tokens=E * C, d_model=DM, d_ff=wg.shape[-1],
                      n_experts=E, top_k=1, dtype=dtype_name(x_routed.dtype))


def compute_dispatch(expert_idx: torch.Tensor, n_experts: int,
                     capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based routing tables.

    expert_idx: (..., T, K) int; each leading index is a group with
    tables of its own.  Returns (dest, keep) of the same shape:
      dest int32 — flat slot ``e * C + rank`` for kept pairs,
      keep bool  — False where the expert overflowed capacity.
    Deterministic: rank is assignment order (token-major), the GShard drop
    policy; an overflowing pair's slot is clamped to ``C - 1``."""
    *lead, T, K = expert_idx.shape
    flat = expert_idx.reshape(*lead, 1, T * K).long()           # (..., 1, TK)
    onehot = (torch.arange(n_experts, device=flat.device)[:, None]
              == flat).to(torch.int32)                          # (..., E, TK)
    # the count runs along the inner dimension: a scan down the outer one
    # of a (T*K, E) table is a slow kernel on the card
    ranks = torch.cumsum(onehot, dim=-1) - 1
    rank = ranks.gather(-2, flat)[..., 0, :]
    flat = flat[..., 0, :]
    keep = rank < capacity
    dest = flat * capacity + torch.clamp(rank, max=capacity - 1)
    return (dest.reshape(*lead, T, K).to(torch.int32),
            keep.reshape(*lead, T, K))
