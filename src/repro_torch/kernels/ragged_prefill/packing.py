"""Packing-metadata helpers for ragged (variable-length) prefill.

A numpy-only copy of the JAX package's ``kernels/ragged_prefill/
packing.py``; tests/test_torch_ragged_prefill.py holds the two equal.

A packed buffer concatenates every sequence's tokens along one axis;
``cu_seqlens`` is the (S+1,) offset vector with segment s spanning
``[cu[s], cu[s+1])`` and ``cu[0] == 0``.  The derived per-token metadata
is the pair the kernel masks on: ``seg[t]`` (owning segment, ``fill``
— default -1 — past ``cu[S]``) and ``pos[t]`` (segment-relative
position, 0 on padding).

These run on the host (serving engine, tests); :func:`validate_packing`
is the runtime mirror of the family's pre-solver ``assert_in_range``
offset-bound invariant — packing metadata that is non-monotone, starts
off zero, or escapes the buffer is rejected before any kernel masks on
it.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class PackingError(ValueError):
    """Packing metadata violating the cu_seqlens invariants."""


def cu_seqlens(lengths: Sequence[int]) -> np.ndarray:
    """(S,) per-sequence token counts -> (S+1,) int32 offset vector."""
    lens = np.asarray(lengths, dtype=np.int64)
    if lens.ndim != 1:
        raise PackingError(f"lengths must be 1-D, got shape {lens.shape}")
    if lens.size and lens.min() < 0:
        raise PackingError(f"negative sequence length in {lens.tolist()}")
    cu = np.zeros(lens.size + 1, dtype=np.int64)
    np.cumsum(lens, out=cu[1:])
    return cu.astype(np.int32)


def lengths_from_cu(cu: np.ndarray) -> np.ndarray:
    """Inverse of :func:`cu_seqlens` (validates first)."""
    cu = validate_packing(cu)
    return np.diff(cu).astype(np.int32)


def validate_packing(cu: np.ndarray,
                     total: Optional[int] = None) -> np.ndarray:
    """Check the offset-vector invariants: 1-D, starts at 0, monotone
    non-decreasing, and (when ``total`` is given) bounded by the packed
    buffer.  Returns the validated int32 vector."""
    cu = np.asarray(cu)
    if cu.ndim != 1 or cu.size < 1:
        raise PackingError(f"cu_seqlens must be 1-D non-empty, got "
                           f"shape {cu.shape}")
    if int(cu[0]) != 0:
        raise PackingError(f"cu_seqlens must start at 0, got {int(cu[0])}")
    if np.any(np.diff(cu) < 0):
        raise PackingError(f"cu_seqlens not monotone: {cu.tolist()}")
    if total is not None and int(cu[-1]) > total:
        raise PackingError(
            f"cu_seqlens total {int(cu[-1])} escapes the {total}-token "
            f"packed buffer")
    return cu.astype(np.int32)


def segment_ids_from_cu(cu: np.ndarray, total: Optional[int] = None,
                        fill: int = -1) -> np.ndarray:
    """(total,) int32 packed-token -> segment map; ``fill`` past cu[-1].

    Empty segments simply own no tokens (searchsorted skips them)."""
    cu = validate_packing(cu, total)
    total = int(cu[-1]) if total is None else int(total)
    t = np.arange(total, dtype=np.int64)
    seg = np.searchsorted(cu.astype(np.int64), t, side="right") - 1
    seg = np.where(t < int(cu[-1]), seg, fill)
    return seg.astype(np.int32)


def positions_from_cu(cu: np.ndarray,
                      total: Optional[int] = None) -> np.ndarray:
    """(total,) int32 segment-relative position per packed token
    (``t - cu[seg[t]]``; 0 on padding)."""
    cu = validate_packing(cu, total)
    total = int(cu[-1]) if total is None else int(total)
    seg = segment_ids_from_cu(cu, total)
    t = np.arange(total, dtype=np.int64)
    pos = np.where(seg >= 0, t - cu.astype(np.int64)[np.maximum(seg, 0)], 0)
    return pos.astype(np.int32)


def ragged_metadata(cu: np.ndarray, total: Optional[int] = None,
                    fill: int = -1):
    """Convenience: ``(segment_ids, positions)`` for one offset vector."""
    return (segment_ids_from_cu(cu, total, fill),
            positions_from_cu(cu, total))


def pack_ragged(rows: Sequence[np.ndarray],
                total: Optional[int] = None):
    """Concatenate variable-length rows (leading axis is the token axis)
    into one packed buffer, zero-padded to ``total`` slots.  Returns
    ``(packed, cu)`` with ``cu == cu_seqlens([len(r) for r in rows])``."""
    cu = cu_seqlens([int(np.asarray(r).shape[0]) for r in rows])
    used = int(cu[-1])
    total = used if total is None else int(total)
    if used > total:
        raise PackingError(
            f"{used} packed tokens do not fit the {total}-slot buffer")
    if rows:
        body = np.concatenate([np.asarray(r) for r in rows], axis=0)
    else:
        body = np.zeros((0,), dtype=np.float32)
    pad = np.zeros((total - used,) + body.shape[1:], dtype=body.dtype)
    return np.concatenate([body, pad], axis=0), cu


def unpack_ragged(packed: np.ndarray, cu: np.ndarray) -> List[np.ndarray]:
    """Inverse of :func:`pack_ragged`: split the packed buffer back into
    per-segment rows (padding past cu[-1] is dropped)."""
    cu = validate_packing(cu, int(np.asarray(packed).shape[0]))
    return [np.asarray(packed)[int(cu[s]):int(cu[s + 1])]
            for s in range(cu.size - 1)]
