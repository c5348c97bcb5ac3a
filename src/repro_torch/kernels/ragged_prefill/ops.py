"""Public entry points for ragged-prefill attention, with the ARGUS
gate.

The port of the JAX package's ``kernels/ragged_prefill/ops.py``.  A
kernel config must pass compile-time validation of the packing
invariants (the shared :func:`repro_torch.core.verify_engine
.default_engine`, family ``ragged_prefill``, verified at the blocks the
CUDA kernel runs) before the kernel may launch: a cross-sequence leak,
an off-by-one causal bound, a mis-based cu_seqlens offset or a
skipped/replayed KV block is rejected with :class:`InvariantViolation`
before any launch.  The concrete metadata is range-checked by
:func:`.packing.validate_packing`.  Kernel configs come from
:func:`default_config`; the fleet dispatch table is not ported
(ROADMAP A7).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...core.families.ragged_prefill import (RaggedPrefillConfig,
                                             RaggedPrefillProblem)
from ...core.verify_engine import InvariantViolation, default_engine
from .._build import dtype_name
from .ragged_prefill import ragged_prefill as _ragged_prefill_kernel


def _validate(cfg: RaggedPrefillConfig,
              prob: RaggedPrefillProblem) -> None:
    res = default_engine().verify("ragged_prefill", cfg, prob)
    if not res.hard_ok:
        raise InvariantViolation(
            f"ARGUS rejected {cfg.name()} for {prob}:\n{res.render()}")


def _problem(total_k: int, n_seqs: int, q_heads: int, kv_heads: int,
             head_dim: int, dtype: str) -> RaggedPrefillProblem:
    return RaggedPrefillProblem(
        n_seqs=max(int(n_seqs), 1), total_tokens=int(total_k),
        q_heads=int(q_heads), kv_heads=int(kv_heads),
        head_dim=int(head_dim), dtype=dtype)


def default_config(total_q: int, total_k: int) -> RaggedPrefillConfig:
    """Largest pow2 blocks ≤ 128 tiling the packed buffers.  block_q
    must divide *both* totals, as in the JAX package (its family
    program models packed self-attention over one token axis)."""
    bq = 128
    while bq > 8 and (total_q % bq or total_k % bq):
        bq //= 2
    bkv = 128
    while bkv > 8 and total_k % bkv:
        bkv //= 2
    return RaggedPrefillConfig(block_q=bq, block_kv=bkv)


def ragged_prefill_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          seg_q: torch.Tensor, pos_q: torch.Tensor,
                          seg_k: torch.Tensor, pos_k: torch.Tensor, *,
                          cfg: Optional[RaggedPrefillConfig] = None,
                          scale=None) -> torch.Tensor:
    """Validated ragged-prefill attention.  q (Hq, TQ, D) packed
    queries; k, v (Hkv, TK, D) packed KV; seg/pos (TQ,)/(TK,) int32
    per-token metadata (seg -1 on padding)."""
    Hq, TQ, D = q.shape
    Hkv, TK, _ = k.shape
    segs = np.asarray(seg_k.cpu())
    n_seqs = int(segs.max()) + 1 if segs.size and segs.max() >= 0 else 1
    prob = _problem(TK, n_seqs, Hq, Hkv, D,
                    dtype_name(q.dtype))
    cfg = cfg or default_config(int(TQ), int(TK))
    _validate(cfg, prob)
    return _ragged_prefill_kernel(q, k, v, seg_q, pos_q, seg_k, pos_k,
                                  cfg=cfg, scale=scale)


def verified_config(total_q: int, total_k: int, n_seqs: int, *,
                    q_heads: int, kv_heads: int, head_dim: int,
                    dtype: str = "bf16",
                    cfg: Optional[RaggedPrefillConfig] = None
                    ) -> Optional[RaggedPrefillConfig]:
    """ARGUS gate for a serving engine's packed-prefill geometry.

    Statically verifies the leakage invariants of the config
    (:func:`default_config` unless ``cfg``) for this packing geometry.
    Returns the verified config, or ``None`` when the geometry is
    unverifiable (blocks cannot tile the buffers, or the invariant check
    rejects) — the serving engine's signal to stay on the dense fallback
    path."""
    prob = _problem(total_k, n_seqs, q_heads, kv_heads, head_dim, dtype)
    cfg = cfg or default_config(total_q, total_k)
    if total_q % cfg.block_q or total_k % cfg.block_q \
            or total_k % cfg.block_kv:
        return None
    try:
        _validate(cfg, prob)
    except InvariantViolation:
        return None
    return cfg
