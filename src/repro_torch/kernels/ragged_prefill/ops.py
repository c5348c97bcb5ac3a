"""Public entry points for ragged-prefill attention, with the serving
path's concrete tiling check.

The port of the JAX package's ``kernels/ragged_prefill/ops.py``.  It
keeps the concrete checks the serving path makes: the block tiling of
the packed geometry (:func:`verified_config`) and, in
:mod:`.packing`, ``validate_packing`` of cu_seqlens.  It leaves out for
now the symbolic ARGUS gate (``VerificationEngine.verify`` of the
``ragged_prefill`` family's leakage invariants): it runs before any
kernel and changes no number the kernel produces; the port's gate
(``repro_torch.core``) has no ``ragged_prefill`` family yet, and wiring
it in here is the next slice (ROADMAP).  Kernel configs come from
:func:`default_config`; the fleet dispatch table is not ported either.
"""
from __future__ import annotations

from typing import Optional

import torch

from .ragged_prefill import RaggedPrefillConfig
from .ragged_prefill import ragged_prefill as _ragged_prefill_kernel


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
    """Ragged-prefill attention.  q (Hq, TQ, D) packed queries; k, v
    (Hkv, TK, D) packed KV; seg/pos (TQ,)/(TK,) int32 per-token metadata
    (seg -1 on padding)."""
    cfg = cfg or default_config(int(q.shape[1]), int(k.shape[1]))
    return _ragged_prefill_kernel(q, k, v, seg_q, pos_q, seg_k, pos_k,
                                  cfg=cfg, scale=scale)


def verified_config(total_q: int, total_k: int, n_seqs: int, *,
                    q_heads: int, kv_heads: int, head_dim: int,
                    dtype: str = "bf16",
                    cfg: Optional[RaggedPrefillConfig] = None
                    ) -> Optional[RaggedPrefillConfig]:
    """Config for a serving engine's packed-prefill geometry, or None
    when the blocks cannot tile the buffers — the engine's signal to
    stay on the dense fallback path.  The head geometry, ``n_seqs`` and
    ``dtype`` are what the symbolic gate (not ported yet) reads."""
    cfg = cfg or default_config(total_q, total_k)
    if total_q % cfg.block_q or total_k % cfg.block_q \
            or total_k % cfg.block_kv:
        return None
    return cfg
