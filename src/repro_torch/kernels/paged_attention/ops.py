"""Public entry points for paged-attention decode, with the ARGUS gate.

The port of the JAX package's ``kernels/paged_attention/ops.py``.  A
kernel config must pass compile-time validation of the block-table
indirection invariants (the shared :func:`repro_torch.core.verify_engine
.default_engine`, family ``paged_attention``, verified at the step the
CUDA kernel runs) before the kernel may launch: an out-of-range page
mapping, a stale V-path table, a wrong GQA head or an under-covering
page grid is rejected with :class:`InvariantViolation` before any
launch.  :func:`validate_block_tables` adds the concrete runtime checks
the serving path makes before a kernel reads through a block table: the
page range, the mapped length of each row and the absence of null
holes.  Kernel configs come from :func:`default_config`; the fleet
dispatch table is not ported (ROADMAP A7).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...core.families.paged_attention import (PagedAttentionConfig,
                                              PagedAttentionProblem)
from ...core.verify_engine import InvariantViolation, default_engine
from .._build import dtype_name
from .paged_attention import paged_decode as _paged_decode_kernel


def _validate(cfg: PagedAttentionConfig,
              prob: PagedAttentionProblem) -> None:
    res = default_engine().verify("paged_attention", cfg, prob)
    if not res.hard_ok:
        raise InvariantViolation(
            f"ARGUS rejected {cfg.name()} for {prob}:\n{res.render()}")


def default_config(pages_per_seq: int) -> PagedAttentionConfig:
    """Largest page block ≤ 4 that tiles the sequence's page count."""
    bp = 4
    while bp > 1 and pages_per_seq % bp:
        bp //= 2
    return PagedAttentionConfig(block_pages=bp)


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, table: torch.Tensor,
                 lengths: Optional[torch.Tensor] = None, *,
                 cfg: Optional[PagedAttentionConfig] = None,
                 scale=None) -> torch.Tensor:
    """Validated paged decode.  ``lengths`` (B,) masks each sequence's
    scores beyond its logical length (None ⇒ full NP·PS span)."""
    B, Hq, _, D = q.shape
    P, Hkv, PS, _ = k_pages.shape
    NP = int(table.shape[1])
    prob = PagedAttentionProblem(
        batch=int(B), q_heads=int(Hq), kv_heads=int(Hkv),
        seq_kv=NP * int(PS), page_size=int(PS), pool_pages=int(P),
        head_dim=int(D), dtype=dtype_name(q.dtype))
    cfg = cfg or default_config(NP)
    _validate(cfg, prob)
    return _paged_decode_kernel(q, k_pages, v_pages, table, lengths,
                                cfg=cfg, scale=scale)


def paged_decode_pool(q: torch.Tensor, kv_leaves, table: torch.Tensor,
                      lengths: torch.Tensor, *,
                      cfg: Optional[PagedAttentionConfig] = None,
                      scale=None) -> torch.Tensor:
    """Batched serving entry: decode attention straight off one layer's
    page-pool leaves ``{"k": (P, HK, PS, D), "v": ...}``, the engine's
    (B, NP) block tables and the (B,) logical lengths (0 for inactive
    rows — their output is a zero row, never a null-page read)."""
    return paged_decode(q, kv_leaves["k"], kv_leaves["v"], table, lengths,
                        cfg=cfg, scale=scale)


def validate_block_tables(tables, *, model=None, page_size: int,
                          pool_pages: int, q_heads: int = None,
                          kv_heads: int = None, head_dim: int = None,
                          dtype: str = "f32", lengths=None,
                          cfg: Optional[PagedAttentionConfig] = None
                          ) -> Optional[PagedAttentionConfig]:
    """ARGUS gate for a serving engine's block tables.

    ``tables`` is the engine's (batch, pages_per_seq) int array mapping
    logical to physical pages; its contents are range-checked against
    the pool.  Given the head geometry, it builds the family problem for
    this batch geometry and statically verifies the indirection
    invariants of the config (:func:`default_config` unless ``cfg``) at
    the step the kernel runs for ``dtype`` (the pool's type), raising
    :class:`InvariantViolation` on a rejection.  ``lengths``
    (per-sequence logical token counts) adds the mapped-length
    consistency check: each row must map exactly
    ``ceil(length / page_size)`` physical pages as a null-padded prefix
    (physical page 0 is the reserved null page).  A row holding fewer
    pages than its length needs, or more, or a mapped page after a null
    hole, is rejected before any kernel or gather reads through it.

    Head geometry comes from ``model.cfg`` when a model is given; MLA
    caches have no GQA head mapping, so they get the concrete checks
    only.  Returns the verified config (None when only the concrete
    checks apply).
    """
    B, NP = int(tables.shape[0]), int(tables.shape[1])
    t = np.asarray(tables.cpu() if isinstance(tables, torch.Tensor)
                   else tables)
    if t.size and (t.min() < 0 or t.max() >= pool_pages):
        raise InvariantViolation(
            f"block table maps physical page {int(t.max())} outside the "
            f"{pool_pages}-page pool")
    if lengths is not None:
        lens = np.asarray(lengths.cpu() if isinstance(lengths, torch.Tensor)
                          else lengths).astype(np.int64)
        if lens.shape != (B,):
            raise InvariantViolation(
                f"lengths shape {lens.shape} does not match the "
                f"{B}-row block table")
        mapped = (t != 0).sum(axis=1)              # page 0 == null page
        prefix = (t != 0)[:, ::-1].cumsum(axis=1)[:, ::-1] > 0
        holes = ((t == 0) & prefix).any(axis=1)
        need = -(-np.maximum(lens, 0) // page_size)  # ceil
        for b in range(B):
            if holes[b]:
                raise InvariantViolation(
                    f"block table row {b} maps a page after a null hole "
                    f"— logical pages must be a contiguous prefix")
            if int(mapped[b]) != int(need[b]):
                raise InvariantViolation(
                    f"block table row {b} maps {int(mapped[b])} pages "
                    f"but logical length {int(lens[b])} needs "
                    f"{int(need[b])} ({page_size}-token pages)")
    mcfg = getattr(model, "cfg", None)
    if mcfg is not None and getattr(mcfg, "attn_type", None) != "mla":
        q_heads = q_heads or mcfg.n_heads
        kv_heads = kv_heads or mcfg.n_kv_heads
        head_dim = head_dim or mcfg.resolved_head_dim
    if not (q_heads and kv_heads and head_dim):
        return None
    prob = PagedAttentionProblem(
        batch=B, q_heads=int(q_heads), kv_heads=int(kv_heads),
        seq_kv=NP * page_size, page_size=page_size,
        pool_pages=pool_pages, head_dim=int(head_dim), dtype=dtype)
    cfg = cfg or default_config(NP)
    _validate(cfg, prob)
    return cfg
