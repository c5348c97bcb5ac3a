"""KV-cache plumbing for decode: the GQA part of the JAX package's
``models/attention.py`` (MLA is not ported yet: ROADMAP, port item A6).
"""
from __future__ import annotations

import torch

from .config import ModelConfig


def gqa_cache_shape(cfg: ModelConfig, batch: int, max_len: int):
    hd = cfg.resolved_head_dim
    return {
        "k": (batch, cfg.n_kv_heads, max_len, hd),
        "v": (batch, cfg.n_kv_heads, max_len, hd),
    }


def cache_update(cache: torch.Tensor, new: torch.Tensor, pos,
                 axis: int) -> torch.Tensor:
    """Write ``new`` (a length-S slab along ``axis``) into ``cache`` at
    ``pos``, **in place**, and return ``cache``.

    ``pos`` is an int or 0-d tensor (every batch row at the same offset)
    or a (B,) tensor of per-row offsets.  As ``lax.dynamic_update_slice``
    does in the JAX package, each start is clamped to
    ``[0, cache.shape[axis] - S]`` so the slab always fits."""
    S, L = new.shape[axis], cache.shape[axis]
    new = new.to(cache.dtype)
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        B = cache.shape[0]
        start = pos.to(cache.device).long().clamp(0, L - S)
        idx = start[:, None] + torch.arange(S, device=cache.device)
        rows = torch.arange(B, device=cache.device)[:, None]
        c = cache.movedim(axis, 1)                   # (B, L, ...)
        c[rows, idx] = new.movedim(axis, 1)
        return cache
    start = min(max(int(pos), 0), L - S)
    cache.narrow(axis, start, S).copy_(new)
    return cache
