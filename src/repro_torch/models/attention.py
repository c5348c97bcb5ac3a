"""Attention beyond plain GQA — Multi-head Latent Attention (MLA,
DeepSeek-V2) — and KV-cache plumbing for decode: the port of the JAX
package's ``models/attention.py``.

MLA caches the low-rank latent ``c_kv`` and the shared roped key
``k_rope`` instead of full K/V: kv_lora_rank + qk_rope_dim numbers a
token instead of 2·H·head_dim.  Its cache leaves have no heads axis, so
MLA serves on the gather paths, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict

import torch

from .components import (F32, _heads_proj, attn_out, dtype_of, rope,
                         sdpa)
from .config import ModelConfig
from .params import ParamSpec


def mla_specs(cfg: ModelConfig) -> Dict:
    m = cfg.mla
    dt = dtype_of(cfg.dtype)
    H = cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    s: Dict = {}
    if m.q_lora_rank:
        s["wq_a"] = ParamSpec((cfg.d_model, m.q_lora_rank), dt,
                              ("embed", None))
        s["q_norm"] = {"scale": ParamSpec((m.q_lora_rank,), F32, (None,),
                                          "ones")}
        s["wq_b"] = ParamSpec((m.q_lora_rank, H, qk), dt,
                              (None, "heads", "head_dim"))
    else:
        s["wq"] = ParamSpec((cfg.d_model, H, qk), dt,
                            ("embed", "heads", "head_dim"))
    s["w_dkv"] = ParamSpec((cfg.d_model, m.kv_lora_rank), dt,
                           ("embed", "kv_lora"))
    s["w_kr"] = ParamSpec((cfg.d_model, m.qk_rope_dim), dt, ("embed", None))
    s["kv_norm"] = {"scale": ParamSpec((m.kv_lora_rank,), F32, ("kv_lora",),
                                       "ones")}
    s["w_uk"] = ParamSpec((m.kv_lora_rank, H, m.qk_nope_dim), dt,
                          ("kv_lora", "heads", "head_dim"))
    s["w_uv"] = ParamSpec((m.kv_lora_rank, H, m.v_head_dim), dt,
                          ("kv_lora", "heads", "head_dim"))
    s["wo"] = ParamSpec((H, m.v_head_dim, cfg.d_model), dt,
                        ("heads", "head_dim", "embed"))
    return s


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(F32)
    return (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
            * scale).to(x.dtype)


def mla_latents(p: Dict, x: torch.Tensor, positions, cfg: ModelConfig):
    """x (B, S, D) -> the cached quantities: c_kv (B, S, r), RMS-normed,
    and k_rope (B, S, rope_dim), roped."""
    c_kv = _rms(x @ p["w_dkv"], p["kv_norm"]["scale"], cfg.norm_eps)
    k_r = rope(x @ p["w_kr"], positions, theta=cfg.rope_theta)
    return c_kv, k_r


def mla_attention(p: Dict, x: torch.Tensor, c_kv: torch.Tensor,
                  k_rope: torch.Tensor, positions, cfg: ModelConfig, *,
                  kv_positions=None) -> torch.Tensor:
    """Causal MLA attention.  x: (B, Sq, D) queries; c_kv (B, Skv, r) and
    k_rope (B, Skv, rope_dim) cover the (possibly longer, cached) key
    range.  Per-head keys and values are rebuilt from the latent; the
    score scale is (qk_nope + qk_rope)^-0.5 while V is v_head_dim wide.
    Returns (B, Sq, D)."""
    m = cfg.mla
    H = cfg.n_heads
    if m.q_lora_rank:
        q_lat = _rms(x @ p["wq_a"], p["q_norm"]["scale"], cfg.norm_eps)
        q = _heads_proj(q_lat, p["wq_b"])
    else:
        q = _heads_proj(x, p["wq"])                   # (B, H, Sq, qk)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = rope(q_rope, positions, theta=cfg.rope_theta)
    k_nope = _heads_proj(c_kv, p["w_uk"])             # (B, H, Skv, nope)
    v = _heads_proj(c_kv, p["w_uv"])                  # (B, H, Skv, v_dim)
    B, Skv = k_rope.shape[0], k_rope.shape[1]
    k_r = k_rope[:, None].expand(B, H, Skv, m.qk_rope_dim)
    k = torch.cat([k_nope, k_r.to(k_nope.dtype)], dim=-1)
    qk = torch.cat([q_nope, q_rope], dim=-1)
    o = sdpa(qk, k, v, causal=True, q_positions=positions,
             kv_positions=kv_positions,
             scale=(m.qk_nope_dim + m.qk_rope_dim) ** -0.5)
    return attn_out(p, o)


def mla_cache_shape(cfg: ModelConfig, batch: int, max_len: int):
    return {
        "c_kv": (batch, max_len, cfg.mla.kv_lora_rank),
        "k_rope": (batch, max_len, cfg.mla.qk_rope_dim),
    }


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
