"""Shared model components: norms, RoPE, embeddings, dense FFNs, attention.

The port of the JAX package's ``models/components.py`` for the dense
GQA family as qwen3 uses it — RMS norms, qk head-norm, full rotary,
tied float32 embedding, SwiGLU; the other flavours of the JAX config
(layernorm, qkv bias, partial rotary, GeGLU, scaled or untied
embeddings) come with the architectures that use them, and
``TransformerLM`` refuses a config that asks for one.  Pure functions
over (params, activations), with parameter shapes declared by matching
``*_specs`` builders (see params.py).
Tensor layouts match the JAX package: activations (B, S, D), q
(B, Hq, S, hd), k/v (B, Hkv, S, hd).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .params import ParamSpec

F32 = torch.float32
NEG_INF = -1e30


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


# -- norms -------------------------------------------------------------------

def norm_specs(cfg: ModelConfig) -> Dict:
    return {"scale": ParamSpec((cfg.d_model,), F32, ("embed",), "ones")}


def apply_norm(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMS norm in float32, cast back to x's dtype."""
    xf = x.to(F32)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"]).to(x.dtype)


def head_norm_specs(dim: int) -> Dict:
    """Per-head RMS norm (qk_norm)."""
    return {"scale": ParamSpec((dim,), F32, (None,), "ones")}


def apply_head_norm(p: Dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(F32)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


# -- rotary embeddings -------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, *,
         theta: float) -> torch.Tensor:
    """x: (..., S, D) with positions (..., S) or (S,); every channel
    rotates (rotate-half layout)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=F32, device=x.device)
                      / half)
    ang = positions[..., None].to(F32) * freqs          # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    while cos.ndim < x1.ndim:                            # broadcast heads
        cos, sin = cos[..., None, :, :], sin[..., None, :, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- embeddings --------------------------------------------------------------

def embed_specs(cfg: ModelConfig) -> Dict:
    """The tied float32 token table (the unembed is its transpose)."""
    return {"tok": ParamSpec((cfg.padded_vocab, cfg.d_model), F32,
                             ("vocab", None), "embed_normal")}


def embed(p: Dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return p["tok"][tokens.long()].to(dtype_of(cfg.dtype))


def unembed(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """float32 logits (TF32 is off: see repro_torch.device)."""
    logits = torch.matmul(x.to(F32), p["tok"].T)
    if cfg.padded_vocab != cfg.vocab:   # mask pad columns out of softmax
        valid = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab
        logits = torch.where(valid, logits,
                             torch.tensor(NEG_INF, dtype=F32,
                                          device=x.device))
    return logits


# -- dense FFN ---------------------------------------------------------------

def ffn_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict:
    d_ff = d_ff or cfg.d_ff
    dt = dtype_of(cfg.dtype)
    return {
        "wg": ParamSpec((cfg.d_model, d_ff), dt, ("embed", "mlp")),
        "wu": ParamSpec((cfg.d_model, d_ff), dt, ("embed", "mlp")),
        "wd": ParamSpec((d_ff, cfg.d_model), dt, ("mlp", "embed")),
    }


def apply_ffn(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU."""
    return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


# -- GQA attention -----------------------------------------------------------

def attention_specs(cfg: ModelConfig) -> Dict:
    hd = cfg.resolved_head_dim
    dt = dtype_of(cfg.dtype)
    s = {
        "wq": ParamSpec((cfg.d_model, cfg.n_heads, hd), dt,
                        ("embed", "heads", "head_dim")),
        "wk": ParamSpec((cfg.d_model, cfg.n_kv_heads, hd), dt,
                        ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((cfg.d_model, cfg.n_kv_heads, hd), dt,
                        ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((cfg.n_heads, hd, cfg.d_model), dt,
                        ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        s["qnorm"] = head_norm_specs(hd)
        s["knorm"] = head_norm_specs(hd)
    return s


def _heads_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) · w (D, H, e) -> (B, H, S, e) as one matmul."""
    D, H, e = w.shape
    y = x @ w.reshape(D, H * e)                        # (B, S, H·e)
    return y.reshape(x.shape[0], x.shape[1], H, e).transpose(1, 2)


def qkv_project(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor):
    """x: (B, S, D) -> q (B, Hq, S, hd), k/v (B, Hkv, S, hd), roped."""
    q = _heads_proj(x, p["wq"])
    k = _heads_proj(x, p["wk"])
    v = _heads_proj(x, p["wv"])
    if cfg.qk_norm:
        q = apply_head_norm(p["qnorm"], q, cfg.norm_eps)
        k = apply_head_norm(p["knorm"], k, cfg.norm_eps)
    q = rope(q, positions, theta=cfg.rope_theta)
    k = rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def sdpa(q, k, v, *, q_positions, kv_positions=None):
    """Causal masked attention with GQA broadcast — the direct path of the
    JAX package's ``sdpa_xla``: one float32 score rectangle, masked to
    -1e30 where a key's position exceeds the query's, plain softmax.
    (The JAX ``sdpa`` moves to a KV-block scan at 1024+ query tokens; the
    port keeps the direct path at every length.)

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D); q_positions (Sq,) or
    (B, Sq); kv_positions (Skv,) (default ``arange(Skv)``)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, Hkv, g, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.to(F32), k.to(F32)) * D ** -0.5
    kpos = (kv_positions if kv_positions is not None
            else torch.arange(Skv, device=q.device))
    m = q_positions[..., :, None] >= kpos[None, :]     # (B|, Sq, Skv)
    if m.ndim == 2:
        m = m[None]
    m = m[:, None, None, :, :]                         # (B|1,1,1,Sq,Skv)
    s = torch.where(m, s, torch.tensor(NEG_INF, dtype=F32, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(F32))
    return out.reshape(B, Hq, Sq, v.shape[-1]).to(q.dtype)


def attn_out(p: Dict, o: torch.Tensor) -> torch.Tensor:
    """o: (B, H, S, hd) -> (B, S, D)."""
    B, H, S, e = o.shape
    wo = p["wo"]
    return o.transpose(1, 2).reshape(B, S, H * e) @ wo.reshape(H * e, -1)
