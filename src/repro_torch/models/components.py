"""Shared model components: norms, RoPE, embeddings, dense FFNs, attention.

The port of the JAX package's ``models/components.py``, every flavour
its configs use: RMS norm or layernorm (head norms stay RMS), full or
partial rotary, tied or untied float32 embeddings with an optional
sqrt(d_model) scale, SwiGLU, GeGLU or plain GELU FFNs, and GQA
projections with or without qkv biases.  Pure functions over (params,
activations), with parameter shapes declared by matching ``*_specs``
builders (see params.py).
Tensor layouts match the JAX package: activations (B, S, D), q
(B, Hq, S, hd), k/v (B, Hkv, S, hd).
"""
from __future__ import annotations

import math
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

def norm_specs(cfg: ModelConfig, with_bias: Optional[bool] = None) -> Dict:
    bias = cfg.norm_type == "layernorm" if with_bias is None else with_bias
    s = {"scale": ParamSpec((cfg.d_model,), F32, ("embed",), "ones")}
    if bias:
        s["bias"] = ParamSpec((cfg.d_model,), F32, ("embed",), "zeros")
    return s


def apply_norm(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMS norm, or layernorm (the mean subtracted first), in float32,
    cast back to x's dtype."""
    xf = x.to(F32)
    if cfg.norm_type == "layernorm":
        xf = xf - xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"]
    if "bias" in p:
        y = y + p["bias"]
    return y.to(x.dtype)


def head_norm_specs(dim: int) -> Dict:
    """Per-head RMS norm (qk_norm)."""
    return {"scale": ParamSpec((dim,), F32, (None,), "ones")}


def apply_head_norm(p: Dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(F32)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


# -- rotary embeddings -------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float,
         frac: float = 1.0) -> torch.Tensor:
    """x: (..., S, D) with positions (..., S) or (S,), rotate-half layout.
    Partial rotary: only the first ``frac·D`` channels (rounded down to
    even) rotate, with frequencies over that width; the rest pass
    through (stablelm)."""
    D = x.shape[-1]
    rot = int(D * frac)
    rot -= rot % 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=F32, device=x.device)
                      / half)
    ang = positions[..., None].to(F32) * freqs          # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., :half], xr[..., half:]
    while cos.ndim < x1.ndim:                            # broadcast heads
        cos, sin = cos[..., None, :, :], sin[..., None, :, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# -- embeddings --------------------------------------------------------------

def embed_specs(cfg: ModelConfig) -> Dict:
    """The float32 token table, and an untied float32 unembed (d_model,
    V) unless the config ties it to the table's transpose."""
    v = cfg.padded_vocab
    s = {"tok": ParamSpec((v, cfg.d_model), F32, ("vocab", None),
                          "embed_normal")}
    if not cfg.tie_embeddings:
        s["unembed"] = ParamSpec((cfg.d_model, v), F32, (None, "vocab"),
                                 "normal")
    return s


def embed(p: Dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = p["tok"][tokens.long()].to(dtype_of(cfg.dtype))
    if cfg.scale_embed:
        # sqrt(d_model) rounded to x's type first, as the JAX package
        # multiplies by jnp.asarray(sqrt(d_model), x.dtype)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def unembed(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """float32 logits (TF32 is off: see repro_torch.device)."""
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    logits = torch.matmul(x.to(F32), w)
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
    s = {"wu": ParamSpec((cfg.d_model, d_ff), dt, ("embed", "mlp")),
         "wd": ParamSpec((d_ff, cfg.d_model), dt, ("mlp", "embed"))}
    if cfg.ffn_type in ("swiglu", "geglu"):
        s["wg"] = ParamSpec((cfg.d_model, d_ff), dt, ("embed", "mlp"))
    return s


def apply_ffn(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU, GeGLU or plain GELU (tanh-approximated GELU, as the JAX
    package's ``approximate=True``)."""
    if cfg.ffn_type == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wu"])
    elif cfg.ffn_type == "geglu":
        h = F.gelu(x @ p["wg"], approximate="tanh") * (x @ p["wu"])
    else:
        h = F.gelu(x @ p["wu"], approximate="tanh")
    return h @ p["wd"]


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
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((cfg.n_heads, hd), F32, ("heads", "head_dim"),
                            "zeros")
        s["bk"] = ParamSpec((cfg.n_kv_heads, hd), F32,
                            ("kv_heads", "head_dim"), "zeros")
        s["bv"] = ParamSpec((cfg.n_kv_heads, hd), F32,
                            ("kv_heads", "head_dim"), "zeros")
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
    if cfg.qkv_bias:
        # the float32 biases rounded to the activations' type first
        q = q + p["bq"][None, :, None, :].to(q.dtype)
        k = k + p["bk"][None, :, None, :].to(k.dtype)
        v = v + p["bv"][None, :, None, :].to(v.dtype)
    if cfg.qk_norm:
        q = apply_head_norm(p["qnorm"], q, cfg.norm_eps)
        k = apply_head_norm(p["knorm"], k, cfg.norm_eps)
    q = rope(q, positions, theta=cfg.rope_theta, frac=cfg.rope_frac)
    k = rope(k, positions, theta=cfg.rope_theta, frac=cfg.rope_frac)
    return q, k, v


def sdpa(q, k, v, *, q_positions, kv_positions=None, scale=None):
    """Causal masked attention with GQA broadcast — the direct path of the
    JAX package's ``sdpa_xla``: one float32 score rectangle, masked to
    -1e30 where a key's position exceeds the query's, plain softmax.
    (The JAX ``sdpa`` moves to a KV-block scan at 1024+ query tokens; the
    port keeps the direct path at every length.)

    q: (B, Hq, Sq, D); k: (B, Hkv, Skv, D); v: (B, Hkv, Skv, Dv) (Dv
    differs from D in MLA); q_positions (Sq,) or (B, Sq); kv_positions
    (Skv,) (default ``arange(Skv)``); ``scale`` defaults to D^-0.5."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Hkv, g, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.to(F32), k.to(F32)) * scale
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
