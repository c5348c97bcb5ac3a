"""Shared model components: norms, RoPE, embeddings, dense FFNs, attention.

The port of the JAX package's ``models/components.py``, every flavour
its configs use: RMS norm or layernorm (head norms stay RMS), full or
partial rotary, tied or untied float32 embeddings with an optional
sqrt(d_model) scale, SwiGLU, GeGLU or plain GELU FFNs, GQA
projections with or without qkv biases, and ``sdpa``: causal or not,
with or without a sliding window, on the direct path below 1,024 query
tokens and on the KV-block scan at or above it.  Pure functions over (params,
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

from repro_torch.parallel.api import embed_rows, per_shard_attention, \
    reshape

from .config import ModelConfig
from .params import ParamSpec

F32 = torch.float32
NEG_INF = -1e30


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "int32": torch.int32}[name]


def rounded(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype`` first, as a Python float: a scalar
    operand with the value of ``torch.tensor(v, dtype=dtype)`` that
    copies nothing to the device, so a CUDA graph can capture the op."""
    return torch.tensor(v, dtype=dtype).item()


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
    x = embed_rows(p["tok"], tokens.long()).to(dtype_of(cfg.dtype))
    if cfg.scale_embed:
        # sqrt(d_model) rounded to x's type first, as the JAX package
        # multiplies by jnp.asarray(sqrt(d_model), x.dtype)
        x = x * rounded(math.sqrt(cfg.d_model), x.dtype)
    return x


def unembed(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """float32 logits (TF32 is off: see repro_torch.device)."""
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    logits = torch.matmul(x.to(F32), w)
    if cfg.padded_vocab != cfg.vocab:   # mask pad columns out of softmax
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab
        logits = logits.masked_fill(pad, NEG_INF)
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


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU computed as the JAX package's
    ``jax.nn.gelu(approximate=True)`` computes it: each step in x's own
    type, its constants rounded to that type first.  In bfloat16 that
    gives JAX's values bit for bit; ``F.gelu`` computes in float32 and
    rounds once, which puts many bfloat16 outputs on the other
    neighbour."""
    c = lambda v: rounded(v, x.dtype)
    inner = c(math.sqrt(2 / math.pi)) * (x + c(0.044715) * (x * x * x))
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted type of the two, as JAX's type promotion
    computes a bf16 x float32 product in float32 (the encoder's float32
    frame embeddings meeting bf16 weights); of one type, a plain
    ``x @ w``."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def apply_ffn(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU, GeGLU or plain GELU (tanh-approximated GELU, as the JAX
    package's ``approximate=True``: :func:`gelu_tanh`)."""
    if cfg.ffn_type == "swiglu":
        h = F.silu(matmul(x, p["wg"])) * matmul(x, p["wu"])
    elif cfg.ffn_type == "geglu":
        h = gelu_tanh(matmul(x, p["wg"])) * matmul(x, p["wu"])
    else:
        h = gelu_tanh(matmul(x, p["wu"]))
    return matmul(h, p["wd"])


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
    B, S = x.shape[:2]
    # the (B, S) rows flattened as matmul folds them, through
    # parallel.api.reshape (a cache sharded on its sequence)
    y = matmul(reshape(x, B * S, D), reshape(w, D, H * e))    # (B·S, H·e)
    return reshape(y, B, S, H, e).transpose(1, 2)


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


def sdpa_direct(q, k, v, *, causal: bool, q_positions=None,
                kv_positions=None, scale=None, window: int = 0):
    """Masked attention with GQA broadcast over one float32 score
    rectangle — the JAX package's ``sdpa_xla``.  A key is kept where
    its position is at most the query's (``causal``) or is at least 0
    (not causal), and, with ``window`` > 0, where the query is fewer than
    ``window`` positions past it; the rest score -1e30, so a fully masked
    row takes the mean of V, as in the JAX package.

    q: (B, Hq, Sq, D); k: (B, Hkv, Skv, D); v: (B, Hkv, Skv, Dv) (Dv
    differs from D in MLA); q_positions (Sq,) or (B, Sq) and kv_positions
    (Skv,) or (B, Skv), each ``arange`` by default; ``scale`` defaults
    to D^-0.5."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = reshape(q, B, Hkv, g, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.to(F32), k.to(F32)) * scale
    m = _mask(q_positions, kv_positions, Sq, Skv, causal, window, q)
    s = torch.where(m, s, torch.tensor(NEG_INF, dtype=F32, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(F32))
    return reshape(out, B, Hq, Sq, v.shape[-1]).to(q.dtype)


def _mask(q_positions, kv_positions, Sq, Skv, causal, window, q,
          sentinel: bool = False):
    """(B|1, 1, 1, Sq, Skv) keep-mask of the JAX package's ``sdpa``;
    ``sentinel`` also drops the padding slots (position _PAD_SENTINEL)
    of the KV-block scan.  Positions on ``q``'s device (replicated on
    its mesh under DTensor)."""
    qpos = (q_positions if q_positions is not None
            else torch.arange(Sq, device=q.device))
    kpos = (kv_positions if kv_positions is not None
            else torch.arange(Skv, device=q.device))
    qp = qpos[..., :, None]                            # (..., Sq, 1)
    kp = kpos[..., None, :]                            # (..., 1, Skv)
    m = ((qp >= kp) if causal else (kp >= 0).expand(
        torch.broadcast_shapes(qp.shape, kp.shape)))
    if sentinel:
        m = m & (kp < _PAD_SENTINEL)
    if window:
        m = m & (qp - kp < window)
    if m.ndim == 2:                                    # (Sq, Skv)
        m = m[None]
    return m[:, None, None, :, :]


# Query length at which ``sdpa`` leaves the direct path for the KV-block
# scan, and the scan's block, as in the JAX package: no (Sq, Skv) score
# tensor is built past it (at 4,096 tokens and 10 heads a float32
# rectangle is 671 MB a batch row).
FLASH_SDPA_THRESHOLD = 1024
SDPA_KV_CHUNK = 512
_PAD_SENTINEL = 1 << 30


def sdpa_flash(q, k, v, *, causal: bool, q_positions=None,
               kv_positions=None, scale=None, window: int = 0,
               kv_chunk: int = SDPA_KV_CHUNK):
    """Online-softmax attention over KV blocks of ``kv_chunk`` — the JAX
    package's ``sdpa_flash_xla``, a Python loop over the blocks in place
    of ``lax.scan``, carrying the running max, sum and accumulator in
    float32.  Skv must be a multiple of ``kv_chunk`` (``sdpa`` pads).
    As in the JAX package, the scores are float32 sums of the storage
    type's exact products, p is rounded to V's type before P·V, and a
    fully masked row gives zeros."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    if Skv % kv_chunk:
        raise ValueError(f"Skv {Skv} is no multiple of {kv_chunk}")
    qg = reshape(q, B, Hkv, g, Sq, D).to(F32)
    qpos = (q_positions if q_positions is not None
            else torch.arange(Sq, device=q.device))
    kpos = (kv_positions if kv_positions is not None
            else torch.arange(Skv, device=q.device))
    neg = torch.tensor(NEG_INF, dtype=F32, device=q.device)
    # the running state takes the queries' placements under DTensor
    m = torch.full_like(qg[..., :1], NEG_INF)
    l = torch.zeros_like(qg[..., :1])
    acc = l.expand(B, Hkv, g, Sq, Dv)
    for c0 in range(0, Skv, kv_chunk):
        kb = k[:, :, c0:c0 + kv_chunk].to(F32)
        vb = v[:, :, c0:c0 + kv_chunk]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kb) * scale
        mask = _mask(qpos, kpos[..., c0:c0 + kv_chunk], Sq, kv_chunk,
                     causal, window, q, sentinel=True)
        s = torch.where(mask, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhgqk,bhkd->bhgqd", p.to(vb.dtype).to(F32), vb.to(F32))
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    return reshape(acc / l, B, Hq, Sq, Dv).to(q.dtype)


def sdpa(q, k, v, *, causal: bool, q_positions=None, kv_positions=None,
         scale=None, window: int = 0):
    """Scaled dot-product attention, dispatched as in the JAX package:
    below FLASH_SDPA_THRESHOLD query tokens the direct path
    (:func:`sdpa_direct`), at or above it the KV-block scan
    (:func:`sdpa_flash`) over KV padded to a multiple of SDPA_KV_CHUNK
    with sentinel positions that every mask rejects.  Arguments as
    :func:`sdpa_direct`'s.  Under DTensor each rank attends over its own
    batch rows and heads (``parallel.api.per_shard_attention``)."""
    return per_shard_attention(_sdpa, q, k, v, causal=causal,
                               q_positions=q_positions,
                               kv_positions=kv_positions, scale=scale,
                               window=window)


def _sdpa(q, k, v, *, causal: bool, q_positions=None, kv_positions=None,
          scale=None, window: int = 0):
    Sq, Skv = q.shape[2], k.shape[2]
    kw = dict(causal=causal, q_positions=q_positions, scale=scale,
              window=window)
    if Sq < FLASH_SDPA_THRESHOLD:
        return sdpa_direct(q, k, v, kv_positions=kv_positions, **kw)
    pad = (-Skv) % SDPA_KV_CHUNK
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        kp = (kv_positions if kv_positions is not None
              else torch.arange(Skv, device=q.device))
        kv_positions = torch.cat(
            [kp, torch.full(kp.shape[:-1] + (pad,), _PAD_SENTINEL,
                            dtype=kp.dtype, device=kp.device)], dim=-1)
    return sdpa_flash(q, k, v, kv_positions=kv_positions, **kw)


def attn_out(p: Dict, o: torch.Tensor) -> torch.Tensor:
    """o: (B, H, S, hd) -> (B, S, D)."""
    B, H, S, e = o.shape
    wo = p["wo"]
    return matmul(reshape(o.transpose(1, 2), B, S, H * e),
                  reshape(wo, H * e, wo.shape[-1]))
