"""RecurrentGemma / Griffin pieces: RG-LRU recurrent blocks and local
(sliding-window, MQA) attention — the port of the JAX package's
``models/recurrent.py`` — and the depthwise causal convolution that the
Mamba-2 mixer shares.

RG-LRU (arXiv:2402.19427):  with a = σ(Λ), r_t = σ(W_a x_t), i_t = σ(W_x x_t)
    a_t = a^(c·r_t)          (c = 8)
    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ u_t)

A full sequence runs the recurrence as a log-depth scan over time
(:func:`rglru_scan`, the odd/even recursion of ``jax.lax.associative_scan``
in plain torch); decode (one token) is the direct state update.  The
gates, the decay and the state are float32.

Local attention decodes from a ring buffer of ``window`` slots.  Its
``pos`` leaf starts at zeros, as in the JAX package: a slot not yet
written claims position 0 with K = V = 0, passes both masks and dilutes
the softmax until the ring is full (a defect of the reference, kept so
the two agree; ROADMAP section C).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.parallel.api import on_replicated

from . import attention as attn_mod
from .components import (F32, attention_specs, attn_out, dtype_of,
                         gelu_tanh, qkv_project, sdpa)
from .config import ModelConfig
from .params import ParamSpec

C_EXP = 8.0


def rglru_block_specs(cfg: ModelConfig) -> Dict:
    W = cfg.recurrent.lru_width or cfg.d_model
    dt = dtype_of(cfg.dtype)
    cw = cfg.recurrent.conv_width
    return {
        "w_main": ParamSpec((cfg.d_model, W), dt, ("embed", "mlp")),
        "w_gate": ParamSpec((cfg.d_model, W), dt, ("embed", "mlp")),
        "conv": ParamSpec((cw, W), F32, (None, "mlp"), "normal",
                          1.0 / math.sqrt(cw)),
        "conv_b": ParamSpec((W,), F32, ("mlp",), "zeros"),
        "w_a": ParamSpec((W, W), dt, ("mlp", None)),
        "w_x": ParamSpec((W, W), dt, ("mlp", None)),
        "lambda": ParamSpec((W,), F32, (None,), "normal", 1.0),
        "w_out": ParamSpec((W, cfg.d_model), dt, ("mlp", "embed")),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d.  u: (B,S,W); w: (cw,W).  With ``state``
    ((B, cw-1, W), decode) prepends it instead of zero padding; returns
    (out, new_state).  Shifted multiply-adds in float32, as in the JAX
    package: ``F.conv1d`` would run float32 through cuDNN in TF32."""
    cw = w.shape[0]
    if state is None:
        # zeros with u's placements under DTensor
        pad = torch.zeros_like(u[:, :1]).expand(u.shape[0], cw - 1,
                                                u.shape[2])
    else:
        pad = state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)                  # (B, S+cw-1, W)
    out = torch.zeros_like(u, dtype=F32)
    for i in range(cw):
        out = out + full[:, i:i + u.shape[1], :].to(F32) * w[i]
    out = out + b
    new_state = full[:, -(cw - 1):, :] if cw > 1 else pad
    return out.to(u.dtype), new_state


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """e0 o0 e1 o1 ... along dim 1 (``even`` as long as ``odd`` or one
    longer)."""
    n = odd.shape[1]
    both = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([both, even[:, n:]], dim=1)


def _scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of (a, b) pairs along dim 1 under
    (al, bl) ∘ (ar, br) = (al·ar, ar·bl + br), by the odd/even recursion
    of ``jax.lax.associative_scan``: the same products and sums in the
    same order, 2·ceil(log2 S) levels of elementwise steps."""
    S = a.shape[1]
    if S < 2:
        return a, b
    al, bl, ar, br = a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]
    oa, ob = _scan(al * ar, ar * bl + br)               # odd positions
    if S % 2 == 0:
        pa, pb = oa[:, :-1], ob[:, :-1]
    else:
        pa, pb = oa, ob
    na, nb = a[:, 2::2], b[:, 2::2]
    ea = torch.cat([a[:, :1], pa * na], dim=1)          # even positions
    eb = torch.cat([b[:, :1], na * pb + nb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_scan(a: torch.Tensor, bx: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t h_{t−1} + bx_t by a log-depth scan over time.  a, bx:
    (B,S,W); ``h0`` (B,W) is folded into the first step, as in the JAX
    package."""
    if h0 is not None:
        bx = torch.cat([bx[:, :1] + a[:, :1] * h0[:, None], bx[:, 1:]],
                       dim=1)
    return _scan(a, bx)[1]


def apply_rglru_block(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                      state: Optional[Dict] = None
                      ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B,S,D) -> (B,S,D).  ``state``: {"h": (B,W) float32, "conv":
    (B,cw-1,W)} for decode (S == 1); None for a full sequence.  Returns
    the output and the new state (None for a full sequence)."""
    u = x @ p["w_main"]
    gate = gelu_tanh((x @ p["w_gate"]).to(F32))
    conv_state = state["conv"] if state is not None else None
    u, new_conv = _causal_conv(u, p["conv"], p["conv_b"], conv_state)

    uf = u.to(F32)
    r = torch.sigmoid((u @ p["w_a"]).to(F32))
    i = torch.sigmoid((u @ p["w_x"]).to(F32))
    # log σ(Λ) (W,): DTensor has no rule for logsigmoid's backward, so
    # it runs on the replicated parameter's local tensor
    log_a_base = on_replicated(F.logsigmoid, p["lambda"])
    a = torch.exp(C_EXP * r * log_a_base)              # (B,S,W), ≤ 1
    bx = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)

    if state is None:
        h = rglru_scan(a, bx)
        new_state = None
    else:
        h = a * state["h"][:, None, :] + bx            # S == 1 decode
        new_state = {"h": h[:, -1, :], "conv": new_conv}
    y = (h * gate).to(x.dtype)
    return y @ p["w_out"], new_state


def local_attn_specs(cfg: ModelConfig) -> Dict:
    return attention_specs(cfg)


def apply_local_attn(p: Dict, x: torch.Tensor, positions,
                     cfg: ModelConfig, *, cache: Optional[Dict] = None,
                     pos0=0) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Sliding-window MQA.  A full sequence (``cache`` None) attends
    causally within the window; decode writes the token into ring slot
    ``pos0 % window`` (``pos0`` an int or a (B,) tensor), **in place**,
    and attends over the ring by the positions its ``pos`` leaf holds."""
    win = cfg.recurrent.window
    q, k, v = qkv_project(p, x, cfg, positions)
    if cache is None:
        o = sdpa(q, k, v, causal=True, window=win, q_positions=positions)
        return attn_out(p, o), None
    slot = pos0 % win
    attn_mod.cache_update(cache["k"], k, slot, 2)
    attn_mod.cache_update(cache["v"], v, slot, 2)
    B = cache["pos"].shape[0]
    attn_mod.cache_update(cache["pos"], positions.expand(B, 1), slot, 1)
    o = sdpa(q, cache["k"], cache["v"], causal=True, window=win,
             kv_positions=cache["pos"], q_positions=positions)
    return attn_out(p, o), cache


def local_attn_cache_shape(cfg: ModelConfig, batch: int):
    hd = cfg.resolved_head_dim
    win = cfg.recurrent.window
    return {
        "k": ((batch, cfg.n_kv_heads, win, hd), cfg.dtype),
        "v": ((batch, cfg.n_kv_heads, win, hd), cfg.dtype),
        "pos": ((batch, win), "int32"),
    }


def rglru_cache_shape(cfg: ModelConfig, batch: int):
    W = cfg.recurrent.lru_width or cfg.d_model
    cw = cfg.recurrent.conv_width
    return {
        "h": ((batch, W), "float32"),
        "conv": ((batch, cw - 1, W), cfg.dtype),
    }
