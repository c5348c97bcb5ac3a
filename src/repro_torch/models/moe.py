"""MoE layer: router + shared experts + capacity-based routed experts.

The port of the JAX package's ``models/moe.py``: plain tensor code
(``torch.einsum``, ``torch.topk``), as XLA computes it there.  The
heavy math is dense per-expert einsums; the only data-dependent motion
is an index-table scatter (E·C ints) and a row gather.  Semantics match
:mod:`repro_torch.kernels.moe` (the same ``compute_dispatch``), whose
grouped-FFN kernel computes the routed experts of one group.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe.moe import compute_dispatch
from repro_torch.parallel.api import constrain_rows, reshape

from .components import F32, apply_ffn, dtype_of, ffn_specs, gelu_tanh
from .config import ModelConfig
from .params import ParamSpec


def moe_specs(cfg: ModelConfig) -> Dict:
    m = cfg.moe
    dt = dtype_of(cfg.dtype)
    dfe = m.d_ff_expert
    s: Dict = {
        "router": ParamSpec((cfg.d_model, m.n_experts), F32,
                            ("embed", None), "normal"),
        "wg": ParamSpec((m.n_experts, cfg.d_model, dfe), dt,
                        ("expert", "embed", "mlp")),
        "wu": ParamSpec((m.n_experts, cfg.d_model, dfe), dt,
                        ("expert", "embed", "mlp")),
        "wd": ParamSpec((m.n_experts, dfe, cfg.d_model), dt,
                        ("expert", "mlp", "embed")),
    }
    if m.router_aux_free:
        s["router_bias"] = ParamSpec((m.n_experts,), F32, (None,), "zeros")
    if m.n_shared:
        s["shared"] = ffn_specs(cfg, d_ff=m.n_shared * dfe)
    return s


def route(p: Dict, x: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (T, D) -> (gates (T,K) f32, idx (T,K) int32, router probs (T,E)
    f32).  The JAX package's ``route`` returns the aux loss in the last
    place; here :func:`load_balance_loss` computes it from the probs,
    only where a caller reads it."""
    m = cfg.moe
    logits = (x.to(F32) @ p["router"]).to(F32)
    probs = torch.softmax(logits, dim=-1)
    select_from = probs
    if m.router_aux_free:
        # DeepSeek aux-free: bias only affects selection, not gate values
        select_from = probs + p["router_bias"][None, :]
    _, idx = torch.topk(select_from, m.top_k, dim=-1)
    gates = torch.gather(probs, -1, idx)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx.to(torch.int32), probs


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing aux loss of one routing (reported even
    when aux-free): E x the dot product of the mean router probability
    and the top-1 share of each expert."""
    me = probs.mean(dim=0)                                     # (E,)
    ce = F.one_hot(idx[:, 0].long(), n_experts).to(F32).mean(dim=0)
    return n_experts * torch.sum(me * ce)


def _act(hg: torch.Tensor, hu: torch.Tensor, cfg: ModelConfig):
    if cfg.ffn_type == "geglu":
        return gelu_tanh(hg) * hu
    return F.silu(hg) * hu


def routed_experts_grouped(p: Dict, x: torch.Tensor, gates: torch.Tensor,
                           idx: torch.Tensor, cfg: ModelConfig
                           ) -> torch.Tensor:
    """GShard-style group-local capacity dispatch.  x: (G, S, D) with the
    group dim = batch rows: every gather/scatter stays inside a group.
    Each expert takes C rows of a group, in the working dtype; pairs
    beyond an expert's capacity are dropped.  Static shapes, as in the
    JAX package: every (token, expert) pair is scattered into its slot,
    a dropped pair into one more slot past the E·C real ones, which is
    thrown away (JAX's ``mode="drop"``), so the same code runs on every
    device and under DTensor."""
    m = cfg.moe
    G, S, D = x.shape
    E, K = m.n_experts, m.top_k
    C = max(8, int(-(-S * K * m.capacity_factor // E) // 8 * 8))
    dest, keep = compute_dispatch(idx, E, C)                   # (G, S, K)
    flat_dest = torch.where(keep, dest, E * C).reshape(G, S * K).long()
    keep = keep.reshape(G, S * K)
    # (G, S*K) tokens of the pairs, and zeros of (G, E*C + 1), each with
    # the rows' placements under DTensor
    tok_of_pair = (torch.zeros_like(flat_dest) + torch.arange(
        S, device=x.device).repeat_interleave(K))
    zeros = torch.zeros_like(flat_dest[:, :1]).expand(
        G, E * C + 1).contiguous()
    slot_tok = torch.scatter(zeros, 1, flat_dest, tok_of_pair)[:, :E * C]
    slot_ok = torch.scatter(zeros, 1, flat_dest, 1)[:, :E * C] > 0

    xr = torch.gather(x, 1, slot_tok[..., None].expand(G, E * C, D))
    xr = xr * slot_ok[..., None].to(x.dtype)
    # under DTensor: the groups' slots stay with their batch rows, each
    # expert's weights meet them there
    xr = reshape(constrain_rows(xr), G, E, C, D)
    hg = torch.einsum("gecd,edf->gecf", xr, p["wg"])
    hu = torch.einsum("gecd,edf->gecf", xr, p["wu"])
    act = _act(hg, hu, cfg)
    y = reshape(constrain_rows(torch.einsum("gecf,efd->gecd", act,
                                            p["wd"])), G, E * C, D)

    # a dropped pair reads the last slot, as in the JAX package; its
    # weight below is 0
    src = torch.clamp(flat_dest, max=E * C - 1)
    pair = torch.gather(y, 1, src[..., None].expand(G, S * K, D))
    pair = pair * (keep[..., None]
                   * gates.reshape(G, S * K)[..., None]).to(pair.dtype)
    return reshape(pair, G, S, K, D).sum(dim=2).to(x.dtype)


def _every_expert(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("td,edf->etf", x, w)`` as einsum computes it (one product
    with the experts' columns side by side, bit for bit), its (E, F)
    split through ``parallel.api.reshape`` so that DTensor can carry it."""
    T, D = x.shape
    E, _, Fd = w.shape
    y = x @ reshape(w.permute(1, 0, 2), D, E * Fd)
    return reshape(y, T, E, Fd).permute(1, 0, 2)


def routed_experts_dense(p: Dict, x: torch.Tensor, gates: torch.Tensor,
                         idx: torch.Tensor, cfg: ModelConfig
                         ) -> torch.Tensor:
    """Decode path (S == 1): every token through every expert, masked
    combine, in float32 (each expert's weights cast up on every call, as
    in the JAX package).  x: (T, D)."""
    m = cfg.moe
    xf = x.to(F32)
    hg = _every_expert(xf, p["wg"].to(F32))
    hu = _every_expert(xf, p["wu"].to(F32))
    act = _act(hg, hu, cfg)
    y = torch.bmm(act, p["wd"].to(F32))                # "etf,efd->etd"
    onehot = (idx[..., None] == torch.arange(
        m.n_experts, device=x.device)).to(F32)
    w = (onehot * gates[..., None]).sum(dim=1)                  # (T, E)
    return torch.einsum("te,etd->td", w, y).to(x.dtype)


def moe_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, router probs (B*S, E), idx (B*S, K)).
    Shared experts run the dense FFN of the config's ``ffn_type``.  The
    serving paths call this and read no aux loss."""
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    gates, idx, probs = route(p, xf, cfg)
    if S == 1:
        out = routed_experts_dense(p, xf, gates, idx, cfg)
    else:
        out = routed_experts_grouped(
            p, x, gates.reshape(B, S, -1), idx.reshape(B, S, -1),
            cfg).reshape(B * S, D)
    if cfg.moe.n_shared:
        out = out + apply_ffn(p["shared"], xf, cfg)
    return out.reshape(B, S, D), probs, idx


def apply_moe(p: Dict, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss), as the JAX package's
    ``apply_moe``."""
    out, probs, idx = moe_forward(p, x, cfg)
    return out, load_balance_loss(probs, idx, cfg.moe.n_experts)
