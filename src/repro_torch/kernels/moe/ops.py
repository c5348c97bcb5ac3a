"""Full fused-MoE layer op: route → dispatch → grouped FFN kernel →
combine, with the ARGUS gate on the kernel config.

The port of the JAX package's ``kernels/moe/ops.py``.  A kernel config
must pass compile-time validation of the family's invariants (the shared
:func:`repro_torch.core.verify_engine.default_engine`) before the kernel
may launch: a config the gate rejects raises
:class:`InvariantViolation`, with the rendered report, before any
launch.  With no ``cfg``, the config comes from the installed fleet
dispatch table (:func:`repro_torch.core.tuning.dispatch.configured`: the
tuned config of the problem's shape bucket, verified at the exact
problem) and, failing that, from the shape-adaptive
:func:`default_config`.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.families.moe import MoEConfig, MoEProblem, capacity_for
from ...core.verify_engine import InvariantViolation, default_engine
from ...core.tuning.dispatch import configured
from .._build import dtype_name
from .moe import compute_dispatch, grouped_ffn

__all__ = ["moe_ffn", "capacity_for", "default_config",
           "InvariantViolation"]


def _validate(cfg: MoEConfig, prob: MoEProblem) -> None:
    res = default_engine().verify("moe", cfg, prob)
    if not res.hard_ok:
        raise InvariantViolation(
            f"ARGUS rejected {cfg.name()} for {prob}:\n{res.render()}")


def default_config(d_model: int, d_ff: int) -> MoEConfig:
    """The JAX package's default: 64-row token blocks and the largest
    d_ff block of at most 512 that divides d_ff (at least 128 when
    d_ff is a multiple of 128, else all of d_ff)."""
    bf = 512
    while d_ff % bf:
        bf //= 2
    bt = 64
    return MoEConfig(block_t=bt, block_f=max(bf, 128) if d_ff % 128 == 0
                     else d_ff)


def moe_ffn(x: torch.Tensor, gates: torch.Tensor, expert_idx: torch.Tensor,
            wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor, *,
            cfg: Optional[MoEConfig] = None,
            capacity_factor: float = 1.25) -> torch.Tensor:
    """Fused MoE feed-forward.

    x: (T, DM); gates: (T, K) f32; expert_idx: (T, K) int;
    wg, wu: (E, DM, DF); wd: (E, DF, DM).  Returns (T, DM) in x's dtype.
    Tokens above expert capacity are dropped (contribute zero), the
    GShard/Switch convention; the dense oracle ``moe_ffn_ref`` is
    capacity-free, so layer tests compare through ``compute_dispatch``'s
    keep mask.  The JAX package scatters every pair and lets
    ``mode="drop"`` discard the dropped ones; here the dropped pairs are
    masked out of the scatter explicitly."""
    T, DM = x.shape
    E, _, DF = wg.shape
    K = gates.shape[1]
    prob = MoEProblem(tokens=int(T), d_model=int(DM), d_ff=int(DF),
                      n_experts=int(E), top_k=int(K),
                      dtype=dtype_name(x.dtype))
    cfg = cfg or configured("moe", prob) or default_config(DM, DF)
    _validate(cfg, prob)
    C = capacity_for(T, K, E, cfg.block_t, capacity_factor)

    dest, keep = compute_dispatch(expert_idx, E, C)          # (T, K)
    flat_dest = dest.reshape(-1).long()
    flat_keep = keep.reshape(-1)
    kept = torch.nonzero(flat_keep).squeeze(1)
    tok_of_pair = torch.arange(T, device=x.device).repeat_interleave(K)

    # dispatch: scatter the kept pairs' token rows into (E*C, DM) slots
    x_routed = torch.zeros(E * C, DM, dtype=x.dtype, device=x.device)
    x_routed[flat_dest[kept]] = x[tok_of_pair[kept]]
    g_routed = torch.zeros(E * C, 1, dtype=torch.float32, device=x.device)
    g_routed[flat_dest[kept]] = gates.reshape(-1, 1).to(torch.float32)[kept]

    y_routed = grouped_ffn(
        x_routed.reshape(E, C, DM), wg, wu, wd,
        g_routed.reshape(E, C, 1), cfg=cfg)

    # combine: gather each (token, slot) pair's output and sum over slots;
    # gate scaling already applied in the kernel epilogue when fused
    y_flat = y_routed.reshape(E * C, DM)
    pair_out = torch.where(flat_keep[:, None], y_flat[flat_dest],
                           torch.zeros((), dtype=x.dtype, device=x.device)
                           ).to(torch.float32)
    if not cfg.fuse_gate:
        pair_out = pair_out * gates.reshape(-1, 1).to(torch.float32)
    out = pair_out.reshape(T, K, DM).sum(dim=1)
    return out.to(x.dtype)
