"""Public flash-attention entry points with the ARGUS gate and a
recompute backward.

The port of the JAX package's ``kernels/flash_attention/ops.py``.  A
kernel config must pass compile-time validation of the family's
invariants (the shared :func:`repro_torch.core.verify_engine
.default_engine`) before the kernel may launch: a config the gate
rejects raises :class:`InvariantViolation`, with the rendered report,
before any launch.  The backward pass saves nothing but q, k and v and
differentiates the plain version ``mha_ref`` on them (FlashAttention-2's
recompute backward; the JAX package's ``custom_vjp``).  With no ``cfg``,
the config comes from the installed fleet dispatch table
(:func:`repro_torch.core.tuning.dispatch.configured`: the tuned config
of the problem's shape bucket, verified at the exact problem) and,
failing that, from the shape-adaptive :func:`default_config` (prefill)
or the kv_splits rule of :func:`mha_decode`.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.families.flash_attention import (FlashAttentionConfig,
                                              FlashAttentionProblem)
from ...core.families.flash_decode import (FlashDecodeConfig,
                                           FlashDecodeProblem)
from ...core.verify_engine import InvariantViolation, default_engine
from ...core.tuning.dispatch import configured
from .._build import dtype_name
from . import ref
from .decode import flash_decode
from .flash_attention import flash_attention

__all__ = ["mha", "mha_decode", "default_config", "InvariantViolation"]

def _validate(cfg: FlashAttentionConfig,
              prob: FlashAttentionProblem) -> None:
    res = default_engine().verify("flash_attention", cfg, prob)
    if not res.hard_ok:
        raise InvariantViolation(
            f"ARGUS rejected {cfg.name()} for {prob}:\n{res.render()}")


def default_config(seq_q: int, seq_kv: int,
                   head_dim: int) -> FlashAttentionConfig:
    bq = 256 if seq_q >= 256 else max(8, seq_q)
    bkv = 128 if seq_kv >= 128 else max(8, seq_kv)
    return FlashAttentionConfig(block_q=bq, block_kv=bkv)


class _Attn(torch.autograd.Function):
    """Forward: the kernel (the plain version on CPU tensors).  Backward:
    the vector-Jacobian product of ``mha_ref`` at the saved q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, cfg, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return flash_attention(q, k, v, cfg=cfg, causal=causal, scale=scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
            o = ref.mha_ref(qd, kd, vd, causal=ctx.causal, scale=ctx.scale)
            dq, dk, dv = torch.autograd.grad(o, (qd, kd, vd), g)
        return dq, dk, dv, None, None, None


def _validate_decode(cfg: FlashDecodeConfig,
                     prob: FlashDecodeProblem) -> None:
    res = default_engine().verify("flash_decode", cfg, prob)
    if not res.hard_ok:
        raise InvariantViolation(
            f"ARGUS rejected {cfg.name()} for {prob}:\n{res.render()}")


def mha_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len,
               *, cfg: Optional[FlashDecodeConfig] = None,
               scale=None) -> torch.Tensor:
    """Validated split-KV decode attention.  q: (B, Hq, 1, D); k, v:
    (B, Hkv, S, D) cache; kv_len: the current length (an int or an int32
    tensor).  The plain version is ``ref.mha_ref(..., causal=False,
    kv_len=kv_len)``."""
    B, Hq, _, D = q.shape
    _, Hkv, S, _ = k.shape
    prob = FlashDecodeProblem(
        batch=int(B), q_heads=int(Hq), kv_heads=int(Hkv), seq_kv=int(S),
        head_dim=int(D), dtype=dtype_name(q.dtype))
    cfg = cfg or configured("flash_decode", prob) or FlashDecodeConfig(
        kv_splits=max(1, min(16, S // max(S // 16, 128))))
    while S % cfg.kv_splits:
        cfg = FlashDecodeConfig(kv_splits=cfg.kv_splits - 1)
    _validate_decode(cfg, prob)
    return flash_decode(q, k, v, kv_len, cfg=cfg, scale=scale)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        cfg: Optional[FlashAttentionConfig] = None, causal: bool = True,
        scale=None) -> torch.Tensor:
    """Validated GQA flash attention, differentiable.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D).  The plain version is
    ``ref.mha_ref``."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    prob = FlashAttentionProblem(
        batch=int(B), q_heads=int(Hq), kv_heads=int(Hkv), seq_q=int(Sq),
        seq_kv=int(Skv), head_dim=int(D), causal=bool(causal),
        dtype=dtype_name(q.dtype))
    cfg = cfg or configured("flash_attention", prob) \
        or default_config(Sq, Skv, D)
    if prob.causal is False and cfg.causal_block_skip:
        cfg = FlashAttentionConfig(cfg.block_q, cfg.block_kv,
                                   cfg.v_transposed_staging, False,
                                   cfg.applies_mask)
    _validate(cfg, prob)
    return _Attn.apply(q, k, v, cfg, causal, scale)
