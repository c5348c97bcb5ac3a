"""Public entry point for the quantized GEMM family, with the ARGUS gate.

The port of the JAX package's ``kernels/quant_gemm/ops.py``.  A kernel
config must pass compile-time scale-provenance validation (the shared
:func:`repro_torch.core.verify_engine.default_engine`) before the kernel
may launch: a config that pairs a dequant scale with the wrong K-slice,
row or column is rejected *here*, with a concrete counterexample, by
:class:`InvariantViolation`.  With no ``cfg``, the config comes from the
installed fleet dispatch table
(:func:`repro_torch.core.tuning.dispatch.configured`: the tuned config
of the problem's shape bucket, verified at the exact problem) and,
failing that, from the shape-adaptive :func:`default_config`.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.families.quant_gemm import QuantGemmConfig, QuantGemmProblem
from ...core.verify_engine import InvariantViolation, default_engine
from ...core.tuning.dispatch import configured
from .quant_gemm import quant_gemm

__all__ = ["quant_matmul", "default_config", "InvariantViolation"]

_FP8 = {getattr(torch, n) for n in ("float8_e4m3fn", "float8_e5m2")
        if hasattr(torch, n)}


def _validate(cfg: QuantGemmConfig, prob: QuantGemmProblem) -> None:
    res = default_engine().verify("quant_gemm", cfg, prob)
    if not res.hard_ok:
        raise InvariantViolation(
            f"ARGUS rejected {cfg.name()} for {prob}:\n{res.render()}")


def quant_matmul(a: torch.Tensor, b: torch.Tensor, sa: torch.Tensor,
                 sb: torch.Tensor, *, group: int,
                 cfg: Optional[QuantGemmConfig] = None,
                 out_dtype=torch.float32) -> torch.Tensor:
    """Validated dequantizing GEMM, through the CUDA kernel on CUDA
    tensors and the plain version on CPU tensors.  On the card a config
    that ``families/quant_gemm.py::is_wgmma`` accepts runs on the int8
    wgmma instance (a transpose of B into scratch, then the GEMM), any
    other on the mma.sync instance; the two give the same bits at one
    bk.  An fp8 problem passes the gate (its invariants are the same)
    and the kernel then refuses it: the kernel takes int8 only."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("quant_matmul takes 2-D A and B")
    prob = QuantGemmProblem(m=int(a.shape[0]), n=int(b.shape[1]),
                            k=int(a.shape[1]), group=int(group),
                            dtype="fp8" if a.dtype in _FP8 else "i8")
    cfg = cfg or configured("quant_gemm", prob) \
        or default_config(prob.m, prob.n, prob.k, prob.group)
    _validate(cfg, prob)
    return quant_gemm(a, b, sa, sb, group=group, cfg=cfg,
                      out_dtype=out_dtype)


def default_config(m: int, n: int, k: int, group: int) -> QuantGemmConfig:
    """Shape-adaptive default (the harness' tuned configs override
    this); the same rule as the JAX package's."""
    bk = min(128, group)
    while group % bk:
        bk //= 2
    bm = 128 if m >= 128 else max(32, 1 << (m - 1).bit_length())
    bn = 128
    return QuantGemmConfig(bm=bm, bn=bn, bk=bk)
