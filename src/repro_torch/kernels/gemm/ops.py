"""Public entry point for the GEMM family, with the ARGUS gate.

The port of the JAX package's ``kernels/gemm/ops.py``.  A kernel config
must pass compile-time invariant validation (the shared
:func:`repro_torch.core.verify_engine.default_engine`) before the kernel
may launch: a config that mispairs operands, clobbers its accumulator,
or under-covers the output is rejected *here*, with a concrete
counterexample, by :class:`InvariantViolation`.  The engine memoizes
verdicts, so a repeat config revalidates for free.  With no ``cfg``, the
config comes from the installed fleet dispatch table
(:func:`repro_torch.core.tuning.dispatch.configured`: the tuned config
of the problem's shape bucket, verified at the exact problem) and,
failing that, from the shape-adaptive :func:`default_config`.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.families.gemm import GemmConfig, GemmProblem
from ...core.verify_engine import InvariantViolation, default_engine
from ...core.tuning.dispatch import configured
from .._build import dtype_name
from .gemm import gemm

__all__ = ["matmul", "default_config", "InvariantViolation"]


def _validate(cfg: GemmConfig, prob: GemmProblem) -> None:
    res = default_engine().verify("gemm", cfg, prob)
    if not res.hard_ok:
        raise InvariantViolation(
            f"ARGUS rejected {cfg.name()} for {prob}:\n{res.render()}")


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           cfg: Optional[GemmConfig] = None,
           out_dtype=None) -> torch.Tensor:
    """Validated GEMM: C = A @ B with an f32 accumulator, through the
    CUDA kernel on CUDA tensors and the plain version on CPU tensors."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("matmul takes 2-D A and B")
    prob = GemmProblem(m=int(a.shape[0]), n=int(b.shape[1]),
                       k=int(a.shape[1]),
                       dtype=dtype_name(a.dtype))
    cfg = cfg or configured("gemm", prob) \
        or default_config(prob.m, prob.n, prob.k)
    _validate(cfg, prob)
    return gemm(a, b, cfg=cfg, out_dtype=out_dtype)


def default_config(m: int, n: int, k: int) -> GemmConfig:
    """Shape-adaptive default (the harness' tuned configs override
    this); the same rule as the JAX package's."""
    bm = 128 if m >= 128 else max(8, 1 << (m - 1).bit_length())
    bn = 128 if n >= 128 else max(128, n)
    bk = 128 if k >= 128 else max(128, k)
    if m * n <= 256 * 256 and k >= 4096 and (k // bk) % 4 == 0:
        return GemmConfig(bm=bm, bn=min(bn, 128), bk=bk, split_k=4)
    return GemmConfig(bm=bm, bn=bn, bk=bk)
