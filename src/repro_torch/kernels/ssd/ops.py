"""Public SSD entry point with the ARGUS gate.

The port of the JAX package's ``kernels/ssd/ops.py``.  A kernel config
must pass compile-time validation of the family's invariants (the
shared :func:`repro_torch.core.verify_engine.default_engine`) before the
kernel may launch: a config the gate rejects raises
:class:`InvariantViolation`, with the rendered report, before any
launch.  There is no fleet dispatch table in the port yet (ROADMAP A7):
with no ``cfg`` the JAX default ``SSDConfig(chunk=min(128, S))`` is
used.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.families.ssd import SSDConfig, SSDProblem
from ...core.verify_engine import InvariantViolation, default_engine
from .ssd import ssd_chunk_scan

__all__ = ["ssd", "InvariantViolation"]

_DTYPE_NAMES = {"float32": "f32", "bfloat16": "bf16"}


def _validate(cfg: SSDConfig, prob: SSDProblem) -> None:
    res = default_engine().verify("ssd", cfg, prob)
    if not res.hard_ok:
        raise InvariantViolation(
            f"ARGUS rejected {cfg.name()} for {prob}:\n{res.render()}")


def ssd(x: torch.Tensor, da: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, *, cfg: Optional[SSDConfig] = None
        ) -> torch.Tensor:
    """Validated SSD chunk scan, through the CUDA kernel on CUDA tensors
    (three launches: the chunk states, the pass over them in chunk
    order, the chunk scan, with scratch states from the caching
    allocator) and the plain version on CPU tensors.  x: (BH, S, P); da:
    (BH, S) log-decays; Bm, Cm: (BH, S, N) -> y (BH, S, P).  Raises when
    S is not a multiple of the chunk."""
    BH, S, P = x.shape
    name = str(x.dtype).replace("torch.", "")
    prob = SSDProblem(batch_heads=int(BH), seq=int(S),
                      head_dim=int(P), d_state=int(Bm.shape[-1]),
                      dtype=_DTYPE_NAMES.get(name, name))
    cfg = cfg or SSDConfig(chunk=min(128, S))
    _validate(cfg, prob)
    return ssd_chunk_scan(x, da, Bm, Cm, cfg=cfg)
