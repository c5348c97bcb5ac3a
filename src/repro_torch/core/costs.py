"""Analytic H100 cost-model primitives — shared by every kernel family.

The harness' "runtime profile" is napkin math: ``time = max(compute term,
memory term)``, so the planner can rank thousands of configs without
running one.  The family-specific estimators live with their families in
:mod:`repro_torch.core.families`; this module holds the hardware model
constants and the shared grain / wave-quantisation helpers, so family
modules depend only on :mod:`repro_torch.core` (no harness import cycle).

All constants are model parameters of an NVIDIA H100 SXM (data-sheet
rates), not measurements — they give the planner a landscape with real
trade-offs.  What the card really does with a config is measured by
``chip_smoke.py``, which prints this model's estimate beside the
measured time.
"""
from __future__ import annotations

from dataclasses import dataclass

from .kernelspec import N_SMS, cdiv

# dense peak rates of an H100 SXM (model parameters): bf16 on the tensor
# cores, f32 as FMAs on the CUDA cores (the port keeps TF32 off)
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
HBM_BW = 3.35e12       # HBM3 bytes/s (model parameter)
STAGGER_DERATE = 0.75  # unstaggered streaming keeps ~75% of HBM bw (model)
SCALAR_PATH_DERATE = 0.5  # masked scalar loads instead of 16-byte copies

# Narrow-dtype tensor-core rate multiplier: int8/fp8 operands run at twice
# the bf16 rate (model parameter); the quantized families' compute term
# divides by ``peak_flops(dtype)``.
QUANT_FACTOR = {"i8": 2.0, "fp8": 2.0}


def peak_flops(dtype: str = "bf16") -> float:
    """Dense peak for the operand dtype (model parameter)."""
    if dtype == "f32":
        return PEAK_FLOPS["f32"]
    return PEAK_FLOPS["bf16"] * QUANT_FACTOR.get(dtype, 1.0)


def grain_util(tile, cta, k_chunk: int) -> float:
    """Fraction of the issued tensor-core work that is useful for one
    config tile (rows, cols, depth) run on CTAs of ``cta`` = (rows, cols)
    over ``k_chunk``-deep stages: masked rows, columns and zero-filled
    depth are issued all the same."""
    pad = lambda x, q: x / (cdiv(x, q) * q)
    rows, cols, depth = tile
    return max(pad(rows, cta[0]) * pad(cols, cta[1]) * pad(depth, k_chunk),
               0.05)


def wave_eff(n_ctas: int, per_sm: int) -> float:
    """Wave quantisation over the 132 SMs: the last wave of CTAs leaves
    slots idle, and a grid smaller than one wave leaves SMs idle."""
    slots = N_SMS * per_sm
    waves = cdiv(max(n_ctas, 1), slots)
    return max(n_ctas, 1) / (waves * slots)


@dataclass
class CostEstimate:
    compute_s: float
    memory_s: float
    flops: float
    hbm_bytes: float

    @property
    def time_s(self) -> float:
        return max(self.compute_s, self.memory_s)

    @property
    def bound(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"

    def tflops(self) -> float:
        return self.flops / self.time_s / 1e12 if self.time_s else 0.0


def sol_estimate(flops: float, hbm_bytes: float,
                 dtype: str = "bf16") -> CostEstimate:
    """Speed-of-light :class:`CostEstimate`: the config-independent roofline
    floor for a problem.  ``flops`` is the ideal algorithmic work and
    ``hbm_bytes`` the minimal one-pass HBM traffic (each operand read once,
    each output written once) — no grain, wave, stagger or revisit
    derates, so for any real config the family ``cost`` hook's
    ``time_s`` is ≥ this estimate's."""
    return CostEstimate(compute_s=flops / peak_flops(dtype),
                        memory_s=hbm_bytes / HBM_BW,
                        flops=flops, hbm_bytes=hbm_bytes)
