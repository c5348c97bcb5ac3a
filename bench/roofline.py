"""Peaks of the chip, and the least time a piece of work could take.

The peaks are NVIDIA's H100 SXM data sheet (dense, no sparsity), as
``chip_smoke.py`` has them.  A configuration's family counts the work
(its ``shape(model)``: ``tick_work`` and ``kernel_work``, e.g.
:mod:`bench.families.decoder`).  The counts are of the work the tokens
*need*, from the configuration and the tokens alone, whatever computes
it: each weight read once a tick in the configuration's type, each
row's keys and values read once at its length, only the top-k experts
of a token multiplied, and the unembedding only for the rows whose
logits the engine reads.  A padded, capacity-dispatched or repeated
computation therefore counts no more than a tight one.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def bound_s(flops: float, n_bytes: float, dtype: str = "bfloat16") -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over HBM's bandwidth."""
    return max(flops / PEAK_FLOPS[dtype], n_bytes / HBM_BYTES_PER_S)
