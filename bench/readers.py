"""The arithmetic the metric readers share.

Each metric has a reader of its own, ``bench/metrics/<name>.py``, whose
``read(run)`` takes a :class:`bench.harness.Run` and returns the value,
or None where the run holds nothing to read (the harness then leaves
the metric out of the result).  Span readers take the window's ticks
outside the profiled stretch, whose host times the profiler inflates.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from bench import roofline


def _ticks(run) -> List[dict]:
    return [t for t in run.ticks if not t["profiled"]]


# -- end to end -------------------------------------------------------------------

def setup_s(run) -> float:
    return run.setup_s


def output_tokens_per_s(run) -> Optional[float]:
    n = sum(t["tokens"] for t in run.ticks)
    return n / run.window_s if n and run.window_s > 0 else None


def prompt_tokens_per_s(run) -> Optional[float]:
    n = sum(t["prefill_tokens"] for t in run.ticks)
    return n / run.window_s if n and run.window_s > 0 else None


def token_gaps_s(run) -> List[float]:
    """Every gap between consecutive tokens of a request, both inside
    the window."""
    gaps = []
    for times in run.token_times.values():
        t = np.asarray([x for x in times if x > run.window_open])
        gaps.extend(np.diff(t).tolist())
    return gaps


def tpot_p95_ms(run) -> Optional[float]:
    gaps = token_gaps_s(run)
    return float(np.percentile(gaps, 95)) * 1e3 if gaps else None


# -- spans --------------------------------------------------------------------------

def engine_self_ms(run) -> Optional[float]:
    """A tick's wall time less its time in the model's calls, the wait
    for their tokens and the gate's ``verify`` (each a child span), and
    the wrappers' own reads; mean over the ticks."""
    ticks = [t for t in _ticks(run) if t["model"]]
    if not ticks:
        return None
    self_s = [t["t1"] - t["t0"] - sum(e + w for _, e, w in t["model"])
              - t["gate_s"] - t["instr_s"] for t in ticks]
    return float(np.mean(self_s)) * 1e3


def gate_ms_per_tick(run) -> Optional[float]:
    ticks = _ticks(run)
    if not ticks or not run.trace:
        return None
    return sum(t["gate_s"] for t in ticks) / len(ticks) * 1e3


def model_enqueue_ms(run, kind: str) -> Optional[float]:
    """Host time inside the model's ``kind`` call, mean over the ticks
    that made one."""
    calls = [e for t in _ticks(run) for k, e, _ in t["model"] if k == kind]
    return float(np.mean(calls)) * 1e3 if calls else None


def mfu(run) -> Optional[float]:
    """The step's share of the chip's peak: the least time the ticks'
    needed work could take (the family's ``shape.tick_work``) over the
    ticks' wall time, in %."""
    ticks = [t for t in _ticks(run) if t["model"]]
    if not ticks:
        return None
    need = sum(roofline.bound_s(*run.shape.tick_work(
        decode_lengths=t["decode_lengths"],
        prefill_spans=t["prefill_spans"],
        logits_rows=len(t["decode_lengths"]) + len(t["prefill_spans"])),
        run.shape.dtype) for t in ticks)
    wall = sum(t["t1"] - t["t0"] for t in ticks)
    return 100.0 * need / wall


# -- the device trace -----------------------------------------------------------------

PAGED_DECODE = ("paged_decode", "paged_combine", "decode_bf16_panel",
                "decode_f32_panel")
RAGGED_PREFILL = ("ragged_", "prefill_bf16_panel", "prefill_f32_panel")


def kernel_roofline(run, names, work_of) -> Optional[float]:
    """Σ over the profiled stretch's calls of a kernel of the least time
    their work needs, over the kernel's device time there, in %.
    ``work_of(tick)``: the (FLOPs, bytes) of all the kernel's calls in
    that tick, or None where the tick made none."""
    p = run.profile
    if p is None or not p["kept"]:
        return None
    dev_s = sum(e - s for n, s, e in p["device"]
                if any(k in n for k in names)) / 1e6
    need = 0.0
    for t in run.ticks:
        w = work_of(t) if t["profiled"] else None
        if w is not None:
            need += roofline.bound_s(*w, run.shape.dtype)
    return 100.0 * need / dev_s if dev_s > 0 and need > 0 else None


def paged_decode_roofline(run) -> Optional[float]:
    return kernel_roofline(
        run, PAGED_DECODE,
        lambda t: run.shape.kernel_work("paged_decode", t))


def ragged_prefill_roofline(run) -> Optional[float]:
    return kernel_roofline(
        run, RAGGED_PREFILL,
        lambda t: run.shape.kernel_work("ragged_prefill", t))


def busy_s(profile) -> float:
    """Seconds in which some device operation ran (the union of the
    stretch's device intervals)."""
    busy, end = 0.0, None
    for _, s, e in sorted(profile["device"], key=lambda x: x[1]):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e6


def device_idle(run) -> Optional[float]:
    p = run.profile
    if p is None or not p["kept"] or p["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - busy_s(p) / p["wall_s"])
