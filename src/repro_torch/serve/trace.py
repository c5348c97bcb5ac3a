"""Seeded arrival traces and the request-level replay driver.

A copy of the JAX package's ``serve/trace.py``: the same seed gives the
same arrivals in both packages.

A trace is a list of :class:`Arrival` events — (tick, request) pairs
drawn from a seeded generator, so the same seed always yields the same
workload (``benchmarks/fig_serving.py`` relies on this for its
byte-identical report gate).  Two arrival models:

* :func:`poisson_trace` — independent exponential inter-arrival gaps,
  the steady "millions of users" open-loop load model;
* :func:`bursty_trace` — idle gaps punctuated by back-to-back bursts,
  the pathological queue-depth / preemption stressor.

:func:`replay` feeds a trace through either engine tick-by-tick and
returns per-request latency (ticks from arrival to retirement), the
token streams, and the engine's final metrics snapshot.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from .engine import Request


@dataclass(frozen=True)
class Arrival:
    tick: int
    rid: int
    prompt: Tuple[int, ...]
    max_new_tokens: int
    trace_id: str = ""       # span correlation id; defaults to req-<rid>

    def request(self) -> Request:
        return Request(self.rid, list(self.prompt),
                       max_new_tokens=self.max_new_tokens,
                       trace_id=self.trace_id or f"req-{self.rid}")


def _prompts(rng, n, prompt_lens, max_new, vocab):
    lo, hi = prompt_lens
    nlo, nhi = max_new
    return [(tuple(int(t) for t in rng.integers(2, vocab, size=int(
        rng.integers(lo, hi + 1)))), int(rng.integers(nlo, nhi + 1)))
        for _ in range(n)]


def poisson_trace(*, seed: int, n_requests: int, mean_gap: float,
                  prompt_lens=(4, 24), max_new=(4, 12),
                  vocab: int = 256) -> List[Arrival]:
    """Open-loop Poisson arrivals: exponential gaps of mean ``mean_gap``
    ticks between consecutive requests."""
    rng = np.random.default_rng(seed)
    bodies = _prompts(rng, n_requests, prompt_lens, max_new, vocab)
    t, out = 0.0, []
    for rid, (prompt, mnt) in enumerate(bodies):
        t += rng.exponential(mean_gap)
        out.append(Arrival(int(t), rid, prompt, mnt,
                           trace_id=f"poisson{seed}-r{rid}"))
    return out


def bursty_trace(*, seed: int, n_bursts: int, burst_size: int,
                 burst_gap: int, prompt_lens=(4, 24), max_new=(4, 12),
                 vocab: int = 256) -> List[Arrival]:
    """``n_bursts`` bursts of ``burst_size`` simultaneous arrivals,
    ``burst_gap`` idle ticks apart — deep queues and pool pressure."""
    rng = np.random.default_rng(seed)
    bodies = _prompts(rng, n_bursts * burst_size, prompt_lens, max_new,
                      vocab)
    out = []
    for rid, (prompt, mnt) in enumerate(bodies):
        out.append(Arrival((rid // burst_size) * burst_gap, rid, prompt,
                           mnt, trace_id=f"burst{seed}-r{rid}"))
    return out


def replay(engine, trace: List[Arrival], *, max_ticks: int = 100_000
           ) -> Dict:
    """Drive ``engine`` through ``trace`` one tick at a time.

    Returns {"latency": {rid: ticks}, "outputs": {rid: tokens},
    "ticks": total, "metrics": snapshot} — everything a deterministic
    function of (engine config, trace).
    """
    pending = sorted(trace, key=lambda a: (a.tick, a.rid))
    arrived_at = {a.rid: a.tick for a in pending}
    latency: Dict[int, int] = {}
    seen = 0
    t = 0
    while t < max_ticks:
        while pending and pending[0].tick <= t:
            engine.submit(pending.pop(0).request())
        engine.step()
        for req in engine.finished[seen:]:
            latency[req.rid] = t - arrived_at[req.rid]
        seen = len(engine.finished)
        if not pending and not engine.queue and _idle(engine):
            break
        t += 1
    return {
        "ticks": t + 1,
        "latency": dict(sorted(latency.items())),
        "outputs": {r.rid: list(r.output)
                    for r in sorted(engine.finished, key=lambda r: r.rid)},
        "errors": {r.rid: r.error for r in engine.finished if r.error},
        "metrics": engine.metrics.snapshot(),
    }


def _idle(engine) -> bool:
    if hasattr(engine, "slots"):
        return all(s.req is None for s in engine.slots)
    return not engine.active


def percentile(values: List[int], q: float) -> int:
    """Nearest-rank percentile over ints — float-free, so reports are
    byte-stable across platforms."""
    if not values:
        return 0
    v = sorted(values)
    k = max(0, min(len(v) - 1, int(np.ceil(q / 100.0 * len(v))) - 1))
    return int(v[k])
