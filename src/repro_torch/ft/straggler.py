"""Straggler mitigation: per-host step timing, EWMA outlier detection, and
a pluggable action — a copy of the JAX package's ``ft/straggler.py``.

On a multi-host deployment each host feeds its step wall-time into the
monitor (through a key-value store such as ``torch.distributed``'s);
synchronous steps let one slow host gate the fleet.  The monitor flags
hosts whose EWMA exceeds ``threshold ×`` the fleet median; the configured
action fires (log, checkpoint-and-evict, or rebalance via an elastic
restart onto the surviving hosts).

On one host the monitor is exercised by unit tests and the trainer's
local timing; the detection logic is host-count agnostic.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


class StepTimer:
    def __init__(self):
        self._t0: Optional[float] = None
        self.last: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.last = time.perf_counter() - self._t0
        return False


@dataclass
class HostStats:
    ewma: float = 0.0
    n: int = 0


class StragglerMonitor:
    def __init__(self, *, alpha: float = 0.2, threshold: float = 1.5,
                 min_samples: int = 8,
                 action: Optional[Callable[[str, float, float], None]]
                 = None):
        self.alpha = alpha
        self.threshold = threshold
        self.min_samples = min_samples
        self.action = action or self._default_action
        self.hosts: Dict[str, HostStats] = {}
        self.flagged: List[str] = []

    @staticmethod
    def _default_action(host: str, ewma: float, median: float) -> None:
        print(f"[straggler] host={host} ewma={ewma:.3f}s "
              f"fleet_median={median:.3f}s")

    def record(self, host: str, step_time: float) -> None:
        st = self.hosts.setdefault(host, HostStats())
        st.ewma = (step_time if st.n == 0
                   else self.alpha * step_time + (1 - self.alpha) * st.ewma)
        st.n += 1

    def _median(self) -> float:
        vals = sorted(s.ewma for s in self.hosts.values() if s.n > 0)
        return vals[len(vals) // 2] if vals else 0.0

    def check(self) -> List[str]:
        """Returns hosts currently flagged as stragglers."""
        med = self._median()
        out: List[str] = []
        if med <= 0:
            return out
        for host, st in self.hosts.items():
            if st.n >= self.min_samples and st.ewma > self.threshold * med:
                out.append(host)
                self.action(host, st.ewma, med)
        self.flagged = out
        return out
