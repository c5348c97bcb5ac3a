"""Preemption handling: catch SIGTERM/SIGINT, finish the in-flight step,
checkpoint, and exit cleanly so the scheduler can restart elsewhere — a
copy of the JAX package's ``ft/preemption.py``."""
from __future__ import annotations

import signal
from typing import Callable, Optional


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._requested = False
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._on_signal)
            except ValueError:
                pass  # non-main thread (tests)

    def _on_signal(self, signum, frame):
        self._requested = True

    @property
    def preempted(self) -> bool:
        return self._requested

    def restore(self) -> None:
        for s, h in self._prev.items():
            signal.signal(s, h)
