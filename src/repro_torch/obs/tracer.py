"""Spans: a zero-cost-when-off tracer with Chrome trace-event export.

A copy of the JAX package's ``obs/tracer.py``.

The tracer is a process-global switch plus a bounded in-memory ring.
``span(name)`` is the only hot-path entry point and is engineered to be
a true no-op while tracing is disabled: the module-level ``ENABLED``
flag is a plain global read, the returned ``_NullSpan`` is a shared
singleton (no allocation, no closure), and attrs default to ``None``
instead of ``**kwargs`` so no dict is materialized per call.

When enabled, each span records ``(name, ts, dur, pid, tid, args)``
into a ``deque(maxlen=capacity)`` ring and exports as Chrome
trace-event JSON (complete ``"ph": "X"`` events, microsecond
timestamps) loadable in Perfetto / ``chrome://tracing``; one event is
shown by ``TRACE_EVENT_EXAMPLE`` below.

The clock is injectable (seconds, monotonic); benchmarks pass a
:class:`TickClock` so two runs emit byte-identical trace files.
"""
import json
import os
import threading
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

TRACE_EVENT_EXAMPLE = {
    "name": "serve.decode_tick",  # span name, dot-namespaced
    "ph": "X",                    # complete event: ts + dur in one record
    "ts": 1250,                   # start, microseconds since enable()
    "dur": 50,                    # duration, microseconds
    "pid": 0,                     # process lane (worker id in the fleet)
    "tid": 0,                     # thread lane (0 unless overridden)
    "args": {"tick": 25},         # span attrs, JSON-safe
}

#: Hot-path switch.  Read directly by :func:`span`; flip only via
#: :func:`enable` / :func:`disable` so the global tracer stays in sync.
ENABLED = False

_DEFAULT_CAPACITY = 65536


class _NullSpan:
    """Shared do-nothing span handed out while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **attrs):  # pragma: no cover - guarded by enabled()
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    """Live span: stamps start on entry, appends one event on exit."""

    __slots__ = ("_tracer", "name", "tid", "attrs", "_t0")

    def __init__(self, tracer, name, tid, attrs):
        self._tracer = tracer
        self.name = name
        self.tid = tid
        self.attrs = attrs

    def set(self, **attrs):
        """Attach late attrs (merged over the ones passed at open)."""
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)
        return self

    def __enter__(self):
        self._t0 = self._tracer._now_us()
        return self

    def __exit__(self, exc_type, exc, tb):
        tr = self._tracer
        tr._events.append((self.name, self._t0,
                           tr._now_us() - self._t0, self.tid, self.attrs))
        return False


class Tracer:
    """Bounded ring of completed spans with Chrome trace-event export.

    ``clock`` returns seconds (monotonic); timestamps are microseconds
    relative to the clock value captured at construction, so traces
    start near ``ts == 0``.  ``pid`` labels the process lane in the
    exported file (the fleet uses worker ids).
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None, *,
                 capacity: int = _DEFAULT_CAPACITY, pid: Optional[int] = None):
        import time
        self._clock = clock or time.perf_counter
        self._epoch = self._clock()
        self._events: deque = deque(maxlen=capacity)
        self.pid = os.getpid() if pid is None else pid

    def _now_us(self) -> int:
        return int((self._clock() - self._epoch) * 1e6)

    def span(self, name: str, attrs: Optional[Dict[str, Any]] = None,
             tid: int = 0) -> _Span:
        return _Span(self, name, tid, attrs)

    def clear(self) -> None:
        self._events.clear()

    def events(self) -> List[Dict[str, Any]]:
        """Completed spans as Chrome trace-event dicts (oldest first)."""
        out = []
        for name, ts, dur, tid, attrs in self._events:
            ev = {"name": name, "ph": "X", "ts": ts, "dur": dur,
                  "pid": self.pid, "tid": tid}
            if attrs:
                ev["args"] = attrs
            out.append(ev)
        return out

    def chrome_trace(self) -> Dict[str, Any]:
        return {"displayTimeUnit": "ms", "traceEvents": self.events()}

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, sort_keys=True)
            f.write("\n")


_GLOBAL: Optional[Tracer] = None
_LOCK = threading.Lock()


def enable(*, clock: Optional[Callable[[], float]] = None,
           capacity: int = _DEFAULT_CAPACITY,
           pid: Optional[int] = None) -> Tracer:
    """Install a fresh global tracer and flip the hot-path flag on."""
    global ENABLED, _GLOBAL
    with _LOCK:
        _GLOBAL = Tracer(clock, capacity=capacity, pid=pid)
        ENABLED = True
    return _GLOBAL


def disable() -> None:
    global ENABLED
    ENABLED = False


def enabled() -> bool:
    return ENABLED


def tracer() -> Optional[Tracer]:
    """The active global tracer (survives :func:`disable` for export)."""
    return _GLOBAL


def span(name: str, attrs: Optional[Dict[str, Any]] = None,
         tid: int = 0):
    """Open a span on the global tracer; a shared no-op when disabled.

    Callers that want to attach computed attrs should guard the
    computation with :func:`enabled` and call ``sp.set(...)`` inside
    the ``with`` block — building an attrs dict at the call site would
    defeat the disabled path's zero-allocation guarantee.
    """
    if not ENABLED:
        return _NULL_SPAN
    return _GLOBAL.span(name, attrs, tid)


class TickClock:
    """Deterministic virtual clock: advances ``step_us`` per reading.

    Benchmarks hand one to both the tracer and the serving engine so
    span ``ts``/``dur`` values and step-time histograms are pure
    functions of the call sequence — byte-identical across reruns.
    Returns seconds, like the real clocks it stands in for.
    """

    __slots__ = ("_now_us", "step_us")

    def __init__(self, step_us: int = 50, start_us: int = 0):
        self._now_us = start_us
        self.step_us = step_us

    def __call__(self) -> float:
        self._now_us += self.step_us
        return self._now_us * 1e-6


def well_nested(events: Iterable[Dict[str, Any]]) -> bool:
    """Check spans on each (pid, tid) lane either nest fully or are
    disjoint — the structural invariant Perfetto's track layout
    assumes.  Events need ``ts``/``dur``/``pid``/``tid`` keys and
    non-negative durations."""
    lanes: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for ev in events:
        ts, dur = ev["ts"], ev["dur"]
        if ts < 0 or dur < 0:
            return False
        lanes.setdefault((ev["pid"], ev["tid"]), []).append((ts, ts + dur))
    for spans in lanes.values():
        # Sort by start asc, end desc: a parent sorts before its
        # children, so a stack discipline must hold exactly.
        spans.sort(key=lambda se: (se[0], -se[1]))
        stack: List[Tuple[int, int]] = []
        for start, end in spans:
            while stack and start >= stack[-1][1]:
                stack.pop()
            if stack and end > stack[-1][1]:
                return False  # partial overlap: neither nested nor disjoint
            stack.append((start, end))
    return True
