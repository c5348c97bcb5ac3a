"""Serving metrics: the per-tick health surface of both engines.

A copy of the JAX package's ``serve/metrics.py``: the snapshot schema v4
below is byte-identical to it, so a scraper reads either engine.

One :class:`ServingMetrics` per engine.  ``record_tick`` is called by
``step()`` exactly once per tick — idle ticks included, so a replayed
arrival trace keeps wall-tick alignment.  Counters are monotonic
(cumulative over the engine's life); gauges are the last tick's values;
peaks are running maxima.  ``snapshot()`` emits the versioned schema
below and ``from_snapshot`` round-trips it, so a scraper can diff
snapshots across ticks without reaching into engine internals.

``capacity`` is the engine's occupancy denominator: decode slots for
the dense engine, usable (non-null) pool pages for the paged one —
``occupancy / capacity`` is the pool-utilization number
``benchmarks/fig_serving.py`` gates on.

Schema v3 adds ``latency``: four mergeable log2 histograms
(:class:`repro_torch.obs.hist.LogHistogram`) recorded by the engines —
queue-wait, TTFT, and TPOT in engine *ticks* (the replay-aligned
virtual clock), per-tick step time in *microseconds* from the engine's
injectable wall clock.  Schema v4 adds the prefill-path counters:
``kernel_prefill_ticks`` (prefill ticks served by the ragged-prefill
kernel, no dense view) and ``prefill_gather_bytes`` (bytes the prefill
path read from the pool — full dense views on the gather/fallback
path, token-granular packed-KV reads on the kernel path).
``from_snapshot`` still loads v2 and v3 snapshots (missing counters
default to 0, latency defaults to empty on v2) and rejects unknown
versions with a ``ValueError`` naming the version.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.obs.hist import LogHistogram

SCHEMA_VERSION = 4

# The snapshot schema, by example — identical to the JAX package's
# (tests/test_torch_serving.py compares the two).
SCHEMA_EXAMPLE = {
    "schema": 4,
    "kind": "paged",            # "dense" | "paged"
    "capacity": 24,             # slots (dense) | usable pages (paged)
    "counters": {               # monotonic, cumulative
        "ticks": 37,
        "admitted": 6,          # requests admitted to the batch
        "finished": 4,          # requests retired
        "preempted": 1,         # pool-pressure evictions (paged only)
        "prefill_tokens": 96,   # prompt tokens written to the cache
        "decode_tokens": 118,   # generated tokens written to the cache
        "gather_bytes": 4096,   # decode-tick dense-view bytes gathered
                                # (kernel-path decode gathers none)
        "kernel_decode_ticks": 9,  # decode ticks served by the paged-
                                   # attention kernel, no dense view
        "kernel_prefill_ticks": 3,    # prefill ticks served by the
                                      # ragged-prefill kernel
        "prefill_gather_bytes": 2048,  # prefill-path pool reads: dense
                                       # views (gather/fallback) or
                                       # packed-KV tokens (kernel)
    },
    "gauges": {                 # last recorded tick
        "queue_depth": 2,
        "active": 3,            # sequences holding cache space
        "occupancy": 14,        # slots / pages in use
    },
    "peaks": {                  # running maxima over all ticks
        "queue_depth": 5,
        "active": 4,
        "occupancy": 19,
    },
    "latency": {                # log2 histograms (repro_torch.obs.hist),
                                # sparse {bucket index: count}
        "queue_wait": {         # submit/requeue -> admission, in ticks
            "scheme": "log2", "counts": {"0": 4, "2": 2}, "sum": 6},
        "ttft": {               # submit -> first generated token, ticks
            "scheme": "log2", "counts": {"2": 4, "3": 2}, "sum": 22},
        "tpot": {               # gap between generated tokens, ticks
            "scheme": "log2", "counts": {"1": 118}, "sum": 118},
        "step_time": {          # step() wall time, microseconds
            "scheme": "log2", "counts": {"7": 37}, "sum": 3700},
    },
}

_COUNTERS = ("ticks", "admitted", "finished", "preempted",
             "prefill_tokens", "decode_tokens", "gather_bytes",
             "kernel_decode_ticks", "kernel_prefill_ticks",
             "prefill_gather_bytes")
# counters new in schema v4: optional (default 0) when loading v2/v3
_V4_COUNTERS = ("kernel_prefill_ticks", "prefill_gather_bytes")
_GAUGES = ("queue_depth", "active", "occupancy")
_LATENCY = ("queue_wait", "ttft", "tpot", "step_time")


class ServingMetrics:
    def __init__(self, capacity: int, kind: str):
        if kind not in ("dense", "paged"):
            raise ValueError(f"kind must be dense|paged, got {kind!r}")
        self.capacity = int(capacity)
        self.kind = kind
        self.counters: Dict[str, int] = {k: 0 for k in _COUNTERS}
        self.gauges: Dict[str, int] = {k: 0 for k in _GAUGES}
        self.peaks: Dict[str, int] = {k: 0 for k in _GAUGES}
        self.latency: Dict[str, LogHistogram] = {k: LogHistogram()
                                                 for k in _LATENCY}

    def record_tick(self, *, queue_depth: int, active: int, occupancy: int,
                    prefill_tokens: int = 0, decode_tokens: int = 0,
                    admitted: int = 0, finished: int = 0,
                    preempted: int = 0, gather_bytes: int = 0,
                    kernel_decode_ticks: int = 0,
                    kernel_prefill_ticks: int = 0,
                    prefill_gather_bytes: int = 0,
                    step_time_us: int = 0) -> None:
        c = self.counters
        c["ticks"] += 1
        c["admitted"] += admitted
        c["finished"] += finished
        c["preempted"] += preempted
        c["prefill_tokens"] += prefill_tokens
        c["decode_tokens"] += decode_tokens
        c["gather_bytes"] += gather_bytes
        c["kernel_decode_ticks"] += kernel_decode_ticks
        c["kernel_prefill_ticks"] += kernel_prefill_ticks
        c["prefill_gather_bytes"] += prefill_gather_bytes
        self.latency["step_time"].record(step_time_us)
        g = {"queue_depth": int(queue_depth), "active": int(active),
             "occupancy": int(occupancy)}
        self.gauges = g
        for k, v in g.items():
            self.peaks[k] = max(self.peaks[k], v)

    def record_latency(self, kind: str, value: int) -> None:
        self.latency[kind].record(value)

    # -- derived ------------------------------------------------------------
    def utilization(self) -> float:
        return self.gauges["occupancy"] / self.capacity

    def peak_utilization(self) -> float:
        return self.peaks["occupancy"] / self.capacity

    def tokens_per_tick(self) -> float:
        t = self.counters["ticks"]
        return ((self.counters["prefill_tokens"]
                 + self.counters["decode_tokens"]) / t) if t else 0.0

    def latency_quantiles(self) -> Dict[str, Dict[str, int]]:
        """Per-kind ``{count, sum, p50, p95, p99}`` — the percentile
        block benchmark reports embed."""
        return {k: self.latency[k].summary() for k in _LATENCY}

    # -- snapshot schema ----------------------------------------------------
    def snapshot(self) -> Dict:
        return {
            "schema": SCHEMA_VERSION,
            "kind": self.kind,
            "capacity": self.capacity,
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "peaks": dict(self.peaks),
            "latency": {k: self.latency[k].to_dict() for k in _LATENCY},
        }

    @classmethod
    def from_snapshot(cls, snap: Dict) -> "ServingMetrics":
        version = snap.get("schema")
        if version not in (2, 3, SCHEMA_VERSION):
            raise ValueError(
                f"unsupported metrics schema {version!r} "
                f"(this build reads v2..v{SCHEMA_VERSION})")
        m = cls(snap["capacity"], snap["kind"])
        for group, keys in (("counters", _COUNTERS), ("gauges", _GAUGES),
                            ("peaks", _GAUGES)):
            src = snap[group]
            # counters introduced by v4 are optional on older snapshots
            # (default 0); nothing outside the schema is ever accepted
            required = set(keys)
            if group == "counters" and version < 4:
                required -= set(_V4_COUNTERS)
            if not (required <= set(src) <= set(keys)):
                raise ValueError(f"snapshot {group} keys {sorted(src)} != "
                                 f"schema keys {sorted(keys)}")
            getattr(m, group).update({k: int(src.get(k, 0)) for k in keys})
        if version >= 3:
            src = snap["latency"]
            if set(src) != set(_LATENCY):
                raise ValueError(f"snapshot latency keys {sorted(src)} != "
                                 f"schema keys {sorted(_LATENCY)}")
            m.latency = {k: LogHistogram.from_dict(src[k]) for k in _LATENCY}
        # v2: latency stays at the empty-histogram default.
        return m
