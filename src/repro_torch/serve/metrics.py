"""Serving metrics: the per-tick health surface of both engines.

The JAX package's ``serve/metrics.py`` (schema v4) plus the port's v5
fields: every v4 field is computed as there, so under a virtual
:class:`~repro_torch.obs.TickClock` the v4 part of a snapshot is
byte-identical to the JAX engine's, and a scraper reads either engine.

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
Schema v5 (the port's) adds the engine's host-time counters, read from
``time.perf_counter`` and never from the injectable clock:
``gate_verifications`` (memo misses that ran the ARGUS gate on the
serving path) and ``gate_us`` (their host microseconds), ``pack_us``
(building and copying a tick's kernel inputs), ``prefill_model_us`` and
``decode_model_us`` (host time inside the model's kernel-path calls,
``prefill_chunk_packed`` and ``decode_step_paged``: the eager enqueue,
and any wait for the device inside them) and ``token_wait_us`` (the
device-to-host read of the tick's tokens); and three
latency histograms in microseconds beside the tick-unit ones:
``queue_wait_us``, ``ttft_us`` and ``tpot_us``.  Schema v6 adds two
counters of the paged engine's kernel decode call on a CUDA device:
``decode_graph_replays`` (calls replayed as the engine's CUDA graph)
and ``decode_graph_captures`` (captures of that graph: one per batch
geometry).  ``from_snapshot`` still loads v2 to v5 snapshots (the JAX
engine's v4 included: missing counters and histograms default to 0 and
empty) and rejects unknown versions with a ``ValueError`` naming the
version.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.obs.hist import LogHistogram

SCHEMA_VERSION = 6

# The snapshot schema, by example: the JAX package's v4 example plus the
# v5 and v6 fields (tests/test_torch_serving.py compares the v4 part).
SCHEMA_EXAMPLE = {
    "schema": 6,
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
        # v5: host microseconds (time.perf_counter), and gate runs
        "gate_verifications": 4,   # serving-path gate runs (memo misses)
        "gate_us": 21000,          # host us in those gate runs
        "pack_us": 900,            # building + copying kernel inputs
        "prefill_model_us": 5200,  # inside the model's prefill calls
        "decode_model_us": 7400,   # inside the model's decode calls
        "token_wait_us": 3100,     # device-to-host reads of tokens
        # v6: the kernel decode call's CUDA graph (paged, on a card)
        "decode_graph_replays": 9,   # decode calls replayed as the graph
        "decode_graph_captures": 1,  # its captures, one a batch geometry
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
        # v5: the first three in microseconds (time.perf_counter)
        "queue_wait_us": {
            "scheme": "log2", "counts": {"0": 4, "12": 2}, "sum": 5000},
        "ttft_us": {
            "scheme": "log2", "counts": {"12": 4, "13": 2}, "sum": 28000},
        "tpot_us": {
            "scheme": "log2", "counts": {"8": 118}, "sum": 21000},
    },
}

#: counters new in schema v6: the kernel decode call's CUDA graph
GRAPH_COUNTERS = ("decode_graph_replays", "decode_graph_captures")
#: counters the engine adds up over a tick and hands to ``record_tick``:
#: v5's gate runs and host time, then v6's
HOST_COUNTERS = ("gate_verifications", "gate_us", "pack_us",
                 "prefill_model_us", "decode_model_us",
                 "token_wait_us") + GRAPH_COUNTERS
_COUNTERS = ("ticks", "admitted", "finished", "preempted",
             "prefill_tokens", "decode_tokens", "gather_bytes",
             "kernel_decode_ticks", "kernel_prefill_ticks",
             "prefill_gather_bytes") + HOST_COUNTERS
# counters new in schema v4: optional (default 0) when loading v2/v3
_V4_COUNTERS = ("kernel_prefill_ticks", "prefill_gather_bytes")
_GAUGES = ("queue_depth", "active", "occupancy")
_V4_LATENCY = ("queue_wait", "ttft", "tpot", "step_time")
_LATENCY = _V4_LATENCY + ("queue_wait_us", "ttft_us", "tpot_us")


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
                    step_time_us: int = 0, gate_verifications: int = 0,
                    gate_us: int = 0, pack_us: int = 0,
                    prefill_model_us: int = 0, decode_model_us: int = 0,
                    token_wait_us: int = 0, decode_graph_replays: int = 0,
                    decode_graph_captures: int = 0) -> None:
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
        c["gate_verifications"] += gate_verifications
        c["gate_us"] += gate_us
        c["pack_us"] += pack_us
        c["prefill_model_us"] += prefill_model_us
        c["decode_model_us"] += decode_model_us
        c["token_wait_us"] += token_wait_us
        c["decode_graph_replays"] += decode_graph_replays
        c["decode_graph_captures"] += decode_graph_captures
        self.latency["step_time"].record(step_time_us)
        g = {"queue_depth": int(queue_depth), "active": int(active),
             "occupancy": int(occupancy)}
        self.gauges = g
        for k, v in g.items():
            self.peaks[k] = max(self.peaks[k], v)

    def record_latency(self, kind: str, value: int, n: int = 1) -> None:
        """``n`` readings of ``value`` in the ``kind`` histogram."""
        self.latency[kind].record(value, n)

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
        if version not in (2, 3, 4, 5, SCHEMA_VERSION):
            raise ValueError(
                f"unsupported metrics schema {version!r} "
                f"(this build reads v2..v{SCHEMA_VERSION})")
        m = cls(snap["capacity"], snap["kind"])
        for group, keys in (("counters", _COUNTERS), ("gauges", _GAUGES),
                            ("peaks", _GAUGES)):
            src = snap[group]
            # counters introduced by v4, v5 and v6 are optional on
            # older snapshots (default 0); nothing outside the schema is
            # ever accepted
            required = set(keys)
            if group == "counters" and version < 6:
                required -= set(GRAPH_COUNTERS)
            if group == "counters" and version < 5:
                required -= set(HOST_COUNTERS)
            if group == "counters" and version < 4:
                required -= set(_V4_COUNTERS)
            if not (required <= set(src) <= set(keys)):
                raise ValueError(f"snapshot {group} keys {sorted(src)} != "
                                 f"schema keys {sorted(keys)}")
            getattr(m, group).update({k: int(src.get(k, 0)) for k in keys})
        if version >= 3:
            src = snap["latency"]
            want = _LATENCY if version >= 5 else _V4_LATENCY
            if set(src) != set(want):
                raise ValueError(f"snapshot latency keys {sorted(src)} != "
                                 f"schema keys {sorted(want)}")
            m.latency.update({k: LogHistogram.from_dict(src[k])
                              for k in want})
        # v2: latency stays at the empty-histogram default; before v5
        # the microsecond histograms do.
        return m
