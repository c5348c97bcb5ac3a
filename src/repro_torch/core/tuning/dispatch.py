"""Versioned serving dispatch table — the fleet tuner's output artifact
(the port of the JAX package's ``core/tuning/dispatch.py``).

``dispatch_table.json`` maps family -> problem-shape bucket -> the
winning verified config plus its provenance (which verification stages
fired during tuning, repair count, cost-model estimate, budget reached).
The serving and launch paths consult *this* table — not the raw
``tuning_cache.json`` — via :func:`install`/:func:`configured`: each
validated kernel entry point (:mod:`repro_torch.kernels`' per-family ``ops``)
asks ``configured(family, prob)`` before falling back to its
shape-adaptive default config.

Shape buckets coarsen exact problems so one tuned entry serves nearby
shapes: integer fields round *up* to the next power of two, everything
else (dtype, flags) is kept verbatim.  Lookup buckets the runtime
problem the same way, so any problem in the bucket resolves to the entry
tuned for the bucket's representative.

The table is deterministic given (jobs, seeds): entries are built from
the reconciled synchronous-schedule selection only
(:func:`repro_torch.core.tuning.scheduler.reconcile_schedule` — never from
speculative async extras, wall-clock or worker ids) and serialized with
sorted keys, which is what the ``--workers 1`` vs ``--workers 4`` and
sync-vs-``--async`` bitwise-identity checks of
``tests/test_torch_tuning_fleet.py`` and ``chip_smoke.py``'s tune phase
assert.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterable, Optional

from ..families import get_family
from ..fslock import locked, merge_save, replace_file

VERSION = 1

# One complete, valid dispatch-table document (the JAX package's, verbatim;
# tests/test_torch_tuning.py feeds it through validate()).
SCHEMA_EXAMPLE = {
    "version": 1,
    "entries": {
        "gemm": {
            "m=8192,n=8192,k=8192,dtype=bf16": {
                "config": {"bm": 256, "bn": 256, "bk": 512, "split_k": 1,
                           "stagger_k": True, "precision": "f32"},
                "problem": {"m": 8192, "n": 8192, "k": 8192,
                            "dtype": "bf16"},
                "est_ms": 6.01, "baseline_ms": 7.45, "speedup": 1.24,
                "provenance": {
                    "job": "gemm:m=8192,n=8192,k=8192,dtype=bf16",
                    "seed": 1234567890,
                    "rungs": 3, "budget": 14, "cost_units": 126.0,
                    "accepted": 4, "repairs": 0,
                    "verdict_stages": {"ok": 9, "solver": 2,
                                       "structural": 3},
                    "sol_frac": 0.94,
                },
            },
        },
    },
}


def shape_bucket(prob) -> str:
    """Problem-shape bucket key: ints round up to a power of two, other
    fields verbatim — deterministic and family-agnostic (any problem
    dataclass works)."""
    parts = []
    for f in dataclasses.fields(prob):
        v = getattr(prob, f.name)
        if isinstance(v, bool):
            parts.append(f"{f.name}={int(v)}")
        elif isinstance(v, int):
            b = v if v <= 1 else 1 << (v - 1).bit_length()
            parts.append(f"{f.name}={b}")
        else:
            parts.append(f"{f.name}={v}")
    return ",".join(parts)


def validate(data) -> dict:
    """Schema check; raises ``ValueError`` with the offending path.
    Every config must reconstruct through its family's ``config_cls`` —
    a table naming unknown families or stale knobs is rejected here, not
    at serve time."""
    if not isinstance(data, dict):
        raise ValueError("dispatch table: not a JSON object")
    if data.get("version") != VERSION:
        raise ValueError(f"dispatch table: version {data.get('version')!r}"
                         f" != {VERSION}")
    entries = data.get("entries")
    if not isinstance(entries, dict):
        raise ValueError("dispatch table: 'entries' missing or not a dict")
    for family, buckets in entries.items():
        try:
            fam = get_family(family)
        except KeyError:
            raise ValueError(f"dispatch table: entries[{family!r}] names "
                             f"an unregistered kernel family") from None
        if not isinstance(buckets, dict):
            raise ValueError(f"dispatch table: entries[{family!r}] not a "
                             f"dict")
        for bucket, entry in buckets.items():
            where = f"entries[{family!r}][{bucket!r}]"
            for req in ("config", "problem", "est_ms", "speedup",
                        "provenance"):
                if req not in entry:
                    raise ValueError(f"dispatch table: {where} lacks "
                                     f"{req!r}")
            try:
                fam.config_cls(**entry["config"])
                fam.problem_cls(**entry["problem"])
            except TypeError as e:
                raise ValueError(f"dispatch table: {where} does not "
                                 f"reconstruct: {e}") from None
    return data


class DispatchTable:
    """Loaded dispatch table with bucketed config lookup."""

    def __init__(self, data: dict):
        self.data = validate(data)

    @property
    def entries(self) -> dict:
        return self.data["entries"]

    def lookup(self, family: str, prob) -> Optional[dict]:
        """The raw entry for ``prob``'s bucket, or ``None``."""
        return self.entries.get(family, {}).get(shape_bucket(prob))

    def config_for(self, family: str, prob):
        """The tuned config instance for ``prob``'s bucket, or ``None``
        (caller falls back to its shape-adaptive default)."""
        entry = self.lookup(family, prob)
        if entry is None:
            return None
        return get_family(family).config_cls(**entry["config"])

    def summary(self) -> str:
        n = sum(len(b) for b in self.entries.values())
        fams = ",".join(sorted(self.entries))
        return f"{n} tuned configs across [{fams}]"

    def save(self, path) -> None:
        """Replace-on-save under the advisory lock (atomic via
        :func:`repro_torch.core.fslock.replace_file`: a killed writer leaves
        the previous table, never a torn one).  The table is a
        *published artifact* (one orchestrator run owns it), so unlike
        the caches it is not merged — a stale entry surviving a re-tune
        would silently serve an old config."""
        with locked(path, exclusive=True):
            replace_file(path, json.dumps(self.data, indent=2,
                                          sort_keys=True) + "\n")


def load(path) -> DispatchTable:
    with locked(path, exclusive=False):
        data = json.loads(Path(path).read_text())
    return DispatchTable(data)


def build_table(records: Iterable[dict]) -> DispatchTable:
    """Build the table from journal records — the caller passes the
    *reconciled* selection, so sync/async and any worker count feed the
    same records here: per job keep the highest completed rung — at equal
    rung the better speedup (so a bandit-funded extra branch that beat
    its base record wins the slot); per (family, bucket) keep the best
    speedup (deterministic job-id tie-break)."""
    per_job: Dict[str, dict] = {}
    for rec in records:
        cur = per_job.get(rec["job"])
        if cur is None or rec["rung"] > cur["rung"] or (
                rec["rung"] == cur["rung"]
                and rec["speedup"] > cur["speedup"]):
            per_job[rec["job"]] = rec
    entries: Dict[str, Dict[str, dict]] = {}
    for job_id in sorted(per_job):
        rec = per_job[job_id]
        fam = get_family(rec["family"])
        prob = fam.problem_cls(**rec["problem"])
        bucket = shape_bucket(prob)
        entry = {
            "config": dict(rec["best_cfg"]),
            "problem": dict(rec["problem"]),
            "est_ms": rec["best_time_s"] * 1e3,
            "baseline_ms": rec["baseline_time_s"] * 1e3,
            "speedup": rec["speedup"],
            "provenance": {
                "job": rec["job"],
                "seed": rec["seed"],
                "rungs": rec["rung"] + 1,
                "budget": rec["iterations_done"],
                "cost_units": rec["cost_units"],
                "accepted": rec["accepted"],
                "repairs": rec["repairs"],
                "verdict_stages": dict(rec["verdict_stages"]),
                "sol_frac": rec.get("sol_frac"),
            },
        }
        slot = entries.setdefault(rec["family"], {})
        prev = slot.get(bucket)
        if prev is None or entry["speedup"] > prev["speedup"]:
            slot[bucket] = entry
    return DispatchTable({"version": VERSION, "entries": entries})


def update_legacy_tuning_cache(path, table: DispatchTable) -> None:
    """Mirror the winners into the legacy ``tuning_cache.json`` shape
    (family -> {problem, config, est_ms, speedup}) via the shared
    read-merge-write helper, for consumers not yet on the dispatch
    table."""
    ours = {}
    for family, buckets in table.entries.items():
        best = max(buckets.values(), key=lambda e: e["speedup"])
        ours[family] = {"problem": best["problem"],
                        "config": best["config"],
                        "est_ms": best["est_ms"],
                        "speedup": best["speedup"]}

    def merge(disk):
        merged = dict(disk) if isinstance(disk, dict) else {}
        merged.update(ours)
        return merged

    merge_save(path, merge, indent=2, sort_keys=True)


# ---------------------------------------------------------------------------
# Process-wide active table (what serving consults)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[DispatchTable] = None


def install(table) -> DispatchTable:
    """Make ``table`` (a :class:`DispatchTable`, a path, or raw dict) the
    process-wide active table consulted by :func:`configured`."""
    global _ACTIVE
    if table is None:
        _ACTIVE = None
        return None
    if isinstance(table, DispatchTable):
        _ACTIVE = table
    elif isinstance(table, dict):
        _ACTIVE = DispatchTable(table)
    else:
        _ACTIVE = load(table)
    return _ACTIVE


def active() -> Optional[DispatchTable]:
    return _ACTIVE


def configured(family: str, prob):
    """The installed table's config for ``prob``, or ``None`` — the hook
    the validated kernel entry points call before their shape-adaptive
    default.

    Buckets are coarse (ints round up to a power of two), so the tuned
    winner may be invalid for a non-representative shape in its bucket
    (e.g. a ``split_k`` that divides the bucket's K but not this one).
    The config is therefore pre-verified against the *exact* problem
    through the shared default engine — memoized, so repeat calls are a
    dict hit — and ``None`` is returned on anything short of a hard
    pass, letting the caller fall back to its shape-adaptive default
    instead of crashing on a config tuned for a neighbor."""
    if _ACTIVE is None:
        return None
    cfg = _ACTIVE.config_for(family, prob)
    if cfg is None:
        return None
    from .. import verify_engine
    if not verify_engine.default_engine().verify(family, cfg,
                                                 prob).hard_ok:
        return None
    return cfg
