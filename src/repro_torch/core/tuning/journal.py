"""Crash-resumable JSONL journal for fleet-tuner runs (the port of the
JAX package's ``core/tuning/journal.py``; the format is the same, so
either package reads the other's journal).

Line 1 is a header pinning the journal format version and a fingerprint
of (jobs, seeds, budget schedule); every later line is one completed
work item's result record.  The orchestrator appends a record the moment
an item finishes, so a killed run loses at most the items that were
mid-flight — re-invoking the orchestrator replays the deterministic
schedule, loads every journaled item instead of re-running it, and
continues from the first missing one.

Record format (one JSON object per line):

    {"kind": "result", "item": "<job_id>@r<rung>", "job": "<job_id>",
     "family": ..., "rung": r, "budget": b, "seed": s, "extra": 0,
     "problem": {...}, "start_cfg": {...},
     "best_cfg": {...}, "cur_cfg": {...},
     "baseline_time_s": ..., "best_time_s": ..., "speedup": ...,
     "sol_time_s": ..., "sol_frac": ...,
     "iterations_done": n, "cost_units": ..., "solved": true,
     "accepted": n, "repairs": n, "verdict_stages": {stage: count},
     "verify_stats": {...}, "lessons_imported": n, "lessons_reused": n,
     "lessons_published": n, "worker": wid, "wall_s": ...,
     "mono_start_s": ..., "mono_end_s": ...}

``extra`` > 0 marks a bandit-funded side branch (item id
``<job_id>@r<rung>+e<n>``) — journaled and table-eligible like any
record, but never fed back into promotion decisions.  ``sol_time_s`` /
``sol_frac`` are the family's analytic speed-of-light bound and the
fraction of it the best verified config reached (``null`` for families
without a ``sol_bound`` hook); the scheduler's early-stop rule reads
``sol_frac``.  ``worker``/``wall_s``/``lessons_*`` are provenance of
*this* run and are excluded from the dispatch table (which must be
bitwise-identical across worker counts).  ``mono_start_s`` /
``mono_end_s`` are ``time.monotonic()`` stamps around the item's
execution — CLOCK_MONOTONIC is system-wide on Linux, so stamps from
different worker processes share one timeline and
:func:`fleet_timeline` can rebuild the fleet's Gantt chart from
the journal alone, stragglers visible as long bars.  Loading tolerates
a torn final line — the signature of a process killed mid-append — by
skipping lines that fail to parse.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional

from ..fslock import locked, replace_file

VERSION = 1


class JournalMismatch(RuntimeError):
    """The on-disk journal belongs to a different (jobs, budgets) run."""


class Journal:
    def __init__(self, path):
        self.path = Path(path)

    def start(self, fingerprint: str, *, fresh: bool = False
              ) -> Dict[str, dict]:
        """Open (or create) the journal for a run with ``fingerprint``.
        Returns the already-completed records keyed by item id.  A
        journal written for a *different* fingerprint raises
        :class:`JournalMismatch` unless ``fresh`` truncates it — silently
        mixing two job sets would corrupt the resume."""
        if not self.path.exists() or fresh:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with locked(self.path, exclusive=True):
                replace_file(self.path, json.dumps(
                    {"kind": "header", "version": VERSION,
                     "fingerprint": fingerprint}) + "\n")
            return {}
        header, records = self._read()
        if header is None or header.get("version") != VERSION:
            raise JournalMismatch(
                f"{self.path} has no readable v{VERSION} header; "
                f"pass fresh=True (--fresh) to start over")
        if header.get("fingerprint") != fingerprint:
            raise JournalMismatch(
                f"{self.path} was written for a different job set / "
                f"budget schedule; pass fresh=True (--fresh) to discard "
                f"it or point --out-dir elsewhere")
        return records

    def append(self, record: dict) -> None:
        """Append one result record (single line, flushed) under the
        advisory lock so concurrent writers cannot interleave lines.
        A torn final line (a writer killed mid-append) is sealed with a
        newline first — otherwise the new record would concatenate onto
        the fragment and both lines would be lost to every later read."""
        line = json.dumps(record, sort_keys=True)
        with locked(self.path, exclusive=True):
            with open(self.path, "a+b") as fh:
                fh.seek(0, os.SEEK_END)
                if fh.tell():
                    fh.seek(-1, os.SEEK_END)
                    if fh.read(1) != b"\n":
                        fh.write(b"\n")
                fh.write(line.encode("utf-8") + b"\n")
                fh.flush()

    def records(self) -> Dict[str, dict]:
        return self._read()[1]

    def timeline(self) -> dict:
        """The fleet timeline as a Chrome trace (see
        :func:`fleet_timeline`)."""
        return fleet_timeline(self.records())

    # -- internals -----------------------------------------------------------
    def _read(self):
        header: Optional[dict] = None
        records: Dict[str, dict] = {}
        try:
            with locked(self.path, exclusive=False):
                lines: List[str] = self.path.read_text().splitlines()
        except OSError:
            return None, {}
        for line in lines:
            try:
                obj = json.loads(line)
            except ValueError:
                continue        # torn write from a killed process
            if not isinstance(obj, dict):
                continue
            if obj.get("kind") == "header" and header is None:
                header = obj
            elif obj.get("kind") == "result" and "item" in obj:
                records[obj["item"]] = obj   # later line wins (re-runs)
        return header, records


def fleet_timeline(records: Dict[str, dict]) -> dict:
    """Rebuild the fleet's execution timeline from journaled monotonic
    stamps as a Chrome trace-event dict (Perfetto-loadable): one
    complete event per record, one ``tid`` lane per worker, timestamps
    rebased to the earliest stamp.  Records without stamps (journals
    written before the stamps existed) are skipped — the timeline is a
    best-effort view, never a correctness input."""
    stamped = [r for r in records.values()
               if r.get("mono_start_s") is not None
               and r.get("mono_end_s") is not None]
    base = min((r["mono_start_s"] for r in stamped), default=0.0)
    events = []
    for r in sorted(stamped, key=lambda r: (r["mono_start_s"],
                                            str(r["item"]))):
        ts = int((r["mono_start_s"] - base) * 1e6)
        events.append({
            "name": r["item"], "ph": "X", "ts": ts,
            "dur": max(0, int((r["mono_end_s"] - base) * 1e6) - ts),
            "pid": 0, "tid": int(r.get("worker", 0)),
            "args": {"family": r.get("family"), "rung": r.get("rung"),
                     "budget": r.get("budget"),
                     "speedup": r.get("speedup")}})
    return {"displayTimeUnit": "ms", "traceEvents": events}
