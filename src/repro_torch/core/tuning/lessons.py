"""Shared fleet lesson store — cross-worker ICRL (the port of the JAX
package's ``core/tuning/lessons.py``; the store's format is the same).

``lessons.json`` is how the fleet's workers pool *strategy* knowledge the
way ``constraint_cache.json`` pools proofs: after every work item a
worker distills its trajectory into stage-attributed lesson entries
(:func:`repro_torch.core.harness.export_lessons`) and publishes them; before
the next item it warm-starts a fresh :class:`PlannerParams` from the
union (:func:`repro_torch.core.harness.import_lessons`) — so a ``quant_gemm``
worker's "retile keeps tripping the scale-provenance conformity at the
solver stage" lesson reaches the ``gemm`` worker mid-run, through the
generic skills both families share.

Entries are keyed by a **content hash** over (source item, skill,
family, direction, stage, assertion).  The consequences:

* **publication is idempotent** — a crashed/re-dispatched item
  re-publishing the same lessons inserts nothing new;
* **merge order cannot change the store** — the union of entry sets is
  the same whatever order workers publish in (`fslock.merge_save`
  serializes the read-merge-write, sorted keys serialize the bytes);
* **decay is a consumer policy, not store state** — repeated
  observations of the same lesson saturate logarithmically at *import*
  (see :func:`repro_torch.core.harness.import_lessons`), so the store never
  needs order-dependent counters.

Eviction past :data:`MAX_LESSONS` drops the smallest
``(|advantage|, key)`` first — deterministic given the entry set.

Lessons change planner trajectories, so a ``--lessons`` run trades the
strict any-worker-count byte-identity of ``dispatch_table.json`` for
within-run learning; the flag is part of the journal fingerprint.
"""
from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Dict, Iterable, List

from ..fslock import merge_save, read_json

VERSION = 1
LESSONS_NAME = "lessons.json"
MAX_LESSONS = 4096

# One complete, valid lesson-store document (the JAX package's, verbatim;
# tests/test_torch_tuning.py feeds it through a LessonStore).
SCHEMA_EXAMPLE = {
    "version": 1,
    "lessons": {
        "63bcee52276f4e1f": {
            "skill": "retile",
            "family": "quant_gemm",
            "source": "quant_gemm:m=8192,n=8192,k=8192,group=128,"
                      "dtype=i8@r0",
            "direction": "avoid",
            "advantage": -0.412738,
            "stage": "solver",
            "assertion": "assert_conform(mm_2,t_SA_3)",
            "strikes": 3,
        },
    },
}


def lesson_key(entry: Dict) -> str:
    """Content hash identifying one lesson entry: SHA-256 over the
    fields that define *what was learned where* — the advantage value is
    deliberately excluded, so a re-executed item publishing a slightly
    different number still dedups onto its original entry."""
    blob = "|".join(str(entry.get(k, "")) for k in
                    ("source", "skill", "family", "direction", "stage",
                     "assertion"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def _evict(lessons: Dict[str, Dict]) -> Dict[str, Dict]:
    """Deterministically bound the store: keep the MAX_LESSONS entries
    with the largest (|advantage|, key) — a function of the entry set
    only, so every worker evicts identically."""
    if len(lessons) <= MAX_LESSONS:
        return lessons
    ranked = sorted(lessons,
                    key=lambda k: (abs(float(
                        lessons[k].get("advantage", 0.0))), k),
                    reverse=True)
    return {k: lessons[k] for k in sorted(ranked[:MAX_LESSONS])}


class LessonStore:
    """The on-disk shared store; every mutation goes through
    :func:`repro_torch.core.fslock.merge_save`, every read through the shared
    advisory lock."""

    def __init__(self, path):
        self.path = Path(path)

    def load(self) -> Dict[str, Dict]:
        """The current entry union, keyed by content hash.  Missing,
        corrupt or wrong-version files read as an empty store."""
        data = read_json(self.path)
        if not isinstance(data, dict) or data.get("version") != VERSION:
            return {}
        lessons = data.get("lessons")
        return dict(lessons) if isinstance(lessons, dict) else {}

    def load_entries(self) -> List[Dict]:
        """The entries in key order — the deterministic iteration order
        :func:`repro_torch.core.harness.import_lessons` consumes."""
        lessons = self.load()
        return [lessons[k] for k in sorted(lessons)]

    def publish(self, entries: Iterable[Dict]) -> int:
        """Union ``entries`` into the store (read-merge-write under the
        exclusive advisory lock).  Returns how many were actually new —
        re-publishing an already-stored entry is a no-op, keyed on
        :func:`lesson_key`."""
        entries = list(entries)
        if not entries:
            return 0
        added = [0]

        def merge(disk):
            if isinstance(disk, dict) and disk.get("version") == VERSION \
                    and isinstance(disk.get("lessons"), dict):
                lessons = dict(disk["lessons"])
            else:
                lessons = {}
            added[0] = 0
            for e in entries:
                k = lesson_key(e)
                if k not in lessons:
                    lessons[k] = dict(e)
                    added[0] += 1
            return {"version": VERSION, "lessons": _evict(lessons)}

        merge_save(self.path, merge, indent=2, sort_keys=True)
        return added[0]
