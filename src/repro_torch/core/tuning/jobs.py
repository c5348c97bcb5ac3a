"""Tuning-job model for the fleet tuner (the port of the JAX package's
``core/tuning/jobs.py``, over the port's family registry).

A *tuning job* is the unit the orchestrator schedules: (family, problem,
seed, budget).  Jobs are enumerated straight from the kernel-family
registry — every registered family with a production ``example()``
becomes one job, and under ``sweep=True`` every problem in the family's
``sweep_problems()`` shape-bucket grid becomes one, so registering a new
family (or widening its grid) makes it fleet-tunable with no
orchestrator changes — and carry a *priority* from the family's
analytic cost hook (the H100 model of :mod:`repro_torch.core.costs`):
kernels that dominate the modeled wall-clock are dispatched first within
each rung.

Seeds are derived by :func:`stable_seed`, a content hash of
``(family, problem, base seed)`` — never a shared ``seed=0`` — so
parallel workers explore *decorrelated* trajectories and every job's
trajectory is reproducible independent of which worker ran it or in what
order (the scheduling satellite of the determinism story: results depend
only on (jobs, seeds), not on worker count).
"""
from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass
from typing import List, Optional, Sequence

from ..families import all_families, get_family


def stable_seed(*parts) -> int:
    """Content-derived RNG seed: a SHA-256 of the rendered parts, folded
    to 63 bits.  Stable across processes and Python versions (unlike
    ``hash``), collision-free in practice, and decorrelated between any
    two distinct part tuples — (family, problem, job seed) here, plus the
    rung index for per-slice selector/lowering streams."""
    text = "|".join(str(p) for p in parts)
    digest = hashlib.sha256(text.encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big") >> 1


def problem_key(prob) -> str:
    """Exact, deterministic identity string for a problem dataclass —
    the job-naming granularity (dispatch buckets coarsen separately)."""
    parts = [f"{f.name}={getattr(prob, f.name)}"
             for f in dataclasses.fields(prob)]
    return ",".join(parts)


@dataclass(frozen=True)
class TuningJob:
    """One schedulable tuning task: optimize ``family`` on ``problem``
    starting from ``start_cfg``, with RNG streams derived from ``seed``.
    ``priority`` orders dispatch within a rung (highest modeled cost
    first); it never affects results, only which worker picks what up
    when."""

    family: str
    problem: object
    start_cfg: object
    seed: int
    priority: float

    @property
    def job_id(self) -> str:
        return f"{self.family}:{problem_key(self.problem)}"


def make_job(family: str, problem, start_cfg=None, *,
             seed: int = 0) -> TuningJob:
    fam = get_family(family)
    if start_cfg is None:
        start_cfg = fam.config_cls()
    est = fam.cost(start_cfg, problem)
    return TuningJob(family, problem, start_cfg,
                     stable_seed(family, problem_key(problem), seed),
                     priority=est.time_s)


def enumerate_jobs(families: Optional[Sequence[str]] = None, *,
                   seed: int = 0, sweep: bool = False) -> List[TuningJob]:
    """One job per registered family's production example (the registry
    is the source of truth; families without an ``example()`` are not
    tunable and are skipped).  With ``sweep``, families declaring a
    ``sweep_problems()`` grid contribute one job per grid problem — each
    lands in its own dispatch-table shape bucket, so the table gets
    populated from measurements across the family's serving regimes
    instead of a single ``example()`` point.  Every job starts from the
    example config; the example problem is always included and
    duplicates (a grid restating the example) collapse by job id.
    Deterministic order: priority-descending, job-id tie-break."""
    fams = (all_families() if families is None
            else [get_family(n) for n in families])
    jobs = []
    for fam in fams:
        if fam.example is None:
            continue
        cfg, prob = fam.example()
        probs = [prob]
        if sweep and fam.sweep_problems is not None:
            probs += list(fam.sweep_problems())
        seen = set()
        for p in probs:
            key = problem_key(p)
            if key in seen:
                continue
            seen.add(key)
            jobs.append(make_job(fam.name, p, cfg, seed=seed))
    jobs.sort(key=lambda j: (-j.priority, j.job_id))
    return jobs
