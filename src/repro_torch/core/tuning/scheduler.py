"""Successive-halving budget schedulers: synchronous rungs + async ASHA
(the port of the JAX package's ``core/tuning/scheduler.py``).

Solver time is the fleet's scarce resource, so budgets concentrate where
the verified cost model says they pay off: every job first gets a small
iteration budget (rung 0), then the survivors — ranked by *verified*
cost-model score, i.e. the speedup their best invariant-passing config
achieved — continue with a doubled budget, and so on until the per-rung
budget exceeds ``max_budget``.  Each rung runs as a budgeted
:func:`repro_torch.core.harness.optimize_kernel` slice resuming from the
previous rung's :class:`repro_torch.core.harness.OptimizeCheckpoint`, so a
promoted job's trajectory continues instead of restarting.

Two schedulers share that budget ladder:

* :class:`SuccessiveHalving` — synchronous rungs: rung ``r+1`` starts
  only when *every* rung-``r`` item has finished, so the pool barriers
  on its slowest job once per rung.
* :class:`AsyncSuccessiveHalving` — rung-free (ASHA) promotion: a job
  promotes the moment it ranks in the top ``1/eta`` of the *completed*
  rung peers, so a straggler delays only its own trajectory, never an
  unrelated promotion.

Asynchrony changes *which* items run, not what any item returns — an
item's result depends only on its own job's previous-rung checkpoint —
so :func:`reconcile_schedule` can replay the synchronous schedule over
the accumulated records afterwards and select exactly the records the
synchronous run would have produced.  That reconciliation is what keeps
``dispatch_table.json`` byte-identical across sync/async modes, worker
counts and scheduling orders; async items outside the synchronous
schedule are speculation, journaled but never in the table.

Everything here is deterministic given (jobs, results): survivor
selection sorts by (speedup desc, job id), budgets follow the fixed
``base_budget · eta^rung`` schedule, and work items are identified by
``job_id@r<rung>`` — which is what makes the journal resumable and the
dispatch table independent of worker count.

With a :class:`repro_torch.core.tuning.bandit.SolPolicy` both schedulers add
the speed-of-light early stop: a job whose record is within the policy's
slack of its family's analytic bound stops being *run* but keeps
occupying the promotion slots its frozen record's rank earns — stopping
job A therefore never changes which other jobs promote, it only frees
the budgets of the slots A's frozen record wins.  The synchronous
scheduler re-spends ``realloc`` of the freed iterations through the
policy's :class:`repro_torch.core.tuning.bandit.GapBandit` as *extra* side
items (``job_id@r<rung>+e<n>``) on the remaining buckets; the async
scheduler only suppresses promotions and leaves the extras to the
reconciliation pass, which replays the same deterministic grants.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from .bandit import GapBandit, SolPolicy
from .jobs import TuningJob


def _budget_ladder(base_budget: int, max_budget: int,
                   eta: int) -> List[int]:
    if base_budget < 1 or eta < 2:
        raise ValueError("need base_budget >= 1 and eta >= 2")
    budgets = [base_budget]
    while budgets[-1] * eta <= max_budget:
        budgets.append(budgets[-1] * eta)
    return budgets


@dataclass(frozen=True)
class WorkItem:
    """One budgeted optimize slice: run ``budget`` more iterations of
    ``job`` at rung ``rung``, resuming from ``checkpoint`` (the previous
    rung's journal record, ``None`` at rung 0).  ``extra`` > 0 marks a
    bandit-funded side branch: it resumes from the job's latest *base*
    record at that rung but runs under its own RNG stream, and its
    result never feeds scheduling — only the dispatch table."""

    job: TuningJob
    rung: int
    budget: int
    checkpoint: Optional[dict] = None
    extra: int = 0

    @property
    def item_id(self) -> str:
        base = f"{self.job.job_id}@r{self.rung}"
        return f"{base}+e{self.extra}" if self.extra else base


class SuccessiveHalving:
    """Synchronous successive halving over the job list.

    ``first_rung()`` yields every job at ``base_budget``; after each rung
    completes, ``next_rung(records)`` keeps the top ``1/eta`` fraction
    (at least one) and doubles the per-rung budget, embedding each
    survivor's rung record as the next slice's checkpoint.  Jobs cut at
    rung *r* keep their rung-*r* result — the dispatch table is built
    from every job's highest completed rung, so nothing is lost, only
    not refined further.

    With ``sol`` set, a job whose rung record stops (within the policy's
    slack of the analytic bound) stays in the ranking with that frozen
    record but is never run again: every slot its frozen rank wins frees
    that rung's budget, of which the policy's ``realloc`` fraction comes
    back as bandit-granted extra items on the remaining buckets.  Since
    the frozen speedup is a lower bound on what the job would have
    scored, and the keep count is unchanged, every *non-stopped* job the
    plain schedule promotes is still promoted.
    """

    def __init__(self, jobs: List[TuningJob], *, base_budget: int = 4,
                 max_budget: int = 32, eta: int = 2,
                 sol: Optional[SolPolicy] = None):
        self.jobs = sorted(jobs, key=lambda j: (-j.priority, j.job_id))
        self.eta = eta
        self.budgets = _budget_ladder(base_budget, max_budget, eta)
        self.sol = sol
        self._alive = list(self.jobs)
        self._rung = 0
        self._by_id = {j.job_id: j for j in self.jobs}
        self._stopped: Dict[str, dict] = {}   # job_id -> frozen record
        self._latest: Dict[str, dict] = {}    # job_id -> last base record
        self._bandit = GapBandit(sol) if sol is not None else None
        self._freed = 0
        self._granted = 0
        self._extra_seq: Dict[str, int] = {}

    @property
    def rung(self) -> int:
        return self._rung

    @property
    def freed_iterations(self) -> int:
        """Iterations the SoL early stop freed so far (0 without sol)."""
        return self._freed

    @property
    def granted_iterations(self) -> int:
        """Freed iterations the bandit re-granted as extras so far."""
        return self._granted

    @property
    def stopped(self) -> Dict[str, dict]:
        """Jobs stopped at the SoL floor, with their frozen records."""
        return dict(self._stopped)

    def first_rung(self) -> List[WorkItem]:
        return [WorkItem(j, 0, self.budgets[0]) for j in self._alive]

    def next_rung(self, records: Dict[str, dict]) -> List[WorkItem]:
        """Promote survivors of the just-finished rung.  ``records`` maps
        job_id -> that job's *base* journal record for the current rung
        (it must cover every alive job; extra side-branch records must
        not be fed here).  Returns ``[]`` when the schedule is
        exhausted."""
        if self.sol is None:
            missing = [j.job_id for j in self._alive
                       if j.job_id not in records]
            if missing:
                raise ValueError(
                    f"rung {self._rung} incomplete: {missing}")
            self._rung += 1
            if self._rung >= len(self.budgets):
                return []
            ranked = sorted(
                self._alive,
                key=lambda j: (-records[j.job_id]["speedup"], j.job_id))
            keep = max(1, len(ranked) // self.eta)
            self._alive = sorted(ranked[:keep],
                                 key=lambda j: (-j.priority, j.job_id))
            return [WorkItem(j, self._rung, self.budgets[self._rung],
                             checkpoint=records[j.job_id])
                    for j in self._alive]
        return self._next_rung_sol(records)

    # -- speed-of-light path -------------------------------------------------
    def _next_rung_sol(self, records: Dict[str, dict]) -> List[WorkItem]:
        live = [j for j in self._alive if j.job_id not in self._stopped]
        missing = [j.job_id for j in live if j.job_id not in records]
        if missing:
            raise ValueError(f"rung {self._rung} incomplete: {missing}")
        for j in live:
            rec = records[j.job_id]
            self._observe(j.job_id, rec)
            self._latest[j.job_id] = rec
            if self.sol.stops(rec):
                self._stopped[j.job_id] = rec
        # A rung may have nothing to run (every winning slot frozen, no
        # extras granted) while the ladder still has budget for the
        # frozen slots to free — keep advancing until there is work or
        # the schedule is exhausted.
        while True:
            self._rung += 1
            if self._rung >= len(self.budgets):
                return []
            budget = self.budgets[self._rung]
            ranked = sorted(
                self._alive,
                key=lambda j: (-self._latest[j.job_id]["speedup"],
                               j.job_id))
            keep = max(1, len(ranked) // self.eta)
            self._alive = sorted(ranked[:keep],
                                 key=lambda j: (-j.priority, j.job_id))
            promoted = [j for j in self._alive
                        if j.job_id not in self._stopped]
            self._freed += budget * (len(self._alive) - len(promoted))
            items = [WorkItem(j, self._rung, budget,
                              checkpoint=self._latest[j.job_id])
                     for j in promoted]
            items += self._grant_extras(
                running={j.job_id for j in promoted})
            if items:
                return items

    def _observe(self, job_id: str, rec: dict) -> None:
        """Feed the bandit one base-rung transition: sol_frac gained per
        iteration, against the previous base record (or, at rung 0, the
        start config's implied fraction ``sol_frac / speedup``)."""
        frac, speedup = rec.get("sol_frac"), rec.get("speedup")
        if frac is None:
            return
        prev = self._latest.get(job_id)
        if prev is not None:
            prev_frac = prev.get("sol_frac")
        else:
            prev_frac = frac / speedup if speedup else None
        if prev_frac is None:
            return
        self._bandit.observe(job_id, frac - prev_frac,
                             rec.get("budget", 0))

    def _grant_extras(self, running: Set[str]) -> List[WorkItem]:
        """Spend ``realloc`` of the freed iterations, in chunks of the
        base budget, on the buckets still short of their bound: not
        stopped, not currently promoted, with a measurable gap."""
        allowance = int(self._freed * self.sol.realloc)
        chunk = self.budgets[0]
        out: List[WorkItem] = []
        while self._granted + chunk <= allowance:
            cands = [jid for jid, rec in self._latest.items()
                     if jid not in self._stopped and jid not in running
                     and rec.get("sol_frac") is not None]
            jid = self._bandit.grant(cands)
            if jid is None:
                break
            self._granted += chunk
            seq = self._extra_seq.get(jid, 0) + 1
            self._extra_seq[jid] = seq
            rec = self._latest[jid]
            out.append(WorkItem(self._by_id[jid], rec["rung"], chunk,
                                checkpoint=rec, extra=seq))
        return out


class AsyncSuccessiveHalving:
    """Rung-free (asynchronous) successive halving — the ASHA promotion
    rule over the same budget ladder.

    ``initial_items()`` issues every job at rung 0; ``on_result(record)``
    files one completed record and returns the work items it newly
    unlocks: a job promotes to rung ``r+1`` the moment it ranks in the
    top ``len(completed) // eta`` of the rung-``r`` records completed *so
    far* (speedup descending, job-id tie-break).  No barrier: a straggler
    holds back only its own promotions.  Ranks are re-evaluated on every
    completion — a job that enters the top fraction later (because a
    worse peer landed) still promotes; an already-promoted job that falls
    out is speculation the reconciliation pass will discard.

    Compared to the synchronous scheduler this strictly *under*-promotes
    while a rung is partially complete (``n // eta`` is 0 until ``eta``
    peers land, and never applies the sync rule's minimum of one
    survivor), and can promote jobs the complete ranking would not —
    both are healed by :func:`reconcile_schedule`, which tops up missing
    synchronous-schedule items and drops speculative extras.
    """

    def __init__(self, jobs: List[TuningJob], *, base_budget: int = 4,
                 max_budget: int = 32, eta: int = 2,
                 sol: Optional[SolPolicy] = None):
        self.jobs = sorted(jobs, key=lambda j: (-j.priority, j.job_id))
        self.eta = eta
        self.budgets = _budget_ladder(base_budget, max_budget, eta)
        self.sol = sol
        self._by_id = {j.job_id: j for j in self.jobs}
        self._completed: Dict[int, Dict[str, dict]] = {}
        self._issued: Set[str] = set()

    def initial_items(self) -> List[WorkItem]:
        out = [WorkItem(j, 0, self.budgets[0]) for j in self.jobs]
        self._issued.update(it.item_id for it in out)
        return out

    def on_result(self, record: dict) -> List[WorkItem]:
        """File one completed item's journal record; return the newly
        promotable work items (possibly for *other* jobs whose rank the
        new record improved).  Unknown jobs and rungs past the ladder
        are ignored, so journal replay can feed every record through."""
        job_id, rung = record.get("job"), record.get("rung")
        if job_id not in self._by_id or not isinstance(rung, int) \
                or not 0 <= rung < len(self.budgets):
            return []
        self._completed.setdefault(rung, {})[job_id] = record
        nxt = rung + 1
        if nxt >= len(self.budgets):
            return []
        recs = self._completed[rung]
        ranked = sorted(recs, key=lambda j: (-recs[j]["speedup"], j))
        out = []
        for jid in ranked[:len(ranked) // self.eta]:
            if self.sol is not None and self.sol.stops(recs[jid]):
                continue    # at the SoL floor: occupies the slot, never runs
            item = WorkItem(self._by_id[jid], nxt, self.budgets[nxt],
                            checkpoint=recs[jid])
            if item.item_id not in self._issued:
                self._issued.add(item.item_id)
                out.append(item)
        return out


def reconcile_schedule(jobs: List[TuningJob], records: Dict[str, dict],
                       *, base_budget: int = 4, max_budget: int = 32,
                       eta: int = 2, sol: Optional[SolPolicy] = None
                       ) -> Tuple[Dict[str, dict], List[WorkItem]]:
    """Replay the *synchronous* schedule against completed ``records``
    (item id -> journal record).

    Returns ``(selected, missing)``: ``selected`` maps each item id the
    synchronous schedule has reached so far to its record; ``missing``
    is the first incomplete rung's outstanding work items (empty when
    the schedule is fully covered).  Pure and deterministic — an item's
    result depends only on its own job's previous-rung record, so a
    record is valid evidence no matter which mode, worker or scheduling
    order produced it.  Building the dispatch table from ``selected``
    (and nothing else) is what makes the table byte-identical across
    sync/async and any worker count.  With ``sol`` the replay includes
    the early stops and the bandit's extra grants — both pure functions
    of base records and the policy seed, so the same property holds."""
    sched = SuccessiveHalving(jobs, base_budget=base_budget,
                              max_budget=max_budget, eta=eta, sol=sol)
    items = sched.first_rung()
    selected: Dict[str, dict] = {}
    while items:
        missing = [it for it in items if it.item_id not in records]
        if missing:
            return selected, missing
        for it in items:
            selected[it.item_id] = records[it.item_id]
        items = sched.next_rung(
            {it.job.job_id: records[it.item_id] for it in items
             if not it.extra})
    return selected, []


def sol_summary(jobs: List[TuningJob], records: Dict[str, dict],
                *, base_budget: int = 4, max_budget: int = 32,
                eta: int = 2, sol: SolPolicy) -> dict:
    """Replay the SoL-guided synchronous schedule over complete
    ``records`` and report what the policy did: which jobs stopped at
    the floor (job id -> sol_frac), how many iterations the frozen slots
    freed, and how many the bandit re-granted."""
    sched = SuccessiveHalving(jobs, base_budget=base_budget,
                              max_budget=max_budget, eta=eta, sol=sol)
    items = sched.first_rung()
    while items:
        if any(it.item_id not in records for it in items):
            break
        items = sched.next_rung(
            {it.job.job_id: records[it.item_id] for it in items
             if not it.extra})
    return {
        "stopped": {jid: rec.get("sol_frac")
                    for jid, rec in sorted(sched.stopped.items())},
        "freed_iterations": sched.freed_iterations,
        "granted_iterations": sched.granted_iterations,
    }
