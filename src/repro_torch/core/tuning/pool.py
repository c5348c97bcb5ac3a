"""Multi-process fleet orchestration: workers, scheduling, resume (the
port of the JAX package's ``core/tuning/pool.py``).

``run_fleet`` drives the whole pipeline: enumerate → schedule →
execute → journal → reconcile → dispatch table.  Work items execute
either inline (``--workers 1`` — serial, one long-lived engine) or on a
pool of ``multiprocessing`` *spawn* workers.  Each worker owns a
:class:`repro_torch.core.verify_engine.VerificationEngine` whose
:class:`ConstraintCache` warm-starts from the shared
``constraint_cache.json`` before every item and publishes back (a
read-merge-write union under the :mod:`repro_torch.core.fslock` advisory lock)
after every item — so worker B re-uses the canonicalized proofs worker A
just discharged instead of re-proving them, which is why N workers
discharge far fewer than N× a solo run.

With ``lessons=True`` the workers pool *strategy* the same way they pool
proofs: around every item they warm-start the planner's θ from, and
publish stage-attributed ICRL lessons to, the shared
:mod:`repro_torch.core.tuning.lessons` store — a ``quant_gemm`` worker's
"this skill keeps tripping that assertion" lesson reaches the ``gemm``
worker mid-run through the generic skills both families share.

Scheduling is synchronous successive halving by default;
``async_mode=True`` switches to rung-free ASHA promotion
(:class:`repro_torch.core.tuning.scheduler.AsyncSuccessiveHalving`) so a
straggling job stops barriering the pool.  Either way the run ends with
a deterministic **reconciliation pass**
(:func:`repro_torch.core.tuning.scheduler.reconcile_schedule`): the
synchronous schedule is replayed over the journal, any item it needs
that async skipped is run, and the dispatch table is built from exactly
the records the synchronous schedule selects — speculative async extras
stay in the journal but never reach the table.

Determinism: an item's outcome depends only on (job, rung, previous-rung
checkpoint) — selector/lowering RNG streams are content-seeded via
:func:`repro_torch.core.tuning.jobs.stable_seed`, verdicts and cost scores are
cache-independent — so the reconciled dispatch table is
bitwise-identical for any worker count, sync or async.  (``lessons``
is the exception by design: imported lessons steer the planner, so the
flag trades strict reproducibility for within-run learning and is part
of the journal fingerprint.)  Crash safety: the parent journals every
completed item; re-invoking replays the deterministic schedule and runs
only the items the journal is missing.  Workers are daemonic *and*
watch their parent pid, so a SIGKILLed orchestrator does not leave
orphans grinding on.

``device`` (default ``"cuda"``) is resolved once by the orchestrator —
it raises on a host without a CUDA card unless it is ``"cpu"`` — and
handed to every worker's :class:`repro_torch.core.harness.Validator`:
with ``run_kernels`` the unit tests run the families' CUDA kernels on
it (their plain versions on the CPU), each spawn worker in a CUDA
context of its own.  The kernels are built once per source
(``kernels/_build.py``), so a fleet started after they are built only
loads them.  An error building or launching a kernel is never a
rejected candidate: it propagates out of the validator, the worker
reports it and the orchestrator raises.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import multiprocessing
import os
import queue
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

from repro_torch import obs as _obs
from repro_torch.device import resolve_device

from ..families import get_family
from ..harness import (KernelState, LoweringAgent, OptimizeCheckpoint,
                       Planner, PlannerParams, Selector, Validator,
                       export_lessons, import_lessons, optimize_kernel)
from ..verify_engine import ConstraintCache, VerificationEngine, merge_stats
from .dispatch import DispatchTable, build_table, update_legacy_tuning_cache
from .jobs import TuningJob, stable_seed
from .journal import Journal
from .lessons import LESSONS_NAME, LessonStore
from .bandit import SolPolicy
from .scheduler import (AsyncSuccessiveHalving, SuccessiveHalving,
                        WorkItem, reconcile_schedule, sol_summary)

JOURNAL_NAME = "fleet_journal.jsonl"
TABLE_NAME = "dispatch_table.json"
CONSTRAINTS_NAME = "constraint_cache.json"
LEGACY_CACHE_NAME = "tuning_cache.json"

# how long the parent waits with a dead worker and zero results before
# re-dispatching the missing items to the survivors (a dead worker loses
# at most its one in-flight item; re-running it is deterministic and
# idempotent, so over-eager re-dispatch costs time, never correctness)
_STALL_S = 60.0

_LESSON_COUNTERS = ("lessons_imported", "lessons_reused",
                    "lessons_published")


def fleet_fingerprint(jobs: List[TuningJob], *, base_budget: int,
                      max_budget: int, eta: int,
                      run_kernels: bool = False,
                      lessons: bool = False,
                      sol_slack: Optional[float] = None,
                      sol_realloc: Optional[float] = None) -> str:
    """Content hash pinning (jobs, seeds, budget schedule, and the flags
    that change item outcomes) — what makes a journal safely resumable.
    ``run_kernels`` is included because it changes verdicts; ``lessons``
    because imported lessons steer the planner's trajectories; the SoL
    policy knobs because they change which items exist at all.  Worker
    count and sync-vs-async scheduling are deliberately excluded: an
    item's result does not depend on either, so a run killed at
    ``--workers 4 --async`` may resume at ``--workers 1`` sync."""
    desc = {
        "jobs": [{"job": j.job_id, "seed": j.seed,
                  "start_cfg": dataclasses.asdict(j.start_cfg)}
                 for j in sorted(jobs, key=lambda j: j.job_id)],
        "base_budget": base_budget, "max_budget": max_budget, "eta": eta,
        "run_kernels": run_kernels,
    }
    if lessons:
        # only stamped when on, so pre-existing journals stay valid
        desc["lessons"] = True
    if sol_slack is not None:
        # likewise only stamped when SoL guidance is on
        desc["sol"] = {"slack": sol_slack, "realloc": sol_realloc}
    blob = json.dumps(desc, sort_keys=True)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def _to_wire(item: WorkItem) -> dict:
    """Flatten a WorkItem to a picklable/JSON-able dict (the worker and
    the journal both speak this)."""
    j = item.job
    ckpt = None
    if item.checkpoint is not None:
        ckpt = {k: item.checkpoint[k] for k in
                ("cur_cfg", "best_cfg", "baseline_time_s",
                 "iterations_done")}
    return {"item": item.item_id, "job": j.job_id, "family": j.family,
            "rung": item.rung, "budget": item.budget, "seed": j.seed,
            "extra": item.extra,
            "problem": dataclasses.asdict(j.problem),
            "start_cfg": dataclasses.asdict(j.start_cfg),
            "checkpoint": ckpt}


class ItemRunner:
    """Executes work items against one long-lived engine, warm-starting
    from and publishing to the shared persisted constraint cache — and,
    when enabled, the shared lesson store — around every item."""

    def __init__(self, cache_dir, *, run_kernels: bool = False,
                 temperature: float = 0.15, worker: int = 0,
                 lessons: bool = False, device="cuda"):
        self.cache_path = Path(cache_dir) / CONSTRAINTS_NAME
        self.run_kernels = run_kernels
        self.device = device
        self.temperature = temperature
        self.worker = worker
        self.constraints = ConstraintCache()   # run() warm-loads per item
        self.engine = VerificationEngine(constraints=self.constraints)
        self.lessons = (LessonStore(Path(cache_dir) / LESSONS_NAME)
                        if lessons else None)

    def run(self, wire: dict) -> dict:
        """Execute one work item; the record carries monotonic start/end
        stamps (system-wide clock, comparable across workers) so
        :func:`repro_torch.core.tuning.journal.fleet_timeline` can rebuild the
        fleet's Gantt chart from the journal alone."""
        mono0 = time.monotonic()
        sp = _obs.span("fleet.item")
        with sp:
            if _obs.enabled():
                sp.set(item=wire["item"], family=wire["family"],
                       rung=wire["rung"], budget=wire["budget"],
                       worker=self.worker)
            rec = self._run_item(wire)
        rec["mono_start_s"] = round(mono0, 6)
        rec["mono_end_s"] = round(time.monotonic(), 6)
        return rec

    def _run_item(self, wire: dict) -> dict:
        fam = get_family(wire["family"])
        prob = fam.problem_cls(**wire["problem"])
        start_cfg = fam.config_cls(**wire["start_cfg"])
        ckpt = None
        if wire.get("checkpoint"):
            c = wire["checkpoint"]
            ckpt = OptimizeCheckpoint(
                cur_cfg=fam.config_cls(**c["cur_cfg"]),
                best_cfg=fam.config_cls(**c["best_cfg"]),
                baseline_time_s=c["baseline_time_s"],
                iterations_done=c["iterations_done"])
        # pick up proofs peers published since our last item
        self.constraints.load(self.cache_path)
        # ... and, in a learning fleet, their lessons: warm-start θ from
        # the store's union, restricted to this family's skill names
        params = PlannerParams()
        lesson_stats = dict.fromkeys(_LESSON_COUNTERS, 0)
        if self.lessons is not None:
            counts = import_lessons(
                params, self.lessons.load_entries(),
                family=wire["family"],
                skills={s.name for s in fam.skills})
            lesson_stats["lessons_imported"] = counts["imported"]
            lesson_stats["lessons_reused"] = counts["reused"]
        t0 = time.perf_counter()
        st = KernelState(wire["family"], start_cfg, prob).refresh()
        # extra side-branches fork their own RNG streams off the base
        # rung's; extra == 0 reproduces the legacy streams byte-exactly
        rung_key = (f"{wire['rung']}+e{wire['extra']}"
                    if wire.get("extra") else wire["rung"])
        res = optimize_kernel(
            st, planner=Planner(params),
            selector=Selector(
                temperature=self.temperature,
                seed=stable_seed(wire["seed"], rung_key, "selector")),
            lowering=LoweringAgent(
                fault_model=False,
                seed=stable_seed(wire["seed"], rung_key, "lowering")),
            validator=Validator(run_kernels=self.run_kernels,
                                engine=self.engine, device=self.device),
            iterations=wire["budget"], checkpoint=ckpt)
        # publish our proofs for the peers (read-merge-write union)
        self.constraints.save(self.cache_path)
        if self.lessons is not None:
            lesson_stats["lessons_published"] = self.lessons.publish(
                export_lessons(res, family=wire["family"],
                               source=wire["item"]))
        stages: Dict[str, int] = {}
        for rec in res.history:
            key = rec.verdict.caught_stage or "ok"
            stages[key] = stages.get(key, 0) + 1
        # speed-of-light provenance: stamped on every record whose family
        # declares a bound, whether or not the run is SoL-guided — the
        # scheduler's stop rule and the roofline report both read it
        sol_time = sol_frac = None
        if fam.sol_bound is not None:
            sol_time = fam.sol_bound(prob).time_s
            if res.best_time_s:
                sol_frac = sol_time / res.best_time_s
        return {
            "kind": "result", "item": wire["item"], "job": wire["job"],
            "family": wire["family"], "rung": wire["rung"],
            "budget": wire["budget"], "seed": wire["seed"],
            "extra": wire.get("extra", 0),
            "problem": wire["problem"], "start_cfg": wire["start_cfg"],
            "best_cfg": dataclasses.asdict(res.best_state.cfg),
            "cur_cfg": dataclasses.asdict(res.final_state.cfg),
            "baseline_time_s": res.baseline_time_s,
            "best_time_s": res.best_time_s,
            "speedup": res.speedup,
            "sol_time_s": sol_time,
            "sol_frac": sol_frac,
            "iterations_done": res.iterations_done,
            "cost_units": res.cost_units,
            "solved": res.solved,
            "accepted": sum(r.accepted for r in res.history),
            "repairs": sum(len(r.repairs) for r in res.history),
            "verdict_stages": stages,
            "verify_stats": res.verify_stats,
            **lesson_stats,
            "worker": self.worker,
            "wall_s": time.perf_counter() - t0,
        }


def _worker_main(wid: int, cache_dir: str, run_kernels: bool,
                 lessons: bool, work_q, result_q,
                 trace_dir: Optional[str] = None,
                 device: str = "cuda") -> None:
    parent = os.getppid()
    if trace_dir:
        # per-worker tracing: spans ring up in-process, one Perfetto
        # file per worker dumped on exit (pid lane = worker id)
        _obs.enable(pid=wid)
    runner = ItemRunner(cache_dir, run_kernels=run_kernels, worker=wid,
                        lessons=lessons, device=device)
    try:
        while True:
            try:
                wire = work_q.get(timeout=2.0)
            except queue.Empty:
                if os.getppid() != parent:
                    return      # orchestrator was killed: don't orphan
                continue
            if wire is None:
                return
            if os.getppid() != parent:
                return          # don't grind through a dead parent's rung
            try:
                result_q.put(runner.run(wire))
            except Exception as e:   # report, keep serving the queue
                result_q.put({"kind": "error", "item": wire.get("item"),
                              "worker": wid,
                              "error": f"{type(e).__name__}: {e}"})
    finally:
        if trace_dir:
            try:
                _obs.tracer().save(
                    Path(trace_dir) / f"fleet_worker{wid}.trace.json")
            except OSError:
                pass            # tracing is telemetry, never a failure


class WorkerPool:
    """Spawn workers plus the in-flight bookkeeping.  ``submit`` /
    ``next_result`` are the streaming interface the async scheduler
    drives (dispatch more the moment anything completes); ``run`` is the
    batch wrapper the synchronous rungs use."""

    def __init__(self, workers: int, cache_dir, *,
                 run_kernels: bool = False, lessons: bool = False,
                 trace_dir=None, device: str = "cuda"):
        ctx = multiprocessing.get_context("spawn")
        self.work_q = ctx.Queue()
        self.result_q = ctx.Queue()
        self._pending: Dict[str, dict] = {}
        self._requeued: set = set()
        self._last_progress = time.monotonic()
        self.procs = [
            ctx.Process(target=_worker_main,
                        args=(i, str(cache_dir), run_kernels, lessons,
                              self.work_q, self.result_q,
                              str(trace_dir) if trace_dir else None,
                              device),
                        daemon=True, name=f"fleet-worker-{i}")
            for i in range(workers)]
        for p in self.procs:
            p.start()

    @property
    def pending(self) -> int:
        return len(self._pending)

    def submit(self, wire: dict) -> None:
        self._pending[wire["item"]] = wire
        self.work_q.put(wire)

    def next_result(self) -> dict:
        """Block until one submitted item's result arrives.  Handles the
        dead-worker protocol: if a worker died and the survivors have
        gone quiet for ``_STALL_S``, the missing in-flight items are
        re-dispatched (at most once each — duplicates are deterministic,
        so a late duplicate result is simply dropped)."""
        if not self._pending:
            raise RuntimeError("next_result with nothing pending")
        while True:
            try:
                rec = self.result_q.get(timeout=1.0)
            except queue.Empty:
                dead = [p.name for p in self.procs if not p.is_alive()]
                if len(dead) == len(self.procs):
                    raise RuntimeError(
                        f"all workers died mid-run ({dead}); completed "
                        f"items are journaled — re-run to resume")
                if dead and time.monotonic() - self._last_progress \
                        > _STALL_S:
                    for item, w in self._pending.items():
                        if item not in self._requeued:
                            self._requeued.add(item)
                            self.work_q.put(w)
                    self._last_progress = time.monotonic()
                continue
            self._last_progress = time.monotonic()
            if rec.get("kind") == "error":
                raise RuntimeError(
                    f"worker {rec.get('worker')} failed on "
                    f"{rec.get('item')}: {rec.get('error')}")
            if rec["item"] not in self._pending:
                continue    # duplicate from a re-dispatch — same result
            del self._pending[rec["item"]]
            return rec

    def run(self, wires: List[dict],
            on_result: Optional[Callable] = None) -> List[dict]:
        for w in wires:
            self.submit(w)
        out: List[dict] = []
        while self._pending:
            rec = self.next_result()
            if on_result is not None:
                on_result(rec)
            out.append(rec)
        return out

    def close(self) -> None:
        for _ in self.procs:
            self.work_q.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()


@dataclass
class FleetReport:
    """What one orchestrator invocation did (resumed + ran)."""

    table: DispatchTable
    records: Dict[str, dict] = field(default_factory=dict)
    ran: int = 0
    skipped: int = 0
    rungs: int = 0
    stats: Dict[str, int] = field(default_factory=dict)
    # SoL-guidance summary (empty unless sol=True): jobs stopped at the
    # floor with their sol_frac, iterations freed, iterations re-granted
    sol: Dict = field(default_factory=dict)
    # shared-lesson traffic this run (all zero unless lessons=True):
    # entries imported into planners, the cross-family subset of those,
    # and entries newly published to the store
    lessons: Dict[str, int] = field(default_factory=dict)
    wall_s: float = 0.0


def run_fleet(jobs: List[TuningJob], *, workers: int = 1,
              out_dir=".", base_budget: int = 4, max_budget: int = 32,
              eta: int = 2, run_kernels: bool = False,
              fresh: bool = False, async_mode: bool = False,
              lessons: bool = False, sol: bool = False,
              sol_slack: float = 0.1, sol_realloc: float = 0.25,
              trace_dir=None, device="cuda",
              log: Optional[Callable] = None) -> FleetReport:
    """Orchestrate the full successive-halving tune of ``jobs``.

    Writes into ``out_dir``: the crash-resumable journal, the shared
    ``constraint_cache.json`` (and ``lessons.json`` when ``lessons``),
    the versioned ``dispatch_table.json`` and the legacy
    ``tuning_cache.json`` mirror.  Re-invoking with the same (jobs,
    budgets, flags) resumes from the journal; items already journaled
    are *not* re-run.  ``async_mode`` promotes rung-free (ASHA) and
    reconciles afterwards; the table is built from the reconciled
    synchronous selection in both modes.  ``sol`` turns on speed-of-
    light guidance: jobs within ``sol_slack`` of their family's analytic
    bound stop promoting, and ``sol_realloc`` of the freed iterations
    come back as bandit-granted extras on the remaining buckets.
    ``trace_dir`` turns on span tracing: each worker (the orchestrator
    itself when serial) dumps ``fleet_worker<wid>.trace.json`` there —
    Perfetto-loadable, the within-item companion to the journal's
    monotonic-stamp timeline.  ``device`` is where the unit tests run
    the kernels under ``run_kernels`` (see the module docstring); it is
    resolved here, so the fleet raises on a host without a card unless
    it is ``"cpu"``.  It is not part of the journal fingerprint: like
    the worker count, it does not change an item's result."""
    dev = str(resolve_device(device))
    log = log or (lambda msg: None)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if trace_dir is not None:
        trace_dir = Path(trace_dir)
        trace_dir.mkdir(parents=True, exist_ok=True)
    fp = fleet_fingerprint(jobs, base_budget=base_budget,
                           max_budget=max_budget, eta=eta,
                           run_kernels=run_kernels, lessons=lessons,
                           sol_slack=sol_slack if sol else None,
                           sol_realloc=sol_realloc if sol else None)
    policy = SolPolicy(slack=sol_slack, realloc=sol_realloc,
                       seed=fp) if sol else None
    journal = Journal(out / JOURNAL_NAME)
    done = journal.start(fp, fresh=fresh)
    if done:
        log(f"journal: resuming {len(done)} finished work items")

    report = FleetReport(table=None,
                         lessons=dict.fromkeys(_LESSON_COUNTERS, 0))
    pool = (WorkerPool(workers, out, run_kernels=run_kernels,
                       lessons=lessons, trace_dir=trace_dir, device=dev)
            if workers > 1 else None)
    runner = (ItemRunner(out, run_kernels=run_kernels, lessons=lessons,
                         device=dev)
              if pool is None else None)
    if trace_dir is not None and pool is None:
        _obs.enable(pid=0)      # serial: the orchestrator is worker 0
    t0 = time.perf_counter()
    run_stats: List[Dict[str, int]] = []

    def finish(rec: dict) -> None:
        journal.append(rec)
        report.records[rec["item"]] = rec
        run_stats.append(rec["verify_stats"])
        report.ran += 1
        for k in _LESSON_COUNTERS:
            report.lessons[k] += rec.get(k, 0)
        log(f"  {rec['job']} r{rec['rung']}: "
            f"{rec['best_time_s'] * 1e3:.3f} ms "
            f"({rec['speedup']:.2f}x, {rec['accepted']} accepted, "
            f"{rec['verify_stats'].get('solver_discharges', 0)} "
            f"discharges, worker {rec['worker']})")

    def recall(item_id: str) -> None:
        """Adopt a journaled record instead of running its item."""
        report.records[item_id] = done[item_id]
        report.skipped += 1

    try:
        if async_mode:
            _run_async(jobs, report, done, pool, runner, finish, recall,
                       base_budget=base_budget, max_budget=max_budget,
                       eta=eta, sol=policy, log=log)
        else:
            _run_sync(jobs, report, done, pool, runner, finish, recall,
                      base_budget=base_budget, max_budget=max_budget,
                      eta=eta, sol=policy, log=log)

        # Reconciliation: replay the synchronous schedule over this
        # run's records and top up whatever it still needs — from the
        # journal where possible, by running otherwise.  A no-op after
        # a sync run, the determinism pass after an async one (with
        # ``sol`` that includes the bandit's extra grants, which async
        # never issues itself).  The table is built from exactly the
        # reconciled selection, never from speculative extras.
        while True:
            selected, missing = reconcile_schedule(
                jobs, report.records, base_budget=base_budget,
                max_budget=max_budget, eta=eta, sol=policy)
            if not missing:
                break
            todo = []
            for it in missing:
                if it.item_id in done:
                    recall(it.item_id)
                else:
                    todo.append(it)
            if todo:
                log(f"reconcile: {len(todo)} synchronous-schedule "
                    f"items to run")
                wires = [_to_wire(it) for it in todo]
                if pool is not None:
                    pool.run(wires, on_result=finish)
                else:
                    for w in wires:
                        finish(runner.run(w))
    finally:
        if pool is not None:
            pool.close()
        elif trace_dir is not None:
            try:
                _obs.tracer().save(trace_dir / "fleet_worker0.trace.json")
            except OSError:
                pass
            _obs.disable()

    report.rungs = 1 + max((r["rung"] for r in selected.values()),
                           default=-1)
    report.stats = merge_stats(run_stats)
    report.wall_s = time.perf_counter() - t0
    if policy is not None:
        report.sol = sol_summary(jobs, report.records,
                                 base_budget=base_budget,
                                 max_budget=max_budget, eta=eta,
                                 sol=policy)
        log(f"sol: {len(report.sol['stopped'])} jobs stopped at the "
            f"floor, {report.sol['freed_iterations']} iterations freed, "
            f"{report.sol['granted_iterations']} re-granted")
    report.table = build_table(selected.values())
    report.table.save(out / TABLE_NAME)
    update_legacy_tuning_cache(out / LEGACY_CACHE_NAME, report.table)
    return report


def _run_sync(jobs, report, done, pool, runner, finish, recall, *,
              base_budget, max_budget, eta, sol=None, log) -> None:
    """Synchronous rungs: run each rung to completion, then promote.
    Only base items feed promotion — bandit extras run in the same
    batches but their records go straight to the journal/table."""
    sched = SuccessiveHalving(jobs, base_budget=base_budget,
                              max_budget=max_budget, eta=eta, sol=sol)
    items = sched.first_rung()
    while items:
        cached = [it for it in items if it.item_id in done]
        pending = [it for it in items if it.item_id not in done]
        for it in cached:
            recall(it.item_id)
        log(f"rung {sched.rung}: {len(items)} jobs × "
            f"{items[0].budget} iterations "
            f"({len(pending)} to run, {len(cached)} from journal)")
        wires = [_to_wire(it) for it in pending]
        if pool is not None:
            pool.run(wires, on_result=finish)
        else:
            for w in wires:
                finish(runner.run(w))
        rung_records = {r["job"]: r for r in
                        (report.records[it.item_id] for it in items
                         if not it.extra)}
        items = sched.next_rung(rung_records)


def _run_async(jobs, report, done, pool, runner, finish, recall, *,
               base_budget, max_budget, eta, sol=None, log) -> None:
    """Rung-free ASHA: dispatch promotions the moment their rank
    justifies them.  Journaled items feed the scheduler as instant
    results; everything else streams through the pool (or runs FIFO
    serially).  No barrier anywhere — a straggler delays only its own
    chain."""
    asched = AsyncSuccessiveHalving(jobs, base_budget=base_budget,
                                    max_budget=max_budget, eta=eta,
                                    sol=sol)
    serial_q: deque = deque()     # wires awaiting the in-process runner
    replayed: deque = deque()     # journal records awaiting on_result

    def dispatch(item: WorkItem) -> None:
        if item.item_id in done:
            recall(item.item_id)
            replayed.append(done[item.item_id])
        elif pool is not None:
            pool.submit(_to_wire(item))
        else:
            serial_q.append(_to_wire(item))

    items = asched.initial_items()
    log(f"async: {len(items)} rung-0 jobs, rung-free promotion "
        f"(eta {asched.eta}, budgets {asched.budgets})")
    for it in items:
        dispatch(it)
    while True:
        if replayed:
            rec = replayed.popleft()
        elif pool is not None and pool.pending:
            rec = pool.next_result()
            finish(rec)
        elif pool is None and serial_q:
            rec = runner.run(serial_q.popleft())
            finish(rec)
        else:
            break
        for promoted in asched.on_result(rec):
            dispatch(promoted)