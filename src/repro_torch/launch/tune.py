"""Fleet tuning launcher: the paper's workflow at production scale, on a
CUDA card by default.

    PYTHONPATH=src python -m repro_torch.launch.tune --workers 4 \\
        [--async] [--sweep] [--lessons] [--sol] [--sol-slack 0.1] \\
        [--family gemm --family quant_gemm] [--base-budget 4] \\
        [--max-budget 32] [--out-dir .] [--run-kernels] [--device cuda]

The port of the JAX package's ``examples/argus_optimize.py``, with its
flags, over :mod:`repro_torch.core.tuning`: tuning jobs are enumerated
from the port's kernel-family registry (one per family's production
problem — or, with ``--sweep``, one per problem in the family's
shape-bucket sweep grid), budgets are allocated successive-halving style
(every job gets ``--base-budget`` iterations, survivors by verified
cost-model score get doubled budgets up to ``--max-budget``), and work
items run on ``--workers`` cache-sharing worker processes (``--workers
1`` runs them in this process).  Progress is journaled to
``fleet_journal.jsonl`` — a killed run re-invoked with the same flags
resumes without re-running finished items — and the output is a
versioned ``dispatch_table.json`` (family -> shape bucket -> winning
config + provenance) that ``python -m repro_torch.launch.serve
--dispatch-table`` and the serving engines consult, plus the legacy
``tuning_cache.json`` mirror and the shared ``constraint_cache.json``
solver warm start.

``--async`` switches to rung-free (ASHA) promotion followed by a
deterministic reconciliation pass, so the dispatch table stays
bitwise-identical for any ``--workers`` value, sync or async.
``--lessons`` turns on the shared lesson store (``lessons.json``),
trading strict table reproducibility for within-run cross-worker
learning.  ``--sol`` turns on speed-of-light guidance: a job within
``--sol-slack`` of its family's analytic bound stops being refined, and
a share of the freed iterations is re-granted by a deterministic bandit
to the buckets still far from theirs.

``--run-kernels`` makes every accepted candidate's unit test real: the
family's CUDA kernel on ``--device`` against its plain version (the
plain version alone with ``--device cpu``).  The launcher needs a CUDA
card unless it is given ``--device cpu``.  ``--expect-resume`` asserts
that a re-invocation ran nothing; ``--fresh`` discards a stale journal.
"""
from __future__ import annotations

import argparse

from repro_torch.core.families import all_families
from repro_torch.core.tuning import enumerate_jobs, run_fleet


def main(argv=None):
    names = [f.name for f in all_families() if f.example is not None]
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", action="append", choices=names,
                    help="tune only this family (repeatable); "
                         "default: all registered families")
    ap.add_argument("--workers", type=int, default=1,
                    help="worker processes (1 = serial, in-process)")
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="rung-free (ASHA) promotion + deterministic "
                         "reconciliation — stragglers stop barriering "
                         "the pool")
    ap.add_argument("--sweep", action="store_true",
                    help="tune every problem in each family's "
                         "shape-bucket sweep grid, not just example()")
    ap.add_argument("--lessons", action="store_true",
                    help="share stage-attributed ICRL lessons across "
                         "workers via lessons.json (trades strict "
                         "table reproducibility for in-run learning)")
    ap.add_argument("--sol", action="store_true",
                    help="speed-of-light guidance: stop refining jobs "
                         "within --sol-slack of their family's analytic "
                         "bound and re-grant freed iterations to the "
                         "buckets still far from theirs")
    ap.add_argument("--sol-slack", type=float, default=0.1,
                    help="relative slack on the SoL bound before a job "
                         "stops (0.1 = within 10%%)")
    ap.add_argument("--base-budget", type=int, default=4,
                    help="rung-0 iterations for every job")
    ap.add_argument("--max-budget", type=int, default=32,
                    help="per-rung iteration cap (budgets double per "
                         "rung up to this)")
    ap.add_argument("--eta", type=int, default=2,
                    help="successive-halving keep fraction 1/eta")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--run-kernels", action="store_true",
                    help="unit-test accepted candidates: the family's "
                         "CUDA kernel on --device against its plain "
                         "version")
    ap.add_argument("--device", default="cuda",
                    help="where --run-kernels runs the kernels "
                         "(cuda, or cpu for the plain versions)")
    ap.add_argument("--out-dir", default=".",
                    help="where the journal, caches and dispatch table "
                         "live")
    ap.add_argument("--trace-dir", default=None,
                    help="dump per-worker Perfetto span traces "
                         "(fleet_worker<wid>.trace.json) here")
    ap.add_argument("--fresh", action="store_true",
                    help="discard an existing journal for a different "
                         "job set")
    ap.add_argument("--expect-resume", action="store_true",
                    help="assert everything was already journaled "
                         "(nothing ran)")
    args = ap.parse_args(argv)

    jobs = enumerate_jobs(args.family, seed=args.seed, sweep=args.sweep)
    print(f"fleet: {len(jobs)} jobs, {args.workers} worker(s), "
          f"budgets {args.base_budget}..{args.max_budget} (eta "
          f"{args.eta}), "
          f"{'async' if args.async_mode else 'sync'} promotion"
          f"{', shared lessons' if args.lessons else ''}"
          f"{f', sol slack {args.sol_slack}' if args.sol else ''}"
          f", device {args.device}")
    report = run_fleet(jobs, workers=args.workers, out_dir=args.out_dir,
                       base_budget=args.base_budget,
                       max_budget=args.max_budget, eta=args.eta,
                       run_kernels=args.run_kernels, fresh=args.fresh,
                       async_mode=args.async_mode, lessons=args.lessons,
                       sol=args.sol, sol_slack=args.sol_slack,
                       trace_dir=args.trace_dir, device=args.device,
                       log=print)

    print(f"\nfleet done: {report.rungs} rungs, {report.ran} items ran, "
          f"{report.skipped} resumed from the journal, "
          f"{report.wall_s:.1f}s wall")
    for family, buckets in sorted(report.table.entries.items()):
        for bucket, e in sorted(buckets.items()):
            p = e["provenance"]
            frac = p.get("sol_frac")
            sol_s = f", {frac:.2f} of SoL" if frac is not None else ""
            print(f"  {family:18s} {e['est_ms']:9.3f} ms "
                  f"({e['speedup']:.2f}x, {p['rungs']} rungs, "
                  f"budget {p['budget']}, {p['repairs']} repairs"
                  f"{sol_s})")
    s = report.stats
    if s:
        print(f"verify (aggregated across workers, this run): "
              f"{s.get('verify_calls', 0)} calls, "
              f"{s.get('result_hits', 0)} result hits, "
              f"{s.get('constraint_hits', 0)} constraint hits "
              f"({s.get('persisted_hits', 0)} from disk, "
              f"{s.get('canonical_hits', 0)} canonical), "
              f"{s.get('solver_discharges', 0)} solver discharges")
        print(f"build  (aggregated across workers, this run): "
              f"{s.get('full_builds', 0)} full builds, "
              f"{s.get('skeleton_rebinds', 0)} skeleton rebinds, "
              f"{s.get('program_hits', 0)} program hits")
    if args.lessons:
        les = report.lessons
        print(f"lessons (shared store, this run): "
              f"{les.get('lessons_published', 0)} published, "
              f"{les.get('lessons_imported', 0)} imported, "
              f"{les.get('lessons_reused', 0)} reused cross-family")
    print(f"wrote {args.out_dir}/dispatch_table.json "
          f"({report.table.summary()})")

    if args.expect_resume and report.ran:
        raise SystemExit(
            f"--expect-resume: journal should have covered everything "
            f"but {report.ran} items ran")
    return report


if __name__ == "__main__":
    main()
