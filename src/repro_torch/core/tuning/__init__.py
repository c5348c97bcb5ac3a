"""Fleet tuner: multi-process autotuning orchestration — the port of the
JAX package's ``core/tuning``, over the port's family registry.

The subsystem that takes the paper's per-kernel agentic search to
production scale: jobs enumerated from the kernel-family registry
(:mod:`.jobs`, shape-bucket sweeps included), successive-halving budget
allocation — synchronous rungs or rung-free async ASHA with a
deterministic reconciliation pass (:mod:`.scheduler`), a
crash-resumable JSONL journal (:mod:`.journal`), cache- and
lesson-sharing worker processes (:mod:`.pool`, :mod:`.lessons`), and a
versioned serving dispatch table (:mod:`.dispatch`) that the
serve/launch paths consult.

    PYTHONPATH=src python -m repro_torch.launch.tune --workers 4

The modules are the JAX package's, line for line, but for the worker's
device: :func:`run_fleet` takes ``device=`` (default ``"cuda"``) and
hands it to every worker's :class:`repro_torch.core.harness.Validator`,
whose unit tests then run the families' CUDA kernels there (their plain
versions on the CPU).
"""
from .dispatch import (DispatchTable, build_table, configured, install,
                       shape_bucket)
from .dispatch import load as load_dispatch_table
from .jobs import TuningJob, enumerate_jobs, make_job, stable_seed

# The orchestration half (pool pulls in multiprocessing + the whole
# harness) loads lazily: the serving/kernel paths import this package
# only for the dispatch hooks above and must not pay for the fleet.
_LAZY = {"Journal": ".journal", "JournalMismatch": ".journal",
         "SuccessiveHalving": ".scheduler", "WorkItem": ".scheduler",
         "AsyncSuccessiveHalving": ".scheduler",
         "reconcile_schedule": ".scheduler",
         "sol_summary": ".scheduler",
         "SolPolicy": ".bandit", "GapBandit": ".bandit",
         "LessonStore": ".lessons", "LESSONS_NAME": ".lessons",
         "lesson_key": ".lessons",
         "FleetReport": ".pool", "ItemRunner": ".pool",
         "fleet_fingerprint": ".pool", "run_fleet": ".pool"}

__all__ = ["TuningJob", "enumerate_jobs", "make_job", "stable_seed",
           "DispatchTable", "build_table", "load_dispatch_table",
           "configured", "install", "shape_bucket", *_LAZY]


def __getattr__(name: str):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    from importlib import import_module
    return getattr(import_module(target, __name__), name)
