"""The port's fleet tuner end to end on the CPU (``run_fleet``, the
``repro_torch.launch.tune`` CLI) and serving through its dispatch table
(the paged engine and ``repro_torch.launch.serve --dispatch-table``),
against the JAX package where the two meet: with the JAX family's
hardware hooks swapped into the port's registry, the port's fleet
writes the JAX fleet's ``dispatch_table.json`` byte for byte; with the
same table installed, the port's paged kernel engine gives the JAX
engine's tokens and metrics.  With its own H100 model the port's table
is held byte-identical over one and two workers, sync and async, resume
and a kill mid-run."""
import copy
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import jax

from repro import configs as jconfigs
from repro.core import tuning as jt
from repro.core.families import get_family as jax_family
from repro.core.tuning import dispatch as jdispatch
from repro.core.tuning import pool as jpool
from repro.models import build as jax_build
from repro.obs import TickClock as JaxTickClock
from repro.serve import PagedServingEngine as JaxPaged
from repro.serve.trace import replay as jax_replay

from repro_torch import configs as tconfigs
from repro_torch.core import tuning as pt
from repro_torch.core.families import base as pbase
from repro_torch.core.families import get_family
from repro_torch.core.families.paged_attention import PagedAttentionProblem
from repro_torch.core.families.ragged_prefill import RaggedPrefillProblem
from repro_torch.core.tuning import dispatch as pdispatch
from repro_torch.core.tuning import pool as ppool
from repro_torch.kernels import ALL_KERNELS
from repro_torch.models import build as torch_build, from_jax_numpy
from repro_torch.obs import TickClock
from repro_torch.serve import PagedServingEngine
from repro_torch.serve.trace import poisson_trace, replay

REPO = Path(__file__).resolve().parent.parent
FAST = dict(base_budget=2, max_budget=4)
# the reduced qwen3-1.7b serving geometry of test_torch_serving.py
GEOM = dict(page_size=8, max_batch=4, max_len=64, prefill_chunk=8)
POOL = 25
PAGED = PagedAttentionProblem(4, 4, 2, 64, 8, POOL, 16, "bf16")
RAGGED = RaggedPrefillProblem(2, 128, 4, 2, 16, "bf16")


@pytest.fixture
def no_table():
    yield
    pdispatch.install(None)
    jdispatch.install(None)


def _gemm_problem():
    """gemm's cheapest sweep problem (2048 x 8192 x 8192)."""
    return get_family("gemm").sweep_problems()[1]


def _jobs(make_job, fam_of, problems):
    return [make_job(f, fam_of(f).problem_cls(**dataclasses.asdict(p)))
            for f, p in problems]


# -- the port's fleet against the JAX fleet -----------------------------------

def test_run_fleet_matches_jax_with_the_jax_cost(tmp_path, monkeypatch):
    """Serial, ``run_kernels=False``: with the JAX family's hardware
    hooks (cost, structural checks, speed-of-light bound) in the port's
    registry, the same jobs give the same journal fingerprint and a
    byte-identical dispatch table (and legacy cache)."""
    for f in ("gemm", "paged_attention"):
        jf = jax_family(f)
        monkeypatch.setitem(pbase._REGISTRY, f, dataclasses.replace(
            pbase._REGISTRY[f], cost=jf.cost, structural=jf.structural,
            sol_bound=jf.sol_bound))
    problems = [("gemm", _gemm_problem()), ("paged_attention", PAGED)]
    pj = _jobs(pt.make_job, get_family, problems)
    jj = _jobs(jt.make_job, jax_family, problems)
    assert [(j.job_id, j.seed, j.priority) for j in pj] == \
        [(j.job_id, j.seed, j.priority) for j in jj]
    assert ppool.fleet_fingerprint(pj, eta=2, **FAST) == \
        jpool.fleet_fingerprint(jj, eta=2, **FAST)
    prep = pt.run_fleet(pj, out_dir=tmp_path / "p", device="cpu", **FAST)
    jrep = jt.run_fleet(jj, out_dir=tmp_path / "j", **FAST)
    assert prep.ran == jrep.ran > len(pj)
    for name in ("dispatch_table.json", "tuning_cache.json"):
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
    # the same verify calls (the solver's work differs: the port verifies
    # the paged program at the CUDA kernel's step)
    assert prep.stats["verify_calls"] == jrep.stats["verify_calls"]


# -- the port's own determinism gates ------------------------------------------

def _own_jobs():
    return _jobs(pt.make_job, get_family, [
        ("gemm", _gemm_problem()), ("paged_attention", PAGED),
        ("ragged_prefill", RAGGED)])


def _fleet(out, **kw):
    return pt.run_fleet(_own_jobs(), out_dir=out, device="cpu",
                        **{**FAST, **kw})


def _table(out):
    return (Path(out) / "dispatch_table.json").read_bytes()


def test_fleet_table_is_the_same_sync_async_and_resumed(tmp_path):
    r1 = _fleet(tmp_path / "sync")
    ref = _table(tmp_path / "sync")
    assert r1.ran > 0 and r1.skipped == 0
    assert set(json.loads(ref)["entries"]) == {"gemm", "paged_attention",
                                              "ragged_prefill"}
    r2 = _fleet(tmp_path / "async", async_mode=True)
    assert _table(tmp_path / "async") == ref and r2.rungs == r1.rungs
    again = _fleet(tmp_path / "sync")
    assert again.ran == 0 and again.skipped == r1.ran
    assert _table(tmp_path / "sync") == ref
    jpath = tmp_path / "sync" / "fleet_journal.jsonl"
    lines = jpath.read_text().splitlines()
    jpath.write_text("\n".join(lines[:-1]) + "\n")     # lose the last item
    r3 = _fleet(tmp_path / "sync")
    assert r3.ran == 1 and r3.skipped == len(lines) - 2
    assert _table(tmp_path / "sync") == ref
    with pytest.raises(pt.JournalMismatch):
        _fleet(tmp_path / "sync", run_kernels=True)


@pytest.mark.multiproc
def test_fleet_table_is_the_same_on_two_workers(tmp_path):
    """Two spawn workers sharing the caches, sync and async: the one
    worker's table byte for byte, with fewer than twice its solver
    discharges."""
    r1 = _fleet(tmp_path / "w1")
    r2 = _fleet(tmp_path / "w2", workers=2)
    r3 = _fleet(tmp_path / "w2a", workers=2, async_mode=True)
    assert _table(tmp_path / "w2") == _table(tmp_path / "w1") == \
        _table(tmp_path / "w2a")
    assert r2.stats["solver_discharges"] < \
        2 * max(r1.stats["solver_discharges"], 1)
    assert {r["worker"] for r in r2.records.values()} <= {0, 1}


def test_run_kernels_runs_the_plain_versions_on_the_cpu(tmp_path,
                                                        monkeypatch):
    """``run_kernels=True, device="cpu"``: every candidate that passes
    the gate is unit-tested by its family's plain version (no kernel
    launch is counted on the CPU); all pass, so the table is the one
    without unit tests."""
    calls = {}
    for f in ("gemm", "paged_attention", "ragged_prefill"):
        fam = pbase._REGISTRY[f]

        def counted(cfg, prob, device="cuda", _fam=fam):
            assert str(device) == "cpu"
            calls[_fam.name] = calls.get(_fam.name, 0) + 1
            return _fam.reference_check(cfg, prob, device)
        monkeypatch.setitem(pbase._REGISTRY, f, dataclasses.replace(
            fam, reference_check=counted))
    for k in ALL_KERNELS:
        k.launches = 0
    rep = _fleet(tmp_path / "real", run_kernels=True)
    assert set(calls) == {"gemm", "paged_attention", "ragged_prefill"}
    oks = sum(r["verdict_stages"].get("ok", 0)
              for r in rep.records.values())
    assert sum(calls.values()) == oks > 0
    assert all(k.launches == 0 for k in ALL_KERNELS)
    _fleet(tmp_path / "model")
    assert _table(tmp_path / "real") == _table(tmp_path / "model")


def test_a_kernel_error_in_a_unit_test_stops_the_fleet(tmp_path,
                                                       monkeypatch):
    """An error launching a kernel is never a rejected candidate: it
    ends the run (serial here; a worker reports it and the parent
    raises, as in the JAX pool)."""
    fam = pbase._REGISTRY["paged_attention"]

    def broken(cfg, prob, device="cuda"):
        raise RuntimeError("paged_decode failed to launch")
    monkeypatch.setitem(pbase._REGISTRY, "paged_attention",
                        dataclasses.replace(fam, reference_check=broken))
    with pytest.raises(RuntimeError, match="failed to launch"):
        _fleet(tmp_path, run_kernels=True)


def test_run_fleet_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.run_fleet(_own_jobs(), out_dir=tmp_path, **FAST)
    assert not (tmp_path / "fleet_journal.jsonl").exists()


# -- the CLI: launch.tune, and a kill mid-run ----------------------------------

_CLI = [sys.executable, "-m", "repro_torch.launch.tune", "--device", "cpu",
        "--workers", "2", "--family", "gemm", "--family", "quant_gemm",
        "--family", "moe", "--base-budget", "2", "--max-budget", "4"]
_DONE = re.compile(r"fleet done: \d+ rungs, (\d+) items ran, "
                   r"(\d+) resumed from the journal")


def _env():
    return {**os.environ, "PYTHONPATH": str(REPO / "src")}


def test_launch_tune_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import tune
    argv = ["--device", "cpu", "--family", "gemm", "--base-budget", "1",
            "--max-budget", "2", "--out-dir", str(tmp_path)]
    rep = tune.main(argv)
    assert rep.ran == 2 and rep.rungs == 2
    out = capsys.readouterr().out
    assert "device cpu" in out and "1 tuned configs across [gemm]" in out
    table = pdispatch.load(tmp_path / "dispatch_table.json")
    assert set(table.entries) == {"gemm"}
    assert tune.main(argv + ["--expect-resume"]).ran == 0
    with pytest.raises(SystemExit):
        tune.main(["--device", "cpu", "--family", "gemm", "--base-budget",
                   "1", "--max-budget", "4", "--out-dir", str(tmp_path),
                   "--fresh", "--expect-resume"])


@pytest.mark.multiproc
def test_kill_mid_run_resumes_without_rerunning_finished(tmp_path):
    """SIGKILL the orchestrator (two spawn workers) after its first
    journaled item: the re-invocation resumes every journaled item, runs
    only the rest and writes the uninterrupted run's table; a third
    invocation runs nothing (``--expect-resume``)."""
    ref_dir, out_dir = tmp_path / "ref", tmp_path / "killed"
    ref = subprocess.run(_CLI + ["--out-dir", str(ref_dir)], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert ref.returncode == 0, ref.stderr
    proc = subprocess.Popen(_CLI + ["--out-dir", str(out_dir)], cwd=REPO,
                            env=_env(), stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    journal = out_dir / "fleet_journal.jsonl"
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and proc.poll() is None:
        if journal.exists() and '"kind": "result"' in journal.read_text():
            break
        time.sleep(0.05)
    if proc.poll() is None:
        proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=30)
    assert journal.exists(), "journal never appeared before the kill"
    finished = len(pt.Journal(journal).records())
    res = subprocess.run(_CLI + ["--out-dir", str(out_dir)], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    m = _DONE.search(res.stdout)
    assert m and int(m.group(2)) == finished, res.stdout
    assert _table(out_dir) == _table(ref_dir)
    res2 = subprocess.run(_CLI + ["--out-dir", str(out_dir),
                                  "--expect-resume"], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert res2.returncode == 0, res2.stdout + res2.stderr


# -- serving through the table ---------------------------------------------------

ARCH = "qwen3-1.7b"


@pytest.fixture(scope="module")
def models():
    jc = dataclasses.replace(jconfigs.get_reduced(ARCH), dtype="float32")
    tc = dataclasses.replace(tconfigs.get_reduced(ARCH), dtype="float32")
    jm, tm = jax_build(jc), torch_build(tc)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _entry(family, prob, cfg):
    return {"config": cfg, "problem": dataclasses.asdict(prob),
            "est_ms": 1.0, "speedup": 1.0, "provenance": {"job": family}}


def _serving_table(dtype):
    """Entries for the reduced engine's decode geometry (block_pages 2;
    the default is 4 at its 8-page tables) and for every packed prefill
    bucket it can reach (32 x 32 blocks; the default is 64 x 64 or
    64 x 128 at its 64-token-padded buffers)."""
    paged = dataclasses.replace(PAGED, dtype=dtype)
    entries = {"paged_attention": {pdispatch.shape_bucket(paged): _entry(
        "paged_attention", paged, {"block_pages": 2})}, "ragged_prefill": {}}
    for n in (1, 2, 4):
        for total in (64, 128, 256):
            prob = RaggedPrefillProblem(n, total, 4, 2, 16, dtype)
            entries["ragged_prefill"][pdispatch.shape_bucket(prob)] = \
                _entry("ragged_prefill", prob, {"block_q": 32,
                                                "block_kv": 32})
    return {"version": 1, "entries": entries}


def test_paged_engine_with_a_table_matches_jax(models, no_table):
    """The reduced qwen3 paged kernel engine with the same table in both
    packages: the table's non-default configs are the ones that ran, at
    every geometry, and tokens and the whole metrics snapshot are the
    JAX engine's — and the port's without a table."""
    jm, jp, tm, tp = models
    table = _serving_table("f32")
    kw = dict(pool_pages=POOL, eos_id=-1, decode_path="kernel",
              prefill_path="kernel", **GEOM)
    trace = poisson_trace(seed=1, n_requests=12, mean_gap=3.0,
                          prompt_lens=(4, 28), max_new=(4, 12),
                          vocab=tm.cfg.vocab)
    plain = replay(PagedServingEngine(tm, tp, clock=TickClock(),
                                      device="cpu", **kw), trace)
    teng = PagedServingEngine(tm, tp, clock=TickClock(), device="cpu",
                              dispatch_table=copy.deepcopy(table), **kw)
    assert pdispatch.active() is teng.dispatch
    got = replay(teng, trace)
    jeng = JaxPaged(jm, jp, clock=JaxTickClock(),
                    dispatch_table=copy.deepcopy(table), **kw)
    want = jax_replay(jeng, trace)
    assert got["outputs"] == want["outputs"] == plain["outputs"]
    assert got["metrics"] == want["metrics"]
    c = got["metrics"]["counters"]
    assert c["kernel_decode_ticks"] > 0 and c["kernel_prefill_ticks"] > 0
    assert c["gather_bytes"] == 0
    assert dataclasses.asdict(teng._kernel_cfg) == {"block_pages": 2} == \
        dataclasses.asdict(jeng._kernel_cfg)
    assert len(teng._prefill_cfgs) >= 2
    assert {k: dataclasses.asdict(v) for k, v in
            teng._prefill_cfgs.items()} == {k: dataclasses.asdict(v) for
                                            k, v in
                                            jeng._prefill_cfgs.items()}
    assert all(dataclasses.asdict(v) == {"block_q": 32, "block_kv": 32}
               for v in teng._prefill_cfgs.values())
    # a second engine without dispatch_table= takes the installed table
    assert PagedServingEngine(tm, tp, device="cpu", **kw).dispatch \
        is teng.dispatch


def test_launch_serve_with_a_dispatch_table(tmp_path, capsys, no_table):
    from repro_torch.launch import serve as launch
    path = tmp_path / "dispatch_table.json"
    path.write_text(json.dumps(_serving_table("bf16")))
    done = launch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--dispatch-table", str(path), "--requests", "3",
                        "--max-new-tokens", "3", "--max-len", "64",
                        "--page-size", "8", "--slots", "4"])
    assert len(done) == 3 and all(len(r.output) == 3 for r in done)
    out = capsys.readouterr().out
    assert "dispatch table: 10 tuned configs across " \
        "[paged_attention,ragged_prefill]" in out
    active = pdispatch.active()
    assert active is not None and active.data == json.loads(
        path.read_text())
    metrics = json.loads(out.split("metrics: ", 1)[1].splitlines()[0])
    assert metrics["counters"]["kernel_decode_ticks"] > 0
