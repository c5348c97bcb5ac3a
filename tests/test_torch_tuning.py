"""The port's fleet tuner, pure modules and dispatch table
(``repro_torch.core.tuning``), against the JAX package's
(``repro.core.tuning``): job identities and shape buckets, the
successive-halving schedulers, the speed-of-light policy and its bandit,
the journal and the lesson store (each package reads the other's files),
``build_table`` and the dispatch hooks of the port's kernel entry
points.  The fleet itself and serving through a table are in
``test_torch_tuning_fleet.py``."""
import copy
import dataclasses
import json
import random

import pytest
import torch

from repro.core.families import get_family as jax_family
from repro.core import tuning as jt
from repro.core.tuning import dispatch as jdispatch
from repro.core.tuning import journal as jjournal
from repro.core.tuning import lessons as jlessons
from repro.core.tuning import scheduler as jsched
from repro_torch.core.families import all_families, get_family
from repro_torch.core import tuning as pt
from repro_torch.core.tuning import dispatch as pdispatch
from repro_torch.core.tuning import journal as pjournal
from repro_torch.core.tuning import lessons as plessons
from repro_torch.core.tuning import scheduler as psched

FAMILIES = [f.name for f in all_families()]


@pytest.fixture
def no_table():
    """Whatever a test installs is uninstalled after it, in both
    packages (the install is process-wide)."""
    yield
    pdispatch.install(None)
    jdispatch.install(None)


def _jax_problem(family, prob):
    return jax_family(family).problem_cls(**dataclasses.asdict(prob))


def _problems(family):
    fam = get_family(family)
    return [fam.example()[1]] + list(fam.sweep_problems())


# -- job identity ------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_job_identity_and_bucket_match_jax(family):
    """``stable_seed``, ``problem_key``, ``shape_bucket`` and the job's
    id and seed are the JAX package's for every example and sweep
    problem of the family."""
    for prob in _problems(family):
        jp = _jax_problem(family, prob)
        assert pt.jobs.problem_key(prob) == jt.jobs.problem_key(jp)
        assert pdispatch.shape_bucket(prob) == jdispatch.shape_bucket(jp)
        for seed in (0, 1, 17):
            assert pt.stable_seed(family, pt.jobs.problem_key(prob), seed) \
                == jt.stable_seed(family, jt.jobs.problem_key(jp), seed)
        pj, jj = pt.make_job(family, prob), jt.make_job(family, jp)
        assert (pj.job_id, pj.seed) == (jj.job_id, jj.seed)
        assert dataclasses.asdict(pj.start_cfg) == \
            dataclasses.asdict(jj.start_cfg)


def test_enumerate_jobs_gives_the_jax_job_set():
    """The same jobs and seeds (the order follows each package's cost
    model: the H100 model here, the TPU model there)."""
    for sweep in (False, True):
        for seed in (0, 3):
            got = {(j.job_id, j.seed)
                   for j in pt.enumerate_jobs(seed=seed, sweep=sweep)}
            want = {(j.job_id, j.seed)
                    for j in jt.enumerate_jobs(seed=seed, sweep=sweep)}
            assert got == want
    jobs = pt.enumerate_jobs(sweep=True)
    assert [j.priority for j in jobs] == sorted(
        (j.priority for j in jobs), reverse=True)
    assert {pdispatch.shape_bucket(j.problem) for j in jobs
            if j.family == "gemm"} == {pdispatch.shape_bucket(p)
                                       for p in _problems("gemm")}


# -- schedulers, SoL policy and bandit ----------------------------------------

def _jobs(n, seed):
    """The same synthetic jobs in both packages: gemm problems with
    priorities drawn from ``seed`` (ties included)."""
    rng = random.Random(seed)
    prios = [float(rng.choice([1, 2, 3, 5])) for _ in range(n)]
    out = {}
    for pkg, fam in (("p", get_family("gemm")), ("j", jax_family("gemm"))):
        cls = pt.TuningJob if pkg == "p" else jt.TuningJob
        out[pkg] = [cls("gemm", fam.problem_cls(256 * (i + 1), 512, 512),
                        fam.config_cls(), seed=i, priority=prios[i])
                    for i in range(n)]
    return out["p"], out["j"]


def _record(rng, item, fracs):
    """A journal record for ``item``: its speedup and sol_frac grow by
    a random step, some jobs reaching their bound."""
    jid = item.job.job_id
    f = min(1.0, fracs.get(jid, 0.0) + rng.choice([0.05, 0.2, 0.45]))
    fracs[jid] = f
    return {"kind": "result", "item": item.item_id, "job": jid,
            "rung": item.rung, "budget": item.budget,
            "speedup": round(1.0 + f + rng.random() * 0.1, 6),
            "sol_frac": f, "extra": item.extra}


def _view(items):
    return [(it.item_id, it.budget, it.rung, it.extra,
             None if it.checkpoint is None else it.checkpoint["item"])
            for it in items]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("sol", [False, True], ids=["plain", "sol"])
def test_successive_halving_matches_jax(seed, sol):
    """Driven by the same records, both synchronous schedulers issue
    the same items (budgets, checkpoints, bandit extras), stop the same
    jobs and free and grant the same iterations; reconciliation and the
    SoL summary agree."""
    pj, jj = _jobs(7, seed)
    ppol = pt.SolPolicy(seed=f"fp{seed}") if sol else None
    jpol = jt.SolPolicy(seed=f"fp{seed}") if sol else None
    kw = dict(base_budget=2, max_budget=16, eta=2)
    ps = psched.SuccessiveHalving(pj, sol=ppol, **kw)
    js = jsched.SuccessiveHalving(jj, sol=jpol, **kw)
    rng, fracs, records = random.Random(seed), {}, {}
    pi, ji = ps.first_rung(), js.first_rung()
    while pi or ji:
        assert _view(pi) == _view(ji)
        for it in pi:
            records[it.item_id] = _record(rng, it, fracs)
        base = {it.job.job_id: records[it.item_id] for it in pi
                if not it.extra}
        pi, ji = ps.next_rung(base), js.next_rung(base)
    assert ps.stopped.keys() == js.stopped.keys()
    assert (ps.freed_iterations, ps.granted_iterations) == \
        (js.freed_iterations, js.granted_iterations)
    if sol:
        assert any("+e" in i for i in records) or not ps.freed_iterations
    got = psched.reconcile_schedule(pj, records, sol=ppol, **kw)
    want = jsched.reconcile_schedule(jj, records, sol=jpol, **kw)
    assert sorted(got[0]) == sorted(want[0]) and got[1] == [] == want[1]
    if sol:
        assert psched.sol_summary(pj, records, sol=ppol, **kw) == \
            jsched.sol_summary(jj, records, sol=jpol, **kw)
    # a partial journal: the same first incomplete rung is missing
    partial = dict(list(records.items())[:len(records) // 2])
    got = psched.reconcile_schedule(pj, partial, sol=ppol, **kw)
    want = jsched.reconcile_schedule(jj, partial, sol=jpol, **kw)
    assert sorted(got[0]) == sorted(want[0])
    assert _view(got[1]) == _view(want[1])


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("sol", [False, True], ids=["plain", "sol"])
def test_async_successive_halving_matches_jax(seed, sol):
    """Completions in the same (shuffled) order unlock the same
    promotions in both ASHA schedulers."""
    pj, jj = _jobs(6, seed)
    kw = dict(base_budget=2, max_budget=8, eta=2)
    pa = psched.AsyncSuccessiveHalving(
        pj, sol=pt.SolPolicy(seed="s") if sol else None, **kw)
    ja = jsched.AsyncSuccessiveHalving(
        jj, sol=jt.SolPolicy(seed="s") if sol else None, **kw)
    rng, fracs = random.Random(100 + seed), {}
    frontier = pa.initial_items()
    assert _view(frontier) == _view(ja.initial_items())
    while frontier:
        it = frontier.pop(rng.randrange(len(frontier)))
        rec = _record(rng, it, fracs)
        got, want = pa.on_result(rec), ja.on_result(rec)
        assert _view(got) == _view(want)
        frontier += got
    assert pa.on_result({"job": "ghost", "rung": 0, "speedup": 9.0}) == []


def test_sol_policy_and_bandit_match_jax():
    for frac in (None, 0.5, 0.9, 0.91, 1.0):
        for slack in (0.0, 0.1, 0.5):
            rec = {} if frac is None else {"sol_frac": frac}
            assert pt.SolPolicy(slack=slack).stops(rec) == \
                jt.SolPolicy(slack=slack).stops(rec)
    rng = random.Random(5)
    pb, jb = (pt.GapBandit(pt.SolPolicy(seed="fp")),
              jt.GapBandit(jt.SolPolicy(seed="fp")))
    arms = [f"job{i}" for i in range(5)]
    for _ in range(40):
        if rng.random() < 0.5:
            a, g, n = rng.choice(arms), rng.random() * 0.3, rng.choice(
                [0, 2, 4])
            pb.observe(a, g, n)
            jb.observe(a, g, n)
        cands = rng.sample(arms, rng.randint(0, len(arms)))
        assert pb.grant(cands) == jb.grant(cands)


# -- journal and lesson store: each package reads the other's files ----------

def _result(item, **kw):
    return {"kind": "result", "item": item, "job": item.split("@")[0],
            "rung": 0, "speedup": 1.5, "worker": 1,
            "mono_start_s": 10.0 + len(item), "mono_end_s": 12.5, **kw}


def test_journal_written_by_jax_is_read_by_the_port(tmp_path):
    """A JAX journal with a torn tail: the port reads the same records,
    seals the fragment before its own append, and the JAX package reads
    the port's append back; the fleet timelines agree."""
    path = tmp_path / "fleet_journal.jsonl"
    jj = jjournal.Journal(path)
    jj.start("fp")
    jj.append(_result("a@r0"))
    jj.append(_result("b@r0", speedup=2.0))
    with open(path, "a") as fh:
        fh.write('{"kind": "result", "item": "c@r0", "x"')
    pj = pjournal.Journal(path)
    assert pj.start("fp") == jj.start("fp")
    assert set(pj.records()) == {"a@r0", "b@r0"}
    with pytest.raises(pjournal.JournalMismatch):
        pj.start("other")
    pj.append(_result("c@r0", speedup=3.0))
    assert jj.records() == pj.records()
    assert set(jj.records()) == {"a@r0", "b@r0", "c@r0"}
    assert pj.timeline() == jj.timeline()
    assert pjournal.fleet_timeline(pj.records()) == \
        jjournal.fleet_timeline(jj.records())


def _lesson(i, **kw):
    return {"skill": ["retile", "software_pipelining"][i % 2],
            "family": ["gemm", "quant_gemm"][i % 3 % 2],
            "source": f"job{i}@r0", "direction": "avoid",
            "advantage": round(-0.1 * (i % 7) + 0.05, 6), "stage": "solver",
            "assertion": f"assert_conform(a{i},b)", "strikes": i % 4, **kw}


def test_lesson_store_written_by_jax_is_read_by_the_port(tmp_path):
    """Keys, union and eviction are the JAX store's; each package reads
    the other's file, and the bytes after the same publications match."""
    for e in (_lesson(i) for i in range(6)):
        assert plessons.lesson_key(e) == jlessons.lesson_key(e)
    jpath, ppath = tmp_path / "j.json", tmp_path / "p.json"
    jstore, pstore = jlessons.LessonStore(jpath), plessons.LessonStore(ppath)
    batches = [[_lesson(i) for i in range(4)],
               [_lesson(i) for i in range(2, 9)], [_lesson(1)]]
    for b in batches:
        assert pstore.publish(b) == jstore.publish(b)
    assert ppath.read_bytes() == jpath.read_bytes()
    assert plessons.LessonStore(jpath).load_entries() == \
        jstore.load_entries()
    assert jlessons.LessonStore(ppath).load() == pstore.load()
    # a truncated file reads as an empty store in both
    jpath.write_text(jpath.read_text()[:40])
    assert plessons.LessonStore(jpath).load() == {} == jstore.load()
    sample = tmp_path / "schema.json"
    sample.write_text(json.dumps(plessons.SCHEMA_EXAMPLE))
    assert plessons.SCHEMA_EXAMPLE == jlessons.SCHEMA_EXAMPLE
    assert plessons.LessonStore(sample).load() == \
        jlessons.LessonStore(sample).load()


def test_lesson_eviction_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(plessons, "MAX_LESSONS", 5)
    monkeypatch.setattr(jlessons, "MAX_LESSONS", 5)
    entries = [_lesson(i) for i in range(12)]
    p, j = tmp_path / "p.json", tmp_path / "j.json"
    plessons.LessonStore(p).publish(entries)
    jlessons.LessonStore(j).publish(entries)
    assert p.read_bytes() == j.read_bytes()
    assert len(json.loads(p.read_text())["lessons"]) == 5


# -- the dispatch table ---------------------------------------------------------

def _table_records():
    """Journal records over three families and two gemm jobs sharing a
    bucket (the better speedup must win it), at several rungs."""
    gemm = [(8192, 8192, 8192), (5000, 8000, 4100)]
    recs = []
    for i, (m, n, k) in enumerate(gemm):
        for rung in range(3 - i):
            recs.append(dict(
                job=f"gemm:m={m},n={n},k={k},dtype=bf16", family="gemm",
                rung=rung, speedup=1.1 + 0.2 * rung + 0.05 * i,
                problem=dict(m=m, n=n, k=k, dtype="bf16"),
                best_cfg=dict(bm=128 * (rung + 1), bn=256, bk=512,
                              split_k=1, stagger_k=bool(i),
                              precision="f32")))
    paged = get_family("paged_attention").example()[1]
    ragged = get_family("ragged_prefill").example()[1]
    recs.append(dict(job="paged", family="paged_attention", rung=0,
                     speedup=1.0, problem=dataclasses.asdict(paged),
                     best_cfg=dict(block_pages=2)))
    recs.append(dict(job="ragged", family="ragged_prefill", rung=1,
                     speedup=1.25, problem=dataclasses.asdict(ragged),
                     best_cfg=dict(block_q=64, block_kv=128)))
    for j, r in enumerate(recs):
        r.update(seed=1000 + j, best_time_s=1e-3 / r["speedup"],
                 baseline_time_s=1e-3, iterations_done=2 + r["rung"],
                 cost_units=9.0 * (j + 1), accepted=j % 3, repairs=j % 2,
                 verdict_stages={"ok": 2, "solver": j % 2},
                 sol_frac=None if j % 2 else 0.5 + 0.01 * j)
    return recs


def test_build_table_is_byte_identical_to_jax(tmp_path):
    recs = _table_records()
    pt_table = pdispatch.build_table(copy.deepcopy(recs))
    jt_table = jdispatch.build_table(copy.deepcopy(recs))
    pt_table.save(tmp_path / "p.json")
    jt_table.save(tmp_path / "j.json")
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    assert pt_table.summary() == jt_table.summary()
    # each package loads the other's file
    assert pdispatch.load(tmp_path / "j.json").data == jt_table.data
    assert jdispatch.load(tmp_path / "p.json").data == pt_table.data
    for t, upd in ((pt_table, pdispatch.update_legacy_tuning_cache),
                   (jt_table, jdispatch.update_legacy_tuning_cache)):
        upd(tmp_path / f"{id(upd)}.json", t)
    legacy = sorted(tmp_path.glob("[0-9]*.json"))
    assert legacy[0].read_bytes() == legacy[1].read_bytes()


def _rejects(validate, data):
    try:
        validate(data)
    except ValueError as e:
        return str(e)
    return None


def test_schema_example_and_its_breakages_validate_as_in_jax():
    assert pdispatch.SCHEMA_EXAMPLE == jdispatch.SCHEMA_EXAMPLE
    pdispatch.DispatchTable(copy.deepcopy(pdispatch.SCHEMA_EXAMPLE))
    jdispatch.DispatchTable(copy.deepcopy(jdispatch.SCHEMA_EXAMPLE))
    entry = ["entries", "gemm", "m=8192,n=8192,k=8192,dtype=bf16"]

    def broken(edit):
        d = copy.deepcopy(pdispatch.SCHEMA_EXAMPLE)
        edit(d, d["entries"]["gemm"][entry[2]])
        return d
    cases = [
        broken(lambda d, e: e.pop("provenance")),
        broken(lambda d, e: e["config"].update(bogus=1)),
        broken(lambda d, e: e["problem"].pop("k")),
        broken(lambda d, e: d["entries"].update(no_such_family={})),
        broken(lambda d, e: d.update(version=2)),
        broken(lambda d, e: d.pop("entries")),
        [1, 2],
    ]
    for data in cases:
        msg = _rejects(pdispatch.validate, data)
        assert msg is not None
        assert msg == _rejects(jdispatch.validate, copy.deepcopy(data))


def _shifted(family, prob):
    """A problem in the same bucket as ``prob`` but not equal to it:
    each int field above 2 moved down by one quarter, rounded up."""
    fields = {}
    for f in dataclasses.fields(prob):
        v = getattr(prob, f.name)
        fields[f.name] = (v - v // 4 if isinstance(v, int)
                          and not isinstance(v, bool) and v > 2 else v)
    return type(prob)(**fields)


@pytest.mark.parametrize("family", FAMILIES)
def test_configured_matches_jax_at_and_around_each_entry(family, no_table):
    """A table of each family's example config at its example problem:
    ``configured`` gives the JAX package's answer at the problem, at an
    in-bucket neighbour (where the tuned config may not fit: None then,
    in both) and outside the bucket."""
    fam = get_family(family)
    cfg, prob = fam.example()
    data = {"version": 1, "entries": {family: {
        pdispatch.shape_bucket(prob): {
            "config": dataclasses.asdict(cfg),
            "problem": dataclasses.asdict(prob), "est_ms": 1.0,
            "speedup": 1.0, "provenance": {}}}}}
    pdispatch.install(copy.deepcopy(data))
    jdispatch.install(copy.deepcopy(data))
    probe = [prob, _shifted(family, prob)]
    probe.append(dataclasses.replace(probe[0], **{
        dataclasses.fields(prob)[0].name:
            getattr(prob, dataclasses.fields(prob)[0].name) * 4}))
    answers = []
    for p in probe:
        got = pdispatch.configured(family, p)
        want = jdispatch.configured(family, _jax_problem(family, p))
        answers.append(got)
        assert (None if got is None else dataclasses.asdict(got)) == \
            (None if want is None else dataclasses.asdict(want)), p
    assert answers[0] == cfg and answers[2] is None


def test_configured_skips_configs_invalid_for_the_exact_problem(no_table):
    """As in the JAX package: a tuned winner whose split_k divides the
    bucket representative's K blocks but not an in-bucket problem's is
    skipped there (None: the caller takes its default)."""
    table = copy.deepcopy(pdispatch.SCHEMA_EXAMPLE)
    entry = table["entries"]["gemm"]["m=8192,n=8192,k=8192,dtype=bf16"]
    entry["config"]["split_k"] = 4
    gemm = get_family("gemm")
    pdispatch.install(table)
    rep = gemm.problem_cls(8192, 8192, 8192, "bf16")
    assert pdispatch.configured("gemm", rep) == gemm.config_cls(
        bm=256, bn=256, bk=512, split_k=4, stagger_k=True)
    odd = gemm.problem_cls(8192, 8192, 5000, "bf16")
    assert pdispatch.shape_bucket(odd) == pdispatch.shape_bucket(rep)
    assert pdispatch.configured("gemm", odd) is None
    pdispatch.install(None)
    assert pdispatch.configured("gemm", rep) is None
    assert pdispatch.active() is None


def test_install_takes_a_path_a_dict_or_a_table(tmp_path, no_table):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(pdispatch.SCHEMA_EXAMPLE))
    for arg in (str(path), path, copy.deepcopy(pdispatch.SCHEMA_EXAMPLE),
                pdispatch.load(path)):
        t = pdispatch.install(arg)
        assert pdispatch.active() is t
        assert t.data == pdispatch.SCHEMA_EXAMPLE
    assert pdispatch.install(None) is None and pdispatch.active() is None


# -- the hook at each kernel entry point ---------------------------------------

def _sites():
    """(family, ops module, name of the kernel wrapper the op calls with
    the resolved cfg, a call on small CPU tensors, its problem and a
    non-default config that is valid there)."""
    from repro_torch.core.families.flash_attention import (
        FlashAttentionConfig, FlashAttentionProblem)
    from repro_torch.core.families.flash_decode import (FlashDecodeConfig,
                                                        FlashDecodeProblem)
    from repro_torch.core.families.gemm import GemmConfig, GemmProblem
    from repro_torch.core.families.moe import MoEConfig, MoEProblem
    from repro_torch.core.families.paged_attention import (
        PagedAttentionConfig, PagedAttentionProblem)
    from repro_torch.core.families.quant_gemm import (QuantGemmConfig,
                                                      QuantGemmProblem)
    from repro_torch.core.families.ragged_prefill import (
        RaggedPrefillConfig, RaggedPrefillProblem)
    from repro_torch.core.families.ssd import SSDConfig, SSDProblem
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.gemm import ops as gm
    from repro_torch.kernels.moe import ops as mo
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.quant_gemm import ops as qg
    from repro_torch.kernels.ragged_prefill import ops as rp
    from repro_torch.kernels.ssd import ops as sd
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    seg = torch.tensor([0] * 40 + [1] * 24, dtype=torch.int32)
    pos = torch.cat([torch.arange(40), torch.arange(24)]).int()
    tab = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    lens = torch.tensor([20, 32], dtype=torch.int32)
    return {
        "gemm": (gm, "gemm", lambda: gm.matmul(r(64, 128), r(128, 64)),
                 GemmProblem(64, 64, 128, "f32"),
                 GemmConfig(bm=32, bn=128, bk=128)),
        "flash_attention": (
            fa, "flash_attention",
            lambda: fa.mha(r(1, 2, 64, 16), r(1, 1, 64, 16),
                           r(1, 1, 64, 16)),
            FlashAttentionProblem(1, 2, 1, 64, 64, 16, True, "f32"),
            FlashAttentionConfig(block_q=32, block_kv=32)),
        "flash_decode": (
            fa, "flash_decode",
            lambda: fa.mha_decode(r(1, 2, 1, 16), r(1, 1, 64, 16),
                                  r(1, 1, 64, 16), 40),
            FlashDecodeProblem(1, 2, 1, 64, 16, "f32"),
            FlashDecodeConfig(kv_splits=2)),
        "paged_attention": (
            pa, "_paged_decode_kernel",
            lambda: pa.paged_decode(r(2, 2, 1, 16), r(9, 1, 8, 16),
                                    r(9, 1, 8, 16), tab, lens),
            PagedAttentionProblem(2, 2, 1, 32, 8, 9, 16, "f32"),
            PagedAttentionConfig(block_pages=2)),
        "ragged_prefill": (
            rp, "_ragged_prefill_kernel",
            lambda: rp.ragged_prefill_attend(
                r(2, 64, 16), r(1, 64, 16), r(1, 64, 16), seg, pos, seg,
                pos),
            RaggedPrefillProblem(2, 64, 2, 1, 16, "f32"),
            RaggedPrefillConfig(block_q=16, block_kv=32)),
        "moe": (
            mo, "grouped_ffn",
            lambda: mo.moe_ffn(r(16, 64), torch.rand(16, 2, generator=g),
                               torch.randint(0, 4, (16, 2), generator=g),
                               r(4, 64, 128), r(4, 64, 128),
                               r(4, 128, 64)),
            MoEProblem(16, 64, 128, 4, 2, "f32"),
            MoEConfig(block_t=16, block_f=64)),
        "quant_gemm": (
            qg, "quant_gemm",
            lambda: qg.quant_matmul(
                torch.randint(-8, 8, (64, 128), dtype=torch.int8,
                              generator=g),
                torch.randint(-8, 8, (128, 64), dtype=torch.int8,
                              generator=g),
                torch.rand(64, 2, generator=g),
                torch.rand(2, 64, generator=g), group=64),
            QuantGemmProblem(64, 64, 128, 64, "i8"),
            QuantGemmConfig(bm=32, bn=64, bk=32)),
        "ssd": (
            sd, "ssd_chunk_scan",
            lambda: sd.ssd(r(2, 64, 8), -torch.rand(2, 64, generator=g),
                           r(2, 64, 4), r(2, 64, 4)),
            SSDProblem(2, 64, 8, 4, "f32"), SSDConfig(chunk=16)),
    }


@pytest.mark.parametrize("family", FAMILIES)
def test_each_entry_point_takes_the_installed_table_config(
        family, monkeypatch, no_table):
    """With no ``cfg`` each validated entry point (the ten config sites
    of the seven ``ops`` modules; paged and ragged each have a second
    site, the serving gate, checked in test_torch_tuning_fleet.py)
    runs the installed table's config for its problem, and its default
    without a table."""
    ops, wrapper, call, prob, tuned = _sites()[family]
    seen = []
    real = getattr(ops, wrapper)

    def spy(*a, cfg=None, **kw):
        seen.append(cfg)
        return real(*a, cfg=cfg, **kw)
    monkeypatch.setattr(ops, wrapper, spy)
    call()
    default = seen[-1]
    assert default != tuned
    data = {"version": 1, "entries": {family: {
        pdispatch.shape_bucket(prob): {
            "config": dataclasses.asdict(tuned),
            "problem": dataclasses.asdict(prob), "est_ms": 1.0,
            "speedup": 1.0, "provenance": {}}}}}
    pdispatch.install(data)
    assert pdispatch.configured(family, prob) == tuned
    call()
    assert seen[-1] == tuned
    pdispatch.install(None)
    call()
    assert seen[-1] == default


def test_the_serving_gates_take_the_table_config(no_table):
    """The second site of each serving family: ``validate_block_tables``
    and ``verified_config`` return the table's config; a ragged entry
    whose block_q passes at the problem but does not tile the packed
    queries gives None, as in the JAX package (the engine then takes
    the gather path)."""
    from repro.kernels.paged_attention.ops import \
        validate_block_tables as jvbt
    from repro.kernels.ragged_prefill.ops import verified_config as jvc
    from repro_torch.core.families.paged_attention import \
        PagedAttentionProblem
    from repro_torch.core.families.ragged_prefill import \
        RaggedPrefillProblem
    from repro_torch.kernels.paged_attention.ops import \
        validate_block_tables
    from repro_torch.kernels.ragged_prefill.ops import verified_config
    paged = PagedAttentionProblem(4, 4, 2, 64, 8, 25, 16, "f32")
    ragged = RaggedPrefillProblem(2, 256, 4, 2, 16, "f32")
    data = {"version": 1, "entries": {
        "paged_attention": {pdispatch.shape_bucket(paged): {
            "config": {"block_pages": 8}, "problem": dataclasses.asdict(
                paged), "est_ms": 1.0, "speedup": 1.0, "provenance": {}}},
        "ragged_prefill": {pdispatch.shape_bucket(ragged): {
            "config": {"block_q": 128, "block_kv": 64},
            "problem": dataclasses.asdict(ragged), "est_ms": 1.0,
            "speedup": 1.0, "provenance": {}}}}}
    tables = torch.zeros(4, 8, dtype=torch.int32)
    kw = dict(page_size=8, pool_pages=25, q_heads=4, kv_heads=2,
              head_dim=16, dtype="f32")
    rkw = dict(q_heads=4, kv_heads=2, head_dim=16, dtype="f32")
    pdispatch.install(copy.deepcopy(data))
    jdispatch.install(copy.deepcopy(data))
    got = validate_block_tables(tables, **kw)
    want = jvbt(tables.numpy(), **kw)
    assert got.block_pages == want.block_pages == 8
    for tq in (128, 64):
        got, want = verified_config(tq, 256, 2, **rkw), jvc(tq, 256, 2,
                                                           **rkw)
        if tq == 128:
            assert (got.block_q, got.block_kv) == (want.block_q,
                                                   want.block_kv) \
                == (128, 64)
        else:
            assert got is None and want is None
    pdispatch.install(None)
    assert verified_config(64, 256, 2, **rkw).block_q == 64
