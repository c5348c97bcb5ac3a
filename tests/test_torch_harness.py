"""The port's agent loop (``repro_torch.core.harness``) against the JAX
package's (``repro.core.harness``).

The loop's logic is held to the JAX package's with the JAX family's
hardware model swapped into the port's registry for the test: its
``gemm_cost`` (and, for ``icrl_train``, its structural checks, whose
findings enter the assertion strikes of θ).  The port itself names no
TPU constant; with the port's own H100 model the loop is checked on its
own terms."""
import dataclasses

import pytest

from repro.core.families.gemm import gemm_cost as jax_gemm_cost
from repro.core.families.gemm import structural_gemm as jax_structural
from repro.core import harness as jh
from repro_torch.core import harness as ph
from repro_torch.core.families import base as pbase
from repro_torch.core.families import get_family
from repro_torch.core.families.gemm import GemmConfig, GemmProblem
from repro_torch.core.verify_engine import VerificationEngine

PROBLEMS = [(8192, 8192, 8192, "bf16"), (2048, 8192, 8192, "bf16"),
            (8192, 8192, 2048, "bf16")]


@pytest.fixture
def jax_model(monkeypatch):
    """The port's registry with the JAX family's hardware model."""
    def swap(structural=False):
        fam = pbase._REGISTRY["gemm"]
        new = dataclasses.replace(fam, cost=jax_gemm_cost)
        if structural:
            new = dataclasses.replace(new, structural=jax_structural)
        monkeypatch.setitem(pbase._REGISTRY, "gemm", new)
    return swap


def _history(res):
    return [(r.skill, r.context, r.accepted, r.verdict.caught_stage,
             r.verdict.ok, r.time_s,
             [(a.stage, a.assertion, a.specificity, a.candidates, a.picked,
               a.fixed) for a in r.repairs]) for r in res.history]


def _run(h, cfg_cls, prob_cls, prob, seed, fault):
    fam = "gemm"
    st = h.KernelState(fam, cfg_cls(), prob_cls(*prob)).refresh()
    return h.optimize_kernel(
        st, planner=h.Planner(),
        selector=h.Selector(temperature=0.15, seed=seed),
        lowering=h.LoweringAgent(fault_model=fault, seed=seed),
        validator=h.Validator(), iterations=24)


@pytest.mark.parametrize("fault", [False, True], ids=["clean", "faults"])
@pytest.mark.parametrize("seed", range(4))
def test_optimize_kernel_matches_the_jax_loop(jax_model, seed, fault):
    from repro.core.families import get_family as jax_family
    jax_model()
    jf = jax_family("gemm")
    prob = PROBLEMS[seed % len(PROBLEMS)]
    j = _run(jh, jf.config_cls, jf.problem_cls, prob, seed, fault)
    p = _run(ph, GemmConfig, GemmProblem, prob, seed, fault)
    assert _history(p) == _history(j)
    assert dataclasses.astuple(p.best_state.cfg) == \
        dataclasses.astuple(j.best_state.cfg)
    assert p.best_time_s == j.best_time_s and p.cost_units == j.cost_units
    skip = ("wall_",)
    assert {k: v for k, v in p.verify_stats.items()
            if not k.startswith(skip)} == \
        {k: v for k, v in j.verify_stats.items() if not k.startswith(skip)}
    if fault:
        assert p.repair_summary() == j.repair_summary()


def test_icrl_train_reaches_the_same_theta(jax_model):
    from repro.core.families import get_family as jax_family
    jax_model(structural=True)
    jf = jax_family("gemm")
    jt = [jh.KernelState("gemm", jf.config_cls(), jf.problem_cls(*p))
          for p in PROBLEMS]
    pt = [ph.KernelState("gemm", GemmConfig(), GemmProblem(*p))
          for p in PROBLEMS]
    jp, jr = jh.icrl_train(jt, episodes=6, iterations=8, seed=0)
    pp, pr = ph.icrl_train(pt, episodes=6, iterations=8, seed=0)
    assert pp.skill_bias == jp.skill_bias
    assert pp.lessons == jp.lessons
    assert pp.assertion_strikes == jp.assertion_strikes
    assert [_history(r) for r in pr] == [_history(r) for r in jr]
    # θ carries over through the lesson exchange the same way
    entries = jh.export_lessons(jr[-1], family="gemm", source="x")
    assert ph.export_lessons(pr[-1], family="gemm", source="x") == entries
    a, b = ph.PlannerParams(), jh.PlannerParams()
    assert ph.import_lessons(a, entries, family="gemm") == \
        jh.import_lessons(b, entries, family="gemm")
    assert a.skill_bias == b.skill_bias and a.lessons == b.lessons


@pytest.mark.parametrize("prob", PROBLEMS, ids=["square", "skinny_m",
                                                "short_k"])
def test_the_h100_model_loop_beats_the_baseline(prob):
    """With the port's own cost model the loop finds a faster config,
    and every config it accepts passes the port's gate."""
    st = ph.KernelState("gemm", GemmConfig(), GemmProblem(*prob)).refresh()
    res = ph.optimize_kernel(
        st, planner=ph.Planner(), selector=ph.Selector(temperature=0.15,
                                                       seed=0),
        validator=ph.Validator(), iterations=24)
    assert res.speedup > 1.0
    eng = VerificationEngine()
    accepted = [r for r in res.history if r.accepted]
    assert accepted
    assert eng.verify("gemm", res.best_state.cfg,
                      GemmProblem(*prob)).hard_ok
    assert all(r.verdict.ok for r in accepted)


def test_validator_runs_the_plain_version_on_the_cpu():
    v = ph.Validator(run_kernels=True, device="cpu")
    st = ph.KernelState("gemm", GemmConfig(bm=64, bn=64, bk=64),
                        GemmProblem(512, 512, 512, "bf16")).refresh()
    verdict = v.evaluate(ph.LoweredState(st), incumbent_s=1.0)
    assert verdict.ok and v.reference_runs == 1
    assert v.reference_refusals == 0
    # a config the small reference problem cannot split is refused
    # before any launch and counts as a failed unit test
    st = ph.KernelState("gemm", GemmConfig(bk=1024, split_k=2),
                        GemmProblem(8192, 8192, 8192, "bf16")).refresh()
    verdict = v.evaluate(ph.LoweredState(st), incumbent_s=1.0)
    assert not verdict.ok and verdict.caught_stage == "unit"
    assert v.reference_refusals == 1 and v.reference_runs == 1


def _with_reference(monkeypatch, fn):
    fam = pbase._REGISTRY["gemm"]
    monkeypatch.setitem(pbase._REGISTRY, "gemm",
                        dataclasses.replace(fam, reference_check=fn))


def test_a_kernel_error_propagates_from_the_validator(monkeypatch):
    """A kernel that fails to build or launch raises; it is not counted
    as a candidate that failed its unit test."""
    def broken(cfg, prob, device):
        raise RuntimeError("CUDA kernel gemm failed to launch: cudaError 98")
    _with_reference(monkeypatch, broken)
    v = ph.Validator(run_kernels=True, device="cpu")
    st = ph.KernelState("gemm", GemmConfig(),
                        GemmProblem(512, 512, 512, "bf16")).refresh()
    with pytest.raises(RuntimeError, match="failed to launch"):
        v.evaluate(ph.LoweredState(st), incumbent_s=1.0)


def test_a_precondition_error_is_a_failed_unit_test(monkeypatch):
    seen = []

    def refuse(cfg, prob, device):
        seen.append(device)
        raise ValueError("split_k must divide the K block count")
    _with_reference(monkeypatch, refuse)
    v = ph.Validator(run_kernels=True, device="cpu")
    st = ph.KernelState("gemm", GemmConfig(),
                        GemmProblem(512, 512, 512, "bf16")).refresh()
    verdict = v.evaluate(ph.LoweredState(st), incumbent_s=1.0)
    assert not verdict.ok and verdict.caught_unit
    assert verdict.violation_report == "allclose fail"
    assert [d.type for d in seen] == ["cpu"]


def test_reference_check_on_the_cpu_holds_the_plain_version():
    fam = get_family("gemm")
    for cfg in (GemmConfig(), GemmConfig(bm=32, bk=64, split_k=4),
                GemmConfig(bm=64, bn=256, stagger_k=True)):
        assert fam.reference_check(cfg, GemmProblem(1, 1, 1, "f32"), "cpu")
    with pytest.raises(ValueError, match="bf16 or f32"):
        fam.reference_check(GemmConfig(), GemmProblem(1, 1, 1, "i8"), "cpu")


def test_knowledge_base_holds_the_gemm_skills():
    names = [s.name for s in ph.KNOWLEDGE_BASE]
    assert set(names) == {s.name for s in get_family("gemm").skills}
    assert [s.name for s in ph.skills_for("gemm")] == \
        [s.name for s in jh.skills_for("gemm")]
