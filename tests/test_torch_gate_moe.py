"""The port's ARGUS gate and agent loop on the MoE family against the JAX
package's.  The tile program, skills, injectable bugs and their
signatures are the JAX family's: on seeded (config, problem) pairs the
two engines give the same verdicts, the same data-flow findings in the
same order, the same counterexamples and the same engine statistics,
and every injectable bug matches its ``BugSignature``.  The structural
stage is a Hopper model here and a TPU model there, so it is left out
of the comparison (as in ``test_torch_gate_attention.py``), and the
loop is held to the JAX loop with the JAX family's cost and structural
hooks swapped into the port's registry (as in
``test_torch_harness.py``).  Also: the Hopper structural model, the H100
cost model against the speed of light, and the family's reference check
on the CPU (the plain version), including a check that it catches a
wrong kernel."""
import dataclasses

import numpy as np
import pytest

from repro.core import harness as jh
from repro.core.families import get_family as jax_family
from repro.core.verify_engine import VerificationEngine as JaxEngine
from repro_torch.core import harness as ph
from repro_torch.core.families import MATCH_EXACT, MATCH_NONE, get_family
from repro_torch.core.families import base as pbase
from repro_torch.core.families import moe as fm
from repro_torch.core.verify_engine import VerificationEngine

FAMILY = "moe"
STAT_KEYS_SKIP = ("wall_",)
PROBLEMS = [(16384, 7168, 2048, 32, 8, "bf16"),   # the family's example
            (4096, 7168, 2048, 32, 8, "bf16"),
            (4096, 1536, 512, 40, 8, "bf16"),     # granite-moe-3b-a800m
            (256, 64, 32, 4, 2, "f32"),           # its reduced config
            (1000, 96, 200, 6, 2, "f32")]         # no power of two


def _pairs(rng, n):
    sizes_t = (8, 16, 32, 64, 128, 256)
    sizes_f = (8, 32, 64, 128, 256, 512, 1024)
    return [((int(rng.choice(sizes_t)), int(rng.choice(sizes_f)),
              bool(rng.integers(2))),
             PROBLEMS[int(rng.integers(len(PROBLEMS)))]) for _ in range(n)]


def _findings(res):
    fb = [f for f in res.feedback if f.stage != "structural"]
    return ([(f.stage, f.assertion_id, f.ok) for f in fb],
            [f.counterexample.render() for f in fb
             if f.counterexample is not None])


def _stats(engine):
    return {k: v for k, v in engine.stats().items()
            if not k.startswith(STAT_KEYS_SKIP)}


def _jax_pair(cfg, prob):
    jf = jax_family(FAMILY)
    return (jf.config_cls(**dataclasses.asdict(cfg)),
            jf.problem_cls(**dataclasses.asdict(prob)))


@pytest.fixture(scope="module")
def run():
    """Both engines fed the same sequence of verify calls on seeded
    pairs, a third of them with an injected bug of the config's menu."""
    fam = get_family(FAMILY)
    rng = np.random.default_rng(0)
    pe, je = VerificationEngine(), JaxEngine()
    results = []
    for cfg_t, prob_t in _pairs(rng, 60):
        cfg, prob = fam.config_cls(*cfg_t), fam.problem_cls(*prob_t)
        menu = fam.bugs_for(cfg, prob)
        bug = (menu[int(rng.integers(len(menu)))]
               if rng.integers(3) == 0 else None)
        jc, jp = _jax_pair(cfg, prob)
        results.append((cfg, prob, bug,
                        je.verify(FAMILY, jc, jp, inject_bug=bug),
                        pe.verify(FAMILY, cfg, prob, inject_bug=bug)))
    return (pe, je), results


def test_the_pairs_span_the_space(run):
    _, results = run
    assert len({(c, p) for c, p, *_ in results}) >= 50
    assert sum(p.hard_ok for *_, p in results) >= 12
    assert sum(not p.hard_ok for *_, p in results) >= 6


def test_gate_verdicts_match_the_jax_gate(run):
    _, results = run
    for cfg, prob, bug, j, p in results:
        where = f"cfg {cfg} prob {prob} bug {bug}"
        assert j.build_error == p.build_error, where
        assert j.hard_ok == p.hard_ok, where
        assert _findings(j) == _findings(p), where
        if bug is not None:
            assert not p.hard_ok, where
        elif prob.d_ff % cfg.block_f == 0:
            assert p.hard_ok, where


def test_a_block_f_beyond_d_ff_is_rejected_as_jax_rejects_it(run):
    """A d_ff block that does not divide d_ff reads another expert's
    rows of Wd: both gates reject it with a counterexample."""
    _, results = run
    bad = [(p, j) for cfg, prob, bug, j, p in results
           if bug is None and prob.d_ff % cfg.block_f]
    assert bad and all(not p.hard_ok and not j.hard_ok for p, j in bad)


def test_engine_stats_match_the_jax_engine(run):
    (pe, je), _ = run
    assert _stats(pe) == _stats(je)
    assert _stats(pe)["verify_calls"] == 60


def _bug_cases():
    fam = get_family(FAMILY)
    cfg0, prob0 = fam.example()
    return [(cfg0, prob0),
            (fm.MoEConfig(128, 512, False), prob0),
            (fm.MoEConfig(64, 128), fm.MoEProblem(4096, 1536, 512, 40, 8)),
            (fm.MoEConfig(16, 32), fm.MoEProblem(256, 64, 32, 4, 2, "f32"))]


def test_injected_bugs_match_the_same_signatures():
    fam, jfam = get_family(FAMILY), jax_family(FAMILY)
    assert [dataclasses.astuple(s) for s in fam.bug_signatures] == \
        [dataclasses.astuple(s) for s in jfam.bug_signatures]
    assert fam.injectable_bugs == jfam.injectable_bugs
    sigs = {s.bug: s for s in fam.bug_signatures}
    pe, je = VerificationEngine(), JaxEngine()
    n = 0
    for cfg, prob in _bug_cases():
        assert pe.verify(FAMILY, cfg, prob).hard_ok, (cfg, prob)
        jc, jp = _jax_pair(cfg, prob)
        assert fam.bugs_for(cfg, prob) == jfam.bugs_for(jc, jp)
        for bug in fam.bugs_for(cfg, prob):
            p = pe.verify(FAMILY, cfg, prob, inject_bug=bug)
            j = je.verify(FAMILY, jc, jp, inject_bug=bug)
            assert p.hard_ok == j.hard_ok is False, (cfg, prob, bug)
            assert _findings(p) == _findings(j), (cfg, prob, bug)
            viol = [f for f in p.violations if f.stage != "structural"]
            assert max((sigs[bug].specificity(f.stage, f.assertion_id)
                        for f in viol), default=MATCH_NONE) == \
                MATCH_EXACT, (cfg, prob, bug)
            n += 1
    assert n == 5 + 4 + 5 + 5


def test_skills_example_and_sweep_match_the_jax_family():
    fam, jfam = get_family(FAMILY), jax_family(FAMILY)
    assert [s.name for s in fam.skills] == [s.name for s in jfam.skills]
    assert [(s.tier, s.families) for s in fam.skills] == \
        [(s.tier, s.families) for s in jfam.skills]
    cfg, prob = fam.example()
    jcfg, jprob = jfam.example()
    assert dataclasses.astuple(cfg) == dataclasses.astuple(jcfg)
    assert dataclasses.astuple(prob) == dataclasses.astuple(jprob)
    assert [dataclasses.astuple(p) for p in fam.sweep_problems()] == \
        [dataclasses.astuple(p) for p in jfam.sweep_problems()]
    assert fam.trace_fields == jfam.trace_fields
    assert cfg.name() == jcfg.name()
    for c in (cfg, fm.MoEConfig(4096, 2048, False), fm.MoEConfig(64, 8)):
        jc, _ = _jax_pair(c, prob)
        for s, js in zip(fam.skills, jfam.skills):
            got = [(lbl, dataclasses.astuple(x)) for lbl, x in
                   s.contexts(c, prob)]
            want = [(lbl, dataclasses.astuple(x)) for lbl, x in
                    js.contexts(jc, jprob)]
            assert got == want, (c, s.name)


# -- the Hopper structural and cost models -------------------------------------

@pytest.mark.parametrize("dtype,split", [
    # f32 runs the mma.sync / FMA instance: 256 x 512 on 16 CTAs of
    # 128 x 64; bf16 runs it on the wgmma instance's 128 x 128 CTAs
    ("f32", "16 CTAs of 128x64"), ("bf16", "8 CTAs of 128x128")])
def test_cta_tiles_and_structural_warnings(dtype, split):
    from repro_torch.core import kernelspec as ks
    assert [fm.cta_tiles(fm.MoEConfig(bt, bf), dm) for bt, bf, dm in
            ((8, 512, 7168), (16, 32, 7168), (24, 96, 1536),
             (64, 512, 1536), (256, 1024, 64), (128, 8, 96))] == \
        [(16, 64, 128), (16, 32, 128), (16, 32, 128), (64, 64, 128),
         (128, 64, 64), (128, 32, 64)]
    assert [fm.cta_tiles(fm.MoEConfig(bt, 512), 7168, True)
            for bt in (64, 128, 192, 256)] == \
        [(64, 128, 256), (128, 128, 256), (64, 128, 256), (128, 128, 256)]
    for tm in fm.CTA_ROWS:
        for dt in ("bf16", "f32"):
            assert all(fm.smem_bytes(tm, tn, 2, dt) <= ks.SMEM_PER_CTA
                       for tn in fm.UP_COLS)
            assert all(fm.smem_bytes(tm, tn, 1, dt) <= ks.SMEM_PER_CTA
                       for tn in fm.DOWN_COLS)
    for tm in fm.WGMMA_ROWS:
        assert fm.smem_bytes(tm, 0, 0, "bf16", True) <= ks.SMEM_PER_CTA
    cfg, prob = fm._example()
    prob = dataclasses.replace(prob, dtype=dtype)
    kinds = [i.kind for i in fm.structural_moe(cfg, prob)]
    # 8 rows on 16-row CTAs, in both launches
    assert kinds == ["grain", "grain", "cta_split"]
    assert fm.structural_moe(fm.MoEConfig(128, 64), prob) == []
    [i] = fm.structural_moe(fm.MoEConfig(256, 512), prob)
    assert i.kind == "cta_split" and split in i.message
    assert fm.is_wgmma(fm.MoEConfig(256, 512), prob) == (dtype == "bf16")
    # rows off the 16-byte grain (d_model 100 in bf16) are staged element
    # by element on the mma.sync tiles: a grain finding, never unsupported
    odd = fm.MoEProblem(1000, 100, 200, 6, 2, "bf16")
    kinds = [i.kind for i in fm.structural_moe(fm.MoEConfig(8, 40), odd)]
    assert "grain" in kinds and "unsupported" not in kinds
    assert not fm.is_wgmma(fm.MoEConfig(64, 128), odd)


def test_the_down_launch_grain_warns_of_masked_d_model_columns():
    """d_model 96 is no multiple of 128: the down launch runs 64-column
    CTAs, the second of them half masked; the structural model says so,
    as the cost model prices it."""
    prob = fm.MoEProblem(1024, 96, 256, 8, 2, "bf16")
    cfg = fm.MoEConfig(128, 64)
    assert fm.cta_tiles(cfg, 96) == (128, 64, 64)
    [i] = fm.structural_moe(cfg, prob)
    assert i.kind == "grain" and i.message.startswith("Y: tile 128x96 ")
    assert fm.structural_moe(cfg, dataclasses.replace(prob, d_model=128)
                             ) == []
    assert fm.grain_util((128, 96, 256), (128, 64), fm.K_CHUNK) == 0.75


def test_speed_of_light_and_the_capacity_rows():
    """moe_sol counts the routed rows (11.67 ms at the production problem
    by operations); the kernel computes E x capacity rows, 1.25 x as
    many here, and the cost model counts those."""
    want = (11.673e-3, 2.918e-3, 23.347e-3)
    for prob, w in zip(fm._sweep(), want):
        sol = fm.moe_sol(prob)
        assert sol.bound == "compute"
        assert sol.time_s == pytest.approx(w, rel=1e-3)
        rows = prob.n_experts * fm.capacity_for(prob.tokens, prob.top_k,
                                                prob.n_experts, 64)
        assert rows == prob.routed_rows * 5 // 4
        est = fm.moe_cost(fm.MoEConfig(64, 512), prob)
        assert est.flops == pytest.approx(6.0 * rows * 7168 * 2048)


def test_cost_never_beats_the_speed_of_light():
    fam = get_family(FAMILY)
    rng = np.random.default_rng(1)
    for cfg_t, prob_t in _pairs(rng, 40):
        cfg, prob = fam.config_cls(*cfg_t), fam.problem_cls(*prob_t)
        assert fam.cost(cfg, prob).time_s >= fam.sol_bound(prob).time_s


def test_the_cost_model_prices_the_grain_and_the_l2_traffic():
    cfg, prob = fm._example()
    example = fm.moe_cost(cfg, prob).time_s
    dflt = fm.moe_cost(fm.MoEConfig(64, 512), prob).time_s
    big = fm.moe_cost(fm.MoEConfig(128, 512), prob).time_s
    assert example > dflt > big


# -- the reference check on the CPU --------------------------------------------

@pytest.mark.parametrize("cfg", [fm.MoEConfig(8), fm.MoEConfig(64, 512),
                                 fm.MoEConfig(16, 32, False)],
                         ids=lambda c: c.name())
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_reference_check_runs_the_plain_version_on_the_cpu(cfg, dtype):
    prob = dataclasses.replace(fm._example()[1], dtype=dtype)
    assert get_family(FAMILY).reference_check(cfg, prob, device="cpu")


def test_reference_check_catches_a_wrong_kernel(monkeypatch):
    """A grouped FFN that drops the last block_f block of d_ff, or the
    gate, fails the check."""
    import repro_torch.kernels.moe as kmoe
    from repro_torch.kernels.moe import grouped_ffn_ref
    cfg, prob = fm.MoEConfig(16, 32), fm._example()[1]

    def short_df(x, wg, wu, wd, gates=None, *, cfg):
        return grouped_ffn_ref(x, wg[..., :-32], wu[..., :-32],
                               wd[:, :-32], gates)

    def no_gate(x, wg, wu, wd, gates=None, *, cfg):
        return grouped_ffn_ref(x, wg, wu, wd)
    for wrong in (short_df, no_gate):
        monkeypatch.setattr(kmoe, "grouped_ffn", wrong)
        assert not get_family(FAMILY).reference_check(cfg, prob,
                                                      device="cpu")


# -- the agent loop --------------------------------------------------------------

def _history(res):
    return [(r.skill, r.context, r.accepted, r.verdict.caught_stage,
             r.verdict.ok, r.time_s,
             [(a.stage, a.assertion, a.specificity, a.candidates, a.picked,
               a.fixed) for a in r.repairs]) for r in res.history]


@pytest.mark.parametrize("seed,fault", [(0, False), (1, True)],
                         ids=["0-clean", "1-faults"])
def test_optimize_kernel_matches_the_jax_loop(monkeypatch, seed, fault):
    """The loop of chip_smoke.py's moe phase (the family's example
    config, 24 steps, the selector's temperature 0.15) at the 4,096-token
    sweep problem takes the JAX loop's steps."""
    fam, jf = pbase._REGISTRY[FAMILY], jax_family(FAMILY)
    monkeypatch.setitem(pbase._REGISTRY, FAMILY, dataclasses.replace(
        fam, cost=jf.cost, structural=jf.structural))

    def run(h, cfg_cls, prob_cls):
        cfg, prob = fam.example()[0], fam.sweep_problems()[1]
        st = h.KernelState(FAMILY, cfg_cls(**dataclasses.asdict(cfg)),
                           prob_cls(**dataclasses.asdict(prob))).refresh()
        return h.optimize_kernel(
            st, planner=h.Planner(),
            selector=h.Selector(temperature=0.15, seed=seed),
            lowering=h.LoweringAgent(fault_model=fault, seed=seed),
            validator=h.Validator(), iterations=24)
    j = run(jh, jf.config_cls, jf.problem_cls)
    p = run(ph, fam.config_cls, fam.problem_cls)
    assert _history(p) == _history(j)
    assert dataclasses.astuple(p.best_state.cfg) == \
        dataclasses.astuple(j.best_state.cfg)
    assert p.best_time_s == j.best_time_s and p.cost_units == j.cost_units
    assert {k: v for k, v in p.verify_stats.items()
            if not k.startswith(STAT_KEYS_SKIP)} == \
        {k: v for k, v in j.verify_stats.items()
         if not k.startswith(STAT_KEYS_SKIP)}
    if fault:
        assert p.repair_summary() == j.repair_summary()
        assert any(r.repairs for r in p.history)


def test_the_h100_model_loop_at_the_production_problem():
    cfg, prob = get_family(FAMILY).example()
    st = ph.KernelState(FAMILY, cfg, prob).refresh()
    res = ph.optimize_kernel(
        st, planner=ph.Planner(), selector=ph.Selector(temperature=0.15,
                                                       seed=0),
        validator=ph.Validator(), iterations=24)
    assert res.speedup > 1.0
    assert VerificationEngine().verify(FAMILY, res.best_state.cfg,
                                       prob).hard_ok
    assert all(r.verdict.ok for r in res.history if r.accepted)


def test_validator_runs_the_plain_version_on_the_cpu():
    cfg, prob = get_family(FAMILY).example()
    v = ph.Validator(run_kernels=True, device="cpu")
    st = ph.KernelState(FAMILY, cfg, prob).refresh()
    assert v.evaluate(ph.LoweredState(st), incumbent_s=1.0).ok
    assert v.reference_runs == 1 and v.reference_refusals == 0
