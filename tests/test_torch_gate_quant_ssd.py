"""The port's ARGUS gate and agent loop on the quantized GEMM and SSD
families against the JAX package's.  The tile programs, skills,
injectable bugs, ``compatible_bugs`` and bug signatures are the JAX
families': on 60 seeded (config, problem) pairs per family the two
engines give the same verdicts, the same data-flow findings in the same
order, the same counterexamples and the same engine statistics, and
every injectable bug matches its ``BugSignature`` exactly.  The
structural stage is a Hopper model here and a TPU model there, so it is
left out of the comparison (as in ``test_torch_gate_moe.py``), and the
loop is held to the JAX loop with the JAX family's cost and structural
hooks swapped into the port's registry.  Also: the Hopper structural
model (what the card cannot run), the H100 cost model against the speed
of light, and the families' reference checks on the CPU (the plain
versions), including checks that they catch a wrong kernel."""
import dataclasses

import numpy as np
import pytest

from repro.core import harness as jh
from repro.core.families import get_family as jax_family
from repro.core.verify_engine import VerificationEngine as JaxEngine
from repro_torch.core import harness as ph
from repro_torch.core import kernelspec as ks
from repro_torch.core.families import MATCH_EXACT, MATCH_NONE, get_family
from repro_torch.core.families import base as pbase
from repro_torch.core.families import quant_gemm as fq
from repro_torch.core.families import ssd as fs
from repro_torch.core.verify_engine import VerificationEngine

FAMILIES = ("quant_gemm", "ssd")
STAT_KEYS_SKIP = ("wall_",)
PROBLEMS = {
    "quant_gemm": [(8192, 8192, 8192, 128, "i8"),   # the example
                   (2048, 8192, 8192, 128, "i8"),
                   (8192, 8192, 2048, 128, "i8"),
                   (512, 512, 1024, 256, "i8"),     # the JAX tests'
                   (300, 200, 500, 64, "i8"),       # ragged
                   (256, 256, 128, 128, "i8"),      # one scale group
                   (1024, 1024, 1024, 128, "fp8")],
    "ssd": [(64, 8192, 64, 128, "f32"),             # the example
            (64, 2048, 64, 128, "f32"),
            (192, 2048, 64, 128, "f32"),            # mamba2-780m's layer
            (8, 1024, 64, 64, "f32"),               # the JAX tests'
            (6, 48, 16, 16, "bf16"),                # its reduced config
            (3, 100, 24, 12, "f32")],               # no power of two
}


def _pairs(family, rng, n):
    probs = PROBLEMS[family]
    out = []
    for _ in range(n):
        prob = probs[int(rng.integers(len(probs)))]
        if family == "quant_gemm":
            cfg = (int(rng.choice((32, 64, 128, 256))),
                   int(rng.choice((32, 64, 128, 256))),
                   int(rng.choice((32, 64, 96, 128, 256))),
                   str(rng.choice(("f32", "bf16"))))
        else:
            cfg = (int(rng.choice((16, 32, 64, 128, 256, 512))),)
        out.append((cfg, prob))
    return out


def _findings(res):
    fb = [f for f in res.feedback if f.stage != "structural"]
    return ([(f.stage, f.assertion_id, f.ok) for f in fb],
            [f.counterexample.render() for f in fb
             if f.counterexample is not None])


def _stats(engine):
    return {k: v for k, v in engine.stats().items()
            if not k.startswith(STAT_KEYS_SKIP)}


def _jax_pair(family, cfg, prob):
    jf = jax_family(family)
    return (jf.config_cls(**dataclasses.asdict(cfg)),
            jf.problem_cls(**dataclasses.asdict(prob)))


@pytest.fixture(scope="module", params=FAMILIES)
def run(request):
    """Both engines fed the same sequence of verify calls on seeded
    pairs, a third of them with an injected bug of the config's menu."""
    family = request.param
    fam = get_family(family)
    rng = np.random.default_rng(0)
    pe, je = VerificationEngine(), JaxEngine()
    results = []
    for cfg_t, prob_t in _pairs(family, rng, 60):
        cfg, prob = fam.config_cls(*cfg_t), fam.problem_cls(*prob_t)
        menu = fam.bugs_for(cfg, prob)
        bug = (menu[int(rng.integers(len(menu)))]
               if menu and rng.integers(3) == 0 else None)
        jc, jp = _jax_pair(family, cfg, prob)
        results.append((cfg, prob, bug,
                        je.verify(family, jc, jp, inject_bug=bug),
                        pe.verify(family, cfg, prob, inject_bug=bug)))
    return family, (pe, je), results


def test_the_pairs_span_the_space(run):
    family, _, results = run
    # ssd's space is 6 chunks x 6 problems
    distinct = {"quant_gemm": 45, "ssd": 25}[family]
    assert len({(c, p) for c, p, *_ in results}) >= distinct, family
    assert sum(p.hard_ok for *_, p in results) >= 12, family
    assert sum(not p.hard_ok for *_, p in results) >= 6, family


def test_gate_verdicts_match_the_jax_gate(run):
    family, _, results = run
    for cfg, prob, bug, j, p in results:
        where = f"{family} cfg {cfg} prob {prob} bug {bug}"
        assert j.build_error == p.build_error, where
        assert j.hard_ok == p.hard_ok, where
        assert _findings(j) == _findings(p), where
        # ssd has no compatible_bugs: with one chunk, reading the "next"
        # chunk is reading this one, and both gates rightly pass it
        one_chunk = family == "ssd" and prob.seq <= cfg.chunk \
            and bug != "state_depends_c"
        if bug is not None and not one_chunk:
            assert not p.hard_ok, where


def test_engine_stats_match_the_jax_engine(run):
    family, (pe, je), _ = run
    assert _stats(pe) == _stats(je), family
    assert _stats(pe)["verify_calls"] == 60


def test_a_bk_that_does_not_divide_the_group_is_rejected_in_both():
    pe, je = VerificationEngine(), JaxEngine()
    cfg, prob = fq.QuantGemmConfig(bk=96), fq.QuantGemmProblem(512, 512,
                                                               1024, 128)
    p = pe.verify("quant_gemm", cfg, prob)
    j = je.verify("quant_gemm", *_jax_pair("quant_gemm", cfg, prob))
    assert not p.hard_ok and p.build_error == j.build_error
    assert "must divide the scale group" in p.build_error


def _bug_cases(family):
    fam = get_family(family)
    cfg0, prob0 = fam.example()
    if family == "quant_gemm":
        return [(cfg0, prob0),
                (fq.QuantGemmConfig(64, 64, 64),
                 fq.QuantGemmProblem(512, 512, 1024, 256)),
                (fq.QuantGemmConfig(128, 128, 128),
                 fq.QuantGemmProblem(256, 256, 128, 128))]
    return [(cfg0, prob0), (fs.SSDConfig(256),
                            fs.SSDProblem(192, 2048, 64, 128)),
            (fs.SSDConfig(16), fs.SSDProblem(6, 48, 16, 16, "bf16"))]


@pytest.mark.parametrize("family", FAMILIES)
def test_injected_bugs_match_the_same_signatures(family):
    fam, jfam = get_family(family), jax_family(family)
    assert [dataclasses.astuple(s) for s in fam.bug_signatures] == \
        [dataclasses.astuple(s) for s in jfam.bug_signatures]
    assert fam.injectable_bugs == jfam.injectable_bugs
    sigs = {s.bug: s for s in fam.bug_signatures}
    pe, je = VerificationEngine(), JaxEngine()
    seen = set()
    for cfg, prob in _bug_cases(family):
        assert pe.verify(family, cfg, prob).hard_ok, (cfg, prob)
        jc, jp = _jax_pair(family, cfg, prob)
        assert fam.bugs_for(cfg, prob) == jfam.bugs_for(jc, jp)
        for bug in fam.bugs_for(cfg, prob):
            p = pe.verify(family, cfg, prob, inject_bug=bug)
            j = je.verify(family, jc, jp, inject_bug=bug)
            assert p.hard_ok == j.hard_ok is False, (cfg, prob, bug)
            assert _findings(p) == _findings(j), (cfg, prob, bug)
            viol = [f for f in p.violations if f.stage != "structural"]
            assert max((sigs[bug].specificity(f.stage, f.assertion_id)
                        for f in viol), default=MATCH_NONE) == \
                MATCH_EXACT, (cfg, prob, bug)
            seen.add(bug)
    assert seen == set(fam.injectable_bugs)     # 7 and 3 bugs
    assert len(seen) == {"quant_gemm": 7, "ssd": 3}[family]


def test_compatible_bugs_follow_the_jax_menu():
    fam, jfam = get_family("quant_gemm"), jax_family("quant_gemm")
    for cfg_t, prob_t in _pairs("quant_gemm", np.random.default_rng(4),
                                40):
        cfg, prob = fam.config_cls(*cfg_t), fam.problem_cls(*prob_t)
        assert fam.bugs_for(cfg, prob) == \
            jfam.bugs_for(*_jax_pair("quant_gemm", cfg, prob))


@pytest.mark.parametrize("family", FAMILIES)
def test_skills_example_and_sweep_match_the_jax_family(family):
    fam, jfam = get_family(family), jax_family(family)
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
    for prob_t in PROBLEMS[family]:
        prob = fam.problem_cls(*prob_t)
        jc, jp = _jax_pair(family, cfg, prob)
        for s, js in zip(fam.skills, jfam.skills):
            got = [(lbl, dataclasses.astuple(x)) for lbl, x in
                   s.contexts(cfg, prob)]
            want = [(lbl, dataclasses.astuple(x)) for lbl, x in
                    js.contexts(jc, jp)]
            assert got == want, (prob, s.name)


def test_the_planner_reaches_both_families_skills():
    """The harness dispatches through the registry: the planner proposes
    each family's own rewrites."""
    for family in FAMILIES:
        fam = get_family(family)
        cfg, prob = fam.example()
        st = ph.KernelState(family, cfg, prob).refresh()
        props = ph.Planner().propose(st)
        assert props and {p.skill.name for p in props} <= \
            {s.name for s in fam.skills}, family
        assert "retile" in {p.skill.name for p in props}, family


# -- the Hopper structural and cost models ------------------------------------

def _kinds(issues):
    return [i.kind for i in issues]


def test_quant_mma_sync_tiles_and_what_the_card_cannot_run():
    """mma.sync instance: two accumulators a thread, so a 128 x 64 CTA
    holds 128 registers of them; 128 x 128 (256) or two 256 x 256
    accumulators would spill, so no compiled instance is that wide.
    wgmma instance: the two over a consumer warpgroup's 64 rows, 128
    registers at 64 x 128, beside the 232 setmaxnreg gives; at 64 x 256
    they would not fit."""
    assert fq.acc_registers(128, 64) == 128
    assert ks.check_registers("CTA", fq.acc_registers(128, 64)) == []
    for tm, tn in ((128, 128), (256, 256)):
        [i] = ks.check_registers("CTA", fq.acc_registers(tm, tn))
        assert i.kind == "registers"
    for tm in fq.CTA_ROWS:
        for tn in fq.CTA_COLS:
            assert fq.smem_bytes(tm, tn) <= ks.SMEM_PER_CTA
            assert ks.check_registers("CTA", fq.acc_registers(tm, tn)) == []
    assert [fq.cta_tile(fq.QuantGemmConfig(bm, bn)) for bm, bn in
            ((128, 128), (256, 256), (32, 64), (48, 96), (16, 32))] == \
        [(128, 64), (128, 64), (32, 64), (16, 32), (16, 32)]
    wg = fq.acc_registers(fq.WGMMA_ROWS, fq.WGMMA_COLS, wgmma=True)
    assert wg == 128 and wg + ks.REG_OVERHEAD <= fq.CONSUMER_REGS
    # a 64 x 256 warpgroup tile could not hold its two accumulators
    assert fq.acc_registers(128, 256, wgmma=True) + ks.REG_OVERHEAD > \
        fq.CONSUMER_REGS
    assert fq.smem_bytes(fq.WGMMA_ROWS, fq.WGMMA_COLS, wgmma=True) <= \
        ks.SMEM_PER_CTA


@pytest.mark.parametrize("instance", ["mma.sync", "wgmma"])
def test_quant_cta_tiles_and_what_the_card_cannot_run(instance):
    """The family example's config tile on each instance: the mma.sync
    instance (a 256-wide group and bk, which wgmma does not take) covers
    128 x 128 with two 128 x 64 CTAs and 256 x 256 with eight; the wgmma
    instance (the example itself) runs 128 x 128 on one CTA and 256 x
    256 on four."""
    cfg, prob = fq._example()
    if instance == "mma.sync":
        prob = dataclasses.replace(prob, group=256)
        cfg = dataclasses.replace(cfg, bk=256)
    big = dataclasses.replace(cfg, bm=256, bn=256)
    assert fq.is_wgmma(cfg, prob) == (instance == "wgmma")
    assert fq.instance_name(cfg, prob).startswith(instance)
    tile = (128, 64) if instance == "mma.sync" else (128, 128)
    assert fq.cta_tile(cfg, prob) == tile
    assert _kinds(fq.structural_quant_gemm(cfg, prob)) == \
        (["cta_split"] if instance == "mma.sync" else [])
    assert fq.structural_quant_gemm(
        dataclasses.replace(cfg, bn=64), prob) == []
    [i] = fq.structural_quant_gemm(big, prob)
    assert (f"{8 if instance == 'mma.sync' else 4} CTAs of "
            f"{tile[0]}x{tile[1]}") in i.message
    odd = fq.QuantGemmProblem(300, 200, 500, 100)
    assert "alignment" in _kinds(fq.structural_quant_gemm(
        fq.QuantGemmConfig(64, 64, 100), odd))
    fp8 = dataclasses.replace(prob, dtype="fp8")
    assert "unsupported" in _kinds(fq.structural_quant_gemm(cfg, fp8))


def test_ssd_structural_model():
    cfg, prob = fs._example()
    assert fs.structural_ssd(cfg, prob) == []
    # the largest chunk the loop reaches fits beside the blocks
    assert fs.smem_bytes(512, 128) <= ks.SMEM_PER_CTA
    assert fs.structural_ssd(fs.SSDConfig(512), prob) == []
    # cumulative decays of a 32768-long chunk do not
    assert "smem" in _kinds(fs.structural_ssd(
        fs.SSDConfig(32768), fs.SSDProblem(1, 32768, 64, 128)))
    # d_state above 128: state panels of 128 (the chunk states on a CTA a
    # panel), never unsupported; 130 pads to 136 (panels of 128 and 8)
    wide = _kinds(fs.structural_ssd(cfg, dataclasses.replace(
        prob, d_state=256)))
    assert "cta_split" in wide and "unsupported" not in wide
    odd = _kinds(fs.structural_ssd(cfg, dataclasses.replace(
        prob, d_state=130)))
    assert "grain" in odd and "cta_split" in odd
    assert fs.state_panels(130) == [128, 8]
    assert fs.state_panels(256) == [128, 128]
    assert fs.smem_bytes(512, 256) == fs.smem_bytes(512, 128)
    kinds = _kinds(fs.structural_ssd(fs.SSDConfig(100),
                                     fs.SSDProblem(3, 100, 24, 12)))
    assert kinds.count("grain") == 3
    assert "cta_split" in _kinds(fs.structural_ssd(
        cfg, dataclasses.replace(prob, head_dim=128)))
    # the state dim pads to the TF32 product's k of 8: N 8 is on it
    assert fs.padded_state(12) == 16 and fs.padded_state(8) == 8
    assert "grain" not in _kinds(fs.structural_ssd(
        cfg, dataclasses.replace(prob, d_state=8)))
    # the scratch states: (BH, S / q, N, P) float32, four HBM passes;
    # at a 16-long chunk they outweigh the operands
    assert fs.scratch_bytes(cfg, prob) == 4 * 64 * 128 * (128 * 64 + 1)
    assert "scratch" in _kinds(fs.structural_ssd(fs.SSDConfig(16), prob))
    assert "scratch" not in _kinds(fs.structural_ssd(fs.SSDConfig(32),
                                                     prob))


def test_speed_of_light_of_both_families():
    """quant_gemm 8192^3 int8: 1.1e12 operations at 1,979 TOP/s, 0.556
    ms; ssd 64 x 8192 x 64 x 128 float32: 2.08e10 operations at the best
    chunk (32, the causal triangle of each chunk) over the 165 TFLOP/s of
    float32-accurate tensor-core products (3xTF32: a third of 495), 0.126
    ms, against 8.07e8 bytes, 0.241 ms: bytes bound it (at the 67 TFLOP/s
    of float32 FMAs the operations took 0.310 ms and bound it)."""
    q = fq.quant_gemm_sol(fq._example()[1])
    assert q.bound == "compute"
    assert q.time_s == pytest.approx(0.5557e-3, rel=1e-3)
    s = fs.ssd_sol(fs._example()[1])
    assert s.bound == "memory"
    assert s.flops == pytest.approx(2.077e10, rel=1e-3)
    assert s.flops / 67e12 == pytest.approx(0.3100e-3, rel=1e-3)
    assert s.compute_s == pytest.approx(0.1259e-3, rel=1e-3)
    assert s.time_s == s.memory_s
    assert s.memory_s == pytest.approx(0.2410e-3, rel=1e-3)


@pytest.mark.parametrize("family", FAMILIES)
def test_cost_never_beats_the_speed_of_light(family):
    fam = get_family(family)
    for cfg_t, prob_t in _pairs(family, np.random.default_rng(1), 40):
        cfg, prob = fam.config_cls(*cfg_t), fam.problem_cls(*prob_t)
        assert fam.cost(cfg, prob).time_s >= fam.sol_bound(prob).time_s


def test_the_cost_models_price_what_the_kernels_do():
    """quant_gemm: a bk of 32 pays four times the dequant epilogues of
    128 (on both instances), the wgmma instance prices its transpose of
    B and runs the example faster than the mma.sync instance's 128 x 64
    tile; ssd: the chunk trades score work against state passes — a
    longer chunk issues more products and moves fewer state bytes."""
    prob = fq._example()[1]
    short = fq.quant_gemm_cost(fq.QuantGemmConfig(bk=32), prob)
    full = fq.quant_gemm_cost(fq.QuantGemmConfig(bk=128), prob)
    assert short.compute_s > full.compute_s
    g256 = dataclasses.replace(prob, group=256)
    assert fq.quant_gemm_cost(fq.QuantGemmConfig(128, 64, 32),
                              g256).compute_s > \
        fq.quant_gemm_cost(fq.QuantGemmConfig(128, 64, 256), g256).compute_s
    mma = fq.quant_gemm_cost(fq.QuantGemmConfig(128, 64, 128), prob)
    assert full.time_s < mma.time_s
    assert full.hbm_bytes - mma.hbm_bytes == 2 * prob.k * prob.n
    sp = fs._example()[1]
    t = {q: fs.ssd_cost(fs.SSDConfig(q), sp)
         for q in (32, 64, 128, 256, 512)}
    assert t[512].compute_s > t[64].compute_s
    assert t[64].hbm_bytes > t[128].hbm_bytes > t[256].hbm_bytes
    # the states, four passes of (BH, S / q, N, P) float32
    assert t[64].hbm_bytes - t[128].hbm_bytes == \
        4 * 4 * 64 * (128 - 64) * 128 * 64 + 3 * 4 * 64 * (128 - 64)
    assert fs.scratch_bytes(fs.SSDConfig(64), sp) == \
        4 * 64 * 128 * (128 * 64 + 1)
    assert fs.kernel_flops(fs.SSDConfig(64), sp) > \
        fs.ssd_sol(sp).flops


# -- the reference checks on the CPU ------------------------------------------

@pytest.mark.parametrize("cfg", [fq.QuantGemmConfig(),
                                 fq.QuantGemmConfig(32, 64, 32),
                                 fq.QuantGemmConfig(256, 32, 64)],
                         ids=lambda c: c.name())
def test_quant_reference_check_runs_the_plain_version_on_the_cpu(cfg):
    fam = get_family("quant_gemm")
    assert fam.reference_check(cfg, fam.example()[1], device="cpu")
    fp8 = dataclasses.replace(fam.example()[1], dtype="fp8")
    assert not fam.reference_check(cfg, fp8, device="cpu")


@pytest.mark.parametrize("chunk", [16, 64, 256])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_reference_check_runs_the_plain_version_on_the_cpu(chunk,
                                                               dtype):
    prob = dataclasses.replace(fs._example()[1], dtype=dtype)
    assert get_family("ssd").reference_check(fs.SSDConfig(chunk), prob,
                                             device="cpu")


def test_reference_checks_catch_a_wrong_kernel(monkeypatch):
    """A quant GEMM that applies the next group's A scales, and an SSD
    scan that drops the carried state, fail their checks."""
    import repro_torch.kernels.quant_gemm.ops as qops
    import repro_torch.kernels.ssd.ops as sops
    from repro_torch.kernels.quant_gemm import quant_gemm_ref
    from repro_torch.kernels.ssd import ssd_ref

    def next_group(a, b, sa, sb, *, group, cfg, out_dtype):
        return quant_gemm_ref(a, b, sa.roll(1, dims=1), sb, group=group,
                              out_dtype=out_dtype)
    monkeypatch.setattr(qops, "quant_gemm", next_group)
    fam = get_family("quant_gemm")
    assert not fam.reference_check(fam.example()[0], fam.example()[1],
                                   device="cpu")

    def no_state(x, da, Bm, Cm, *, cfg):
        q = cfg.chunk
        import torch
        return torch.cat([ssd_ref(x[:, i:i + q], da[:, i:i + q],
                                  Bm[:, i:i + q], Cm[:, i:i + q], q)[0]
                          for i in range(0, x.shape[1], q)], dim=1)
    monkeypatch.setattr(sops, "ssd_chunk_scan", no_state)
    fam = get_family("ssd")
    assert not fam.reference_check(*fam.example(), device="cpu")


# -- the agent loop -----------------------------------------------------------

def _history(res):
    return [(r.skill, r.context, r.accepted, r.verdict.caught_stage,
             r.verdict.ok, r.time_s,
             [(a.stage, a.assertion, a.specificity, a.candidates, a.picked,
               a.fixed) for a in r.repairs]) for r in res.history]


@pytest.mark.parametrize("seed,fault", [(0, False), (1, True)],
                         ids=["0-clean", "1-faults"])
@pytest.mark.parametrize("family", FAMILIES)
def test_optimize_kernel_matches_the_jax_loop(monkeypatch, family, seed,
                                              fault):
    """The loop of chip_smoke.py's phases 10b and 11b (the family's
    example config, 24 steps, the selector's temperature 0.15) at the
    second sweep problem takes the JAX loop's steps."""
    fam, jf = pbase._REGISTRY[family], jax_family(family)
    monkeypatch.setitem(pbase._REGISTRY, family, dataclasses.replace(
        fam, cost=jf.cost, structural=jf.structural))

    def run(h, cfg_cls, prob_cls):
        cfg, prob = fam.example()[0], fam.sweep_problems()[1]
        st = h.KernelState(family, cfg_cls(**dataclasses.asdict(cfg)),
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


@pytest.mark.parametrize("family", FAMILIES)
def test_the_h100_model_loop_at_the_production_problem(family):
    cfg, prob = get_family(family).example()
    st = ph.KernelState(family, cfg, prob).refresh()
    res = ph.optimize_kernel(
        st, planner=ph.Planner(), selector=ph.Selector(temperature=0.15,
                                                       seed=0),
        validator=ph.Validator(), iterations=24)
    assert res.speedup >= 1.0
    assert VerificationEngine().verify(family, res.best_state.cfg,
                                       prob).hard_ok
    assert all(r.verdict.ok for r in res.history if r.accepted)


@pytest.mark.parametrize("family", FAMILIES)
def test_validator_runs_the_plain_version_on_the_cpu(family):
    cfg, prob = get_family(family).example()
    v = ph.Validator(run_kernels=True, device="cpu")
    st = ph.KernelState(family, cfg, prob).refresh()
    assert v.evaluate(ph.LoweredState(st), incumbent_s=1.0).ok
    assert v.reference_runs == 1 and v.reference_refusals == 0
