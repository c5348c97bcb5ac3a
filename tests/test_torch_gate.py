"""The port's ARGUS gate (``repro_torch.core``) against the JAX package's
(``repro.core``): on seeded (config, problem) pairs of the GEMM family
the two engines give the same verdicts, the same data-flow findings in
the same order, the same counterexamples, the same engine statistics
and the same persisted constraint cache, and every injectable bug
matches the same ``BugSignature``.  The structural stage is the one
place they differ by design — a Hopper model here, a TPU model there —
so it is compared by its own unit tests below, not against the JAX
package."""
import dataclasses

import numpy as np
import pytest

from repro.core.families import get_family as jax_family
from repro.core.verify_engine import VerificationEngine as JaxEngine
from repro_torch.core import kernelspec as ks
from repro_torch.core.costs import (HBM_BW, grain_util, peak_flops,
                                    wave_eff)
from repro_torch.core.families import (MATCH_EXACT, MATCH_NONE,
                                       family_names, get_family)
from repro_torch.core.families.gemm import (GemmConfig, GemmProblem,
                                            cta_tile, gemm_cost, gemm_sol,
                                            smem_bytes, structural_gemm,
                                            vector_path)
from repro_torch.core.verify_engine import (ConstraintCache,
                                            VerificationEngine)

PROBLEMS = [(8192, 8192, 8192, "bf16"), (2048, 8192, 8192, "bf16"),
            (8192, 8192, 2048, "bf16"), (200, 300, 520, "f32"),
            (1000, 777, 1500, "bf16"), (512, 512, 1024, "bf16")]
SIZES = (8, 16, 32, 64, 128, 256, 512, 1024)
N_PAIRS = 320
STAT_KEYS_SKIP = ("wall_",)       # wall-clock times differ run to run


def _pairs(seed=0, n=N_PAIRS):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        bm, bn, bk = (int(rng.choice(SIZES)) for _ in range(3))
        split = int(rng.choice([1, 2, 4, 8, 5]))
        stagger = bool(rng.integers(2))
        prob = PROBLEMS[int(rng.integers(len(PROBLEMS)))]
        out.append(((bm, bn, bk, split, stagger), prob))
    return out


def _findings(res):
    """Data-flow findings in order: (stage, assertion id, ok), and each
    counterexample rendered."""
    fb = [f for f in res.feedback if f.stage != "structural"]
    return ([(f.stage, f.assertion_id, f.ok) for f in fb],
            [f.counterexample.render() for f in fb
             if f.counterexample is not None])


def _stats(engine):
    return {k: v for k, v in engine.stats().items()
            if not k.startswith(STAT_KEYS_SKIP)}


@pytest.fixture(scope="module")
def engines():
    """Both engines fed the same sequence of calls; per pair both
    results."""
    JC = jax_family("gemm").config_cls
    JP = jax_family("gemm").problem_cls
    je, pe = JaxEngine(), VerificationEngine()
    results = []
    for cfg, prob in _pairs():
        results.append((cfg, prob, je.verify("gemm", JC(*cfg), JP(*prob)),
                        pe.verify("gemm", GemmConfig(*cfg),
                                  GemmProblem(*prob))))
    return je, pe, results


def test_the_pairs_span_the_space(engines):
    _, _, results = engines
    assert len(results) >= 300
    assert any(p.build_error is not None for *_, p in results)
    assert sum(p.hard_ok for *_, p in results) > 50
    assert {c[3] for c, *_ in results} == {1, 2, 4, 8, 5}


@pytest.mark.parametrize("chunk", range(8))
def test_gate_verdicts_match_the_jax_gate(engines, chunk):
    _, _, results = engines
    for cfg, prob, j, p in results[chunk::8]:
        where = f"cfg {cfg} prob {prob}"
        assert (j.build_error is None) == (p.build_error is None), where
        assert j.build_error == p.build_error, where
        assert j.hard_ok == p.hard_ok, where
        assert _findings(j) == _findings(p), where


def test_engine_stats_match_the_jax_engine(engines):
    je, pe, _ = engines
    assert _stats(je) == _stats(pe)


def test_saved_constraint_cache_is_byte_identical(engines, tmp_path):
    je, pe, _ = engines
    jf, pf = tmp_path / "jax.json", tmp_path / "port.json"
    assert je.constraints.save(jf) == pe.constraints.save(pf) > 0
    assert jf.read_bytes() == pf.read_bytes()
    # and the port warm-starts from the JAX package's file
    warm = ConstraintCache()
    assert warm.load(jf) > 0


def test_a_warm_engine_reverifies_from_the_cache(engines, tmp_path):
    """A fresh engine loading the saved cache proves the same pairs with
    persisted hits and the same verdicts."""
    _, pe, results = engines
    path = tmp_path / "c.json"
    pe.constraints.save(path)
    cache = ConstraintCache()
    cache.load(path)
    warm = VerificationEngine(constraints=cache)
    for cfg, prob, _, p in results[:40]:
        r = warm.verify("gemm", GemmConfig(*cfg), GemmProblem(*prob))
        assert r.hard_ok == p.hard_ok and _findings(r) == _findings(p)
    assert warm.stats()["persisted_hits"] > 0


def _bug_configs():
    """Configs that build and pass, one per problem and a few tilings,
    with and without stagger (stagger_mismatch needs stagger on)."""
    out = []
    for prob in PROBLEMS:
        for cfg in (GemmConfig(), GemmConfig(bm=64, bn=256, bk=64),
                    GemmConfig(stagger_k=True),
                    GemmConfig(bm=256, bn=128, bk=256, stagger_k=True),
                    GemmConfig(bk=64, split_k=2)):
            out.append((cfg, GemmProblem(*prob)))
    return out


@pytest.mark.parametrize("idx", range(len(PROBLEMS)))
def test_injected_bugs_match_the_same_signatures(idx):
    fam, jfam = get_family("gemm"), jax_family("gemm")
    assert [dataclasses.astuple(s) for s in fam.bug_signatures] == \
        [dataclasses.astuple(s) for s in jfam.bug_signatures]
    sigs = {s.bug: s for s in fam.bug_signatures}
    pe, je = VerificationEngine(), JaxEngine()
    n = 0
    for cfg, prob in _bug_configs()[idx * 5:(idx + 1) * 5]:
        base = pe.verify("gemm", cfg, prob)
        if not base.hard_ok:
            continue
        jcfg = jfam.config_cls(**dataclasses.asdict(cfg))
        jprob = jfam.problem_cls(**dataclasses.asdict(prob))
        assert fam.bugs_for(cfg, prob) == jfam.bugs_for(jcfg, jprob)
        for bug in fam.bugs_for(cfg, prob):
            p = pe.verify("gemm", cfg, prob, inject_bug=bug)
            j = je.verify("gemm", jcfg, jprob, inject_bug=bug)
            assert p.hard_ok == j.hard_ok, (cfg, prob, bug)
            assert _findings(p) == _findings(j), (cfg, prob, bug)
            if p.hard_ok:
                # a no-op on this config: grid_short on a one-row grid
                assert bug == "grid_short" and prob.m <= cfg.bm
                continue
            viol = [f for f in p.violations if f.stage != "structural"]
            jviol = [f for f in j.violations if f.stage != "structural"]
            for name, sig in sigs.items():
                got = max((sig.specificity(f.stage, f.assertion_id)
                           for f in viol), default=MATCH_NONE)
                want = max((sig.specificity(f.stage, f.assertion_id)
                            for f in jviol), default=MATCH_NONE)
                assert got == want, (cfg, prob, bug, name)
            assert max(sigs[bug].specificity(f.stage, f.assertion_id)
                       for f in viol) == MATCH_EXACT, (cfg, prob, bug)
            n += 1
    assert n >= 10


# -- the port's own registry -------------------------------------------------

def test_registry_holds_gemm_only_and_names_the_roadmap():
    assert family_names() == ("gemm",)
    for name, item in (("flash_attention", "B4"), ("flash_decode", "B5"),
                       ("moe", "B6"), ("quant_gemm", "B7"), ("ssd", "B8"),
                       ("paged_attention", "A5")):
        with pytest.raises(KeyError, match=f"ROADMAP.md, item {item}"):
            get_family(name)
    with pytest.raises(KeyError, match="unknown kernel family"):
        get_family("nope")


def test_skill_names_match_the_jax_family():
    names = [s.name for s in get_family("gemm").skills]
    assert names == [s.name for s in jax_family("gemm").skills]


# -- the Hopper structural model ----------------------------------------------

def _kinds(cfg, prob):
    return sorted(i.kind for i in structural_gemm(cfg, prob))


def test_the_production_config_has_no_structural_issue():
    assert structural_gemm(GemmConfig(),
                           GemmProblem(8192, 8192, 8192, "bf16")) == []


@pytest.mark.parametrize("bm,bn,want", [
    (128, 128, (128, 128)), (1024, 1024, (128, 128)), (64, 32, (64, 32)),
    (8, 8, (16, 32)), (16, 64, (16, 64)), (96, 96, (32, 32)),
    (24, 200, (16, 32)), (256, 64, (128, 64))])
def test_cta_tile_is_the_largest_instance_dividing_the_tile(bm, bn, want):
    assert cta_tile(GemmConfig(bm=bm, bn=bn)) == want


def test_a_tile_larger_than_a_cta_is_a_cta_split_warning():
    prob = GemmProblem(8192, 8192, 8192, "bf16")
    issues = structural_gemm(GemmConfig(bm=1024, bn=256), prob)
    assert [i.kind for i in issues] == ["cta_split"]
    assert "16 CTAs of 128x128" in issues[0].message


def test_tiles_off_the_tensor_core_grain_are_grain_warnings():
    prob = GemmProblem(8192, 8192, 8192, "bf16")
    assert _kinds(GemmConfig(bm=8), prob) == ["grain"]
    assert _kinds(GemmConfig(bn=16), prob) == ["grain"]
    assert _kinds(GemmConfig(bk=16), prob) == ["grain"]
    assert _kinds(GemmConfig(bm=8, bk=8), prob) == ["grain", "grain"]
    # every compiled CTA tile is on the m16n8 grain; one off it is flagged
    from repro_torch.core.families.gemm import CTA_COLS, CTA_ROWS
    assert all(ks.check_grain("C", (t, u, 32), (t, u)) == []
               for t in CTA_ROWS for u in CTA_COLS)
    [i] = ks.check_grain("C", (24, 128, 32), (24, 128))
    assert "m16n8" in i.message


def test_rows_below_16_bytes_take_the_scalar_path():
    cfg = GemmConfig()
    assert vector_path(cfg, GemmProblem(512, 512, 512, "bf16"))
    # 777 bf16 = 1554 bytes: not a multiple of 16
    p = GemmProblem(1000, 777, 1500, "bf16")
    assert not vector_path(cfg, p) and _kinds(cfg, p) == ["alignment"]
    # k = 1500 bf16 = 3000 bytes; n = 772 f32 = 3088 bytes = 193 x 16
    assert not vector_path(cfg, GemmProblem(64, 768, 1500, "bf16"))
    assert vector_path(cfg, GemmProblem(64, 772, 1500, "f32"))
    assert not vector_path(cfg, GemmProblem(64, 772, 1500, "bf16"))
    # a 12-deep K block: 48 bytes of f32 (aligned), 24 of bf16 (not)
    assert vector_path(GemmConfig(bk=12), GemmProblem(64, 128, 1536, "f32"))
    assert not vector_path(GemmConfig(bk=12),
                           GemmProblem(64, 128, 1536, "bf16"))


def test_shared_memory_and_register_checks():
    # the kernel's layout: two stages of (tm x 32) and (32 x tn), each
    # row padded by 16 bytes
    assert smem_bytes(128, 128, "bf16") == 2 * (128 * 40 + 32 * 136) * 2
    assert smem_bytes(128, 128, "f32") == 2 * (128 * 36 + 32 * 132) * 4
    assert all(smem_bytes(m, n, d) <= ks.SMEM_PER_CTA
               for m in (16, 32, 64, 128) for n in (32, 64, 128)
               for d in ("bf16", "f32"))
    assert ks.check_smem("x", ks.SMEM_PER_CTA) == []
    [i] = ks.check_smem("x", ks.SMEM_PER_CTA + 1)
    assert i.kind == "smem" and "232448" in i.message
    assert ks.check_registers("x", 128) == []
    [i] = ks.check_registers("x", 256)
    assert i.kind == "registers"


def test_structural_issues_never_reject():
    """hard_ok reads the data-flow invariants only."""
    eng = VerificationEngine()
    prob = GemmProblem(1000, 777, 1500, "bf16")
    res = eng.verify("gemm", GemmConfig(bm=8, bn=1024, bk=8), prob)
    assert res.structural and res.hard_ok and not res.ok
    assert {f.repair_hint != "" for f in res.feedback
            if f.stage == "structural"} == {True}


def test_masking_obligation_is_kept():
    [i] = ks.check_masking("A", (100, 64), (64, 64), masked_dims=())
    assert i.kind == "masking"
    assert ks.check_masking("A", (100, 64), (64, 64), masked_dims=(0,)) == []


def test_ctas_per_sm_model():
    # 128 threads x 168 registers -> 3 CTAs by registers
    assert ks.ctas_per_sm(128, 168, 37_888) == 3
    # shared memory bound
    assert ks.ctas_per_sm(128, 32, 100_000) == 2
    assert ks.ctas_per_sm(1024, 255, 10) == 1


# -- the H100 cost model -----------------------------------------------------

def test_rates_are_h100_model_parameters():
    assert peak_flops("bf16") == 989e12
    assert peak_flops("f32") == 67e12
    assert peak_flops("i8") == peak_flops("fp8") == 2 * 989e12
    assert HBM_BW == 3.35e12
    assert ks.N_SMS == 132


def test_speed_of_light_at_the_production_problems():
    sol = gemm_sol(GemmProblem(8192, 8192, 8192, "bf16"))
    assert sol.bound == "compute"
    assert sol.time_s == pytest.approx(1.1117e-3, rel=1e-3)
    assert sol.memory_s == pytest.approx(403e6 / 3.35e12, rel=1e-2)
    for p in (GemmProblem(2048, 8192, 8192, "bf16"),
              GemmProblem(8192, 8192, 2048, "bf16")):
        assert gemm_sol(p).time_s == pytest.approx(0.2779e-3, rel=1e-3)


def test_wave_and_grain_terms():
    assert wave_eff(132, 1) == 1.0
    assert wave_eff(133, 1) == pytest.approx(133 / 264)
    assert wave_eff(66, 1) == 0.5
    assert grain_util((128, 128, 128), (128, 128), 32) == 1.0
    assert grain_util((8, 128, 128), (16, 128), 32) == 0.5
    assert grain_util((128, 128, 8), (128, 128), 32) == 0.25


def test_cost_never_beats_the_speed_of_light():
    prob = GemmProblem(8192, 8192, 8192, "bf16")
    sol = gemm_sol(prob).time_s
    for (bm, bn, bk, split, stagger), _ in _pairs(seed=1, n=60):
        est = gemm_cost(GemmConfig(bm, bn, bk, split, stagger), prob)
        assert est.time_s >= sol
