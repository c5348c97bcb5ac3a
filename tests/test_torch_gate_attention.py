"""The port's ARGUS gate against the JAX package's on the four attention
families: ``flash_attention`` and ``flash_decode`` (whose tile programs
are the JAX ones, verified at the config as given) and
``paged_attention`` and ``ragged_prefill`` (verified at the step the
CUDA kernel runs, ``kernel_config``, with the config's knob kept as a
precondition).  On seeded (config, problem) pairs the two engines give
the same verdicts, the same data-flow findings in the same order, the
same counterexamples and the same engine statistics, and every
injectable bug of each family's ``compatible_bugs`` menu at
``example()`` (and at a few more configs) matches its ``BugSignature``.
The structural stage is a Hopper model here and a TPU model there, so it
is left out of the comparison, as in ``test_torch_gate.py``."""
import dataclasses

import numpy as np
import pytest

from repro.core.families import get_family as jax_family
from repro.core.verify_engine import VerificationEngine as JaxEngine
from repro_torch.core.families import MATCH_EXACT, MATCH_NONE, get_family
from repro_torch.core.families import paged_attention as pa
from repro_torch.core.families import ragged_prefill as rp
from repro_torch.core.verify_engine import VerificationEngine

STAT_KEYS_SKIP = ("wall_",)
FAMILIES = ("flash_attention", "flash_decode", "paged_attention",
            "ragged_prefill")
KERNEL_STEP = {"paged_attention": pa.kernel_config,
               "ragged_prefill": rp.kernel_config}


def _fa_pairs(rng, n):
    probs = [(4, 8, 1, 1024, 2048, 128, True, "bf16"),
             (32, 8, 1, 2048, 2048, 128, True, "bf16"),
             (2, 8, 2, 1000, 1500, 128, True, "f32"),
             (1, 4, 4, 300, 200, 64, False, "bf16"),
             (2, 8, 1, 512, 512, 64, False, "f32")]
    sizes = (8, 16, 32, 64, 128, 256)
    out = []
    for _ in range(n):
        cfg = (int(rng.choice(sizes)), int(rng.choice(sizes)),
               bool(rng.integers(2)), bool(rng.integers(2)),
               bool(rng.integers(4)))
        out.append((cfg, probs[int(rng.integers(len(probs)))]))
    return out


def _fd_pairs(rng, n):
    probs = [(32, 8, 1, 8192, 128, "bf16"), (128, 8, 1, 2048, 128, "bf16"),
             (8, 8, 1, 32768, 128, "bf16"), (3, 4, 2, 1000, 64, "f32"),
             (2, 2, 2, 96, 64, "f32")]
    return [((int(rng.choice([1, 2, 3, 4, 5, 8, 16, 32])),),
             probs[int(rng.integers(len(probs)))]) for _ in range(n)]


def _pa_pairs(rng, n):
    # (B, Hq, Hkv, S, PS, P, D, dtype): six pages (a 64-token tile does
    # not divide the table), a page spanning two tiles (the family's
    # production problem), f32 tiles
    probs = [(4, 8, 2, 96, 16, 40, 128, "bf16"),
             (4, 8, 2, 96, 16, 40, 128, "f32"),
             (3, 4, 4, 128, 8, 64, 64, "bf16"),
             (2, 16, 8, 256, 16, 40, 128, "bf16"),
             (32, 8, 1, 8192, 128, 2304, 128, "bf16"),
             (2, 4, 2, 192, 32, 16, 16, "f32")]
    return [((int(rng.choice([1, 2, 3, 4, 8])),),
             probs[int(rng.integers(len(probs)))]) for _ in range(n)]


def _rp_pairs(rng, n):
    # (n_seqs, T, Hq, Hkv, D, dtype): buffers the kernel's 64 x 32 blocks
    # tile, and 48 / 40 tokens, which they do not
    probs = [(8, 2048, 8, 1, 128, "bf16"), (3, 256, 8, 2, 128, "f32"),
             (4, 192, 4, 4, 64, "bf16"), (3, 48, 4, 2, 16, "f32"),
             (2, 40, 4, 2, 16, "f32")]
    sizes = (8, 16, 32, 64, 128)
    return [((int(rng.choice(sizes)), int(rng.choice(sizes))),
             probs[int(rng.integers(len(probs)))]) for _ in range(n)]


PAIRS = {"flash_attention": _fa_pairs, "flash_decode": _fd_pairs,
         "paged_attention": _pa_pairs, "ragged_prefill": _rp_pairs}
N_PAIRS = {"flash_attention": 24, "flash_decode": 40,
           "paged_attention": 48, "ragged_prefill": 48}
# after the seeded draws, the geometries the kernels take since they read
# head_dim, the group and the page size at run time: head_dim 48, 96 and
# 112; groups 12 (starcoder2-15b), 16 (glm-4-9b) and 71 (falcon-7b's MQA);
# pages of 2, 24 (neither dividing the 64-row tile nor divided by it) and
# 512 tokens; the head dims of the panel route: 100 (rows off the 16-byte
# grain in bf16) and 320 (above 256); and 1-token pages, on which the JAX
# gate itself fails
EXTRA_PAIRS = {
    "paged_attention": [
        ((2,), (4, 8, 2, 96, 16, 40, 96, "bf16")),
        ((1,), (4, 8, 2, 96, 16, 40, 48, "f32")),
        ((4,), (3, 4, 4, 128, 8, 64, 112, "bf16")),
        ((2,), (2, 12, 1, 256, 16, 40, 128, "bf16")),
        ((2,), (2, 32, 2, 256, 16, 40, 128, "bf16")),
        ((1,), (2, 71, 1, 128, 16, 20, 64, "bf16")),
        ((2,), (2, 8, 2, 96, 24, 16, 128, "bf16")),
        ((1,), (2, 8, 2, 1024, 512, 8, 128, "bf16")),
        ((4,), (2, 8, 2, 32, 2, 40, 128, "bf16")),
        ((2,), (2, 4, 2, 64, 2, 72, 48, "f32")),
        ((2,), (4, 8, 2, 96, 16, 40, 100, "bf16")),
        ((2,), (4, 8, 2, 96, 16, 40, 320, "bf16")),
        ((2,), (2, 8, 2, 32, 1, 80, 128, "bf16"))],
    "ragged_prefill": [
        ((64, 64), (4, 192, 4, 4, 96, "bf16")),
        ((32, 32), (3, 256, 8, 2, 48, "f32")),
        ((64, 64), (4, 192, 4, 2, 112, "bf16")),
        ((128, 128), (3, 256, 12, 1, 64, "bf16")),
        ((64, 64), (2, 128, 16, 1, 128, "bf16")),
        ((64, 32), (2, 128, 71, 1, 64, "bf16")),
        ((64, 64), (4, 192, 4, 4, 100, "bf16")),
        ((64, 64), (4, 192, 4, 4, 320, "bf16"))],
    "flash_attention": [
        ((64, 64, False, True, True), (1, 4, 4, 300, 200, 96, True, "bf16")),
        ((32, 64, False, False, True), (2, 8, 2, 256, 256, 48, False,
                                        "f32")),
        ((128, 128, True, True, True), (1, 4, 1, 512, 512, 112, True,
                                        "bf16")),
        ((64, 128, False, True, True), (1, 12, 1, 256, 256, 128, True,
                                        "bf16")),
        ((64, 64, False, True, True), (1, 16, 1, 256, 256, 128, True,
                                       "bf16")),
        ((128, 64, False, True, True), (1, 71, 1, 128, 128, 64, True,
                                        "bf16")),
        ((64, 64, False, True, True), (1, 4, 4, 300, 200, 100, True,
                                       "bf16")),
        ((64, 64, False, True, True), (1, 4, 4, 300, 200, 320, True,
                                       "bf16"))],
    "flash_decode": [
        ((4,), (32, 32, 32, 2048, 96, "bf16")),
        ((2,), (3, 4, 2, 1000, 48, "f32")),
        ((8,), (8, 8, 1, 4096, 112, "bf16")),
        ((4,), (8, 48, 4, 2048, 128, "bf16")),
        ((4,), (8, 32, 2, 2048, 128, "bf16")),
        ((8,), (8, 71, 1, 2048, 64, "bf16")),
        ((4,), (8, 71, 1, 2048, 64, "f32")),
        ((4,), (8, 8, 1, 2048, 100, "bf16")),
        ((4,), (8, 8, 1, 2048, 320, "bf16"))]}
# the head dims of the panel route among the pairs
PANEL_HEAD_DIMS = (100, 320)


def _findings(res):
    fb = [f for f in res.feedback if f.stage != "structural"]
    return ([(f.stage, f.assertion_id, f.ok) for f in fb],
            [f.counterexample.render() for f in fb
             if f.counterexample is not None])


def _stats(engine):
    return {k: v for k, v in engine.stats().items()
            if not k.startswith(STAT_KEYS_SKIP)}


def _jax_side(family, cfg, prob):
    """The (config, problem) the JAX gate is held to: the config itself,
    or for the paged and ragged families the kernel's step.  None when
    the kernel cannot run the geometry at all."""
    step = KERNEL_STEP.get(family)
    if step is None:
        return cfg
    try:
        return step(cfg, prob)
    except ValueError as e:
        return None if "CUDA kernel" in str(e) else cfg


@pytest.fixture(scope="module", params=FAMILIES)
def run(request):
    """Both engines fed the same sequence of verify calls on one
    family's seeded pairs; the port's result beside the JAX one.  A
    second pair of engines is fed the pairs with one port config per
    JAX (config, problem), so that both see the same sequence of
    distinct keys, for the statistics."""
    family = request.param
    fam, jfam = get_family(family), jax_family(family)
    rng = np.random.default_rng(0)
    pe, je = VerificationEngine(), JaxEngine()
    se, sj = VerificationEngine(), JaxEngine()
    seen, results, unsupported = {}, [], []
    for cfg_t, prob_t in (PAIRS[family](rng, N_PAIRS[family])
                          + EXTRA_PAIRS.get(family, [])):
        cfg, prob = fam.config_cls(*cfg_t), fam.problem_cls(*prob_t)
        jcfg = _jax_side(family, cfg, prob)
        if jcfg is None:
            unsupported.append((cfg, prob, pe.verify(family, cfg, prob)))
            continue
        jc = jfam.config_cls(**dataclasses.asdict(jcfg))
        jp = jfam.problem_cls(**dataclasses.asdict(prob))
        results.append((cfg, prob, je.verify(family, jc, jp),
                        pe.verify(family, cfg, prob)))
        if seen.setdefault((jcfg, prob), cfg) == cfg:
            se.verify(family, cfg, prob)
            sj.verify(family, jc, jp)
    return family, (se, sj), results, unsupported


def test_the_pairs_span_the_space(run):
    family, _, results, unsupported = run
    assert len(results) >= 12, family
    assert sum(p.hard_ok for *_, p in results) >= 8, family
    if family in ("paged_attention", "ragged_prefill"):
        assert any(p.build_error for *_, p in results), family
    if family == "paged_attention":
        assert unsupported


def test_gate_verdicts_match_the_jax_gate(run):
    family, _, results, _ = run
    for cfg, prob, j, p in results:
        where = f"{family} cfg {cfg} prob {prob}"
        assert j.build_error == p.build_error, where
        assert j.hard_ok == p.hard_ok, where
        assert _findings(j) == _findings(p), where


def test_engine_stats_match_the_jax_engine(run):
    family, (se, sj), results, _ = run
    assert _stats(se) == _stats(sj), family
    assert _stats(se)["verify_calls"] >= 12


def test_a_geometry_the_kernel_cannot_run_is_a_build_error(run):
    family, _, _, unsupported = run
    for cfg, prob, res in unsupported:
        assert not res.hard_ok and "CUDA kernel" in res.build_error
    if family == "paged_attention":
        # exactly the 1-token page: every head_dim runs
        assert sorted((p.head_dim, p.page_size) for _, p, _ in unsupported) \
            == [(128, 1)]


def test_the_new_geometries_are_held_to_the_jax_gate(run):
    """Every pair at head_dim 48, 96 or 112, group 12, 16 or 71, or pages
    of 2, 24 or 512 tokens is compared with the JAX gate (none is refused
    as a build error), and the JAX gate admits it where its config
    tiles the problem."""
    family, _, results, _ = run
    new = [(c, p, j, q) for c, p, j, q in results
           if p.head_dim in (48, 96, 112) or p.group in (12, 16, 71)
           or getattr(p, "page_size", 16) in (2, 24, 512)]
    assert len(new) >= 6, family
    for cfg, prob, j, p in new:
        assert not p.build_error or "CUDA kernel" not in p.build_error
        assert j.hard_ok == p.hard_ok
    assert sum(p.hard_ok for *_, p in new) >= 5, family


def test_a_head_dim_off_the_grain_is_unsupported(run):
    """Head_dim 100 (bf16 rows of 200 bytes, off the 16-byte grain) and
    320 (above 256) run on the panel route: every family, the paged one
    at the kernel's step, is held to the JAX gate there (same verdict and
    build error), and no structural model says ``unsupported`` of them or
    of any other pair; the panel route's narrow copies (``grain``, at
    100) and its output panels (``cta_split``, at 320) are flagged."""
    family, _, results, unsupported = run
    panel = [(c, p, j, q) for c, p, j, q in results
             if p.head_dim in PANEL_HEAD_DIMS]
    assert len(panel) == 2, family
    assert not [p for _, p, _ in unsupported
                if p.head_dim in PANEL_HEAD_DIMS], family
    fam = get_family(family)
    for cfg, prob, j, p in panel:
        assert (j.hard_ok, j.build_error) == (p.hard_ok, p.build_error)
        kinds = [i.kind for i in fam.structural(cfg, prob)]
        assert ("grain" if prob.head_dim == 100 else "cta_split") in kinds
    for cfg, prob, *_ in results:
        kinds = [i.kind for i in fam.structural(cfg, prob)]
        assert "unsupported" not in kinds, (family, prob)


def test_a_one_token_page_fails_in_both_gates():
    """A page of one token: the JAX gate itself fails to build the
    program ("tuple index out of range"), and the port's refuses it as
    a build error of the CUDA kernel before building any program; the
    wrapper raises on the card (``test_torch_cuda.py``)."""
    from repro.core.families.paged_attention import \
        PagedAttentionConfig as JCfg, PagedAttentionProblem as JProb
    shape = (2, 8, 2, 32, 1, 80, 128, "bf16")
    j = JaxEngine().verify("paged_attention", JCfg(2), JProb(*shape))
    assert not j.hard_ok and "tuple index out of range" in j.build_error
    p = VerificationEngine().verify("paged_attention",
                                    pa.PagedAttentionConfig(2),
                                    pa.PagedAttentionProblem(*shape))
    assert not p.hard_ok and "CUDA kernel" in p.build_error
    assert pa.pages_per_step(1, 128, 2) == 0


PA_BF = pa.PagedAttentionProblem(4, 8, 2, 96, 16, 40, 128, "bf16")
PA_STEPS = [
    # (problem, config's block_pages, the kernel's step or the error)
    (PA_BF, 2, 2),
    (dataclasses.replace(PA_BF, dtype="f32"), 6, 2),
    (PA_BF, 1, 2),
    (pa.PagedAttentionProblem(8, 16, 8, 16 * 125, 16, 8 * 125 + 1, 128,
                              "bf16"), 1, 1),
    (pa.PagedAttentionProblem(8, 16, 8, 16 * 128, 16, 8 * 128 + 1, 128,
                              "bf16"), 1, 4),
    (PA_BF, 4, "block_pages 4 must divide"),
    # 128-token pages span two 64-token tiles: one page a program step
    (pa.PagedAttentionProblem(32, 8, 1, 8192, 128, 2304, 128, "bf16"), 2,
     1),
    # the tensor-core instance's 128-token tile at head_dim 64
    (pa.PagedAttentionProblem(3, 4, 4, 128, 8, 64, 64, "bf16"), 1, 16),
    # 24-token pages: two 24-row slots of the 64-row tile (rows 48..63
    # masked); 512-token pages: eight 64-row chunks a page, one page a
    # step; 2-token pages: eight 8-row slots in bf16, 32 packed pages of
    # the 64-row float32 tile at head_dim 48
    (pa.PagedAttentionProblem(2, 8, 2, 96, 24, 16, 128, "bf16"), 2, 2),
    (pa.PagedAttentionProblem(2, 8, 2, 1024, 512, 8, 128, "bf16"), 1, 1),
    (pa.PagedAttentionProblem(2, 8, 2, 32, 2, 40, 128, "bf16"), 4, 8),
    (pa.PagedAttentionProblem(2, 4, 2, 64, 2, 72, 48, "f32"), 2, 32),
    # head_dim 96 on the 128-column tiles; falcon-7b's 71 heads on one KV
    # head (nine head blocks) walk the same pages
    (pa.PagedAttentionProblem(4, 8, 2, 96, 16, 40, 96, "bf16"), 2, 2),
    (pa.PagedAttentionProblem(2, 71, 1, 128, 16, 20, 64, "bf16"), 1, 8),
    # the panel route: head_dim off the 16-byte grain (100) or above 256
    # (320) on 64-position tiles of packed pages, four 16-token pages a
    # tile; in f32 32-position tiles, two pages
    (pa.PagedAttentionProblem(4, 8, 2, 96, 16, 40, 100, "bf16"), 2, 2),
    (pa.PagedAttentionProblem(4, 8, 2, 96, 16, 40, 320, "bf16"), 2, 2),
    (pa.PagedAttentionProblem(4, 8, 2, 128, 16, 40, 100, "bf16"), 1, 4),
    (pa.PagedAttentionProblem(4, 8, 2, 96, 16, 40, 50, "f32"), 1, 2),
    # still refused: a 1-token page
    (pa.PagedAttentionProblem(2, 8, 2, 32, 1, 80, 128, "bf16"), 2,
     "CUDA kernel"),
]


@pytest.mark.parametrize("prob,bp,want", PA_STEPS)
def test_paged_program_is_built_at_the_kernels_step(prob, bp, want):
    """The kernel walks as many pages as fit one tile, its last step
    shorter, or a page of several tiles; the program is built at
    gcd(step, width), so each kernel step is a run of whole program steps
    or a part of one.  Six 16-token pages: the bf16 tile (64 tokens)
    holds four, the kernel walks 4 + 2 pages and the program steps two;
    in f32 (32-token tiles) both step two.  125 pages (max_len 2000):
    the kernel walks 31 x 4 + 1, the program single pages; 128 pages:
    both step four.  128- and 512-token pages: the program steps one
    page.  24- and 2-token pages: as many whole pages as the tile's page
    slots hold.  A head_dim off the 16-byte grain or above 256 walks
    the panel route's packed 64-position tiles (32 in f32); a 1-token
    page the kernel cannot walk; block_pages stays a precondition."""
    assert pa.pages_per_step(16, 128, 2) == 4
    assert pa.pages_per_step(16, 128, 4) == 2
    assert pa.pages_per_step(128, 128, 2) == 1
    cfg = pa.PagedAttentionConfig(bp)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            pa.kernel_config(cfg, prob)
        return
    assert pa.kernel_config(cfg, prob).block_pages == want
    assert pa.build_paged_attention_program(cfg, prob).name == \
        f"paged[bp={want}]"


def test_the_span_split_depends_on_the_shapes_alone():
    """Spans are whole tiles (whole pages where a page spans tiles) and
    fill the card several times over at the serving shapes: 8 rows x 8
    KV heads x 8 spans of 256 tokens at qwen3's and granite's phase-3
    geometry, 32 x 1 x 16 spans of four 128-token pages at the family's
    production problem."""
    assert pa.span_pages(8, 8, 128, 16, 128, 2) == 16
    assert pa.span_pages(8, 8, 128, 16, 64, 2) == 16
    assert pa.span_pages(32, 1, 64, 128, 128, 2) == 4
    for prob in (pa.PagedAttentionProblem(8, 16, 8, 2048, 16, 768, 128),
                 pa.PagedAttentionProblem(8, 24, 8, 2048, 16, 768, 64),
                 pa.PagedAttentionProblem(32, 8, 1, 8192, 128, 2304, 128)):
        ns = pa.n_spans(prob)
        assert prob.batch * prob.kv_heads * ns >= 2 * 132
        sp = pa.span_pages(prob.batch, prob.kv_heads, prob.pages_per_seq,
                           prob.page_size, prob.head_dim, 2)
        assert sp * prob.page_size % pa.tile_tokens(prob.head_dim, 2) == 0


TC_SMEM = 1024 + 3 * (2 * 16384 + 16)


@pytest.mark.parametrize("D,itemsize,tc,tile,smem", [
    (8, 2, True, 128, TC_SMEM), (16, 2, True, 128, TC_SMEM),
    (32, 2, True, 128, TC_SMEM), (48, 2, True, 128, TC_SMEM),
    (64, 2, True, 128, TC_SMEM), (80, 2, True, 64, TC_SMEM),
    (96, 2, True, 64, TC_SMEM), (112, 2, True, 64, TC_SMEM),
    (128, 2, True, 64, TC_SMEM), (136, 2, True, 32, TC_SMEM),
    (256, 2, True, 32, TC_SMEM),
    (4, 4, False, 64, None), (32, 4, False, 64, None),
    (48, 4, False, 64, None), (80, 4, False, 32, None),
    (96, 4, False, 32, None), (256, 4, False, 16, None)])
def test_paged_instances_and_their_tiles(D, itemsize, tc, tile, smem):
    """bf16 runs on the tensor cores at every head_dim it takes, in 16 KB
    tiles of the least width of 64, 128 and 256 columns at or above it
    (TMA zero-filling past head_dim; 32 positions at 256, one 16-row slab
    for each of two consumer warps), two CTAs an SM; float32 on the CUDA
    cores in tiles of at most 16 KB at its width (64, 128 or 256).
    Every page of 2 tokens or more is walked: whole pages in a tile, or a
    page in tile-sized chunks."""
    from repro_torch.core import kernelspec as ks
    assert pa.tensor_cores(D, itemsize) == tc
    assert pa.tile_tokens(D, itemsize) == tile
    assert pa.instance_name(D, itemsize).startswith(
        "tensor cores" if tc else "cuda cores")
    assert all(pa.pages_per_step(ps, D, itemsize)
               for ps in (2, 3, 8, 16, 24, 32, 64, 100, 128, 256, 512))
    assert pa.pages_per_step(1, D, itemsize) == 0
    if tc:
        assert ks.tile_width(D) >= D and ks.tile_width(D) // 2 < max(D, 33)
        assert pa._smem_bytes(D, itemsize) == smem <= ks.SMEM_PER_CTA // 2
    else:
        assert pa._smem_bytes(D, itemsize) <= 48 * 1024   # static arrays


RP_BF16 = rp.RaggedPrefillProblem(8, 2048, 8, 1, 128, "bf16")


@pytest.mark.parametrize("cfg,prob,want", [
    # bf16 at head_dim 64 and 128: the wgmma design's 128 x 128 step
    ((128, 128), RP_BF16, (128, 128)), ((8, 8), RP_BF16, (128, 128)),
    ((256, 64), RP_BF16, (128, 128)),
    # head_dim 80 on D = 128's tiles; 256 on 64-key tiles
    ((128, 128), dataclasses.replace(RP_BF16, head_dim=80), (128, 128)),
    ((128, 128), dataclasses.replace(RP_BF16, head_dim=256), (128, 64)),
    ((8, 8), dataclasses.replace(RP_BF16, head_dim=256), (128, 64)),
    # 192 tokens (the engine pads to 64): the largest blocks that tile
    ((64, 64), rp.RaggedPrefillProblem(4, 192, 4, 4, 64, "bf16"), (64, 64)),
    # head_dim 16, 48 and 96 on the 64- and 128-column tiles, 136 on the
    # 256-column ones (64-key tiles)
    ((128, 128), dataclasses.replace(RP_BF16, head_dim=16), (128, 128)),
    ((128, 128), dataclasses.replace(RP_BF16, head_dim=48), (128, 128)),
    ((128, 128), dataclasses.replace(RP_BF16, head_dim=96), (128, 128)),
    ((128, 128), dataclasses.replace(RP_BF16, head_dim=136), (128, 64)),
    # float32: the CUDA-core design's 64 x 32
    ((128, 128), dataclasses.replace(RP_BF16, dtype="f32"), (64, 32)),
    ((128, 128), dataclasses.replace(RP_BF16, dtype="f32", head_dim=48),
     (64, 32)),
    ((8, 16), rp.RaggedPrefillProblem(3, 48, 4, 2, 16, "f32"), (16, 16))])
def test_ragged_program_is_built_at_the_kernels_blocks(cfg, prob, want):
    got = rp.kernel_config(rp.RaggedPrefillConfig(*cfg), prob)
    assert got == rp.RaggedPrefillConfig(*want)
    odd = rp.RaggedPrefillProblem(3, 48, 4, 2, 16, "f32")
    with pytest.raises(ValueError, match="must tile"):
        rp.kernel_config(rp.RaggedPrefillConfig(32, 16), odd)


@pytest.mark.parametrize("dtype,D,wgmma", [
    ("bf16", 128, True), ("bf16", 64, True), ("f32", 128, False),
    ("f32", 64, False), ("bf16", 32, True), ("bf16", 16, True),
    ("bf16", 80, True), ("bf16", 256, True), ("f32", 80, False),
    ("f32", 256, False), ("bf16", 8, True), ("bf16", 24, True),
    ("bf16", 48, True), ("bf16", 96, True), ("bf16", 112, True),
    ("bf16", 136, True), ("f32", 4, False), ("f32", 48, False),
    ("f32", 96, False)])
def test_ragged_bf16_at_head_dim_64_and_128_runs_on_wgmma(dtype, D, wgmma):
    """bf16 runs on the wgmma design at every head_dim it takes, in the
    least tile width of 64, 128 and 256 columns at or above it; float32
    on the CUDA cores."""
    from repro_torch.core import kernelspec as ks
    prob = rp.RaggedPrefillProblem(8, 2048, 16, 8, D, dtype)
    assert rp.is_wgmma(prob) == wgmma
    W = ks.tile_width(D)
    assert W >= D and (W == 64 or W // 2 < D)
    # 64-key tiles at width 256: Q and a two-stage ring of 128-key tiles
    # would take 320 KB
    bk = 64 if W == 256 else 128
    assert rp.kernel_blocks(prob) == ((128, bk) if wgmma else (64, 32))
    assert rp.instance_name(prob) == (f"wgmma W={W}" if wgmma
                                      else "cuda cores")
    assert rp.structural_ragged_prefill(rp.RaggedPrefillConfig(), prob) == []
    # the wgmma instance holds Q, a two-stage K/V ring (rows of W columns:
    # TMA zero-fills past D) and a byte and a list entry a key tile,
    # beside 2,132 bytes of static arrays (the row summaries, two tiles'
    # (seg, pos) pairs, the live count); one CTA an SM
    smem = rp._smem_bytes(prob)
    assert smem <= ks.SMEM_PER_CTA
    if wgmma:
        n = 2048 // bk
        assert smem == (1024 + 128 * W * 2 + 4 * bk * W * 2 + 72
                        + 2 * -(-n // 2) + 2 * n + 2132)


# -- injected bugs ------------------------------------------------------------

def _bug_cases(family):
    fam = get_family(family)
    cfg0, prob0 = fam.example()
    if family == "flash_attention":
        more = [(dataclasses.replace(cfg0, block_q=64, block_kv=64,
                                     v_transposed_staging=True),
                 dataclasses.replace(prob0, seq_q=1000, seq_kv=1500)),
                (dataclasses.replace(cfg0, block_q=256),
                 dataclasses.replace(prob0, causal=False, q_heads=4,
                                     kv_heads=4))]
    elif family == "flash_decode":
        more = [(fam.config_cls(16),
                 dataclasses.replace(prob0, seq_kv=2048, batch=128))]
    elif family == "paged_attention":
        # 64-token pages (one tile), then the family example's 128-token
        # pages (two tiles a page) among the more
        more = [(cfg0, prob0)]
        prob0 = dataclasses.replace(prob0, page_size=64, pool_pages=4352)
        more += [(fam.config_cls(1), pa.PagedAttentionProblem(
                    4, 8, 2, 96, 16, 40, 128, "bf16")),
                (fam.config_cls(2), pa.PagedAttentionProblem(
                    2, 16, 8, 256, 16, 40, 128, "f32"))]
    else:
        more = [(fam.config_cls(8, 16),
                 rp.RaggedPrefillProblem(3, 48, 4, 2, 16, "f32"))]
    return [(cfg0, prob0)] + more


@pytest.mark.parametrize("family", FAMILIES)
def test_injected_bugs_match_the_same_signatures(family):
    fam, jfam = get_family(family), jax_family(family)
    assert [dataclasses.astuple(s) for s in fam.bug_signatures] == \
        [dataclasses.astuple(s) for s in jfam.bug_signatures]
    assert fam.injectable_bugs == jfam.injectable_bugs
    sigs = {s.bug: s for s in fam.bug_signatures}
    pe, je = VerificationEngine(), JaxEngine()
    n = 0
    for cfg, prob in _bug_cases(family):
        assert pe.verify(family, cfg, prob).hard_ok, (cfg, prob)
        jcfg = _jax_side(family, cfg, prob)
        jc = jfam.config_cls(**dataclasses.asdict(jcfg))
        jp = jfam.problem_cls(**dataclasses.asdict(prob))
        assert fam.bugs_for(cfg, prob) == jfam.bugs_for(jc, jp)
        for bug in fam.bugs_for(cfg, prob):
            p = pe.verify(family, cfg, prob, inject_bug=bug)
            j = je.verify(family, jc, jp, inject_bug=bug)
            assert p.hard_ok == j.hard_ok, (cfg, prob, bug)
            assert _findings(p) == _findings(j), (cfg, prob, bug)
            assert not p.hard_ok, (family, cfg, prob, bug)
            viol = [f for f in p.violations if f.stage != "structural"]
            assert max((sigs[bug].specificity(f.stage, f.assertion_id)
                        for f in viol), default=MATCH_NONE) == \
                MATCH_EXACT, (cfg, prob, bug)
            n += 1
    assert n >= 6


@pytest.mark.parametrize("family", FAMILIES)
def test_skills_and_examples_match_the_jax_family(family):
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
    # the skills' rewrites are the JAX family's, config for config
    for s, js in zip(fam.skills, jfam.skills):
        got = [(lbl, dataclasses.astuple(c)) for lbl, c in
               s.contexts(cfg, prob)]
        want = [(lbl, dataclasses.astuple(c)) for lbl, c in
                js.contexts(jcfg, jprob)]
        assert got == want, s.name


# -- the Hopper structural and cost models -------------------------------------

# head dims across the three widths of the flash kernels: 64 (8, 48, 64),
# 128 (96, 128) and 256 (136, 256)
FLASH_HEAD_DIMS = (8, 48, 64, 96, 128, 136, 256)


def test_flash_cta_tiles_and_structural_warnings():
    from repro_torch.core import kernelspec as ks
    from repro_torch.core.families import flash_attention as fa
    assert [fa.cta_tile(b) for b in (8, 16, 24, 32, 48, 64, 192, 256)] == \
        [16, 16, 16, 32, 16, 64, 64, 128]
    assert all(fa.smem_bytes(t, d, dt) <= ks.SMEM_PER_CTA
               for t in fa.CTA_TILES for d in FLASH_HEAD_DIMS
               for dt in ("bf16", "f32"))
    cfg, prob = fa._example()
    kinds = [i.kind for i in fa.structural_flash_attention(cfg, prob)]
    assert kinds == ["grain"]                # block_q 8 on a 16-row tile
    big = fa.FlashAttentionConfig(block_q=256)
    [i] = fa.structural_flash_attention(big, prob)
    assert i.kind == "cta_split" and "2 CTAs of 128x128" in i.message
    odd = dataclasses.replace(prob, head_dim=100)
    kinds = [i.kind for i in fa.structural_flash_attention(big, odd)]
    assert "grain" in kinds and "unsupported" not in kinds
    for d in FLASH_HEAD_DIMS:
        ok = dataclasses.replace(prob, head_dim=d)
        assert "unsupported" not in [i.kind for i in
                                     fa.structural_flash_attention(big, ok)]


def test_flash_instances_fit_the_card_and_match_the_kernels_layout():
    """Every compiled instance of the two flash kernels fits a CTA's
    shared memory and the registers of an SM, and the model's threads
    are the kernels' layout: a producer warpgroup beside a consumer
    warpgroup per 64 rows on the wgmma tiles (flash_attention.cu
    WgCfg), a warp per 16 rows on the mma.sync tiles, four threads a
    row in f32; decode four consumer warps and a producer warp in bf16
    (Bf16Dec), 128 threads in f32."""
    from repro_torch.core import kernelspec as ks
    from repro_torch.core.families import flash_attention as fa
    from repro_torch.core.families import flash_decode as fd
    want = {(128, "bf16"): 384, (64, "bf16"): 256, (32, "bf16"): 64,
            (16, "bf16"): 32, (128, "f32"): 512, (64, "f32"): 256,
            (32, "f32"): 128, (16, "f32"): 64}
    for (tile, dt), n in want.items():
        assert fa.threads(tile, dt) == n
        for d in FLASH_HEAD_DIMS:
            assert fa.smem_bytes(tile, d, dt) <= ks.SMEM_PER_CTA
            regs = fa._regs(tile, d, dt)
            assert regs <= ks.MAX_REGS_PER_THREAD
            assert n * regs <= ks.REGS_PER_SM
    # setmaxnreg: the consumers' 232 and the producer's 40 registers are
    # the pool that 168 a thread (384) and 136 (256) reserve at launch
    assert (2 * fa.CONSUMER_REGS + fa.PRODUCER_REGS) * 128 <= 384 * 168
    assert (fa.CONSUMER_REGS + fa.PRODUCER_REGS) * 128 <= 256 * 136
    # the wgmma tiles: 128 keys a step (64 at width 256); 64 on the
    # others in bf16
    assert [fa.key_tile(t, "bf16") for t in fa.CTA_TILES] == \
        [128, 128, 64, 64]
    assert [fa.key_tile(t, "bf16", 200) for t in fa.CTA_TILES] == \
        [64, 64, 64, 64]
    assert fd.KERNEL_THREADS == {"bf16": 160, "f32": 128}
    for d in FLASH_HEAD_DIMS:
        w = fd.tile_width(d)
        assert fd.tile_tokens(d, 2) * w * 2 == fd.TILE_BYTES
        # four consumer warps, two at width 256
        assert fd.tile_tokens(d, 2) % (16 * (2 if w == 256 else 4)) == 0
        for dt in ("bf16", "f32"):
            assert fd.smem_bytes(d, dt) <= ks.SMEM_PER_CTA
    # two bf16 decode CTAs share an SM
    assert 2 * fd.smem_bytes(128, "bf16") <= ks.SMEM_PER_SM
    assert fd.STAGES["bf16"] >= 3


def test_flash_speed_of_light_at_the_production_problems():
    """The bounds chip_smoke.py prints: operations for prefill (the
    causal half at 989 TFLOP/s), bytes for decode (K/V at 3.35 TB/s)."""
    from repro_torch.core.families import flash_attention as fa
    from repro_torch.core.families import flash_decode as fd
    want = (2.2238e-3, 0.2781e-3, 2.2236e-3)
    for prob, w in zip(fa._sweep(), want):
        sol = fa.flash_attention_sol(prob)
        assert sol.bound == "compute"
        assert sol.time_s == pytest.approx(w, rel=2e-3)
    for prob in fd._sweep():
        sol = fd.flash_decode_sol(prob)
        assert sol.bound == "memory"
        assert sol.time_s == pytest.approx(0.0401e-3, rel=5e-3)


@pytest.mark.parametrize("family", FAMILIES)
def test_cost_never_beats_the_speed_of_light(family):
    fam = get_family(family)
    rng = np.random.default_rng(1)
    n = 0
    for cfg_t, prob_t in PAIRS[family](rng, 20):
        cfg, prob = fam.config_cls(*cfg_t), fam.problem_cls(*prob_t)
        assert fam.cost(cfg, prob).time_s >= fam.sol_bound(prob).time_s
        n += 1
    assert n == 20
