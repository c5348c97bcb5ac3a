"""The port's CUDA kernels against their plain PyTorch versions on the
card, at the reduced config's shapes (head_dim 16, page size 8) and at
full width (head_dim 128, page size 16), and the reduced engine on the
card against the same engine on the CPU.  Every test here needs a CUDA
card and ``nvcc``, and skips without them:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: float32 1e-4 (the same products summed in another order);
bfloat16 1e-2, a little above one bfloat16 step at |x| < 2 (2^-7).  The
GEMM kernel against its plain version: a float32 output within 1e-5 of
the largest |output| (the same products summed in another order, the
rounding being of partial sums of the output's scale); a bfloat16
output within one bfloat16 step of each value (both round a float32
sum to bfloat16 once) plus that float32 bound (near zero, the two
float32 sums may differ by more than a step of the value).  The flash
kernels: the tolerance stated beside ``flash_error`` in
``repro_torch/kernels/flash_attention/ref.py``; the MoE, quant-GEMM and
SSD kernels: those beside ``moe_error``, ``quant_error`` and
``ssd_error`` in their packages' ``ref.py``."""
import dataclasses

import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch import resolve_device
    return resolve_device("cuda")


def _decode_inputs(B, Hq, Hkv, D, PS, NP, P, lengths, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, Hq, 1, D, generator=g).to(dtype)
    kp = torch.randn(P, Hkv, PS, D, generator=g).to(dtype)
    vp = torch.randn(P, Hkv, PS, D, generator=g).to(dtype)
    kp[0] = 0
    vp[0] = 0
    table = torch.zeros(B, NP, dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(lengths):
        npg = -(-n // PS)
        table[b, :npg] = torch.arange(nxt, nxt + npg, dtype=torch.int32)
        nxt += npg
    assert nxt <= P
    return q, kp, vp, table, torch.tensor(lengths, dtype=torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D,PS", [(2, 2, 16, 8), (4, 2, 16, 8),
                                         (8, 2, 16, 8), (16, 8, 128, 16)])
def test_paged_decode_kernel_matches_plain(card, dtype, Hq, Hkv, D, PS):
    from repro_torch.kernels.paged_attention import KERNEL, paged_decode_ref
    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_decode
    NP = 8
    lengths = [0, 1, PS, PS + 1, 3 * PS - 2, NP * PS]
    cpu = _decode_inputs(len(lengths), Hq, Hkv, D, PS, NP, 64, lengths,
                         dtype)
    dev = [t.to(card) for t in cpu]
    before = KERNEL.launches
    got = paged_decode(*dev)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    want = paged_decode_ref(*dev)
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL[dtype], err
    assert float(got[0].abs().max()) == 0.0
    # the wrapper on the CPU copies runs the plain version, no launch
    cpu_out = paged_decode(*cpu)
    assert KERNEL.launches == before + 1
    assert float((cpu_out.float() - got.float().cpu()).abs().max()) \
        <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D", [(4, 2, 16), (16, 8, 128),
                                      (4, 4, 64)])
def test_ragged_prefill_kernel_matches_plain(card, dtype, Hq, Hkv, D):
    from repro_torch.kernels.ragged_prefill import (KERNEL,
                                                    ragged_prefill_ref)
    from repro_torch.kernels.ragged_prefill.ragged_prefill import \
        ragged_prefill
    chunks, prefixes = [40, 64, 7, 100], [0, 30, 200, 64]
    pad = lambda t: -(-t // 64) * 64
    TQ, TK = pad(sum(chunks)), pad(sum(p + n for p, n in
                                       zip(prefixes, chunks)))
    sq = torch.full((TQ,), -1, dtype=torch.int32)
    pq = torch.zeros(TQ, dtype=torch.int32)
    sk = torch.full((TK,), -1, dtype=torch.int32)
    pk = torch.zeros(TK, dtype=torch.int32)
    qt = kt = 0
    for j, (p, n) in enumerate(zip(prefixes, chunks)):
        sq[qt:qt + n], pq[qt:qt + n] = j, torch.arange(p, p + n)
        sk[kt:kt + p + n], pk[kt:kt + p + n] = j, torch.arange(p + n)
        qt, kt = qt + n, kt + p + n
    g = torch.Generator().manual_seed(1)
    q = torch.randn(Hq, TQ, D, generator=g).to(dtype)
    k = torch.randn(Hkv, TK, D, generator=g).to(dtype)
    v = torch.randn(Hkv, TK, D, generator=g).to(dtype)
    dev = [t.to(card) for t in (q, k, v, sq, pq, sk, pk)]
    before = KERNEL.launches
    got = ragged_prefill(*dev)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    want = ragged_prefill_ref(*dev)
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL[dtype], err
    assert float(got[:, dev[3] < 0].abs().max()) == 0.0


def _packed_case(Hq, Hkv, D, chunks, prefixes, dtype, seed):
    """Engine-style packing (both extents padded to 64 tokens) of chunks
    against their prefixes; inputs from a seeded generator."""
    pad = lambda t: -(-t // 64) * 64
    TQ, TK = pad(sum(chunks)), pad(sum(p + n for p, n in
                                       zip(prefixes, chunks)))
    sq = torch.full((TQ,), -1, dtype=torch.int32)
    pq = torch.zeros(TQ, dtype=torch.int32)
    sk = torch.full((TK,), -1, dtype=torch.int32)
    pk = torch.zeros(TK, dtype=torch.int32)
    qt = kt = 0
    for j, (p, n) in enumerate(zip(prefixes, chunks)):
        sq[qt:qt + n], pq[qt:qt + n] = j, torch.arange(p, p + n)
        sk[kt:kt + p + n], pk[kt:kt + p + n] = j, torch.arange(p + n)
        qt, kt = qt + n, kt + p + n
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(Hq, TQ, D, generator=g).to(dtype)
    k = torch.randn(Hkv, TK, D, generator=g).to(dtype)
    v = torch.randn(Hkv, TK, D, generator=g).to(dtype)
    return q, k, v, sq, pq, sk, pk


@pytest.mark.parametrize("Hq,Hkv,D", [(16, 8, 128), (24, 8, 64),
                                      (32, 32, 80), (16, 16, 256)])
@pytest.mark.parametrize("chunks,prefixes", [
    # the serving phase's tick: 8 chunks against prefixes up to 768
    ([256] * 7 + [200], [0, 256, 512, 768] * 2),
    # segments shorter than a tile, starting mid-tile, a 64-row tail
    ([40, 64, 7, 100, 3, 130], [0, 30, 200, 64, 700, 5])])
def test_ragged_prefill_wgmma_instance_matches_plain(card, Hq, Hkv, D,
                                                     chunks, prefixes):
    """The bf16 wgmma instance at qwen3's, granite's, stablelm-3b's
    (head_dim 80: D = 128's tiles, zero-filled past 80) and gemma-7b's
    (head_dim 256: 64-key tiles) head geometry: within the tolerance,
    bit-identical to the plain version on all but
    ``P_SPLIT_MISMATCH`` of the outputs, padding rows zero, and a
    poisoned foreign segment leaves every other row bit-identical."""
    from repro_torch.core.families.ragged_prefill import (
        RaggedPrefillProblem, is_wgmma)
    from repro_torch.kernels.ragged_prefill import (KERNEL, default_config,
                                                    ragged_prefill_ref)
    from repro_torch.kernels.ragged_prefill.ragged_prefill import \
        ragged_prefill
    from repro_torch.kernels.ragged_prefill.ref import (P_SPLIT_MISMATCH,
                                                        mismatch_share)
    case = _packed_case(Hq, Hkv, D, chunks, prefixes, torch.bfloat16, 3)
    q, k, v, sq, pq, sk, pk = [t.to(card) for t in case]
    assert is_wgmma(RaggedPrefillProblem(len(chunks), k.shape[1], Hq, Hkv,
                                         D, "bf16"))
    cfg = default_config(q.shape[1], k.shape[1])
    before = KERNEL.launches
    got = ragged_prefill(q, k, v, sq, pq, sk, pk, cfg=cfg)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    want = ragged_prefill_ref(q, k, v, sq, pq, sk, pk)
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL[torch.bfloat16], err
    # p kept at float32 accuracy: the bf16 output is the plain version's
    # almost everywhere (p rounded to bf16 alone moves a third of it)
    share = mismatch_share(got, want, sq)
    assert share <= P_SPLIT_MISMATCH, share
    assert float(got[:, sq < 0].abs().max()) == 0.0
    k2, v2 = k.clone(), v.clone()
    foreign = (sk == 3) | (sk < 0)
    k2[:, foreign] = 1e6
    v2[:, foreign] = 1e6
    poisoned = ragged_prefill(q, k2, v2, sq, pq, sk, pk, cfg=cfg)
    torch.cuda.synchronize()
    keep = sq != 3
    assert torch.equal(got[:, keep], poisoned[:, keep])


def test_reduced_engine_on_the_card_matches_the_cpu(card):
    """float32 reduced model, kernel paths: the card (CUDA kernels) and
    the CPU (plain versions) give the same tokens."""
    from repro_torch import configs
    from repro_torch.kernels import paged_attention, ragged_prefill
    from repro_torch.models import build
    from repro_torch.serve import PagedServingEngine
    from repro_torch.serve.trace import poisson_trace, replay
    cfg = dataclasses.replace(configs.get_reduced("qwen3-1.7b"),
                              dtype="float32")
    model = build(cfg)
    params = model.init(0, device="cpu")
    trace = poisson_trace(seed=1, n_requests=8, mean_gap=3.0,
                          prompt_lens=(4, 28), max_new=(4, 12),
                          vocab=cfg.vocab)
    outs = {}
    serving = [paged_attention.KERNEL, ragged_prefill.KERNEL]
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        before = [k.launches for k in serving]
        eng = PagedServingEngine(model, p, pool_pages=25, page_size=8,
                                 max_batch=4, max_len=64, prefill_chunk=8,
                                 eos_id=-1, decode_path="kernel",
                                 prefill_path="kernel", device=dev)
        outs[dev] = replay(eng, trace)["outputs"]
        launched = [k.launches - b for k, b in zip(serving, before)]
        assert all(n > 0 for n in launched) == (dev == "cuda")
    assert outs["cuda"] == outs["cpu"]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b",
                                  "seamless-m4t-large-v2"])
def test_hybrid_and_encdec_on_the_card_match_the_cpu(card, arch):
    """The reduced float32 models on the card and on the CPU, the same
    weights: ``apply`` over 40 tokens (past recurrentgemma's window of
    32; seamless over 30 seeded frame embeddings) and 12 ``decode_step``
    tokens (recurrentgemma from the zeroed cache, seamless after
    ``prefill``), logits within 1e-4 of each plus 1e-4 of the largest.
    Neither family reaches a kernel: no launch counter moves."""
    from repro_torch import configs
    from repro_torch.kernels import ALL_KERNELS
    from repro_torch.models import build
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="float32")
    model = build(cfg)
    params = model.init(0, device="cpu")
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(2, cfg.vocab, (2, 40), generator=g)
    enc = torch.randn(2, 30, cfg.d_model, generator=g)
    before = [k.launches for k in ALL_KERNELS]
    out = {}
    for dev in ("cpu", "cuda"):
        p, t = _to(params, dev), toks.to(dev)
        if cfg.family == "hybrid":
            full, _ = model.apply(p, t)
            cache = model.init_cache(2, 64, device=dev)
        else:
            full, _ = model.apply(p, t, enc_embeds=enc.to(dev))
            cache = model.prefill(p, enc.to(dev), 64)
        steps = []
        for i in range(12):
            o, cache = model.decode_step(p, cache, t[:, i:i + 1], i)
            steps.append(o[:, 0])
        out[dev] = (full.cpu(), torch.stack(steps, 1).cpu())
    assert [k.launches for k in ALL_KERNELS] == before
    for got, want in zip(out["cuda"], out["cpu"]):
        want = want[..., :cfg.vocab]
        got = got[..., :cfg.vocab]
        tol = 1e-4 * want.abs() + 1e-4 * want.abs().max()
        assert bool(((got - want).abs() <= tol).all()), \
            float((got - want).abs().max())


# -- GEMM --------------------------------------------------------------------

GEMM_CASES = [
    # (m, n, k, cfg fields): the default config, split_k 2 and 4,
    # stagger_k, a tile above 128 (several CTAs), bm = 8, ragged shapes,
    # tiles off the vector path
    (512, 512, 1024, {}),
    (512, 512, 1024, dict(split_k=2)),
    (256, 384, 2048, dict(split_k=4)),
    (640, 384, 1024, dict(stagger_k=True)),
    (1024, 1024, 512, dict(bm=512, bn=256, bk=256)),
    (64, 256, 512, dict(bm=8)),
    (1000, 777, 1500, dict(bm=64, bn=64, bk=64)),
    (200, 300, 520, dict(bm=16, bn=32, bk=8, stagger_k=True)),
    (384, 130, 1000, dict(bm=96, bn=96, bk=100, split_k=2)),
]


def _gemm_check(got, want, out_dtype):
    """The tolerance stated in the module docstring."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    f32_bound = 1e-5 * float(w.abs().max())
    if out_dtype == torch.float32:
        assert float(err.max()) <= f32_bound, err.max()
    else:
        step = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(
            2.0 ** -126))) - 7)
        assert bool((err <= step + f32_bound).all()), \
            float((err - step).max())


@pytest.mark.parametrize("out", [None, torch.float32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,n,k,fields", GEMM_CASES)
def test_gemm_kernel_matches_plain(card, m, n, k, fields, dtype, out):
    from repro_torch.core.families.gemm import GemmConfig
    from repro_torch.kernels.gemm import KERNEL, matmul, matmul_ref
    g = torch.Generator().manual_seed(m + n + k)
    a = torch.randn(m, k, generator=g).to(dtype).to(card)
    b = torch.randn(k, n, generator=g).to(dtype).to(card)
    cfg = GemmConfig(**fields) if fields else None
    before = KERNEL.launches
    got = matmul(a, b, cfg=cfg, out_dtype=out)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    out_dtype = out or dtype
    assert got.dtype == out_dtype and tuple(got.shape) == (m, n)
    _gemm_check(got, matmul_ref(a, b, out_dtype=out_dtype), out_dtype)


WGMMA_CASES = [
    # (m, n, k, cfg fields): the wgmma instances, 128 x 128 and 128 x 256,
    # ragged m, n and k (a B panel wholly past n, a last K block of one
    # partial stage), split_k 2 and 4, stagger_k, a config tile of
    # several CTA tiles
    (1000, 800, 1000, dict(bm=128, bn=256, bk=128)),
    (1000, 1000, 1000, dict(bm=128, bn=128, bk=64, stagger_k=True)),
    (2048, 2048, 4096, dict(bm=128, bn=256, bk=128, split_k=2)),
    (512, 512, 8192, dict(bm=128, bn=128, bk=256, split_k=4)),
    (1024, 2048, 2048, dict(bm=256, bn=512, bk=192, stagger_k=True)),
    (2048, 2048, 2048, dict(bm=512, bn=1024, bk=128, stagger_k=True)),
]


@pytest.mark.parametrize("out", [None, torch.float32])
@pytest.mark.parametrize("m,n,k,fields", WGMMA_CASES)
def test_gemm_wgmma_instances_match_plain(card, m, n, k, fields, out):
    from repro_torch.core.families.gemm import (GemmConfig, GemmProblem,
                                                is_wgmma)
    from repro_torch.kernels.gemm import KERNEL, matmul, matmul_ref
    cfg = GemmConfig(**fields)
    assert is_wgmma(cfg, GemmProblem(m, n, k, "bf16"))
    g = torch.Generator().manual_seed(m + n + k)
    a = torch.randn(m, k, generator=g).bfloat16().to(card)
    b = torch.randn(k, n, generator=g).bfloat16().to(card)
    before = KERNEL.launches
    got = matmul(a, b, cfg=cfg, out_dtype=out)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    out_dtype = out or torch.bfloat16
    assert got.dtype == out_dtype and tuple(got.shape) == (m, n)
    _gemm_check(got, matmul_ref(a, b, out_dtype=out_dtype), out_dtype)


@pytest.mark.parametrize("fields", [{}, dict(bm=512, bn=1024, bk=128,
                                             stagger_k=True)])
def test_gemm_kernel_at_the_production_problem(card, fields):
    from repro_torch.kernels.gemm import KERNEL, matmul, matmul_ref
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(8192, 8192, generator=g, device="cuda").bfloat16()
    b = torch.randn(8192, 8192, generator=g, device="cuda").bfloat16()
    from repro_torch.core.families.gemm import GemmConfig
    before = KERNEL.launches
    got = matmul(a, b, cfg=GemmConfig(**fields))
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    _gemm_check(got, matmul_ref(a, b), torch.bfloat16)


def test_gemm_wrapper_refuses_what_the_kernel_does_not_take(card):
    from repro_torch.kernels.gemm import KERNEL, gemm
    a = torch.zeros(16, 32, device="cuda", dtype=torch.float16)
    before = KERNEL.launches
    with pytest.raises(TypeError, match="bf16 or f32"):
        gemm(a, a.t().contiguous())
    x = torch.zeros(32, 64, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        gemm(x.t(), x)
    with pytest.raises(ValueError, match="one device"):
        gemm(x, torch.zeros(64, 8))
    with pytest.raises(TypeError, match="writes bf16 or f32"):
        gemm(x, x.t().contiguous(), out_dtype=torch.float16)
    assert KERNEL.launches == before


def test_gemm_invalid_config_raises_before_any_launch(card):
    from repro_torch.core.families.gemm import GemmConfig
    from repro_torch.kernels.gemm import KERNEL, InvariantViolation, matmul
    a = torch.zeros(128, 384, device="cuda")
    b = torch.zeros(384, 128, device="cuda")
    before = KERNEL.launches
    with pytest.raises(InvariantViolation):
        matmul(a, b, cfg=GemmConfig(split_k=5))
    assert KERNEL.launches == before


def test_validator_runs_the_kernel_on_the_card(card):
    from repro_torch.core.families.gemm import GemmConfig, GemmProblem
    from repro_torch.core.harness import (KernelState, LoweredState,
                                          Validator)
    from repro_torch.kernels.gemm import KERNEL
    v = Validator(run_kernels=True)
    before = KERNEL.launches
    for cfg in (GemmConfig(), GemmConfig(bm=1024, bn=256, stagger_k=True),
                GemmConfig(bm=8, bk=64, split_k=4)):
        st = KernelState("gemm", cfg,
                         GemmProblem(8192, 8192, 8192, "bf16")).refresh()
        assert v.evaluate(LoweredState(st), incumbent_s=1.0).ok
    assert KERNEL.launches - before == v.reference_runs == 3


def test_paged_decode_kernel_steps_tile_the_table(card):
    """A table width the tile's page count does not divide: six 16-token
    pages walk as 4 + 2 in bf16 (64-token tiles) and 2 + 2 + 2 in f32;
    125 pages (max_len 2000) as 31 x 4 + 1 in bf16, in spans of whole
    tiles, the last span shorter."""
    from repro_torch.core.families.paged_attention import pages_per_step
    from repro_torch.kernels.paged_attention import KERNEL, paged_decode_ref
    from repro_torch.kernels.paged_attention.paged_attention import \
        PagedAttentionConfig, paged_decode
    assert pages_per_step(16, 128, 2) == 4
    assert pages_per_step(16, 128, 4) == 2
    cases = [(torch.bfloat16, 6, 40, [0, 1, 47, 48, 49, 96]),
             (torch.float32, 6, 40, [0, 1, 47, 48, 49, 96]),
             (torch.bfloat16, 125, 520, [2000, 1999, 1985, 17])]
    for dtype, NP, P, lengths in cases:
        dev = [t.to(card) for t in _decode_inputs(
            len(lengths), 16, 8, 128, 16, NP, P, lengths, dtype)]
        before = KERNEL.launches
        got = paged_decode(*dev, cfg=PagedAttentionConfig(1))
        torch.cuda.synchronize()
        assert KERNEL.launches == before + 1
        err = float((got.float() - paged_decode_ref(*dev).float()).abs()
                    .max())
        assert err <= TOL[dtype], (dtype, NP, err)


PAGED_TC_CASES = [
    # (B, Hq, Hkv, D, PS, NP, lengths): the serving phase's qwen3 and
    # granite geometry (16-token pages, 128 a row), the family's
    # production problem's 128-token pages (a page of two tiles, G = 8),
    # pages of 8, 64 and 256 tokens, G 1 and 3, lengths 0, 1, mid-page,
    # mid-tile, a full table, rows shorter than a span
    (8, 16, 8, 128, 16, 128, [0, 1, 17, 256, 300, 777, 1040, 2048]),
    (8, 24, 8, 64, 16, 128, [2048, 1040, 777, 300, 256, 17, 1, 0]),
    (4, 8, 1, 128, 128, 64, [8192, 8000, 129, 0]),
    (3, 8, 8, 64, 8, 64, [512, 100, 7]),
    (3, 6, 2, 128, 64, 16, [1024, 65, 640]),
    (2, 4, 4, 64, 256, 4, [1024, 257]),
    # stablelm-3b's 32/32 x 80 (D = 128's tiles, zero-filled past 80) and
    # gemma-7b's 16/16 x 256 (16 KB tiles of 32 positions, two consumer
    # warps): pages of 8 to 256 tokens (at 80, 64: one a tile; 128 and
    # 256: a page of two to eight tiles), lengths 0 and 1, mid-page,
    # mid-tile, a full table
    (8, 32, 32, 80, 16, 128, [0, 1, 17, 256, 300, 777, 1040, 2048]),
    (3, 32, 32, 80, 8, 64, [512, 100, 0]),
    (3, 8, 2, 80, 64, 16, [1024, 65, 1]),
    (2, 32, 32, 80, 256, 4, [1024, 257]),
    (8, 16, 16, 256, 16, 128, [0, 1, 17, 256, 300, 777, 1040, 2048]),
    (3, 16, 16, 256, 8, 64, [512, 100, 0]),
    (3, 8, 1, 256, 128, 8, [1024, 129, 1]),
    (2, 16, 16, 256, 256, 4, [1024, 257]),
]


def _poisoned(kp, vp, table, lengths, PS):
    """Copies of the pools with every page no row maps and each row's
    tail past its length inside its last page set to 1e6."""
    kp2, vp2 = kp.clone(), vp.clone()
    mapped = {int(t) for b, n in enumerate(lengths)
              for t in table[b, :-(-n // PS)]}
    unmapped = [p for p in range(kp.shape[0]) if p not in mapped]
    kp2[unmapped] = 1e6
    vp2[unmapped] = 1e6
    for b, n in enumerate(lengths):
        if n % PS:
            last = int(table[b, n // PS])
            kp2[last, :, n % PS:] = 1e6
            vp2[last, :, n % PS:] = 1e6
    return kp2, vp2


@pytest.mark.parametrize("case", PAGED_TC_CASES, ids=lambda c: (
    f"{c[1]}-{c[2]}x{c[3]}-ps{c[4]}"))
def test_paged_decode_tensor_core_instance_matches_plain(card, case):
    """The bf16 split walk on tensor cores: within TOL of the plain
    version, at most P_SPLIT_MISMATCH of its outputs off the plain
    version's bf16 value, zeros for a row of length 0, and poisoned
    foreign, null and tail pages leave it bit-identical."""
    from repro_torch.core.families.paged_attention import tensor_cores
    from repro_torch.kernels.paged_attention import KERNEL, paged_decode_ref
    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_decode
    from repro_torch.kernels.paged_attention.ref import (P_SPLIT_MISMATCH,
                                                         mismatch_share)
    B, Hq, Hkv, D, PS, NP, lengths = case
    assert tensor_cores(D, 2)
    P = sum(-(-n // PS) for n in lengths) + 8
    q, kp, vp, table, lens = [t.to(card) for t in _decode_inputs(
        B, Hq, Hkv, D, PS, NP, P, lengths, torch.bfloat16)]
    before = KERNEL.launches
    got = paged_decode(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    want = paged_decode_ref(q, kp, vp, table, lens)
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL[torch.bfloat16], err
    share = mismatch_share(got, want, lens)
    assert share <= P_SPLIT_MISMATCH, share
    for b, n in enumerate(lengths):
        if n == 0:
            assert not got[b].any()
    kp2, vp2 = _poisoned(kp, vp, table.cpu(), lengths, PS)
    assert torch.equal(got, paged_decode(q, kp2, vp2, table, lens))


def test_paged_decode_wrapper_refuses_what_the_kernel_does_not_take(card):
    from repro_torch.kernels.paged_attention import KERNEL
    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_decode
    before = KERNEL.launches
    # head_dim off the 16-byte grain and above 256, a 1-token page
    for Hq, Hkv, D, PS in ((8, 2, 100, 16), (8, 2, 320, 16),
                           (8, 2, 128, 1)):
        q, kp, vp, table, lens = [t.to(card) for t in _decode_inputs(
            2, Hq, Hkv, D, PS, 2, 8, [PS, 1], torch.bfloat16)]
        with pytest.raises(ValueError, match="paged_decode kernel takes"):
            paged_decode(q, kp, vp, table, lens)
    q, kp, vp, table, lens = [t.to(card) for t in _decode_inputs(
        2, 8, 2, 128, 16, 2, 8, [16, 1], torch.bfloat16)]
    with pytest.raises(TypeError, match="int32"):
        paged_decode(q, kp, vp, table.long(), lens)
    with pytest.raises(TypeError, match="one type"):
        paged_decode(q, kp.float(), vp, table, lens)
    assert KERNEL.launches == before


# -- every head_dim, group and page size the JAX kernels take ------------------

PAGED_GEOMETRY_CASES = [
    # (dtype, B, Hq, Hkv, D, PS, NP, lengths): bf16 at head_dim 8, 16, 24,
    # 32 and 48 (64-column tiles), 96 and 112 (128), 136 (256); groups 12
    # (starcoder2-15b), 16 (glm-4-9b) and 71 (falcon-7b, nine head
    # blocks); pages of 2 (eight 8-row slots), 24 (two 24-row slots, the
    # tile's tail masked), 100 (two chunks, the second short) and 512
    # tokens (eight chunks a page); float32 at 4, 48, 96 and G 71
    (torch.bfloat16, 3, 8, 2, 8, 16, 12, [0, 1, 190]),
    (torch.bfloat16, 3, 8, 2, 16, 8, 16, [128, 77, 1]),
    (torch.bfloat16, 3, 4, 4, 24, 16, 12, [191, 0, 33]),
    (torch.bfloat16, 3, 8, 8, 32, 16, 12, [192, 65, 1]),
    (torch.bfloat16, 3, 8, 2, 48, 16, 12, [0, 100, 192]),
    (torch.bfloat16, 4, 32, 32, 96, 16, 24, [384, 0, 1, 217]),
    (torch.bfloat16, 3, 8, 4, 112, 16, 12, [192, 17, 64]),
    (torch.bfloat16, 3, 8, 2, 136, 16, 12, [192, 17, 0]),
    (torch.bfloat16, 4, 48, 4, 128, 16, 24, [384, 0, 1, 217]),
    (torch.bfloat16, 4, 32, 2, 128, 16, 24, [384, 0, 1, 217]),
    (torch.bfloat16, 4, 71, 1, 64, 16, 24, [384, 0, 1, 217]),
    (torch.bfloat16, 3, 8, 2, 128, 2, 64, [128, 3, 0]),
    (torch.bfloat16, 3, 8, 2, 128, 24, 10, [240, 49, 23]),
    (torch.bfloat16, 3, 8, 2, 64, 24, 10, [240, 0, 121]),
    (torch.bfloat16, 3, 16, 16, 256, 24, 10, [240, 49, 1]),
    (torch.bfloat16, 3, 8, 2, 128, 100, 4, [400, 150, 64]),
    (torch.bfloat16, 3, 8, 2, 128, 512, 4, [1536, 700, 1]),
    (torch.bfloat16, 2, 16, 16, 256, 512, 2, [1024, 513]),
    (torch.float32, 3, 8, 2, 4, 16, 12, [0, 100, 192]),
    (torch.float32, 3, 8, 2, 48, 24, 10, [240, 49, 0]),
    (torch.float32, 4, 32, 32, 96, 2, 64, [128, 0, 1, 77]),
    (torch.float32, 4, 71, 1, 64, 512, 2, [1024, 0, 1, 600]),
]


@pytest.mark.parametrize("case", PAGED_GEOMETRY_CASES, ids=lambda c: (
    f"{'bf16' if c[0] == torch.bfloat16 else 'f32'}-{c[2]}-{c[3]}x{c[4]}"
    f"-ps{c[5]}"))
def test_paged_decode_at_every_geometry_matches_plain(card, case):
    """Within TOL of the plain version (bf16 also at most
    P_SPLIT_MISMATCH of the outputs off its bf16 value), zeros for a row
    of length 0, and poisoned foreign, null and tail pages leave the
    output bit-identical."""
    from repro_torch.core.families.paged_attention import tensor_cores
    from repro_torch.kernels.paged_attention import KERNEL, paged_decode_ref
    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_decode
    from repro_torch.kernels.paged_attention.ref import (P_SPLIT_MISMATCH,
                                                         mismatch_share)
    dtype, B, Hq, Hkv, D, PS, NP, lengths = case
    assert tensor_cores(D, dtype.itemsize) == (dtype == torch.bfloat16)
    P = sum(-(-n // PS) for n in lengths) + 4
    q, kp, vp, table, lens = [t.to(card) for t in _decode_inputs(
        B, Hq, Hkv, D, PS, NP, P, lengths, dtype)]
    before = KERNEL.launches
    got = paged_decode(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    want = paged_decode_ref(q, kp, vp, table, lens)
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL[dtype], err
    if dtype == torch.bfloat16:
        share = mismatch_share(got, want, lens)
        assert share <= P_SPLIT_MISMATCH, share
    for b, n in enumerate(lengths):
        if n == 0:
            assert not got[b].any()
    kp2, vp2 = _poisoned(kp, vp, table.cpu(), lengths, PS)
    assert torch.equal(got, paged_decode(q, kp2, vp2, table, lens))


RAGGED_GEOMETRY_CASES = [
    # (dtype, Hq, Hkv, D): bf16 at 8, 24, 48 (64-column tiles, 8 and 24
    # with a half-zero last k step), 96, 112 (128), 136 (256); groups 12,
    # 16 and 71; float32 at 4, 48, 96 and 136
    (torch.bfloat16, 8, 2, 8), (torch.bfloat16, 4, 4, 24),
    (torch.bfloat16, 8, 2, 48), (torch.bfloat16, 32, 32, 96),
    (torch.bfloat16, 8, 4, 112), (torch.bfloat16, 8, 2, 136),
    (torch.bfloat16, 48, 4, 128), (torch.bfloat16, 32, 2, 128),
    (torch.bfloat16, 71, 1, 64),
    (torch.float32, 8, 2, 4), (torch.float32, 8, 2, 48),
    (torch.float32, 32, 32, 96), (torch.float32, 8, 2, 136),
]


@pytest.mark.parametrize("case", RAGGED_GEOMETRY_CASES, ids=lambda c: (
    f"{'bf16' if c[0] == torch.bfloat16 else 'f32'}-{c[1]}-{c[2]}x{c[3]}"))
def test_ragged_prefill_at_every_geometry_matches_plain(card, case):
    """Within TOL of the plain version on an engine-style packing (bf16
    also at most P_SPLIT_MISMATCH of the outputs off its bf16 value),
    zeros on padding queries, and a poisoned foreign segment and padding
    keys leave the other segments bit-identical."""
    from repro_torch.core.families.ragged_prefill import (
        RaggedPrefillProblem, is_wgmma)
    from repro_torch.kernels.ragged_prefill import (KERNEL,
                                                    ragged_prefill_ref)
    from repro_torch.kernels.ragged_prefill.ragged_prefill import \
        ragged_prefill
    from repro_torch.kernels.ragged_prefill.ref import (P_SPLIT_MISMATCH,
                                                        mismatch_share)
    dtype, Hq, Hkv, D = case
    q, k, v, sq, pq, sk, pk = [t.to(card) for t in _packed_case(
        Hq, Hkv, D, [40, 64, 7, 100, 130], [0, 30, 200, 64, 5], dtype, 3)]
    bf = dtype == torch.bfloat16
    assert is_wgmma(RaggedPrefillProblem(
        5, k.shape[1], Hq, Hkv, D, "bf16" if bf else "f32")) == bf
    before = KERNEL.launches
    got = ragged_prefill(q, k, v, sq, pq, sk, pk)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    want = ragged_prefill_ref(q, k, v, sq, pq, sk, pk)
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL[dtype], err
    if bf:
        share = mismatch_share(got, want, sq)
        assert share <= P_SPLIT_MISMATCH, share
    assert not got[:, sq < 0].any()
    k2, v2 = k.clone(), v.clone()
    foreign = (sk == 2) | (sk < 0)
    k2[:, foreign] = 1e6
    v2[:, foreign] = 1e6
    keep = sq != 2
    assert torch.equal(got[:, keep],
                       ragged_prefill(q, k2, v2, sq, pq, sk, pk)[:, keep])


# -- the serving kernels at the other architectures' head dims ------------------

# (query heads, KV heads, head_dim): stablelm-3b's 32/32 x 80, gemma-7b's
# 16/16 x 256 and chameleon-34b's reduced 8/2 x 8; bf16 on the
# tensor-core / wgmma instances, float32 on the CUDA cores
WIDE_HEADS = [(32, 32, 80), (16, 16, 256), (8, 2, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", WIDE_HEADS, ids=str)
def test_paged_decode_at_the_other_head_dims_matches_plain(card, heads,
                                                           dtype):
    """Within TOL of the plain version in 16-token pages (8-token ones at
    head_dim 8), zeros for a row of length 0, and poisoned foreign, null
    and tail pages leave the output bit-identical."""
    from repro_torch.core.families.paged_attention import tensor_cores
    from repro_torch.kernels.paged_attention import KERNEL, paged_decode_ref
    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_decode
    Hq, Hkv, D = heads
    PS = 8 if D == 8 else 16
    NP = 12
    lengths = [0, 1, PS + 3, 5 * PS, 7 * PS - 1, NP * PS]
    P = sum(-(-n // PS) for n in lengths) + 8
    assert tensor_cores(D, dtype.itemsize) == (dtype == torch.bfloat16)
    q, kp, vp, table, lens = [t.to(card) for t in _decode_inputs(
        len(lengths), Hq, Hkv, D, PS, NP, P, lengths, dtype)]
    before = KERNEL.launches
    got = paged_decode(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    want = paged_decode_ref(q, kp, vp, table, lens)
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL[dtype], err
    assert not got[0].any()
    kp2, vp2 = _poisoned(kp, vp, table.cpu(), lengths, PS)
    assert torch.equal(got, paged_decode(q, kp2, vp2, table, lens))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", WIDE_HEADS, ids=str)
def test_ragged_prefill_at_the_other_head_dims_matches_plain(card, heads,
                                                             dtype):
    """Within TOL of the plain version on an engine-style packing, zeros
    on padding queries, and a poisoned foreign segment and padding keys
    leave the other segments bit-identical."""
    from repro_torch.core.families.ragged_prefill import (
        RaggedPrefillProblem, is_wgmma)
    from repro_torch.kernels.ragged_prefill import (KERNEL,
                                                    ragged_prefill_ref)
    from repro_torch.kernels.ragged_prefill.ragged_prefill import \
        ragged_prefill
    Hq, Hkv, D = heads
    q, k, v, sq, pq, sk, pk = [t.to(card) for t in _packed_case(
        Hq, Hkv, D, [40, 64, 7, 100], [0, 30, 200, 64], dtype, 3)]
    assert is_wgmma(RaggedPrefillProblem(
        4, k.shape[1], Hq, Hkv, D, "bf16" if dtype == torch.bfloat16
        else "f32")) == (dtype == torch.bfloat16)
    before = KERNEL.launches
    got = ragged_prefill(q, k, v, sq, pq, sk, pk)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    want = ragged_prefill_ref(q, k, v, sq, pq, sk, pk)
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL[dtype], err
    assert not got[:, sq < 0].any()
    k2, v2 = k.clone(), v.clone()
    foreign = (sk == 2) | (sk < 0)
    k2[:, foreign] = 1e6
    v2[:, foreign] = 1e6
    keep = sq != 2
    assert torch.equal(got[:, keep],
                       ragged_prefill(q, k2, v2, sq, pq, sk, pk)[:, keep])


def test_serving_wrappers_raise_at_a_head_dim_no_instance_has(card):
    """head_dim 100 (bf16 rows of 200 bytes, off the 16-byte grain) and
    320 (above 256): no instance of the four attention kernels takes
    them; each wrapper raises on the card (never the plain version in
    its place), no launch."""
    from repro_torch.kernels.flash_attention import DECODE_KERNEL
    from repro_torch.kernels.flash_attention import KERNEL as FA
    from repro_torch.kernels.flash_attention.decode import flash_decode
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro_torch.kernels.paged_attention import KERNEL as PD
    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_decode
    from repro_torch.kernels.ragged_prefill import KERNEL as RP
    from repro_torch.kernels.ragged_prefill import default_config
    from repro_torch.kernels.ragged_prefill.ragged_prefill import \
        ragged_prefill
    kernels = (PD, RP, FA, DECODE_KERNEL)
    before = [k.launches for k in kernels]
    for D in (100, 320):
        q, kp, vp, table, lens = [t.to(card) for t in _decode_inputs(
            2, 8, 2, D, 16, 2, 8, [16, 1], torch.bfloat16)]
        with pytest.raises(ValueError, match="paged_decode kernel takes"):
            paged_decode(q, kp, vp, table, lens)
        case = [t.to(card) for t in _packed_case(8, 2, D, [40, 7],
                                                 [0, 30], torch.bfloat16, 4)]
        cfg = default_config(case[0].shape[1], case[1].shape[1])
        with pytest.raises(ValueError, match="ragged_prefill kernel takes"):
            ragged_prefill(*case, cfg=cfg)
        x = torch.zeros(1, 8, 64, D, device=card, dtype=torch.bfloat16)
        kv = torch.zeros(1, 2, 64, D, device=card, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="flash_attention kernel takes"):
            flash_attention(x, kv, kv)
        with pytest.raises(ValueError, match="flash_decode kernel takes"):
            flash_decode(x[:, :, :1].contiguous(), kv, kv, 64)
    assert [k.launches for k in kernels] == before


# -- flash attention -----------------------------------------------------------

FA_CASES = [
    # (B, Hq, Hkv, Sq, Skv, D, causal, cfg fields): block_q 128 and 64
    # run the wgmma kernel (128- and 64-row CTAs), 32 and 16 (and the
    # family example's 8) the mma.sync one; Sq and Skv ragged against
    # the 128-key tile, Skv < Sq, a key edge inside the first tile
    (1, 2, 1, 256, 256, 64, True, {}),
    (1, 4, 2, 512, 512, 64, True, dict(block_q=128)),
    (1, 4, 2, 512, 512, 128, True, dict(block_q=64)),
    (1, 4, 1, 384, 448, 64, False, dict(block_q=64)),
    (1, 4, 2, 1000, 1500, 128, True, dict(block_q=128)),
    (1, 4, 2, 1000, 1500, 64, False, dict(block_q=128)),
    (1, 8, 1, 700, 300, 128, True, dict(block_q=256)),
    (1, 2, 1, 200, 77, 64, True, dict(block_q=128)),
    (2, 8, 1, 1000, 1500, 128, True, dict(block_q=64, block_kv=64)),
    (2, 8, 1, 1000, 1500, 128, False, dict(block_q=256)),
    (1, 4, 2, 300, 200, 64, True, dict(block_q=8,
                                       causal_block_skip=False)),
    (1, 8, 8, 129, 77, 64, True, dict(block_q=16, block_kv=16,
                                      v_transposed_staging=True)),
    (2, 16, 2, 512, 512, 128, True, dict(block_q=128, block_kv=256)),
    (1, 2, 1, 64, 64, 128, False, dict(block_q=32, causal_block_skip=False)),
]


def _flash_check(got, want):
    """Within the flash kernels' stated tolerance
    (``repro_torch.kernels.flash_attention.ref``)."""
    from repro_torch.kernels.flash_attention import flash_error
    err, row, ok = flash_error(got, want)
    assert ok, (err, row)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_kernel_matches_plain(card, case, dtype):
    from repro_torch.core.families.flash_attention import \
        FlashAttentionConfig
    from repro_torch.kernels.flash_attention import KERNEL, mha, mha_ref
    B, Hq, Hkv, Sq, Skv, D, causal, fields = case
    g = torch.Generator().manual_seed(Sq + Skv)
    q = torch.randn(B, Hq, Sq, D, generator=g).to(dtype).to(card)
    k = torch.randn(B, Hkv, Skv, D, generator=g).to(dtype).to(card)
    v = torch.randn(B, Hkv, Skv, D, generator=g).to(dtype).to(card)
    cfg = FlashAttentionConfig(**fields) if fields else None
    before = KERNEL.launches
    got = mha(q, k, v, cfg=cfg, causal=causal)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _flash_check(got, mha_ref(q, k, v, causal=causal))


DEC_CASES = [
    # (B, Hq, Hkv, S, D, kv_len, kv_splits): groups 8, 1, 2 and 4, a
    # kv_len that is not a multiple of the tile (64 positions at D = 128,
    # 128 at 64), spans shorter than a tile, kv_len 0
    (2, 8, 1, 1024, 128, 1000, 8),
    (3, 2, 2, 512, 64, 512, 1),
    (1, 16, 2, 4096, 128, 3001, 16),
    (4, 8, 8, 256, 64, 17, 2),
    (2, 4, 2, 1024, 128, 1000, 4),
    (2, 8, 2, 2048, 64, 1999, 8),
    (1, 8, 1, 512, 128, 500, 16),
    (1, 8, 1, 256, 64, 256, 8),
    (2, 8, 1, 512, 128, 0, 4),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DEC_CASES)
def test_flash_decode_kernel_matches_plain(card, case, dtype):
    from repro_torch.core.families.flash_decode import FlashDecodeConfig
    from repro_torch.kernels.flash_attention import (DECODE_KERNEL,
                                                     mha_decode, mha_ref)
    B, Hq, Hkv, S, D, kv_len, ns = case
    g = torch.Generator().manual_seed(S + kv_len)
    q = torch.randn(B, Hq, 1, D, generator=g).to(dtype).to(card)
    k = torch.randn(B, Hkv, S, D, generator=g).to(dtype).to(card)
    v = torch.randn(B, Hkv, S, D, generator=g).to(dtype).to(card)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=card)
    before = DECODE_KERNEL.launches
    got = mha_decode(q, k, v, kl, cfg=FlashDecodeConfig(kv_splits=ns))
    torch.cuda.synchronize()
    assert DECODE_KERNEL.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    # at kv_len 0 every span writes l = 0 and the merged row is zero, as
    # the TPU kernel writes it (mha_ref would average V)
    want = (torch.zeros_like(q) if kv_len == 0 else
            mha_ref(q, k, v, causal=False, kv_len=kv_len))
    _flash_check(got, want)


FA_GEOMETRY_CASES = [
    # (B, Hq, Hkv, Sq, Skv, D, causal, block_q): head_dim 8, 24 and 48
    # (64-column tiles; 8 and 24 with a half-zero last k step), 96 and
    # 112 (128), 136 and 256 (256: 64-key wgmma tiles), on every CTA
    # tile (block_q 128 and 64 on wgmma, 32 and 16 on mma.sync); groups
    # 12, 16 and 71
    (1, 4, 2, 300, 200, 8, True, 128), (1, 4, 2, 300, 200, 24, True, 16),
    (1, 4, 1, 384, 448, 48, False, 64), (1, 4, 4, 300, 300, 96, True, 128),
    (1, 4, 4, 300, 300, 96, True, 32), (1, 4, 2, 257, 300, 112, False, 64),
    (1, 4, 2, 300, 200, 136, True, 128), (1, 4, 2, 300, 200, 136, True, 16),
    (1, 2, 1, 256, 256, 256, True, 64), (1, 48, 4, 256, 256, 128, True, 128),
    (1, 32, 2, 256, 256, 128, True, 64), (1, 71, 1, 200, 200, 64, True, 128),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FA_GEOMETRY_CASES, ids=lambda c: (
    f"{c[1]}-{c[2]}x{c[5]}-bq{c[7]}"))
def test_flash_attention_at_every_geometry_matches_plain(card, case, dtype):
    from repro_torch.core.families.flash_attention import \
        FlashAttentionConfig
    from repro_torch.kernels.flash_attention import KERNEL, mha, mha_ref
    B, Hq, Hkv, Sq, Skv, D, causal, bq = case
    g = torch.Generator().manual_seed(Sq + Skv + D)
    q = torch.randn(B, Hq, Sq, D, generator=g).to(dtype).to(card)
    k = torch.randn(B, Hkv, Skv, D, generator=g).to(dtype).to(card)
    v = torch.randn(B, Hkv, Skv, D, generator=g).to(dtype).to(card)
    before = KERNEL.launches
    got = mha(q, k, v, cfg=FlashAttentionConfig(block_q=bq), causal=causal)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _flash_check(got, mha_ref(q, k, v, causal=causal))


DEC_GEOMETRY_CASES = [
    # (B, Hq, Hkv, S, D, kv_len, kv_splits): head_dim 8, 48, 96, 112, 136
    # and 256 across the three widths; groups 12, 16 and 71; kv_len 0
    (2, 8, 2, 512, 8, 500, 4), (2, 8, 2, 512, 48, 300, 2),
    (2, 32, 32, 1024, 96, 1000, 8), (2, 8, 4, 512, 112, 77, 4),
    (2, 8, 2, 512, 136, 511, 4), (2, 16, 16, 512, 256, 257, 8),
    (2, 48, 4, 1024, 128, 1000, 8), (2, 32, 2, 1024, 128, 999, 4),
    (2, 71, 1, 1024, 64, 1000, 8), (2, 71, 1, 512, 64, 0, 4),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DEC_GEOMETRY_CASES, ids=lambda c: (
    f"{c[1]}-{c[2]}x{c[4]}-len{c[5]}"))
def test_flash_decode_at_every_geometry_matches_plain(card, case, dtype):
    from repro_torch.core.families.flash_decode import FlashDecodeConfig
    from repro_torch.kernels.flash_attention import (DECODE_KERNEL,
                                                     mha_decode, mha_ref)
    B, Hq, Hkv, S, D, kv_len, ns = case
    g = torch.Generator().manual_seed(S + kv_len + D)
    q = torch.randn(B, Hq, 1, D, generator=g).to(dtype).to(card)
    k = torch.randn(B, Hkv, S, D, generator=g).to(dtype).to(card)
    v = torch.randn(B, Hkv, S, D, generator=g).to(dtype).to(card)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=card)
    before = DECODE_KERNEL.launches
    got = mha_decode(q, k, v, kl, cfg=FlashDecodeConfig(kv_splits=ns))
    torch.cuda.synchronize()
    assert DECODE_KERNEL.launches == before + 1
    want = (torch.zeros_like(q) if kv_len == 0 else
            mha_ref(q, k, v, causal=False, kv_len=kv_len))
    _flash_check(got, want)


def test_flash_attention_backward_on_the_card(card):
    """The recompute backward on the card gives the CPU's gradients."""
    from repro_torch.kernels.flash_attention import mha
    g = torch.Generator().manual_seed(5)
    base = [torch.randn(1, 4, 96, 64, generator=g),
            torch.randn(1, 2, 80, 64, generator=g),
            torch.randn(1, 2, 80, 64, generator=g)]
    grads = {}
    for dev in ("cpu", "cuda"):
        xs = [t.detach().to(dev).requires_grad_() for t in base]
        mha(*xs, causal=True).square().sum().backward()
        grads[dev] = [x.grad.cpu() for x in xs]
    for a, b in zip(grads["cpu"], grads["cuda"]):
        assert float((a - b).abs().max()) <= 1e-3


def test_flash_wrappers_refuse_what_the_kernels_do_not_take(card):
    from repro_torch.kernels.flash_attention import (DECODE_KERNEL, KERNEL,
                                                     mha, mha_decode)
    before = (KERNEL.launches, DECODE_KERNEL.launches)
    # float32 head_dim 30: rows of 120 bytes, off the 16-byte grain
    x = torch.zeros(1, 2, 64, 30, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        mha(x, x[:, :1].contiguous(), x[:, :1].contiguous())
    h = torch.zeros(1, 2, 64, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError, match="bf16 or f32"):
        mha(h, h, h)
    q = torch.zeros(1, 2, 1, 30, device="cuda")
    kv = torch.zeros(1, 1, 64, 30, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        mha_decode(q, kv, kv, 64)
    assert (KERNEL.launches, DECODE_KERNEL.launches) == before


# -- MoE -----------------------------------------------------------------------

MOE_CASES = [
    # (E, C, DM, DF, block_t, block_f, fuse_gate, gates given): the
    # default config, the family example's block_t 8 (16-row CTAs, half
    # masked), block_t 16..256 and block_f 8..2048, fuse_gate off and
    # gates None, one expert, d_model 1536 (granite) and 96 (a down tile
    # past the edge)
    (4, 128, 256, 512, 64, 512, True, True),
    (2, 64, 128, 512, 8, 512, True, True),
    (2, 64, 192, 256, 16, 64, True, True),
    (3, 96, 256, 384, 32, 128, False, True),
    (2, 256, 128, 512, 128, 256, True, False),
    (1, 512, 64, 2048, 256, 2048, True, True),
    (2, 64, 1536, 512, 64, 512, True, True),
    (2, 32, 96, 64, 8, 8, True, True),
]


def _moe_inputs(E, C, DM, DF, dtype, seed, device="cuda"):
    """x ~ N(0, 1) with two empty rows an expert, weights scaled by
    1/sqrt(fan-in) (outputs of order one), gates in [0.2, 1)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(E, C, DM, generator=g)
    x[:, 1] = 0
    x[:, -1] = 0
    ws = [torch.randn(*s, generator=g) * s[1] ** -0.5
          for s in ((E, DM, DF), (E, DM, DF), (E, DF, DM))]
    gates = torch.rand(E, C, 1, generator=g) * 0.8 + 0.2
    return ([t.to(device, dtype) for t in [x] + ws],
            gates.to(device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MOE_CASES)
def test_grouped_ffn_kernel_matches_plain(card, case, dtype):
    from repro_torch.core.families.moe import MoEConfig
    from repro_torch.kernels.moe import (KERNEL, grouped_ffn,
                                         grouped_ffn_ref, moe_error)
    E, C, DM, DF, bt, bf, fuse, with_gates = case
    (x, wg, wu, wd), gates = _moe_inputs(E, C, DM, DF, dtype, E + C + DF)
    gates = gates if with_gates else None
    before = KERNEL.launches
    got = grouped_ffn(x, wg, wu, wd, gates, cfg=MoEConfig(bt, bf, fuse))
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    want = grouped_ffn_ref(x, wg, wu, wd, gates if fuse else None)
    err, ok = moe_error(got, want)
    assert ok, err
    assert not got[:, 1].any() and not got[:, -1].any()


@pytest.mark.parametrize("cf", [8.0, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_on_the_card_matches_the_dense_oracle(card, dtype, cf):
    from repro_torch.kernels.moe import (KERNEL, capacity_for,
                                         compute_dispatch, default_config,
                                         moe_error, moe_ffn, moe_ffn_ref)
    T, E, K, DM, DF = 512, 8, 2, 256, 512
    (x, wg, wu, wd), _ = _moe_inputs(E, T, DM, DF, dtype, 3)
    x = x[0]
    g = torch.Generator().manual_seed(4)
    logits = torch.randn(T, E, generator=g) - torch.arange(E) / E
    gates, idx = torch.topk(torch.softmax(logits, -1), K)
    gates, idx = gates.cuda(), idx.int().cuda()
    before = KERNEL.launches
    got = moe_ffn(x, gates, idx, wg, wu, wd, capacity_factor=cf)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    C = capacity_for(T, K, E, default_config(DM, DF).block_t, cf)
    _, keep = compute_dispatch(idx, E, C)
    assert bool((~keep).any()) == (cf < 1)
    err, ok = moe_error(got, moe_ffn_ref(x, gates * keep, idx, wg, wu, wd))
    assert ok, err


MOE_WGMMA_CASES = [
    # (E, C, DM, DF, block_t, block_f, fuse_gate, gates given) on the
    # wgmma instance: 128-row CTAs (block_t 128, 256) and 64-row ones
    # (block_t 64, 192 rows an expert: the last CTA half past the edge),
    # config tiles of several CTA tiles, d_model 576 (the last down tile
    # one panel wide) and 1536, one expert, gates None and fuse off
    (4, 256, 512, 512, 128, 256, True, True),
    (3, 192, 256, 384, 64, 128, True, True),
    (2, 512, 576, 256, 256, 256, True, True),
    (1, 128, 256, 256, 128, 128, True, True),
    (2, 128, 512, 256, 64, 256, True, False),
    (2, 256, 256, 512, 128, 512, False, True),
    (8, 640, 1536, 512, 128, 512, True, True),
]


@pytest.mark.parametrize("case", MOE_WGMMA_CASES, ids=str)
def test_grouped_ffn_wgmma_instance_matches_plain(card, case):
    from repro_torch.core.families.moe import MoEConfig, is_wgmma
    from repro_torch.kernels.moe import (KERNEL, grouped_ffn,
                                         grouped_ffn_ref, moe_error)
    from repro_torch.kernels.moe.moe import instance_problem
    E, C, DM, DF, bt, bf, fuse, with_gates = case
    (x, wg, wu, wd), gates = _moe_inputs(E, C, DM, DF, torch.bfloat16,
                                         E + C + DM)
    gates = gates if with_gates else None
    cfg = MoEConfig(bt, bf, fuse)
    assert is_wgmma(cfg, instance_problem(x, wg))
    before = KERNEL.launches
    got = grouped_ffn(x, wg, wu, wd, gates, cfg=cfg)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    err, ok = moe_error(got, grouped_ffn_ref(x, wg, wu, wd,
                                             gates if fuse else None))
    assert ok, err
    assert not got[:, 1].any() and not got[:, -1].any()


def test_validator_runs_the_moe_kernel_on_the_card(card):
    from repro_torch.core.families.moe import MoEConfig, MoEProblem
    from repro_torch.core.harness import (KernelState, LoweredState,
                                          Validator)
    from repro_torch.kernels.moe import KERNEL
    v = Validator(run_kernels=True)
    before = KERNEL.launches
    for cfg in (MoEConfig(block_t=8), MoEConfig(256, 1024, False),
                MoEConfig(64, 512)):
        st = KernelState("moe", cfg, MoEProblem(16384, 7168, 2048, 32, 8,
                                                "bf16")).refresh()
        assert v.evaluate(LoweredState(st), incumbent_s=1.0).ok
    assert KERNEL.launches - before == v.reference_runs == 3


def test_grouped_ffn_wrapper_refuses_what_the_kernel_does_not_take(card):
    from repro_torch.core.families.moe import MoEConfig
    from repro_torch.kernels.moe import KERNEL, grouped_ffn
    before = KERNEL.launches
    (x, wg, wu, wd), _ = _moe_inputs(2, 16, 100, 64, torch.bfloat16, 0)
    with pytest.raises(ValueError, match="16-byte vectors"):
        grouped_ffn(x, wg, wu, wd, cfg=MoEConfig(8, 32))
    (x, wg, wu, wd), _ = _moe_inputs(2, 16, 64, 64, torch.float32, 0)
    with pytest.raises(TypeError, match="bf16 or f32"):
        grouped_ffn(x.half(), wg.half(), wu.half(), wd.half(),
                    cfg=MoEConfig(8, 32))
    with pytest.raises(TypeError, match="one type"):
        grouped_ffn(x, wg.bfloat16(), wu, wd, cfg=MoEConfig(8, 32))
    with pytest.raises(ValueError, match="contiguous"):
        grouped_ffn(x.transpose(1, 2).contiguous().transpose(1, 2), wg, wu,
                    wd, cfg=MoEConfig(8, 32))
    assert KERNEL.launches == before


# -- quant_gemm and ssd (the tolerances beside quant_error and ssd_error) -----

QUANT_CASES = [
    # (m, n, k, group, bm, bn, bk)
    (256, 256, 512, 128, 128, 128, 128),      # the default config (wgmma)
    (200, 130, 700, 128, 64, 64, 64),         # ragged m, n, k
    (128, 96, 256, 64, 32, 32, 32),
    (64, 256, 384, 128, 16, 256, 128),        # 16-row CTAs, 4 column CTAs
    (100, 100, 300, 100, 32, 32, 100),        # the masked byte path
    (512, 512, 1024, 256, 256, 128, 256),
    # the int8 wgmma instance: bk 32 and 64, group 64, rows masked by
    # TMA's zero fill, n and k ragged against the 128-wide tile and stage
    (40, 256, 512, 128, 128, 128, 128),
    (256, 256, 512, 64, 128, 256, 32),
    (1000, 784, 1552, 128, 128, 128, 64),
    (2048, 2048, 2048, 128, 256, 256, 128),
]


def _quant_inputs(m, n, k, group, seed, device="cuda"):
    from repro_torch.kernels.quant_gemm import quantize_per_group
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(m, k, generator=g)
    b = torch.randn(k, n, generator=g)
    aq, sa = quantize_per_group(a, group, axis=1)
    bq, sb = quantize_per_group(b, group, axis=0)
    return [t.to(device) for t in (aq, bq, sa, sb)]


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", QUANT_CASES, ids=str)
def test_quant_gemm_kernel_matches_plain(card, case, out):
    from repro_torch.core.families.quant_gemm import QuantGemmConfig
    from repro_torch.kernels.quant_gemm import (KERNEL, quant_error,
                                                quant_gemm_ref, quant_matmul)
    m, n, k, group, bm, bn, bk = case
    aq, bq, sa, sb = _quant_inputs(m, n, k, group, m + n + k)
    before = KERNEL.launches
    got = quant_matmul(aq, bq, sa, sb, group=group,
                       cfg=QuantGemmConfig(bm, bn, bk), out_dtype=out)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    want = quant_gemm_ref(aq, bq, sa, sb, group=group, out_dtype=out)
    err, ok = quant_error(got, want)
    assert ok, err


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bk", [32, 64, 128])
def test_quant_gemm_wgmma_is_bit_identical_to_mma_sync(card, bk, out):
    """The two instances promote each block with one expression, in K
    order: at one bk, whatever their tiles, the same bits."""
    from repro_torch.core.families.quant_gemm import (QuantGemmConfig,
                                                      QuantGemmProblem,
                                                      is_wgmma)
    from repro_torch.kernels.quant_gemm import quant_matmul
    aq, bq, sa, sb = _quant_inputs(1000, 784, 1552, 128, bk)
    prob = QuantGemmProblem(1000, 784, 1552, 128)
    wg, ms = QuantGemmConfig(128, 128, bk), QuantGemmConfig(64, 64, bk)
    assert is_wgmma(wg, prob) and not is_wgmma(ms, prob)
    a = quant_matmul(aq, bq, sa, sb, group=128, cfg=wg, out_dtype=out)
    b = quant_matmul(aq, bq, sa, sb, group=128, cfg=ms, out_dtype=out)
    assert torch.equal(a, b), int((a != b).sum())


def test_quant_gemm_unaligned_pointers_take_the_mma_sync_instance(card):
    """TMA needs 16-byte-aligned bases: an A one byte into its buffer
    runs on the mma.sync instance's byte path, as the plain version."""
    from repro_torch.kernels.quant_gemm import (KERNEL, quant_error,
                                                quant_gemm_ref, quant_matmul)
    aq, bq, sa, sb = _quant_inputs(256, 256, 512, 128, 2)
    buf = torch.empty(aq.numel() + 1, dtype=torch.int8, device=aq.device)
    a1 = buf[1:].view(aq.shape)
    a1.copy_(aq)
    assert a1.data_ptr() % 16 and a1.is_contiguous()
    before = KERNEL.launches
    got = quant_matmul(a1, bq, sa, sb, group=128)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    assert quant_error(got, quant_gemm_ref(aq, bq, sa, sb, group=128))[1]


def test_quant_gemm_kernel_at_the_production_problem(card):
    from repro_torch.kernels.quant_gemm import (quant_error, quant_gemm_ref,
                                                quant_matmul)
    aq, bq, sa, sb = _quant_inputs(8192, 8192, 8192, 128, 0)
    got = quant_matmul(aq, bq, sa, sb, group=128)
    err, ok = quant_error(got, quant_gemm_ref(aq, bq, sa, sb, group=128))
    assert ok, err


def test_quant_gemm_wrapper_refuses_what_the_kernel_does_not_take(card):
    from repro_torch.core.families.quant_gemm import QuantGemmConfig
    from repro_torch.kernels.quant_gemm import (KERNEL, InvariantViolation,
                                                quant_gemm, quant_matmul)
    aq, bq, sa, sb = _quant_inputs(128, 128, 256, 128, 1)
    before = KERNEL.launches
    with pytest.raises(InvariantViolation):
        quant_matmul(aq, bq, sa, sb, group=128, cfg=QuantGemmConfig(bk=96))
    with pytest.raises(ValueError, match="must divide"):
        quant_gemm(aq, bq, sa, sb, group=128, cfg=QuantGemmConfig(bk=96))
    with pytest.raises(TypeError, match="int8"):
        quant_matmul(aq.to(torch.float8_e4m3fn), bq.to(torch.float8_e4m3fn),
                     sa, sb, group=128)
    with pytest.raises(ValueError, match="contiguous"):
        quant_gemm(aq.t().contiguous().t(), bq, sa, sb, group=128)
    assert KERNEL.launches == before


def test_validator_runs_the_quant_kernel_on_the_card(card):
    from repro_torch.core.families.quant_gemm import (QuantGemmConfig,
                                                      QuantGemmProblem)
    from repro_torch.core.harness import (KernelState, LoweredState,
                                          Validator)
    from repro_torch.kernels.quant_gemm import KERNEL
    v = Validator(run_kernels=True)
    before = KERNEL.launches
    for cfg in (QuantGemmConfig(), QuantGemmConfig(32, 64, 32),
                QuantGemmConfig(256, 512, 64)):
        st = KernelState("quant_gemm", cfg, QuantGemmProblem(
            8192, 8192, 8192, 128)).refresh()
        assert v.evaluate(LoweredState(st), incumbent_s=1.0).ok
    assert KERNEL.launches - before == v.reference_runs == 3


SSD_CASES = [
    # (BH, S, P, N, chunk)
    (2, 256, 32, 16, 64),
    (1, 512, 64, 128, 512),           # one 512-long chunk
    (3, 96, 24, 12, 32),              # P, N off the grain
    (2, 1024, 128, 64, 256),          # two P tiles
    (64, 2048, 64, 128, 128),
    (4, 160, 16, 8, 160),             # a chunk of no whole 64-row blocks
    (2, 2048, 64, 128, 32),           # 64 chunks a head through the pass
    (2, 256, 9, 7, 64),               # N·P odd: the pass a float a thread
    (64, 8192, 64, 128, 64),          # the family's production problem
]


def _ssd_inputs(BH, S, P, N, dtype, seed, device="cuda"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(BH, S, P, generator=g)
    da = -torch.randn(BH, S, generator=g).abs() * .1
    B = torch.randn(BH, S, N, generator=g) * .3
    C = torch.randn(BH, S, N, generator=g) * .3
    return (x.to(device, dtype), da.to(device), B.to(device, dtype),
            C.to(device, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_kernel_matches_plain(card, case, dtype):
    from repro_torch.core.families.ssd import SSDConfig
    from repro_torch.kernels.ssd import KERNEL, ssd, ssd_error, ssd_ref
    BH, S, P, N, q = case
    x, da, B, C = _ssd_inputs(BH, S, P, N, dtype, BH + S + P)
    before = KERNEL.launches
    got = ssd(x, da, B, C, cfg=SSDConfig(chunk=q))
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    want, _ = ssd_ref(x, da, B, C, q)
    err, row, ok = ssd_error(got, want)
    assert ok, (err, row)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_at_mamba2_decays(card, dtype):
    """da ~ -0.7 a step (mamba2-780m's first layer), |cs| ~ 180 over a
    256-long chunk: L from the difference of cumulative decays."""
    from repro_torch.core.families.ssd import SSDConfig
    from repro_torch.kernels.ssd import ssd, ssd_error, ssd_ref
    x, da, B, C = _ssd_inputs(8, 1024, 64, 128, dtype, 7)
    da = da * 7
    got = ssd(x, da, B, C, cfg=SSDConfig(chunk=256))
    want, _ = ssd_ref(x, da, B, C, 256)
    err, row, ok = ssd_error(got, want)
    assert ok, (err, row)


def test_ssd_via_kernel_on_the_card_matches_ssd_chunked(card):
    from repro_torch.kernels.ssd import KERNEL, ssd_error
    from repro_torch.models.ssm import ssd_chunked, ssd_via_kernel
    g = torch.Generator().manual_seed(3)
    B_, S, H, P, N = 2, 512, 4, 64, 128
    xh = torch.randn(B_, S, H, P, generator=g).cuda()
    da = (-torch.randn(B_, S, H, generator=g).abs() * .1).cuda()
    Bh = (torch.randn(B_, S, H, N, generator=g) * .3).cuda()
    Ch = (torch.randn(B_, S, H, N, generator=g) * .3).cuda()
    before = KERNEL.launches
    got = ssd_via_kernel(xh, da, Bh, Ch, 256)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    want, _ = ssd_chunked(xh, da, Bh, Ch, 256)
    err, row, ok = ssd_error(got, want)
    assert ok, (err, row)


def test_ssd_wrapper_refuses_what_the_kernel_does_not_take(card):
    from repro_torch.core.families.ssd import SSDConfig
    from repro_torch.kernels.ssd import KERNEL, ssd_chunk_scan
    before = KERNEL.launches
    x, da, B, C = _ssd_inputs(1, 128, 16, 256, torch.float32, 0)
    with pytest.raises(ValueError, match="d_state up to 128"):
        ssd_chunk_scan(x, da, B, C, cfg=SSDConfig(64))
    x, da, B, C = _ssd_inputs(1, 128, 16, 16, torch.float32, 0)
    with pytest.raises(TypeError, match="one type"):
        ssd_chunk_scan(x, da, B.bfloat16(), C, cfg=SSDConfig(64))
    with pytest.raises(ValueError, match="must divide chunk"):
        ssd_chunk_scan(x, da, B, C, cfg=SSDConfig(96))
    assert KERNEL.launches == before


def test_validator_runs_the_ssd_kernel_on_the_card(card):
    from repro_torch.core.families.ssd import SSDConfig, SSDProblem
    from repro_torch.core.harness import (KernelState, LoweredState,
                                          Validator)
    from repro_torch.kernels.ssd import KERNEL
    v = Validator(run_kernels=True)
    before = KERNEL.launches
    for chunk in (32, 64, 512):
        st = KernelState("ssd", SSDConfig(chunk), SSDProblem(
            64, 8192, 64, 128)).refresh()
        assert v.evaluate(LoweredState(st), incumbent_s=1.0).ok
    assert KERNEL.launches - before == v.reference_runs == 3


def test_fleet_runs_its_unit_tests_on_the_card(card, tmp_path):
    """A one-job fleet (the reduced qwen3 paged decode geometry) with
    ``run_kernels=True`` on the card: every unit test launches the
    paged-decode kernel (two passes a test), and the table is the one
    the same fleet writes without unit tests."""
    from repro_torch.core.families.paged_attention import \
        PagedAttentionProblem
    from repro_torch.core.tuning import make_job, run_fleet
    from repro_torch.kernels.paged_attention import KERNEL
    job = make_job("paged_attention", PagedAttentionProblem(
        4, 4, 2, 64, 8, 25, 16, "bf16"))
    KERNEL.launches = 0
    rep = run_fleet([job], out_dir=tmp_path / "card", base_budget=2,
                    max_budget=4, run_kernels=True)
    tests = sum(r["verdict_stages"].get("ok", 0)
                for r in rep.records.values())
    assert tests > 0 and KERNEL.launches == 2 * tests
    run_fleet([job], out_dir=tmp_path / "model", base_budget=2,
              max_budget=4, device="cpu")
    assert (tmp_path / "card" / "dispatch_table.json").read_bytes() == \
        (tmp_path / "model" / "dispatch_table.json").read_bytes()
