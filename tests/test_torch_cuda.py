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
float32 sums may differ by more than a step of the value)."""
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


def test_reduced_engine_on_the_card_matches_the_cpu(card):
    """float32 reduced model, kernel paths: the card (CUDA kernels) and
    the CPU (plain versions) give the same tokens."""
    from repro_torch import configs
    from repro_torch.kernels import ALL_KERNELS
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
    serving = [k for k in ALL_KERNELS if k.name != "gemm"]
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


def test_gemm_kernel_at_the_production_problem(card):
    from repro_torch.kernels.gemm import KERNEL, matmul, matmul_ref
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(8192, 8192, generator=g, device="cuda").bfloat16()
    b = torch.randn(8192, 8192, generator=g, device="cuda").bfloat16()
    before = KERNEL.launches
    got = matmul(a, b)
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
