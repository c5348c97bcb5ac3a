"""The port's CUDA kernels against their plain PyTorch versions on the
card, at the reduced config's shapes (head_dim 16, page size 8) and at
full width (head_dim 128, page size 16), and the reduced engine on the
card against the same engine on the CPU.  Every test here needs a CUDA
card and ``nvcc``, and skips without them:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: float32 1e-4 (the same products summed in another order);
bfloat16 1e-2, a little above one bfloat16 step at |x| < 2 (2^-7)."""
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
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        before = [k.launches for k in ALL_KERNELS]
        eng = PagedServingEngine(model, p, pool_pages=25, page_size=8,
                                 max_batch=4, max_len=64, prefill_chunk=8,
                                 eos_id=-1, decode_path="kernel",
                                 prefill_path="kernel", device=dev)
        outs[dev] = replay(eng, trace)["outputs"]
        launched = [k.launches - b for k, b in zip(ALL_KERNELS, before)]
        assert all(n > 0 for n in launched) == (dev == "cuda")
    assert outs["cuda"] == outs["cpu"]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)
