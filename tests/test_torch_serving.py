"""Port of serve/: the port's engines against the JAX engines on the
fig_serving Poisson and bursty traces (benchmarks/fig_serving.py's trace
parameters and engine geometry), at the float32 variant of the reduced
qwen3-1.7b config, with the JAX init's weights carried across.  Tokens
must be identical, and so must the whole metrics snapshot (schema v4):
both engines run on a virtual TickClock, so even the step-time
histograms are a function of the call sequence alone.  Also: a
preemption case, the PageAllocator under a seeded fuzz, the pool's
gather/scatter, and the copied metrics schema."""
import dataclasses

import numpy as np
import pytest

import jax
import torch

from repro import configs as jconfigs
from repro.models import build as jax_build
from repro.obs import TickClock as JaxTickClock
from repro.serve import (PagedServingEngine as JaxPaged,
                         ServingEngine as JaxDense)
from repro.serve import metrics as jax_metrics
from repro.serve.pool import PageAllocator as JaxAllocator
from repro.serve.trace import (bursty_trace as jax_bursty,
                               poisson_trace as jax_poisson,
                               replay as jax_replay)

from repro_torch import configs as tconfigs
from repro_torch.kernels import ALL_KERNELS
from repro_torch.models import build as torch_build, from_jax_numpy
from repro_torch.obs import TickClock
from repro_torch.serve import (KVPool, PagedServingEngine, PageAllocator,
                               PoolExhausted, Request, ServingEngine)
from repro_torch.serve import metrics as torch_metrics
from repro_torch.serve.trace import bursty_trace, poisson_trace, replay

ARCH = "qwen3-1.7b"
GEOM = dict(page_size=8, max_batch=4, max_len=64, prefill_chunk=8)
POOL = 25


@pytest.fixture(scope="module")
def models():
    jc = dataclasses.replace(jconfigs.get_reduced(ARCH), dtype="float32")
    tc = dataclasses.replace(tconfigs.get_reduced(ARCH), dtype="float32")
    jm, tm = jax_build(jc), torch_build(tc)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _traces(vocab, requests=24, seed=0, mod=None):
    """fig_serving.py's two traces (its --seed 0 defaults)."""
    poisson = (mod or {}).get("poisson", poisson_trace)
    bursty = (mod or {}).get("bursty", bursty_trace)
    return {
        "poisson": poisson(seed=seed + 1, n_requests=requests,
                           mean_gap=3.0, prompt_lens=(4, 28),
                           max_new=(4, 12), vocab=vocab),
        "bursty": bursty(seed=seed + 2, n_bursts=max(requests // 6, 1),
                         burst_size=6, burst_gap=20, prompt_lens=(4, 28),
                         max_new=(4, 12), vocab=vocab),
    }


def test_traces_are_the_same_arrivals():
    ours = _traces(256)
    theirs = _traces(256, mod={"poisson": jax_poisson,
                               "bursty": jax_bursty})
    for name in ours:
        assert [dataclasses.astuple(a) for a in ours[name]] == \
            [dataclasses.astuple(a) for a in theirs[name]]


_ENGINES = {
    "dense": lambda: dict(n_slots=4, max_len=64, eos_id=-1),
    "paged_gather": lambda: dict(pool_pages=POOL, eos_id=-1,
                                 decode_path="gather",
                                 prefill_path="gather", **GEOM),
    "paged_kernel": lambda: dict(pool_pages=POOL, eos_id=-1,
                                 decode_path="kernel",
                                 prefill_path="kernel", **GEOM),
}


@pytest.mark.parametrize("trace", ["poisson", "bursty"])
@pytest.mark.parametrize("engine", list(_ENGINES))
def test_engine_matches_jax_on_fig_serving_trace(models, trace, engine):
    jm, jp, tm, tp = models
    kw = _ENGINES[engine]()
    if engine == "dense":
        jeng = JaxDense(jm, jp, clock=JaxTickClock(), **kw)
        teng = ServingEngine(tm, tp, clock=TickClock(), device="cpu", **kw)
    else:
        jeng = JaxPaged(jm, jp, clock=JaxTickClock(), **kw)
        teng = PagedServingEngine(tm, tp, clock=TickClock(), device="cpu",
                                  **kw)
    tr = _traces(tm.cfg.vocab)[trace]
    want = jax_replay(jeng, tr)
    got = replay(teng, tr)
    assert got["outputs"] == want["outputs"]
    assert got["latency"] == want["latency"]
    assert got["ticks"] == want["ticks"]
    assert got["metrics"] == want["metrics"]       # whole snapshot, v4
    c = got["metrics"]["counters"]
    if engine == "paged_kernel":
        # every tick with work went through the kernel paths
        assert c["gather_bytes"] == 0
        assert c["kernel_decode_ticks"] > 0 and c["kernel_prefill_ticks"] > 0
    if engine == "paged_gather":
        assert c["kernel_decode_ticks"] == c["kernel_prefill_ticks"] == 0
    if engine != "dense":
        null = teng.kv.storage["blocks"]
        assert float(null["k"][:, 0].abs().max()) == 0.0
        assert float(null["v"][:, 0].abs().max()) == 0.0


def _mixed_requests(seed=11, n=4, vocab=256):
    rng = np.random.default_rng(seed)
    return [(rng.integers(2, vocab, size=int(rng.integers(6, 28))).tolist(),
             int(rng.integers(4, 12))) for _ in range(n)]


def _submit_all(eng, reqs, req_cls):
    for rid, (p, m) in enumerate(reqs):
        eng.submit(req_cls(rid, list(p), max_new_tokens=m))
    return {r.rid: r.output for r in eng.run()}


def test_kernel_path_preemption_matches_jax(models):
    """A pool far below the working set forces recompute-style
    preemption on the kernel paths: tokens identical to the JAX engine
    under the same pressure and to the port's own roomy run."""
    from repro.serve import Request as JaxRequest
    jm, jp, tm, tp = models
    reqs = _mixed_requests()
    kw = dict(page_size=8, max_batch=4, max_len=64, prefill_chunk=8,
              eos_id=-1, decode_path="kernel", prefill_path="kernel")
    tight = PagedServingEngine(tm, tp, pool_pages=9, device="cpu", **kw)
    got = _submit_all(tight, reqs, Request)
    want = _submit_all(JaxPaged(jm, jp, pool_pages=9, **kw), reqs,
                       JaxRequest)
    roomy = _submit_all(PagedServingEngine(tm, tp, pool_pages=40,
                                           device="cpu", **kw),
                        reqs, Request)
    assert got == want == roomy
    c = tight.metrics.counters
    assert c["preempted"] > 0 and c["gather_bytes"] == 0


def test_kernel_launches_are_not_counted_on_cpu(models):
    """On CPU tensors the wrappers run the plain versions, which never
    move the kernels' launch counters."""
    _, _, tm, tp = models
    before = [k.launches for k in ALL_KERNELS]
    eng = PagedServingEngine(tm, tp, pool_pages=POOL, device="cpu",
                             eos_id=-1, decode_path="kernel",
                             prefill_path="kernel", **GEOM)
    _submit_all(eng, _mixed_requests(n=2), Request)
    assert [k.launches for k in ALL_KERNELS] == before


def _alloc_ops(seed, n_ops=400):
    rng = np.random.default_rng(seed)
    kinds = ("alloc", "ensure", "free", "evict", "touch")
    return [(kinds[int(rng.integers(len(kinds)))], int(rng.integers(6)),
             int(rng.integers(1, 5))) for _ in range(n_ops)]


def _drive(alloc, ops, running):
    trace = []
    for kind, seq, n in ops:
        try:
            if kind == "alloc":
                alloc.alloc(seq, n)
            elif kind == "ensure":
                alloc.ensure(seq, n * alloc.page_size)
            elif kind == "free":
                alloc.free_seq(seq)
            elif kind == "touch":
                alloc.touch(seq)
            else:
                victim = alloc.lru_victim(protected=running)
                if victim is not None:
                    assert victim not in running
                    alloc.free_seq(victim)
        except Exception as e:      # PoolExhausted of either package
            assert type(e).__name__ == "PoolExhausted"
        alloc.check()               # free ∪ mapped partitions 1..n-1
        trace.append((dict(alloc.tables), alloc.free_pages))
    return trace


@pytest.mark.parametrize("seed", range(4))
def test_page_allocator_conserves_pool_under_seeded_fuzz(seed):
    ops = _alloc_ops(seed)
    running = frozenset({0, 1})
    got = _drive(PageAllocator(13, 4), ops, running)
    want = _drive(JaxAllocator(13, 4), ops, running)
    assert got == want
    with pytest.raises(PoolExhausted):
        PageAllocator(3, 4).alloc(0, 3)


def test_pool_gather_scatter_round_trip(models):
    _, _, tm, _ = models
    pool = KVPool(tm, 6, 8, device="cpu")
    for leaf in pool.storage["blocks"].values():
        leaf[:, 1:].normal_(generator=torch.Generator().manual_seed(0))
    tables = torch.tensor([[2, 5, 0], [1, 0, 0]], dtype=torch.int32)
    view = pool.gather(tables)
    k = view["blocks"]["k"]
    assert k.shape == (2, 2, 2, 24, 16)            # (L, B, Hkv, 24, D)
    assert torch.equal(k[:, 0, :, 8:16], pool.storage["blocks"]["k"][:, 5])
    assert float(k[:, 1, :, 8:].abs().max()) == 0.0   # null page reads 0
    view["blocks"]["k"][:, 1, :, 3] = 7.0
    view["blocks"]["v"][:, 1, :, 3] = 7.0
    pool.scatter(view, np.array([1]), np.array([3]), np.array([1]),
                 np.array([3]))
    assert float(pool.storage["blocks"]["k"][:, 1, :, 3].min()) == 7.0
    assert pool.nbytes == 2 * 2 * 6 * 2 * 8 * 16 * 4
    assert KVPool.dense_reserved_bytes(tm, 4, 64) == 2 * 2 * 4 * 2 * 64 \
        * 16 * 4


def test_metrics_schema_is_the_jax_schema():
    assert torch_metrics.SCHEMA_VERSION == jax_metrics.SCHEMA_VERSION == 4
    assert torch_metrics.SCHEMA_EXAMPLE == jax_metrics.SCHEMA_EXAMPLE
    snap = jax_metrics.ServingMetrics.from_snapshot(
        jax_metrics.SCHEMA_EXAMPLE).snapshot()
    assert torch_metrics.ServingMetrics.from_snapshot(snap).snapshot() \
        == snap


def test_engine_argument_errors_match(models):
    _, _, tm, tp = models
    with pytest.raises(ValueError, match="multiple of"):
        PagedServingEngine(tm, tp, pool_pages=8, page_size=8, max_len=60,
                           device="cpu")
    with pytest.raises(ValueError, match="decode_path"):
        PagedServingEngine(tm, tp, pool_pages=8, page_size=8, max_len=32,
                           decode_path="oracle", device="cpu")


class _NoKernelPaths:
    """A model without the paged hooks: the engine must fall back to the
    gather paths on every tick, as the JAX engine does for models it
    cannot paged-attend, and count no kernel tick."""

    def __init__(self, model):
        self._m = model
        self.cfg = model.cfg

    def __getattr__(self, name):
        if name in ("decode_step_paged", "prefill_chunk_packed"):
            raise AttributeError(name)
        return getattr(self._m, name)


def test_models_without_kernel_hooks_fall_back_to_gather(models):
    _, _, tm, tp = models
    reqs = _mixed_requests(seed=4, n=3)
    kw = dict(pool_pages=POOL, eos_id=-1, decode_path="kernel",
              prefill_path="kernel", device="cpu", **GEOM)
    fallback = PagedServingEngine(_NoKernelPaths(tm), tp, **kw)
    kernel = PagedServingEngine(tm, tp, **kw)
    assert _submit_all(fallback, reqs, Request) == \
        _submit_all(kernel, reqs, Request)
    c = fallback.metrics.counters
    assert c["kernel_decode_ticks"] == c["kernel_prefill_ticks"] == 0
    assert c["gather_bytes"] > 0
