"""The paged decode call made capture-safe, on the CPU: every row writes
(an inactive one zeros into the null page) and gives the pool and the
logits of the active-rows-only write it replaced, bit for bit; the
host-to-device scalars that left the decode path (the unembed's pad
mask, the embedding scale, the GELU constants) give the bits they gave;
the engine builds no CUDA graph on the CPU, and counts the replays and
captures of a holder a tick at a time.  The graph itself runs only on
the card (``tests/test_torch_cuda.py``)."""
import dataclasses
import math
from functools import partial

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels.paged_attention.paged_attention import (
    PagedAttentionConfig, paged_decode)
from repro_torch.models import build
from repro_torch.models.components import (F32, NEG_INF, attn_out, embed,
                                           gelu_tanh, qkv_project, unembed)
from repro_torch.serve import PagedServingEngine
from repro_torch.serve.trace import poisson_trace, replay

P, PS, NP = 14, 8, 4
# (table row, write position, length) of each row; an inactive row has
# length 0 (the engine zeroes its table and position; a direct caller
# may not)
ROWS = {
    "active": ([3, 5, 0, 0], 9, 10),
    "inactive": ([0, 0, 0, 0], 0, 0),
    "mid_prefill": ([7, 8, 0, 0], 5, 0),
    "last_offset": ([9, 0, 0, 0], PS - 1, PS),
    "next_page": ([10, 11, 0, 0], PS, PS + 1),
    "first": ([12, 0, 0, 0], 0, 1),
}
CASES = {
    "inactive_rows": ["active", "inactive", "first", "inactive"],
    "rows_mid_prefill": ["mid_prefill", "active", "inactive"],
    "page_boundary": ["last_offset", "next_page", "inactive"],
    "all_inactive": ["inactive", "mid_prefill"],
}
BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def _model(arch, dtype):
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype=dtype)
    model = build(cfg)
    return model, model.init(0, device="cpu")


def _pool(model, dtype, seed):
    """Random pages, the null page 0 zero, as a serving pool holds them."""
    g = torch.Generator().manual_seed(seed)
    shape = (model.n_scanned, P, model.cfg.n_kv_heads, PS,
             model.cfg.resolved_head_dim)
    pool = {"blocks": {k: torch.randn(shape, generator=g).to(dtype)
                       for k in ("k", "v")}}
    for leaf in pool["blocks"].values():
        leaf[:, 0] = 0
    return pool


def _inputs(case, vocab, seed):
    rows = [ROWS[r] for r in CASES[case]]
    g = torch.Generator().manual_seed(seed)
    return (torch.tensor([t for t, _, _ in rows], dtype=torch.int32),
            torch.randint(2, vocab, (len(rows), 1), generator=g,
                          dtype=torch.int32),
            torch.tensor([p for _, p, _ in rows], dtype=torch.int32),
            torch.tensor([n for _, _, n in rows], dtype=torch.int32))


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(BITS[a.dtype]),
                                              b.view(BITS[b.dtype]))


# -- the write the every-row write replaced ----------------------------------

def _rows_only_attention(p, x, positions, cfg, leaf, tables, lengths,
                         writes, *, kernel_cfg):
    q, k, v = qkv_project(p, x, cfg, positions)
    rows, phys, off = writes
    leaf["k"][phys, :, off] = k[rows, :, 0, :].to(leaf["k"].dtype)
    leaf["v"][phys, :, off] = v[rows, :, 0, :].to(leaf["v"].dtype)
    o = paged_decode(q, leaf["k"], leaf["v"], tables, lengths,
                     cfg=kernel_cfg)
    return attn_out(p, o)


def _rows_only_decode(model, params, pool, tables, tokens, pos, lengths,
                      kernel_cfg):
    """The decode call as it wrote before: the active rows alone, found
    with ``torch.nonzero`` (a host sync)."""
    cfg = model.cfg
    x = embed(params["embed"], tokens, cfg)
    pos = pos.to(torch.int64)
    positions = pos[:, None]
    rows = torch.nonzero(lengths > 0).squeeze(1)
    phys = tables[rows, pos[rows] // PS].long()
    writes = (rows, phys, pos[rows] % PS)

    def attend(p, h, leaf):
        return _rows_only_attention(p, h, positions, cfg, leaf, tables,
                                    lengths, writes, kernel_cfg=kernel_cfg)
    x = model._blocks(params, x, partial(model._served_block, attend), pool)
    return model._head(params, x)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "stablelm-3b",
                                  "granite-moe-3b-a800m"])
@pytest.mark.parametrize("case", list(CASES))
def test_every_row_write_gives_the_active_rows_write_bits(case, arch, dtype):
    model, params = _model(arch, dtype)
    tdt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    pool = _pool(model, tdt, seed=len(case))
    inputs = _inputs(case, model.cfg.vocab, seed=len(arch))
    kcfg = PagedAttentionConfig(block_pages=2)
    want_pool = _clone(pool)
    want = _rows_only_decode(model, params, want_pool, *inputs, kcfg)
    got, got_pool = model.decode_step_paged(params, pool, *inputs,
                                            kernel_cfg=kcfg)
    assert got_pool is pool
    assert _same_bits(got, want)
    for name, leaf in pool["blocks"].items():
        assert _same_bits(leaf, want_pool["blocks"][name]), name
        # the null page holds +0.0 in every bit
        assert not leaf[:, 0].view(BITS[tdt]).any(), name


# -- host-to-device scalars off the decode path ------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_pad_column_mask_gives_the_bits_it_gave(dtype):
    cfg = dataclasses.replace(configs.get_reduced("granite-moe-3b-a800m"),
                              vocab=250)
    assert cfg.padded_vocab == 256
    g = torch.Generator().manual_seed(1)
    p = {"tok": torch.randn(cfg.padded_vocab, cfg.d_model, generator=g)}
    x = torch.randn(3, 2, cfg.d_model, generator=g).to(dtype)
    got = unembed(p, x, cfg)
    logits = torch.matmul(x.to(F32), p["tok"].T)
    valid = torch.arange(cfg.padded_vocab) < cfg.vocab
    want = torch.where(valid, logits, torch.tensor(NEG_INF, dtype=F32))
    assert _same_bits(got, want)
    assert (got[..., cfg.vocab:] == NEG_INF).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_embed_scale_and_gelu_constants_give_the_bits_they_gave(dtype):
    g = torch.Generator().manual_seed(2)
    x = (torch.randn(4096, generator=g) * 4).to(dtype)
    c = lambda v: torch.tensor(v, dtype=dtype)
    inner = c(math.sqrt(2 / math.pi)) * (x + c(0.044715) * (x * x * x))
    assert _same_bits(gelu_tanh(x),
                      x * (c(0.5) * (c(1.0) + torch.tanh(inner))))
    cfg = dataclasses.replace(configs.get_reduced("gemma-7b"),
                              dtype={torch.bfloat16: "bfloat16",
                                     torch.float32: "float32"}[dtype])
    assert cfg.scale_embed
    p = {"tok": torch.randn(cfg.padded_vocab, cfg.d_model, generator=g)}
    toks = torch.randint(0, cfg.vocab, (2, 5), generator=g)
    want = p["tok"][toks].to(dtype) * c(math.sqrt(cfg.d_model))
    assert _same_bits(embed(p, toks, cfg), want)


# -- the engine ---------------------------------------------------------------

GEOM = dict(page_size=8, max_batch=4, max_len=64, prefill_chunk=8)


def _trace(vocab):
    return poisson_trace(seed=5, n_requests=6, mean_gap=2.0,
                         prompt_lens=(4, 20), max_new=(3, 8), vocab=vocab)


def _engine(model, params):
    return PagedServingEngine(model, params, pool_pages=25, eos_id=-1,
                              decode_path="kernel", prefill_path="kernel",
                              device="cpu", **GEOM)


def test_the_cpu_engine_builds_no_graph():
    model, params = _model("qwen3-1.7b", "float32")
    eng = _engine(model, params)
    c = replay(eng, _trace(model.cfg.vocab))["metrics"]["counters"]
    assert c["kernel_decode_ticks"] > 0
    assert eng._decode_graph is None
    assert c["decode_graph_replays"] == c["decode_graph_captures"] == 0


class _CountingHolder:
    """A stand-in for the CUDA graph holder: the CPU call runs eagerly,
    and this counts a capture on the first call and a replay on each."""

    def __init__(self):
        self.replays = self.captures = 0

    def seen(self):
        self.captures += self.replays == 0
        self.replays += 1


def test_the_engine_counts_replays_and_captures_a_tick(monkeypatch):
    model, params = _model("qwen3-1.7b", "float32")
    eng = _engine(model, params)
    holder = _CountingHolder()
    real_cfg, real_call = eng._kernel_config, model.decode_step_paged

    def kernel_config(tables):
        cfg = real_cfg(tables)
        eng._decode_graph = holder
        return cfg

    def call(*args, graph, **kw):
        assert graph is holder
        holder.seen()
        return real_call(*args, **kw)
    monkeypatch.setattr(eng, "_kernel_config", kernel_config)
    monkeypatch.setattr(model, "decode_step_paged", call)
    for a in _trace(model.cfg.vocab):
        eng.submit(a.request())
    seen = []
    while eng.queue or eng.active:
        before = dict(eng.metrics.counters)
        eng.step()
        c = eng.metrics.counters
        seen.append({k: c[k] - before[k] for k in
                     ("kernel_decode_ticks", "decode_graph_replays",
                      "decode_graph_captures")})
    assert sum(t["kernel_decode_ticks"] for t in seen) == holder.replays > 0
    assert all(t["decode_graph_replays"] == t["kernel_decode_ticks"]
               for t in seen)
    first = next(i for i, t in enumerate(seen) if t["kernel_decode_ticks"])
    assert [t["decode_graph_captures"] for t in seen] == \
        [int(i == first) for i in range(len(seen))]
