"""Serving deepseek-v2-lite-16b (MLA and DeepSeekMoE) at its reduced
config in float32, with the JAX init's weights carried across: the
port's dense engine, the paged engine on its gather paths and the paged
engine asked for its kernel paths against the JAX engines on
fig_serving's Poisson trace (``benchmarks/fig_serving.py``'s trace
parameters, 12 requests), all on a virtual TickClock.  An MLA cache has
no heads axis, so the paged engine keeps every tick on the gather paths
on both sides, even when asked for the kernels (the JAX engine's rule):
tokens, latencies and every v4 field of the metrics snapshot identical,
no kernel tick.  The reduced config's capacity factor (8) drops no pair, so the
dense and paged engines give the same tokens too.  Then
``launch.serve --arch deepseek-v2-lite-16b --reduced --device cpu`` on
both engines."""
import dataclasses

import numpy as np
import pytest

import jax

from repro import configs as jconfigs
from repro.models import build as jax_build
from repro.obs import TickClock as JaxTickClock
from repro.serve import (PagedServingEngine as JaxPaged,
                         ServingEngine as JaxDense)
from repro.serve.trace import replay as jax_replay

from repro_torch import configs as tconfigs
from repro_torch.models import build as torch_build, from_jax_numpy
from repro_torch.obs import TickClock
from repro_torch.serve import PagedServingEngine, ServingEngine
from repro_torch.serve.trace import poisson_trace, replay
from snapshot_cases import assert_v4_fields_match

ARCH = "deepseek-v2-lite-16b"
GEOM = dict(page_size=8, max_batch=4, max_len=64, prefill_chunk=8)
ENGINES = {
    "dense": dict(n_slots=4, max_len=64, eos_id=-1),
    "paged_gather": dict(pool_pages=25, eos_id=-1, decode_path="gather",
                         prefill_path="gather", **GEOM),
    "paged_kernel": dict(pool_pages=25, eos_id=-1, decode_path="kernel",
                         prefill_path="kernel", **GEOM),
}


@pytest.fixture(scope="module")
def runs():
    jc = dataclasses.replace(jconfigs.get_reduced(ARCH), dtype="float32")
    tc = dataclasses.replace(tconfigs.get_reduced(ARCH), dtype="float32")
    jm, tm = jax_build(jc), torch_build(tc)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    trace = poisson_trace(seed=1, n_requests=12, mean_gap=3.0,
                          prompt_lens=(4, 28), max_new=(4, 8),
                          vocab=tc.vocab)
    out = {}
    for name, kw in ENGINES.items():
        if name == "dense":
            jeng = JaxDense(jm, jp, clock=JaxTickClock(), **kw)
            teng = ServingEngine(tm, tp, clock=TickClock(), device="cpu",
                                 **kw)
        else:
            jeng = JaxPaged(jm, jp, clock=JaxTickClock(), **kw)
            teng = PagedServingEngine(tm, tp, clock=TickClock(),
                                      device="cpu", **kw)
        out[name] = (jax_replay(jeng, trace), replay(teng, trace))
    return out


@pytest.mark.parametrize("engine", list(ENGINES))
def test_engine_matches_jax_on_fig_serving_trace(runs, engine):
    want, got = runs[engine]
    assert len(got["outputs"]) == 12
    assert got["outputs"] == want["outputs"]
    assert got["latency"] == want["latency"]
    assert got["ticks"] == want["ticks"]
    assert_v4_fields_match(got["metrics"], want["metrics"])
    c = got["metrics"]["counters"]
    if engine != "dense":
        assert c["kernel_decode_ticks"] == c["kernel_prefill_ticks"] == 0
        assert c["gather_bytes"] > 0


def test_every_engine_gives_the_same_tokens(runs):
    outs = [runs[name][1]["outputs"] for name in ENGINES]
    assert outs[0] == outs[1] == outs[2]


@pytest.mark.parametrize("engine", ["paged", "dense"])
def test_launcher_serves_reduced_deepseek_on_the_cpu(engine, capsys):
    from repro_torch.launch import serve as launch
    done = launch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--engine", engine, "--requests", "5",
                        "--max-new-tokens", "4", "--max-len", "64",
                        "--page-size", "8", "--prefill-chunk", "16"])
    assert sorted(r.rid for r in done) == list(range(5))
    assert all(r.error is None and len(r.output) == 4 for r in done)
    assert "5/5 requests complete" in capsys.readouterr().out
