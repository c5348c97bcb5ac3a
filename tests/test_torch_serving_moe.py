"""Serving the MoE family: the port's engines against the JAX engines on
fig_serving's Poisson trace (``benchmarks/fig_serving.py``'s trace
parameters and engine geometry, as ``test_torch_serving.py`` runs them
for qwen3-1.7b), at the float32 variant of the reduced
granite-moe-3b-a800m config, with the JAX init's weights carried
across.  Prefill ticks route each chunk through the capacity-dispatched
experts and decode ticks through every expert densely, as in the JAX
package.  Tokens must be identical, and so must every v4 field of the
metrics snapshot (both engines run on a virtual TickClock).  The reduced
config's capacity factor (8) drops no pair, so the kernel path (chunks
of several sequences packed together) and the gather path (one row per
sequence) route every token alike and give the same tokens as well."""
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

ARCH = "granite-moe-3b-a800m"
GEOM = dict(page_size=8, max_batch=4, max_len=64, prefill_chunk=8)
POOL = 25
ENGINES = {
    "dense": dict(n_slots=4, max_len=64, eos_id=-1),
    "paged_gather": dict(pool_pages=POOL, eos_id=-1, decode_path="gather",
                         prefill_path="gather", **GEOM),
    "paged_kernel": dict(pool_pages=POOL, eos_id=-1, decode_path="kernel",
                         prefill_path="kernel", **GEOM),
}


@pytest.fixture(scope="module")
def models():
    jc = dataclasses.replace(jconfigs.get_reduced(ARCH), dtype="float32")
    tc = dataclasses.replace(tconfigs.get_reduced(ARCH), dtype="float32")
    jm, tm = jax_build(jc), torch_build(tc)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _trace(vocab):
    """fig_serving.py's Poisson trace at its --seed 0 defaults."""
    return poisson_trace(seed=1, n_requests=24, mean_gap=3.0,
                         prompt_lens=(4, 28), max_new=(4, 12), vocab=vocab)


@pytest.fixture(scope="module")
def runs(models):
    jm, jp, tm, tp = models
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
        tr = _trace(tm.cfg.vocab)
        out[name] = (jax_replay(jeng, tr), replay(teng, tr), teng)
    return out


@pytest.mark.parametrize("engine", list(ENGINES))
def test_engine_matches_jax_on_fig_serving_trace(runs, engine):
    want, got, teng = runs[engine]
    assert len(got["outputs"]) == 24
    assert got["outputs"] == want["outputs"]
    assert got["latency"] == want["latency"]
    assert got["ticks"] == want["ticks"]
    assert_v4_fields_match(got["metrics"], want["metrics"])
    c = got["metrics"]["counters"]
    if engine == "paged_kernel":
        assert c["gather_bytes"] == 0
        assert c["kernel_decode_ticks"] > 0 and c["kernel_prefill_ticks"] > 0
    if engine == "paged_gather":
        assert c["kernel_decode_ticks"] == c["kernel_prefill_ticks"] == 0
    if engine != "dense":
        null = teng.kv.storage["blocks"]
        assert float(null["k"][:, 0].abs().max()) == 0.0
        assert float(null["v"][:, 0].abs().max()) == 0.0


def test_kernel_and_gather_paths_give_the_same_tokens(runs):
    outs = {name: runs[name][1]["outputs"] for name in ENGINES}
    assert outs["paged_kernel"] == outs["paged_gather"] == outs["dense"]
