"""Serving at the head dims the attention kernels take on their panel
route: reduced qwen3-1.7b with ``head_dim`` 100 (bf16 rows of 200
bytes, off the 16-byte grain) and 320 (above 256), one layer, in
float32, the JAX init's weights carried across.  ``PagedServingEngine``
on its kernel paths (``decode_path="kernel"``, ``prefill_path="kernel"``)
against the JAX engine on fig_serving's Poisson trace (12 requests), both
on a virtual TickClock: tokens, per-request latencies and every v4 field
of the metrics snapshot identical, every prefill and decode tick on the kernels
in both (each gate admits every geometry the trace makes; the port's
paged gate no longer turns these head dims into a build error), and the
gate's verdict on the serving geometries equal to the JAX gate's in bf16
too.  On the CPU the kernels' wrappers run their plain versions; the
card holds the kernels themselves (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phases 4 and 17)."""
import dataclasses

import numpy as np
import pytest

import jax

from repro import configs as jconfigs
from repro.core.families.paged_attention import (
    PagedAttentionConfig as JaxPagedConfig,
    PagedAttentionProblem as JaxPagedProblem)
from repro.core.verify_engine import VerificationEngine as JaxEngine
from repro.models import build as jax_build
from repro.obs import TickClock as JaxTickClock
from repro.serve import PagedServingEngine as JaxPaged
from repro.serve.trace import replay as jax_replay

from repro_torch import configs as tconfigs
from repro_torch.core.families import paged_attention as pa
from repro_torch.core.verify_engine import VerificationEngine
from repro_torch.models import build as torch_build, from_jax_numpy
from repro_torch.obs import TickClock
from repro_torch.serve import PagedServingEngine
from repro_torch.serve.trace import poisson_trace, replay
from snapshot_cases import assert_v4_fields_match

KERNEL_ENGINE = dict(pool_pages=25, eos_id=-1, decode_path="kernel",
                     prefill_path="kernel", page_size=8, max_batch=4,
                     max_len=64, prefill_chunk=8)


@pytest.fixture(scope="module", params=[100, 320])
def models(request):
    D = request.param
    cfg = lambda pkg: dataclasses.replace(
        pkg.get_reduced("qwen3-1.7b"), head_dim=D, n_layers=1,
        dtype="float32")
    jm, tm = jax_build(cfg(jconfigs)), torch_build(cfg(tconfigs))
    jp = jm.init(jax.random.PRNGKey(D))
    tp = from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def test_kernel_engine_matches_jax_at_the_panel_head_dims(models):
    jm, jp, tm, tp = models
    assert tm.cfg.head_dim in (100, 320)
    trace = poisson_trace(seed=2, n_requests=12, mean_gap=3.0,
                          prompt_lens=(4, 28), max_new=(4, 8),
                          vocab=tm.cfg.vocab)
    want = jax_replay(JaxPaged(jm, jp, clock=JaxTickClock(),
                               **KERNEL_ENGINE), trace)
    eng = PagedServingEngine(tm, tp, clock=TickClock(), device="cpu",
                             **KERNEL_ENGINE)
    got = replay(eng, trace)
    assert len(got["outputs"]) == 12
    assert got["outputs"] == want["outputs"]
    assert got["latency"] == want["latency"]
    assert got["ticks"] == want["ticks"]
    assert_v4_fields_match(got["metrics"], want["metrics"])
    c = got["metrics"]["counters"]
    assert c["gather_bytes"] == 0
    assert c["kernel_decode_ticks"] > 0 and c["kernel_prefill_ticks"] > 0


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("D", [100, 320])
def test_the_paged_gate_admits_what_the_jax_gate_admits(D, dtype):
    """The serving engine's decode geometry at the reduced shapes (4 rows,
    4 / 2 heads, 8-token pages, 64-token rows): both gates admit it at
    the kernel's step, with the same findings; the port's kernel takes
    it on the panel route."""
    shape = (4, 4, 2, 64, 8, 25, D, dtype)
    prob = pa.PagedAttentionProblem(*shape)
    cfg = pa.kernel_config(pa.PagedAttentionConfig(2), prob)
    p = VerificationEngine().verify("paged_attention", cfg, prob)
    j = JaxEngine().verify("paged_attention",
                           JaxPagedConfig(cfg.block_pages),
                           JaxPagedProblem(*shape))
    assert p.hard_ok and j.hard_ok and not p.build_error
    assert pa.is_panel(D, 2 if dtype == "bf16" else 4) == (
        dtype == "bf16" or D > 256)
