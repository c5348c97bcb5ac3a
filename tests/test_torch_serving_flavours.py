"""Serving the other GQA architectures — codeqwen1.5-7b (qkv bias),
stablelm-3b (layernorm, partial rotary), gemma-7b (GeGLU, scaled tied
embedding) and chameleon-34b (the VLM family, group 4 at head_dim 8) —
at their reduced configs in float32, with the JAX init's weights carried
across: logits against the JAX model, then ``PagedServingEngine`` on
its kernel paths (``decode_path="kernel"``, ``prefill_path="kernel"``)
against the JAX engine on fig_serving's Poisson trace
(``benchmarks/fig_serving.py``'s trace parameters, 12 requests), both on
a virtual TickClock: tokens, per-request latencies and every v4 field of
the metrics snapshot identical, every prefill and decode tick on the kernels in both
(the gates admit every geometry the trace makes); and
``launch.serve --reduced --device cpu`` on both engines.

Tolerance: float32 logits within 1e-4 plus 1e-5 of the largest |logit|,
as ``test_torch_model_flavours.py``; served tokens identical."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.models import build as jax_build
from repro.obs import TickClock as JaxTickClock
from repro.serve import PagedServingEngine as JaxPaged
from repro.serve.trace import replay as jax_replay

from repro_torch import configs as tconfigs
from repro_torch.models import build as torch_build, from_jax_numpy
from repro_torch.obs import TickClock
from repro_torch.serve import PagedServingEngine
from repro_torch.serve.trace import poisson_trace, replay
from snapshot_cases import assert_v4_fields_match

ARCHS = ["codeqwen1.5-7b", "stablelm-3b", "gemma-7b", "chameleon-34b"]
KERNEL_ENGINE = dict(pool_pages=25, eos_id=-1, decode_path="kernel",
                     prefill_path="kernel", page_size=8, max_batch=4,
                     max_len=64, prefill_chunk=8)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jc = dataclasses.replace(jconfigs.get_reduced(request.param),
                             dtype="float32")
    tc = dataclasses.replace(tconfigs.get_reduced(request.param),
                             dtype="float32")
    jm, tm = jax_build(jc), torch_build(tc)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def test_reduced_logits_match(models):
    jm, jp, tm, tp = models
    assert tm.n_params == jm.n_params
    toks = np.random.default_rng(0).integers(2, tm.cfg.vocab, size=(2, 12),
                                             dtype=np.int32)
    want, _ = jm.apply(jp, jnp.asarray(toks))
    got, _ = tm.apply(tp, torch.from_numpy(toks))
    want = np.asarray(want)
    tol = 1e-4 + 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_kernel_engine_matches_jax_on_fig_serving_trace(models):
    jm, jp, tm, tp = models
    trace = poisson_trace(seed=1, n_requests=12, mean_gap=3.0,
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
    for leaf in eng.kv.storage["blocks"].values():
        assert float(leaf[:, 0].abs().max()) == 0.0


@pytest.mark.parametrize("engine", ["paged", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_reduced_on_the_cpu(arch, engine, capsys):
    from repro_torch.launch import serve as launch
    done = launch.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--engine", engine, "--requests", "4",
                        "--max-new-tokens", "4", "--max-len", "64",
                        "--page-size", "8", "--prefill-chunk", "16"])
    assert sorted(r.rid for r in done) == list(range(4))
    assert all(r.error is None and len(r.output) == 4 for r in done)
    assert "4/4 requests complete" in capsys.readouterr().out
