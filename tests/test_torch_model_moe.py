"""Port of the MoE ``TransformerLM`` (reduced granite-moe-3b-a800m, and
a DeepSeek-style variant of it with GQA attention: one dense front
layer, a shared expert, the aux-free router bias, capacity factor 1.25)
against the JAX TransformerLM, with the JAX init's weights carried
across (``from_jax_numpy``), in float32; and the launcher serving
reduced granite on the CPU.

Tolerance: float32 logits within 1e-4 of each value plus 1e-4 of the
largest |logit| (the two sides round float32 sums whose terms are of the
hidden state's scale, and with shared experts and three layers the
logits reach ~20: an error of ~2e-5 of that scale lands on logits near
zero too)."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.models import build as jax_build

from repro_torch import configs as tconfigs
from repro_torch.models import build as torch_build, from_jax_numpy
from repro_torch.models.params import leaf_paths

ARCH = "granite-moe-3b-a800m"
DEEPSEEK = dict(n_experts=8, top_k=2, n_shared=1, d_ff_expert=32,
                capacity_factor=1.25, first_dense_layers=1, dense_d_ff=96,
                router_aux_free=True)


def _granite(dtype="float32", **moe):
    jc = dataclasses.replace(jconfigs.get_reduced(ARCH), dtype=dtype)
    tc = dataclasses.replace(tconfigs.get_reduced(ARCH), dtype=dtype)
    if moe:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe))
    return jc, tc


# -- TransformerLM ---------------------------------------------------------------

@pytest.fixture(scope="module", params=["granite", "deepseek-style"])
def lm(request):
    moe = DEEPSEEK if request.param == "deepseek-style" else {}
    jc, tc = _granite("float32", **moe)
    if moe:                                  # one dense front layer, two MoE
        jc = dataclasses.replace(jc, n_layers=3)
        tc = dataclasses.replace(tc, n_layers=3)
    jm, tm = jax_build(jc), torch_build(tc)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return request.param, jm, jp, tm, tp


def _close_logits(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * max(1.0, np.abs(want).max()))


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(2, vocab, size=shape,
                                                dtype=np.int32)


def test_params_and_cache_layout_match_jax(lm):
    name, jm, jp, tm, tp = lm
    assert tm.n_params == jm.n_params
    assert tm.n_active_params == jm.n_active_params < tm.n_params
    assert [(p, np.shape(a)) for p, a in
            leaf_paths(jax.tree.map(np.asarray, jp))] == \
        [(p, tuple(t.shape)) for p, t in leaf_paths(tp)]
    assert tm.cache_axes() == jm.cache_axes()
    js, ts = jm.cache_shape(3, 16), tm.cache_shape(3, 16)
    assert {g: {k: tuple(v.shape) for k, v in leaves.items()}
            for g, leaves in ts.items()} == \
        {g: {k: tuple(v.shape) for k, v in leaves.items()}
         for g, leaves in js.items()}
    assert ("front_0" in ts) == (name == "deepseek-style")


def test_logits_and_aux_match_jax(lm):
    _, jm, jp, tm, tp = lm
    toks = _tokens(0, (2, 12))
    jl, ja = jm.apply(jp, jnp.asarray(toks))
    tl, ta = tm.apply(tp, torch.from_numpy(toks))
    _close_logits(tl, jl)
    assert float(ta) == pytest.approx(float(ja), rel=1e-5)
    assert float(ta) > 0


def test_prefill_then_decode_matches_jax(lm):
    """Prefill 8 tokens, then decode 3 one at a time (the dense-expert
    path) against the JAX model, logits at every step."""
    _, jm, jp, tm, tp = lm
    toks = _tokens(1, (2, 11))
    jl, jc = jm.prefill(jp, jnp.asarray(toks[:, :8]), 16)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks[:, :8]), 16)
    _close_logits(tl, jl)
    for t in range(8, 11):
        pos = np.full((2,), t, np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]),
                                torch.from_numpy(pos))
        _close_logits(tl, jl)


def test_decode_agrees_with_the_forward_pass_when_nothing_drops():
    """Reduced granite (capacity factor 8: no pair is dropped): the
    logits of prefill + one-token decode steps equal the full forward
    pass's at the same positions."""
    tm = torch_build(_granite("float32")[1])
    tp = tm.init(0, device="cpu")
    toks = torch.from_numpy(_tokens(2, (2, 10)))
    full, _ = tm.apply(tp, toks)
    logits, cache = tm.prefill(tp, toks[:, :6], 16)
    _close_logits(logits[:, 0], full[:, 5])
    for t in range(6, 10):
        logits, cache = tm.decode_step(tp, cache, toks[:, t:t + 1],
                                       torch.full((2,), t))
        _close_logits(logits[:, 0], full[:, t])


# -- the launcher ----------------------------------------------------------------

@pytest.mark.parametrize("engine", ["paged", "dense"])
def test_launcher_serves_reduced_granite_on_the_cpu(engine, capsys):
    from repro_torch.launch import serve as launch
    done = launch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--engine", engine, "--requests", "6",
                        "--max-new-tokens", "5", "--max-len", "64",
                        "--page-size", "8", "--prefill-chunk", "16"])
    assert sorted(r.rid for r in done) == list(range(6))
    assert all(r.error is None and len(r.output) == 5 for r in done)
    assert "6/6 requests complete" in capsys.readouterr().out
