"""Multi-head Latent Attention and shared experts of other FFN types in
the port's TransformerLM against the JAX package: the MLA flavours
(q_lora_rank 0 as deepseek-v2-lite, and 24) and GeGLU / GELU shared
experts on the reduced qwen3-1.7b config (``flavour_cases.py``), then
the reduced deepseek-v2-lite-16b (MLA, one dense front layer, a shared
expert, the aux-free router bias) end to end: logits, prefill and
decode, the MLA cache's layout, and its page pool, whose leaves have no
heads axis.  Weights are the JAX init's, carried across with
``from_jax_numpy``.

Tolerances: those stated in ``test_torch_model_flavours.py``; the
deepseek logits in float32 within 1e-4 of each value plus 1e-4 of the
largest |logit|, as ``test_torch_model_moe.py`` holds the MoE family
(three layers and a shared expert take logits to ~5: an error of ~2e-5
of that scale lands on logits near zero too)."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.models import build as jax_build
from repro.serve.pool import KVPool as JaxKVPool

from repro_torch import configs as tconfigs
from repro_torch.models import build as torch_build, from_jax_numpy
from repro_torch.serve.pool import KVPool

from flavour_cases import (MLA_MOE_FLAVOURS, check_apply,
                           check_paged_kernel_paths,
                           check_prefill_then_decode,
                           check_weights_and_parameter_counts, make_pair)

ARCH = "deepseek-v2-lite-16b"
CASES = ([(f, "float32") for f in MLA_MOE_FLAVOURS]
         + [(f, "bfloat16") for f in MLA_MOE_FLAVOURS if "mla" in f])


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{f}-{d}" for f, d in CASES])
def pair(request):
    return make_pair(*request.param)


def test_weights_and_parameter_counts_match(pair):
    check_weights_and_parameter_counts(pair)


def test_apply_matches(pair):
    check_apply(pair)


def test_prefill_then_decode_match(pair):
    check_prefill_then_decode(pair)


def test_paged_kernel_paths_match_or_refuse_mla(pair):
    check_paged_kernel_paths(pair)


# -- deepseek-v2-lite-16b, reduced ----------------------------------------------

@pytest.fixture(scope="module")
def deepseek():
    jm = jax_build(dataclasses.replace(jconfigs.get_reduced(ARCH),
                                       dtype="float32"))
    tm = torch_build(dataclasses.replace(tconfigs.get_reduced(ARCH),
                                         dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _close(got, want):
    want = np.asarray(want, np.float32)
    tol = 1e-4 + 1e-4 * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-4,
                               atol=tol)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(2, 256, size=shape,
                                                dtype=np.int32)


def test_deepseek_logits_and_aux_match(deepseek):
    jm, jp, tm, tp = deepseek
    assert tm.n_params == jm.n_params
    assert tm.n_active_params == jm.n_active_params
    assert tm.n_dense_front == 1
    toks = _tokens(0, (2, 12))
    want, jaux = jm.apply(jp, jnp.asarray(toks))
    got, aux = tm.apply(tp, torch.from_numpy(toks))
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_deepseek_prefill_and_decode_match_and_replay_apply(deepseek):
    """prefill, then a scalar-position and a per-row decode step, against
    JAX; and the decode replay of a prompt against ``apply``'s logits at
    every position (the reduced config's capacity factor drops no
    pair)."""
    jm, jp, tm, tp = deepseek
    toks = _tokens(1, (2, 8))
    jl, jc = jm.prefill(jp, jnp.asarray(toks), 16)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), 16)
    _close(tl, jl)
    for group in ("front_0", "blocks"):
        for leaf in ("c_kv", "k_rope"):
            _close(tc[group][leaf], jc[group][leaf])
    one = _tokens(2, (2, 1))
    jl2, jc = jm.decode_step(jp, jc, jnp.asarray(one), jnp.int32(8))
    tl2, tc = tm.decode_step(tp, tc, torch.from_numpy(one), 8)
    _close(tl2, jl2)
    pos = np.asarray([9, 3], np.int32)
    jl3, _ = jm.decode_step(jp, jc, jnp.asarray(one), jnp.asarray(pos))
    tl3, _ = tm.decode_step(tp, tc, torch.from_numpy(one),
                            torch.from_numpy(pos))
    _close(tl3, jl3)
    full, _ = tm.apply(tp, torch.from_numpy(toks))
    cache = tm.init_cache(2, 16, device="cpu")
    for t in range(toks.shape[1]):
        step, cache = tm.decode_step(tp, cache,
                                     torch.from_numpy(toks[:, t:t + 1]), t)
        _close(step[:, 0], full[:, t].numpy())


def test_deepseek_cache_and_pool_layout_match_jax(deepseek):
    """The MLA cache: (batch, kv_seq, kv_lora) latents and (batch,
    kv_seq, rope_dim) roped keys, no heads axis, for the dense front
    layer and the stacked blocks; the page pool built from it has the
    JAX pool's leaves, and its gather returns what was scattered."""
    jm, jp, tm, tp = deepseek
    js, ts = jm.cache_shape(3, 16), tm.cache_shape(3, 16)
    assert set(ts) == set(js) == {"front_0", "blocks"}
    for g in ts:
        assert {k: tuple(v.shape) for k, v in ts[g].items()} == \
            {k: tuple(v.shape) for k, v in js[g].items()}
    assert tm.cache_axes() == jm.cache_axes()
    assert ts["blocks"]["c_kv"].shape == (2, 3, 16, 32)
    pool, jpool = KVPool(tm, 10, 4, device="cpu"), JaxKVPool(jm, 10, 4)
    assert {g: {k: tuple(v.shape) for k, v in leaves.items()}
            for g, leaves in pool.storage.items()} == \
        {g: {k: tuple(v.shape) for k, v in leaves.items()}
         for g, leaves in jpool.storage.items()}
    rng = np.random.default_rng(3)
    view = {g: {k: torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(
        np.float32)) for k, v in leaves.items()}
        for g, leaves in tm.cache_shape(2, 8).items()}
    tables = np.asarray([[3, 5], [7, 1]], np.int32)
    rows = np.repeat(np.arange(2), 8).astype(np.int32)
    pos = np.tile(np.arange(8), 2).astype(np.int32)
    phys = tables[rows, pos // 4]
    pool.scatter(view, rows, pos, phys, (pos % 4).astype(np.int32))
    back = pool.gather(torch.from_numpy(tables))
    for g, leaves in view.items():
        for k, v in leaves.items():
            assert torch.equal(back[g][k], v)
    assert float(pool.storage["blocks"]["c_kv"][:, 0].abs().max()) == 0.0
