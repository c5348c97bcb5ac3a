"""The dense flavours and the VLM family of the port's TransformerLM
against the JAX TransformerLM, one flavour at a time on the reduced
qwen3-1.7b config (2 layers, 4 query / 2 KV heads, head_dim 16), with
the JAX init's weights carried across (``from_jax_numpy``) and every
bias leaf (layernorm, qkv) drawn from a seeded normal on both sides
instead of the init's zeros.  Each flavour runs ``apply``,
``prefill`` + ``decode_chunk`` + ``decode_step`` and, for GQA,
``decode_step_paged`` and ``prefill_chunk_packed`` (the JAX kernels in
interpret mode).  This file runs the float32 cases,
``test_torch_model_flavours_bf16.py`` the bfloat16 ones and
``test_torch_model_mla.py`` the MLA and shared-expert flavours (MLA's
paged entry points raise on both sides); all share
``flavour_cases.py``.

Tolerances: float32 logits within 1e-4 plus 1e-5 of the largest
|logit| (the two sides round float32 sums, rsqrt, exp and rope angles
differently in the last bits; the scaled embedding takes logits to ~50)
and float32 caches and pools within 1e-5.  bfloat16 logits, caches and
pools within two steps of each value (rtol 2^-6) plus 1% of the
largest |value| (about two steps at the top of its range), as
``tests/test_torch_model.py`` holds logits: the two sides round the head
norm's and each layer's outputs to bf16 on their own, and rope and the
next layer mix such roundings into values near zero, so an element is
off by steps at the scale of its head, not of itself (with the drawn
qkv biases one key of 8,192 is off by 0.030 at a scale of ~4)."""

import dataclasses
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.models import build as jax_build
from repro.models.components import embed as jax_embed

from repro_torch import configs as tconfigs
from repro_torch.models import build as torch_build, from_jax_numpy
from repro_torch.models.components import embed as torch_embed

from flavour_cases import (GQA_FLAVOURS, as_np, check_apply,
                           check_paged_kernel_paths,
                           check_prefill_then_decode,
                           check_weights_and_parameter_counts, close_logits,
                           flavour_cfg, make_pair, tokens, weights)


@pytest.fixture(scope="module", params=GQA_FLAVOURS)
def pair(request):
    return make_pair(request.param, "float32")


def test_weights_and_parameter_counts_match(pair):
    check_weights_and_parameter_counts(pair)


def test_apply_matches(pair):
    check_apply(pair)


def test_prefill_then_decode_match(pair):
    check_prefill_then_decode(pair)


def test_paged_kernel_paths_match_or_refuse_mla(pair):
    check_paged_kernel_paths(pair)


def test_inputs_embeds_and_positions_match():
    """``apply(inputs_embeds=, positions=)`` as the JAX signature: the
    embedded tokens passed in, per-row positions offset by 5."""
    jm = jax_build(flavour_cfg(jconfigs, "vlm", "float32"))
    tm = torch_build(flavour_cfg(tconfigs, "vlm", "float32"))
    w = weights(jm)
    jp, tp = jax.tree.map(jnp.asarray, w), from_jax_numpy(w, device="cpu")
    x = np.random.default_rng(3).normal(size=(2, 9, 64)).astype(np.float32)
    pos = (np.arange(9)[None] + np.asarray([[0], [5]])).astype(np.int32)
    want, _ = jm.apply(jp, inputs_embeds=jnp.asarray(x),
                       positions=jnp.asarray(pos))
    got, _ = tm.apply(tp, inputs_embeds=torch.from_numpy(x),
                      positions=torch.from_numpy(pos))
    close_logits(got, want, "float32")
    toks = tokens(4, (2, 9))
    by_tokens, _ = tm.apply(tp, torch.from_numpy(toks))
    by_embeds, _ = tm.apply(tp, inputs_embeds=torch_embed(
        tp["embed"], torch.from_numpy(toks), tm.cfg))
    assert torch.equal(by_tokens, by_embeds)


@pytest.mark.parametrize("d_model", [64, 2560, 3072])
def test_scaled_embedding_rounds_its_scale_as_jax_does(d_model):
    """gemma multiplies the embedded row by sqrt(d_model) rounded to the
    activations' type (sqrt(3072) = 55.43 is 55.5 in bf16): bit-identical
    bf16 rows at gemma-7b's width and beside it."""
    cfg = dataclasses.replace(tconfigs.get_reduced("gemma-7b"),
                              d_model=d_model, dtype="bfloat16")
    jcfg = dataclasses.replace(jconfigs.get_reduced("gemma-7b"),
                               d_model=d_model, dtype="bfloat16")
    tok = np.random.default_rng(0).normal(
        size=(cfg.padded_vocab, d_model)).astype(np.float32)
    ids = tokens(9, (2, 5))
    want = jax_embed({"tok": jnp.asarray(tok)}, jnp.asarray(ids), jcfg)
    got = torch_embed({"tok": torch.from_numpy(tok)}, torch.from_numpy(ids),
                      cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(as_np(got), as_np(want))
    if d_model == 3072:
        plain = torch.from_numpy(tok)[torch.from_numpy(ids).long()]
        assert not torch.equal(
            got, (plain * math.sqrt(d_model)).to(torch.bfloat16))
