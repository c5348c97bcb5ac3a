"""The port's training loss (``repro_torch.models.model.lm_loss``) and
its gradients against the JAX package's, float32, on every reduced
architecture: the same weights (the port's seed-0 init carried to JAX),
a data-pipeline batch of 2 x 16 tokens, the JAX ``value_and_grad``
under ``jax.jit``.

Tolerances: the loss within 1e-5 of its value; each gradient leaf within
1e-4 of the leaf's largest |value| (measured: 5e-5 at most over nine
architectures).  seamless-m4t-large-v2 at its reduced width is
ill-conditioned in float32: its seeded init's attention is peaked, so
JAX's own gradient moves by more than 1e-4 of a leaf's largest |value|
when every weight moves by one float32 ulp
(``test_the_reduced_seamless_gradient_moves_a_lot_under_one_ulp``); the
port is held to 1e-3 there (measured 4.8e-4).  ``remat`` (per-layer
``torch.utils.checkpoint``) changes no bit of the port's gradient."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from train_cases import (ARCHS, batches, jax_value_and_grad, leaf_errors,
                         pair, torch_value_and_grad)

LOSS_REL = 1e-5
GRAD_REL = {"seamless-m4t-large-v2": 1e-3}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_in_float32(arch):
    jm, jp, tm, tp = pair(arch, "float32")
    jb, tb = batches(tm.cfg)
    jl, jmet, jg = jax_value_and_grad(jm, jp, jb)
    tl, tmet, tg = torch_value_and_grad(tm, tp, tb)
    assert abs(tl - jl) <= LOSS_REL * abs(jl), (tl, jl)
    assert abs(tmet["ce"] - jmet["ce"]) <= LOSS_REL * abs(jmet["ce"])
    assert abs(tmet["aux"] - jmet["aux"]) <= 1e-5 * max(1.0, jmet["aux"])
    if tm.cfg.moe is not None:
        assert tmet["aux"] > 0
    assert tg.keys() == jg.keys()
    errs = leaf_errors(tg, jg)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL.get(arch, 1e-4), (worst, errs[worst])
    # recomputation in the backward pass changes nothing
    _, _, tg_plain = torch_value_and_grad(tm, tp, tb, remat=False)
    for path, g in tg.items():
        assert np.array_equal(g, tg_plain[path]), path


def test_the_reduced_seamless_gradient_moves_a_lot_under_one_ulp():
    """Why seamless is held at 1e-3: JAX's own gradient, with every
    float32 weight moved by about one ulp (a seeded sign times 2^-23 of
    its value), moves by more than 1e-4 of some leaf's largest |value|,
    so no float32 port that rounds differently anywhere can meet 1e-4."""
    jm, jp, tm, _ = pair("seamless-m4t-large-v2", "float32")
    jb, _ = batches(tm.cfg)
    _, _, g0 = jax_value_and_grad(jm, jp, jb)
    rng = np.random.default_rng(5)
    nudged = jax.tree.map(lambda a: a * (1 + 2.0 ** -23 * jnp.asarray(
        rng.choice([-1.0, 1.0], size=a.shape), jnp.float32)), jp)
    _, _, g1 = jax_value_and_grad(jm, nudged, jb)
    assert max(leaf_errors(g1, g0).values()) > 1e-4


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-3b-a800m"])
def test_a_mask_weights_the_targets_as_in_jax(arch):
    """A (B, S-1) 0/1 mask over the targets: the loss is the mean over
    the kept ones, in both packages; an all-zero mask gives 0 (the
    denominator is clamped at 1) plus the aux term."""
    jm, jp, tm, tp = pair(arch, "float32")
    jb, tb = batches(tm.cfg, B=2, S=16, step=1)
    mask = (np.random.default_rng(3).random((2, 15)) < 0.6).astype(
        np.float32)
    for m in (mask, np.zeros_like(mask)):
        jb["mask"], tb["mask"] = jnp.asarray(m), torch.from_numpy(m)
        jl, jmet, jg = jax_value_and_grad(jm, jp, jb)
        tl, tmet, tg = torch_value_and_grad(tm, tp, tb)
        assert abs(tl - jl) <= LOSS_REL * abs(jl), (tl, jl)
        assert max(leaf_errors(tg, jg).values()) <= 1e-4
    assert tmet["ce"] == jmet["ce"] == 0.0


def test_inputs_embeds_batches_match_jax():
    """The VLM batch: precomputed ``inputs_embeds`` (B, S, D) stand in
    for the embedded tokens; the targets are still the tokens."""
    jm, jp, tm, tp = pair("chameleon-34b", "float32")
    jb, tb = batches(tm.cfg)
    emb = np.random.default_rng(4).normal(
        size=tuple(tb["tokens"].shape) + (tm.cfg.d_model,)).astype(
        np.float32)
    jb["inputs_embeds"] = jnp.asarray(emb)
    tb["inputs_embeds"] = torch.from_numpy(emb)
    jl, _, jg = jax_value_and_grad(jm, jp, jb)
    tl, _, tg = torch_value_and_grad(tm, tp, tb)
    assert abs(tl - jl) <= LOSS_REL * abs(jl), (tl, jl)
    assert max(leaf_errors(tg, jg).values()) <= 1e-4
