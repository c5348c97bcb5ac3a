"""The port's training loss and gradients against the JAX package's in
bfloat16, on every reduced architecture (the setup of
``test_torch_train_loss.py``).

JAX's ``lm_loss`` runs its layers inside a compiled ``lax.scan``, where
XLA keeps float32 between operations that the port (eager PyTorch)
rounds to bfloat16, as the bf16 model tests found for the logits.  So the
loss is held within 5e-3 of its value (measured: 1.6e-3 at most) and the
whole gradient, every leaf together, within 0.15 of its norm (measured:
0.10 at most, recurrentgemma-2b; each package's bf16 gradient is
0.01-0.38 of the norm away from its own float32 one).  The reduced
seamless-m4t-large-v2's bf16 gradient carries no signal in either
package — JAX's own is as far from its float32 gradient as the norm
(``test_the_reduced_seamless_bf16_gradient_is_noise_in_jax_too``) — so
only its loss is held."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.models import build as jax_build

from repro_torch.data import make_dataset

from train_cases import (ARCHS, batches, global_error, jax_value_and_grad,
                         pair, torch_value_and_grad)

LOSS_REL = 5e-3
GRAD_REL = 0.15
NOISY = "seamless-m4t-large-v2"


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_in_bfloat16(arch):
    jm, jp, tm, tp = pair(arch, "bfloat16")
    jb, tb = batches(tm.cfg)
    jl, _, jg = jax_value_and_grad(jm, jp, jb)
    tl, _, tg = torch_value_and_grad(tm, tp, tb)
    assert abs(tl - jl) <= LOSS_REL * abs(jl), (tl, jl)
    if arch != NOISY:
        assert global_error(tg, jg) <= GRAD_REL


def test_the_reduced_seamless_bf16_gradient_is_noise_in_jax_too():
    """JAX's bf16 gradient against its float32 one on the same values
    (the bf16 weights and batch widened exactly) are more than half the
    float32 gradient's norm apart (measured: 1.0), where the other
    architectures' packages agree within 0.15."""
    jm, jp, tm, _ = pair(NOISY, "bfloat16")
    jb, _ = batches(tm.cfg)
    _, _, g16 = jax_value_and_grad(jm, jp, jb)
    jm32 = jax_build(dataclasses.replace(jm.cfg, dtype="float32"))
    widen = lambda t: jax.tree.map(lambda a: a.astype(jnp.float32)
                                   if a.dtype == jnp.bfloat16 else a, t)
    _, _, g32 = jax_value_and_grad(jm32, widen(jp), widen(jb))
    assert global_error(g16, g32) > 0.5


def test_float32_frame_embeddings_promote_as_in_jax():
    """The pipeline's frame embeddings are float32 and the bf16 model's
    weights bf16: JAX's type promotion runs the encoder (and the cross
    K/V) in float32, and so does the port (``components.matmul``); it
    used to raise on the mixed product.  The encoder output is a float32
    computation on both sides (1e-5 of the largest |value|); the loss is
    held as above."""
    jm, jp, tm, tp = pair(NOISY, "bfloat16")
    b = next(make_dataset(tm.cfg, seq_len=16, global_batch=2))
    assert b["enc_embeds"].dtype == np.float32
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    want = np.asarray(jm.encode(jp, jb["enc_embeds"]))
    with torch.no_grad():
        got = tm.encode(tp, tb["enc_embeds"])
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    jl, _, _ = jax_value_and_grad(jm, jp, jb)
    tl, _, _ = torch_value_and_grad(tm, tp, tb)
    assert abs(tl - jl) <= LOSS_REL * abs(jl), (tl, jl)
