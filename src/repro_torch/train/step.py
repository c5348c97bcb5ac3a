"""Train-step factory: grad, microbatch accumulation, clipping, AdamW —
the port of the JAX package's ``train/step.py``.

The step runs eagerly: ``torch.autograd.grad`` over the parameter
leaves in place of ``jax.value_and_grad``, a Python loop over the
microbatches in place of ``lax.scan``, and an AdamW update that writes
new tensors.  Knobs, as in JAX:

  * ``grad_accum`` — microbatches accumulated into ``acc_dtype``, then
    divided by ``grad_accum``;
  * ``compress_grads`` — accumulate in bf16 instead of float32 (in JAX
    this halves the data-parallel all-reduce; the port has one card);
    the optimizer math is float32;
  * ``remat`` — per-layer recomputation (``torch.utils.checkpoint``).

On DTensor parameters (a distributed launch, the dry-run) the step runs
unchanged: autograd gives each gradient the placements its computation
left (a sum over the data axis still pending, ``Partial``), and the step
moves every gradient to its parameter's placements before clipping.
That is the data-parallel reduction, in the dtype JAX's step holds the
gradient in there: the parameter's at ``grad_accum`` 1, ``acc_dtype``
(bf16 under ``compress_grads="bf16"``) when accumulating.
``abstract_opt_state`` gives the dry-run's optimizer shapes.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.model import lm_loss
from repro_torch.models.params import ShapeDtype
from repro_torch.optim import (AdamWState, adamw_update,
                               clip_by_global_norm, tree_leaves, tree_map)

F32 = torch.float32


def abstract_opt_state(abstract_params) -> AdamWState:
    """ShapeDtype AdamW state congruent with abstract params (the
    dry-run's: no allocation)."""
    mu = tree_map(lambda p: ShapeDtype(tuple(p.shape), F32),
                  abstract_params)
    nu = tree_map(lambda p: ShapeDtype(tuple(p.shape), F32),
                  abstract_params)
    return AdamWState(ShapeDtype((), torch.int32), mu, nu)


def _to_param_placements(g, p):
    """``g`` redistributed to ``p``'s placements when both are DTensors
    (the data-parallel reduction of a pending sum), else ``g``."""
    if isinstance(p, DTensor) and tuple(g.placements) != \
            tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _split_microbatches(batch: Dict, n: int, i: int) -> Dict:
    """Microbatch ``i`` of ``n``: rows ``i * B/n`` .. of every entry."""
    def re(x):
        b = x.shape[0]
        return x.reshape((n, b // n) + tuple(x.shape[1:]))[i]
    return {k: re(v) for k, v in batch.items()}


def value_and_grad(model, params, batch: Dict, *, aux_weight: float = 0.01,
                   remat: bool = True) -> Tuple[torch.Tensor, Dict, Dict]:
    """(loss, metrics, grads) of :func:`lm_loss` — ``jax.value_and_grad``'s
    counterpart over the parameter leaves, which are made to require
    grad.  ``grads`` is a tree of the params' structure; a leaf the loss
    does not reach (an aux-free router's bias) gets zeros, as
    ``jax.grad`` gives it.  The loss and metrics are detached."""
    leaves = tree_leaves(params)
    for t in leaves:
        if not t.requires_grad:
            t.requires_grad_(True)
    loss, metrics = lm_loss(model, params, batch, aux_weight=aux_weight,
                            remat=remat)
    gs = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def grad_of(t):                # tree_map walks tree_leaves' order
        g = next(gs)
        return torch.zeros_like(t) if g is None else g
    grads = tree_map(grad_of, params)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model, *, lr_fn: Callable, grad_accum: int = 1,
                    clip_norm: float = 1.0, aux_weight: float = 0.01,
                    compress_grads: Optional[str] = "bf16",
                    remat: bool = True):
    """-> ``train_step(params, opt, batch) -> (params, opt, metrics)``.
    ``params``: the model's tree; its leaves are made to require grad.
    ``batch``: {"tokens": (B, S)} and the optional entries of
    :func:`~repro_torch.models.model.lm_loss`, on the params' device.
    Metrics (float32 scalar tensors): loss, ce, aux, gnorm, lr; with
    ``grad_accum`` > 1, ``aux`` is 0 and ``loss`` the microbatches' mean,
    as in JAX."""
    acc_dtype = torch.bfloat16 if compress_grads == "bf16" else F32
    kw = dict(aux_weight=aux_weight, remat=remat)

    def train_step(params, opt, batch):
        if grad_accum == 1:
            loss, metrics, grads = value_and_grad(model, params, batch, **kw)
        else:
            grads, loss_sum = None, None
            for i in range(grad_accum):
                loss, _, g = value_and_grad(
                    model, params, _split_microbatches(batch, grad_accum, i),
                    **kw)
                # JAX adds each microbatch's gradient to zeros in
                # acc_dtype: the first sum is the first gradient, cast
                # (and stays a pending sum across ranks, as the others)
                grads = (tree_map(lambda gg: gg.to(acc_dtype), g)
                         if grads is None else
                         tree_map(lambda a, gg: a + gg.to(acc_dtype),
                                  grads, g))
                loss_sum = loss if loss_sum is None else loss_sum + loss
                del g
            grads = tree_map(lambda g: g / grad_accum, grads)
            loss = loss_sum / grad_accum
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}

        grads = tree_map(_to_param_placements, grads, params)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        lr = lr_fn(opt.step)
        params, opt = adamw_update(grads, opt, params, lr=lr)
        metrics = dict(metrics)
        metrics.update(loss=loss, gnorm=gnorm, lr=torch.as_tensor(lr))
        return params, opt, metrics

    return train_step


def make_serve_step(model):
    def serve_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)
    return serve_step


def make_prefill_step(model, max_len: int):
    def prefill_step(params, tokens):
        return model.prefill(params, tokens, max_len)
    return prefill_step
