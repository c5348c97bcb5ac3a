"""Shared setup of ``test_torch_train_loss.py``,
``test_torch_train_loss_bf16.py`` and ``test_torch_train.py``: a reduced
architecture built in both packages on the same weights (the port's
seeded init, carried to JAX leaf by leaf), batches from the data
pipeline, and both packages' loss and gradients.  Not a test file
(pytest's rootdir import puts ``tests/`` on the path)."""
import dataclasses

import numpy as np

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.models import build as jax_build
from repro.models.model import lm_loss as jax_lm_loss

from repro_torch import configs as tconfigs
from repro_torch.data import make_dataset
from repro_torch.models import build as torch_build
from repro_torch.models.model import lm_loss
from repro_torch.models.params import leaf_paths

ARCHS = tconfigs.ARCH_NAMES
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def to_numpy(t):
    """A tensor -> float32 numpy (bf16 widened exactly)."""
    return t.detach().float().numpy()


def to_jax(tree):
    """The port's parameter tree -> the same tree of JAX arrays, dtypes
    kept (bf16 through float32, which holds every bf16 exactly)."""
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    dt = jnp.bfloat16 if tree.dtype == torch.bfloat16 else None
    return jnp.asarray(to_numpy(tree) if dt else tree.detach().numpy(), dt)


def pair(arch, dtype, seed=0, **change):
    """(JAX model, its params, port model, its params): the reduced
    ``arch`` in ``dtype`` (and ``change``) in both packages, on the
    port's seeded init."""
    jc = dataclasses.replace(jconfigs.get_reduced(arch), dtype=dtype,
                             **change)
    tc = dataclasses.replace(tconfigs.get_reduced(arch), dtype=dtype,
                             **change)
    tm = torch_build(tc)
    tp = tm.init(seed, device="cpu")
    return jax_build(jc), to_jax(tp), tm, tp


def batches(cfg, B=2, S=16, seed=0, step=0):
    """(JAX batch, port batch): pipeline batch ``step`` (its frame
    embeddings rounded to the model's type, so both packages read the
    same values)."""
    ds = make_dataset(cfg, seq_len=S, global_batch=B, seed=seed)
    for _ in range(step + 1):
        b = next(ds)
    jb, tb = {}, {}
    for k, v in b.items():
        if k == "tokens":
            jb[k], tb[k] = jnp.asarray(v), torch.from_numpy(v)
        else:
            t = torch.from_numpy(v).to(TORCH_DT[cfg.dtype])
            jb[k], tb[k] = jnp.asarray(to_numpy(t), jnp.dtype(cfg.dtype)), t
    return jb, tb


def jax_value_and_grad(jm, jp, jb, **kw):
    """(loss, metrics, grads as {path: float32 numpy}) of the JAX
    package's ``lm_loss`` under ``jax.jit``."""
    f = jax.jit(jax.value_and_grad(
        lambda p, b: jax_lm_loss(jm, p, b, **kw), has_aux=True))
    (loss, metrics), g = f(jp, jb)
    grads = dict(leaf_paths(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), g)))
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def torch_value_and_grad(tm, tp, tb, **kw):
    """The same of the port's ``lm_loss`` (every leaf made trainable; a
    leaf the loss does not reach gets zeros, as in JAX)."""
    paths = [p for p, _ in leaf_paths(tp)]
    leaves = [t.requires_grad_(True) for _, t in leaf_paths(tp)]
    loss, metrics = lm_loss(tm, tp, tb, **kw)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = {p: (np.zeros(t.shape, np.float32) if g is None
                 else to_numpy(g)) for p, t, g in zip(paths, leaves, gs)}
    return float(loss.detach()), {k: float(v.detach())
                                  for k, v in metrics.items()}, grads


def leaf_errors(got, want):
    """{path: max |got - want| / max |want|} (absolute where want is 0)."""
    out = {}
    for path, w in want.items():
        scale = float(np.abs(w).max()) or 1.0
        out[path] = float(np.abs(got[path] - w).max()) / scale
    return out


def global_error(got, want):
    """||got - want|| / ||want|| over every leaf together."""
    num = sum(float(((got[p] - w) ** 2).sum()) for p, w in want.items())
    den = sum(float((w ** 2).sum()) for w in want.values())
    return (num / den) ** 0.5
