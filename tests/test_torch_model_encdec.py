"""Port of the encoder-decoder family (``repro_torch.models.encdec``,
``EncDecLM``, the seamless-m4t-large-v2 config) against the JAX package,
on the reduced seamless-m4t-large-v2 config (2 encoder + 2 decoder
layers, d_model 64, 4 heads of 16, GELU FFN of 128) with the JAX init's
weights carried across (``from_jax_numpy``) and seeded-normal frame
embeddings standing in for the speech frontend, as in the JAX package.

Tolerances, float32: the encoder output and the cross K/V 1e-5 of each
value plus 1e-5 of the largest |value|; logits 2e-4 of each value plus
2e-4 of the largest |logit|.  The init's attention is peaked (scores of
tens at this width), so a last-bit difference in a score moves an output
by ~1e-5 of its size, and four attention blocks and the unembed compound
it: on these inputs the JAX package's own ``apply`` (compiled under
``lax.scan``) and its layers run eagerly differ by a good part of 1e-4
of the largest |logit| already.  bfloat16: XLA keeps float32 between
operations inside the compiled scan that its eager layers round to
bfloat16, which moves JAX's ``apply`` by several percent of the largest
|logit| from its own eager layers; the port's bf16 logits are held to
the eager JAX layers within 1% of the largest (as the other bf16 model
files hold logits) and to JAX's ``apply`` within 10% of it."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.models import build as jax_build
from repro.models import components as jcomp
from repro.models import encdec as jenc

from repro_torch import configs as tconfigs
from repro_torch.models import EncDecLM, build as torch_build, from_jax_numpy
from repro_torch.models.params import leaf_paths

ARCH = "seamless-m4t-large-v2"
KEY = jax.random.PRNGKey(0)
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    tol = rel * np.abs(want) + rel * np.abs(want).max()
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def _pair(dtype):
    jc = dataclasses.replace(jconfigs.get_reduced(ARCH), dtype=dtype)
    tc = dataclasses.replace(tconfigs.get_reduced(ARCH), dtype=dtype)
    jm, tm = jax_build(jc), torch_build(tc)
    jp = jm.init(KEY)
    tp = from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _inputs(dtype, B=2, S=24, S_enc=30):
    """(tokens, JAX frame embeddings, the port's) from one seed."""
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 256, size=(B, S))
    enc = rng.normal(size=(B, S_enc, 64)).astype(np.float32)
    return (toks, jnp.asarray(enc, jnp.dtype(dtype)),
            torch.from_numpy(enc).to(TORCH_DT[dtype]))


@pytest.fixture(scope="module")
def lm():
    return _pair("float32")


def test_config_and_the_tree_carry_across(lm):
    jm, jp, tm, tp = lm
    assert isinstance(tm, EncDecLM)
    jleaves = dict(leaf_paths(jax.tree.map(np.asarray, jp)))
    tleaves = dict(leaf_paths(tp))
    assert jleaves.keys() == tleaves.keys()
    for path, leaf in tleaves.items():
        assert tuple(leaf.shape) == jleaves[path].shape, path
    assert tleaves[("enc", "attn", "wq")].shape[0] == 2    # layer axes
    assert tleaves[("dec", "xattn", "wq")].shape[0] == 2
    assert tm.n_params == jm.n_params


def test_encode_matches_jax(lm):
    jm, jp, tm, tp = lm
    _, je, te = _inputs("float32")
    want = jm.encode(jp, je)
    got = tm.encode(tp, te)
    assert tuple(got.shape) == want.shape == (2, 30, 64)
    _close(got, want, 1e-5)


def test_apply_logits_match_jax_in_float32(lm):
    jm, jp, tm, tp = lm
    toks, je, te = _inputs("float32")
    jl, jaux = jm.apply(jp, jnp.asarray(toks, jnp.int32), enc_embeds=je)
    tl, taux = tm.apply(tp, torch.from_numpy(toks), enc_embeds=te)
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    V = tm.cfg.vocab
    _close(tl[..., :V], np.asarray(jl)[..., :V], 2e-4)
    assert float(taux) == float(jaux) == 0.0


def _jax_eager_logits(jm, jp, toks, je):
    """The JAX layers run one by one, outside ``lax.scan``."""
    cfg = jm.cfg
    x, pos = je, jnp.arange(je.shape[1])
    for i in range(cfg.enc_layers):
        p = jax.tree.map(lambda a: a[i], jp["enc"])
        h = jcomp.apply_norm(p["ln_attn"], x, cfg)
        q, k, v = jcomp.qkv_project(p["attn"], h, cfg, pos)
        x = x + jcomp.attn_out(p["attn"], jcomp.sdpa(q, k, v, causal=False))
        h = jcomp.apply_norm(p["ln_ffn"], x, cfg)
        x = x + jcomp.apply_ffn(p["ffn"], h, cfg)
    enc_out = jcomp.apply_norm(jp["ln_enc"], x, cfg)
    y = jcomp.embed(jp["embed"], jnp.asarray(toks, jnp.int32), cfg)
    pos = jnp.arange(toks.shape[1])
    for i in range(cfg.n_layers):
        p = jax.tree.map(lambda a: a[i], jp["dec"])
        ek, ev = jenc._cross_kv(p["xattn"], enc_out)
        y, _ = jm._dec_layer(p, y, pos, ek, ev, None, 0)
    y = jcomp.apply_norm(jp["ln_f"], y, cfg)
    return jcomp.unembed(jp["embed"], y, cfg)


def test_apply_logits_match_jax_in_bfloat16():
    jm, jp, tm, tp = _pair("bfloat16")
    toks, je, te = _inputs("bfloat16")
    V = tm.cfg.vocab
    tl, _ = tm.apply(tp, torch.from_numpy(toks), enc_embeds=te)
    got = _np(tl)[..., :V]
    eager = _np(_jax_eager_logits(jm, jp, toks, je))[..., :V]
    assert np.abs(got - eager).max() <= 0.01 * np.abs(eager).max()
    jl, _ = jm.apply(jp, jnp.asarray(toks, jnp.int32), enc_embeds=je)
    want = _np(jl)[..., :V]
    assert np.abs(got - want).max() <= 0.1 * np.abs(want).max()


def test_cache_trees_match_jax(lm):
    jm, jp, tm, tp = lm
    for args in ((3, 16), (3, 16, 40)):
        jshape, tshape = jm.cache_shape(*args), tm.cache_shape(*args)
        jleaves = {p: (s.shape, str(s.dtype)) for p, s in leaf_paths(
            jax.tree.map(lambda s: s, jshape, is_leaf=lambda s: isinstance(
                s, jax.ShapeDtypeStruct)))}
        tleaves = {p: (tuple(s.shape), str(s.dtype).replace("torch.", ""))
                   for p, s in leaf_paths(tshape)}
        assert tleaves == jleaves
    assert tleaves[("cross", "k")][0] == (2, 3, 4, 40, 16)
    assert tm.cache_axes() == jm.cache_axes()


def test_prefill_cross_kv_match_jax(lm):
    """``prefill`` takes frame embeddings and returns the cache only:
    the cross K/V of every decoder layer in the model's type, the
    self-attention KV zeroed."""
    jm, jp, tm, tp = lm
    _, je, te = _inputs("float32")
    jc = jm.prefill(jp, je, 32)
    tc = tm.prefill(tp, te, 32)
    assert isinstance(tc, dict) and set(tc) == {"self", "cross"}
    for k in ("k", "v"):
        assert tuple(tc["cross"][k].shape) == jc["cross"][k].shape == \
            (2, 2, 4, 30, 16)
        assert tc["cross"][k].dtype == torch.float32
        _close(tc["cross"][k], jc["cross"][k], 1e-5)
        assert tuple(tc["self"][k].shape) == jc["self"][k].shape
        assert not tc["self"][k].any()


def test_decode_steps_match_jax_and_the_teacher_forced_apply(lm):
    """``prefill``, then 24 ``decode_step`` tokens (rows at one position,
    the scalar form, then per-row positions, the (B,) form): each step's
    logits against the JAX step's, and against the port's own
    ``apply`` at that position."""
    jm, jp, tm, tp = lm
    toks, je, te = _inputs("float32")
    V = tm.cfg.vocab
    full, _ = tm.apply(tp, torch.from_numpy(toks), enc_embeds=te)
    jc, tc = jm.prefill(jp, je, 32), tm.prefill(tp, te, 32)
    step = jax.jit(jm.decode_step)
    for t in range(toks.shape[1]):
        jpos = jnp.int32(t) if t < 12 else jnp.full((2,), t, jnp.int32)
        tpos = t if t < 12 else torch.full((2,), t)
        jo, jc = step(jp, jc, jnp.asarray(toks[:, t:t + 1], jnp.int32), jpos)
        to, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]),
                                tpos)
        _close(to[..., :V], np.asarray(jo)[..., :V], 2e-4)
        _close(to[:, 0, :V], full[:, t, :V], 1e-4)
    for k in ("k", "v"):
        _close(tc["self"][k], jc["self"][k], 1e-4)


def test_the_engines_and_the_launcher_refuse_the_family(lm):
    """The engines prefill token prompts; ``EncDecLM.prefill`` takes
    frame embeddings and returns a cache only (the JAX package's dense
    engine fails on it too, unpacking (logits, cache))."""
    from repro_torch.launch import serve as launch
    from repro_torch.serve import PagedServingEngine, ServingEngine
    jm, jp, tm, tp = lm
    with pytest.raises(NotImplementedError, match="frame embeddings"):
        ServingEngine(tm, tp, n_slots=2, max_len=32, device="cpu")
    with pytest.raises(NotImplementedError, match="frame embeddings"):
        PagedServingEngine(tm, tp, pool_pages=8, page_size=8, max_len=32,
                           device="cpu")
    for engine in ("dense", "paged"):
        with pytest.raises(NotImplementedError, match="frame embeddings"):
            launch.main(["--arch", ARCH, "--reduced", "--engine", engine,
                         "--device", "cpu"])
