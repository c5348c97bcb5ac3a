"""Port of the hybrid family (``repro_torch.models.recurrent`` and
``hybrid``, ``HybridLM``, the recurrentgemma-2b config) against the JAX
package, on the reduced recurrentgemma-2b config (5 layers: one (rec,
rec, attn) group and two remainder rec layers; d_model 64, 4 query heads
and 1 KV head of 16, RG-LRU width 64, window 32) with the JAX init's
weights carried across (``from_jax_numpy``), and the dense serving
engine and launcher on it.

Tolerances, float32: the scan, the RG-LRU block and local attention 1e-5
of each value plus 1e-5 of the largest |output|; logits 1e-4 of each
value plus 1e-4 of the largest |logit| (five layers of float32 sums,
transcendental functions that differ in their last bit, logits to ~50).
bfloat16: the JAX ``apply`` runs its layers inside a compiled
``lax.scan``, where XLA keeps float32 between operations that its eager
layers round to bfloat16; on these inputs that moves JAX's logits by
several percent of the largest from its own layers run one by one.  So
the port's bf16 logits are held to JAX's ``apply`` within 5% of the
largest |logit| and to the JAX layers run eagerly within 1% of it (as
the other bf16 model files hold logits).  The engines run the config's own bfloat16
and must give identical tokens and v4 metrics fields."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.models import build as jax_build
from repro.models import components as jcomp
from repro.models import hybrid as jhyb
from repro.models import recurrent as jrec
from repro.obs import TickClock as JaxTickClock
from repro.serve import ServingEngine as JaxDense
from repro.serve.trace import replay as jax_replay

from repro_torch import configs as tconfigs
from repro_torch.models import HybridLM, build as torch_build, from_jax_numpy
from repro_torch.models import components as tcomp
from repro_torch.models import recurrent as trec
from repro_torch.models.params import leaf_paths
from repro_torch.models.transformer import layer_slice
from repro_torch.obs import TickClock
from repro_torch.serve import ServingEngine
from repro_torch.serve.trace import poisson_trace, replay
from snapshot_cases import assert_v4_fields_match

ARCH = "recurrentgemma-2b"
KEY = jax.random.PRNGKey(0)


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


@pytest.fixture(scope="module")
def lm():
    return _pair("float32")


def _layer(jp, tp, name):
    """Layer ``name`` ("l0".."l2" of group 0, or "rem_0"/"rem_1") of both
    trees."""
    if name.startswith("rem"):
        return jp[name], tp[name]
    return (jax.tree.map(lambda a: a[0], jp["groups"][name]),
            layer_slice(tp["groups"], 0)[name])


def test_config_and_the_tree_carry_across(lm):
    jm, jp, tm, tp = lm
    assert isinstance(tm, HybridLM)
    assert (tm.n_groups, tm.rem) == (jm.n_groups, jm.rem) == (1, ["rec",
                                                                   "rec"])
    jleaves = dict(leaf_paths(jax.tree.map(np.asarray, jp)))
    tleaves = dict(leaf_paths(tp))
    assert jleaves.keys() == tleaves.keys()
    for path, leaf in tleaves.items():
        assert tuple(leaf.shape) == jleaves[path].shape, path
        assert np.array_equal(_np(leaf), jleaves[path].astype(np.float32))
    assert tm.n_params == jm.n_params


@pytest.mark.parametrize("S", [1, 2, 37, 64])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_the_associative_scan(S, with_h0):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.3, 1.0, size=(2, S, 24)).astype(np.float32)
    bx = rng.normal(size=(2, S, 24)).astype(np.float32)
    h0 = rng.normal(size=(2, 24)).astype(np.float32) if with_h0 else None
    want = jrec.rglru_scan(jnp.asarray(a), jnp.asarray(bx),
                           None if h0 is None else jnp.asarray(h0))
    got = trec.rglru_scan(torch.from_numpy(a), torch.from_numpy(bx),
                          None if h0 is None else torch.from_numpy(h0))
    _close(got, want, 1e-5)
    # the sequential recurrence it stands for
    h = np.zeros((2, 24), np.float32) if h0 is None else h0
    for t in range(S):
        h = a[:, t] * h + bx[:, t]
    _close(got[:, -1], h, 1e-5)


def test_apply_rglru_block_matches_jax(lm):
    """A full sequence, then one decode step from a seeded state."""
    jm, jp, tm, tp = lm
    cfg = tm.cfg
    jl, tl = _layer(jp, tp, "l0")
    x = np.random.default_rng(4).normal(size=(2, 37, 64)).astype(np.float32)
    block = jax.jit(lambda p, x, state: jrec.apply_rglru_block(
        p, x, cfg, state=state))
    jo, jnone = block(jl["mix"], jnp.asarray(x), None)
    to, tnone = trec.apply_rglru_block(tl["mix"], torch.from_numpy(x), cfg)
    assert jnone is None and tnone is None
    _close(to, jo, 1e-5)
    rng = np.random.default_rng(5)
    state = {k: rng.normal(size=s).astype(np.float32)
             for k, (s, _) in trec.rglru_cache_shape(cfg, 2).items()}
    jo, js = block(jl["mix"], jnp.asarray(x[:, :1]),
                   {k: jnp.asarray(v) for k, v in state.items()})
    to, ts = trec.apply_rglru_block(
        tl["mix"], torch.from_numpy(x[:, :1]), cfg,
        state={k: torch.from_numpy(v) for k, v in state.items()})
    _close(to, jo, 1e-5)
    for k in ("h", "conv"):
        _close(ts[k], js[k], 1e-5)
    assert ts["h"].dtype == torch.float32


def test_apply_local_attn_matches_jax_full_and_on_the_ring(lm):
    """A full sequence of 40 tokens (past the window of 32), then the
    same 40 tokens one at a time through the ring — rows at positions t
    and t + 7 (a (B,) vector of slots) — so the ring wraps."""
    jm, jp, tm, tp = lm
    cfg = tm.cfg
    jl, tl = _layer(jp, tp, "l2")
    x = np.random.default_rng(6).normal(size=(2, 40, 64)).astype(np.float32)
    pos = np.arange(40)
    jo, _ = jrec.apply_local_attn(jl["mix"], jnp.asarray(x),
                                  jnp.asarray(pos), cfg)
    to, _ = trec.apply_local_attn(tl["mix"], torch.from_numpy(x),
                                  torch.from_numpy(pos), cfg)
    _close(to, jo, 1e-5)

    shapes = trec.local_attn_cache_shape(cfg, 2)
    assert shapes == jrec.local_attn_cache_shape(cfg, 2)
    jc = {k: jnp.zeros(s, d) for k, (s, d) in shapes.items()}
    tc = {k: torch.zeros(s, dtype=tcomp.dtype_of(d))
          for k, (s, d) in shapes.items()}
    step = jax.jit(lambda p, x, pos, cache: jrec.apply_local_attn(
        p, x, pos[:, None], cfg, cache=cache, pos0=pos))
    for t in range(40):
        p0 = np.array([t, t + 7])
        jo, jc = step(jl["mix"], jnp.asarray(x[:, t:t + 1]),
                      jnp.asarray(p0), jc)
        to, tc = trec.apply_local_attn(
            tl["mix"], torch.from_numpy(x[:, t:t + 1]),
            torch.from_numpy(p0[:, None]), cfg, cache=tc,
            pos0=torch.from_numpy(p0))
        _close(to, jo, 1e-5)
    for k in ("k", "v"):
        _close(tc[k], jc[k], 1e-5)
    assert tc["pos"].dtype == torch.int32
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_apply_logits_match_jax_in_float32(lm):
    jm, jp, tm, tp = lm
    V = tm.cfg.vocab
    toks = np.random.default_rng(7).integers(0, V, size=(2, 40))
    jl, jaux = jm.apply(jp, jnp.asarray(toks, jnp.int32))
    tl, taux = tm.apply(tp, torch.from_numpy(toks))
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    _close(tl[..., :V], np.asarray(jl)[..., :V], 1e-4)
    assert float(taux) == float(jaux) == 0.0
    last, _ = tm.apply(tp, torch.from_numpy(toks), last_only=True)
    _close(last, tl[:, -1:], 1e-6)


def test_apply_logits_match_jax_in_bfloat16():
    jm, jp, tm, tp = _pair("bfloat16")
    V = tm.cfg.vocab
    toks = np.random.default_rng(1).integers(0, V, size=(2, 40))
    jl, _ = jm.apply(jp, jnp.asarray(toks, jnp.int32))
    tl, _ = tm.apply(tp, torch.from_numpy(toks))
    got, want = _np(tl)[..., :V], _np(jl)[..., :V]
    big = np.abs(want).max()
    assert np.abs(got - want).max() <= 0.05 * big
    # the JAX layers run eagerly, one by one
    x = jcomp.embed(jp["embed"], jnp.asarray(toks, jnp.int32), jm.cfg)
    pos = jnp.arange(40)
    for name, kind in [("l0", "rec"), ("l1", "rec"), ("l2", "attn"),
                       ("rem_0", "rec"), ("rem_1", "rec")]:
        jl_, _ = _layer(jp, tp, name)
        x, _ = jhyb._apply_layer(jl_, x, pos, jm.cfg, kind, None, 0)
    eager = jcomp.unembed(jp["embed"], jcomp.apply_norm(jp["ln_f"], x,
                                                        jm.cfg), jm.cfg)
    eager = _np(eager)[..., :V]
    assert np.abs(got - eager).max() <= 0.01 * np.abs(eager).max()


def test_cache_trees_match_jax(lm):
    jm, jp, tm, tp = lm
    jshape, tshape = jm.cache_shape(3, 16), tm.cache_shape(3, 16)
    jleaves = dict(leaf_paths(jax.tree.map(
        lambda s: (s.shape, str(s.dtype)), jshape,
        is_leaf=lambda s: isinstance(s, jax.ShapeDtypeStruct))))
    tleaves = {p: (tuple(s.shape), str(s.dtype).replace("torch.", ""))
               for p, s in leaf_paths(tshape)}
    assert tleaves == jleaves
    assert len(next(iter(tleaves))) == 3          # groups / l{i} / leaf
    assert tm.cache_axes() == jm.cache_axes()
    c = tm.init_cache(3, 16, device="cpu")
    for path, leaf in leaf_paths(c):
        assert (tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")) \
            == jleaves[path] and not leaf.any()


def test_prefill_returns_the_zeroed_cache_as_jax_does(lm):
    """The reference's ``HybridLM.prefill`` returns ``init_cache``: the
    prompt's states and ring are not carried into decode (ROADMAP section
    C).  The port holds to it."""
    jm, jp, tm, tp = lm
    V = tm.cfg.vocab
    toks = np.random.default_rng(8).integers(2, V, size=(1, 20))
    jl, jc = jm.prefill(jp, jnp.asarray(toks, jnp.int32), max_len=32)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=32)
    _close(tl[..., :V], np.asarray(jl)[..., :V], 1e-4)
    jleaves = dict(leaf_paths(jax.tree.map(np.asarray, jc)))
    for path, leaf in leaf_paths(tc):
        assert tuple(leaf.shape) == jleaves[path].shape, path
        assert not jleaves[path].any() and not leaf.any(), path


def _replay(tm, tp, toks, fill_pos=None):
    cache = tm.init_cache(1, 32, device="cpu")
    if fill_pos is not None:
        for path, leaf in leaf_paths(cache):
            if path[-1] == "pos":
                leaf.fill_(fill_pos)
    for t in range(toks.shape[1] - 1):
        out, cache = tm.decode_step(tp, cache,
                                    torch.from_numpy(toks[:, t:t + 1]), t)
    return out[0, -1]


def test_the_ring_position_defect_is_kept_as_in_jax(lm):
    """The ring's ``pos`` leaf starts at zeros in both packages, so every
    slot not yet written claims position 0 (K = V = 0), passes the masks
    and dilutes the softmax: ``tests/test_models.py``'s 12-token replay
    (same key, same tokens) differs from the full forward by ~2.7e-3
    (largest |logit| ~34) in both.  The port's replay matches JAX's; with
    the unwritten slots at -2^30 the port's replay comes within 3e-4
    (ROADMAP section C)."""
    jm, jp, tm, tp = lm
    V = tm.cfg.vocab
    toks = np.array(jax.random.randint(KEY, (1, 12), 2, V))
    jcache, step = jm.init_cache(1, 32), jax.jit(jm.decode_step)
    for t in range(toks.shape[1] - 1):
        jout, jcache = step(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                            jnp.int32(t))
    want = _np(jout)[0, -1, :V]
    got = _np(_replay(tm, tp, toks))[:V]
    _close(got, want, 1e-5)
    full = _np(tm.apply(tp, torch.from_numpy(toks))[0])[0, -2, :V]
    jfull = _np(jm.apply(jp, jnp.asarray(toks))[0])[0, -2, :V]
    assert np.abs(got - full).max() > 1e-3
    assert np.abs(want - jfull).max() > 1e-3
    fixed = _np(_replay(tm, tp, toks, fill_pos=-(1 << 30)))[:V]
    assert np.abs(fixed - full).max() < 3e-4


# -- serving ------------------------------------------------------------------

def test_dense_engine_matches_the_jax_engine():
    """The config's own bfloat16, the JAX init's weights: identical
    tokens and v4 metrics fields (both on a virtual TickClock); every
    request decodes from the zeroed state its prefill returns, in both."""
    jm, jp, tm, tp = _pair("bfloat16")
    tr = poisson_trace(seed=1, n_requests=12, mean_gap=3.0,
                       prompt_lens=(4, 28), max_new=(4, 12),
                       vocab=tm.cfg.vocab)
    geom = dict(n_slots=4, max_len=64, eos_id=-1)
    j = jax_replay(JaxDense(jm, jp, clock=JaxTickClock(), **geom), tr)
    t = replay(ServingEngine(tm, tp, clock=TickClock(), device="cpu",
                             **geom), tr)
    assert t["outputs"] == j["outputs"]
    assert_v4_fields_match(t["metrics"], j["metrics"])
    assert sum(len(o) for o in t["outputs"].values()) > 50


def test_launcher_serves_recurrentgemma_on_the_dense_engine_only():
    from repro_torch.launch import serve as launch
    done = launch.main(["--arch", ARCH, "--reduced", "--engine", "dense",
                        "--device", "cpu", "--requests", "3",
                        "--max-new-tokens", "4", "--max-len", "32"])
    assert len(done) == 3 and all(len(r.output) == 4 for r in done)
    with pytest.raises(NotImplementedError, match="--engine dense"):
        launch.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
