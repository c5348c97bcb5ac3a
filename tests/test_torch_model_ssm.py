"""Port of the Mamba-2 family (``repro_torch.models.ssm``, ``SSMLM``, the
mamba2-780m config) against the JAX package, on the reduced
mamba2-780m config (3 layers, d_model 64, 8 heads of 16, d_state 16,
chunk 16) with the JAX init's weights carried across
(``from_jax_numpy``), and the dense serving engine and launcher on it.

Tolerances, float32 (both sides compute every step in float32 and differ
in the order of their sums): the SSD core and the mixer 1e-5 of each
value plus 1e-5 of the largest |output|; logits 1e-4 of each value plus
1e-4 of the largest |logit| (three layers of sums whose terms are of the
hidden state's scale; logits reach ~50, and an error of ~2e-5 of that
scale lands on logits near zero too).  The engines run the config's own
bfloat16 and must give identical tokens and v4 metrics fields."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.models import build as jax_build
from repro.models import recurrent as jrec
from repro.models import ssm as jssm
from repro.obs import TickClock as JaxTickClock
from repro.serve import ServingEngine as JaxDense
from repro.serve.trace import replay as jax_replay

from repro_torch import configs as tconfigs
from repro_torch.models import SSMLM, build as torch_build, from_jax_numpy
from repro_torch.models import recurrent as trec
from repro_torch.models import ssm as tssm
from repro_torch.models.params import leaf_paths
from repro_torch.obs import TickClock
from repro_torch.serve import ServingEngine
from repro_torch.serve.trace import poisson_trace, replay
from snapshot_cases import assert_v4_fields_match

ARCH = "mamba2-780m"


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    tol = rel * np.abs(want) + rel * np.abs(want).max()
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


@pytest.fixture(scope="module")
def lm():
    jc = dataclasses.replace(jconfigs.get_reduced(ARCH), dtype="float32")
    tc = dataclasses.replace(tconfigs.get_reduced(ARCH), dtype="float32")
    jm, tm = jax_build(jc), torch_build(tc)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _ssd_inputs(B, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, P)).astype(np.float32),
            (-np.abs(rng.normal(size=(B, S, H))) * .1).astype(np.float32),
            (rng.normal(size=(B, S, H, N)) * .3).astype(np.float32),
            (rng.normal(size=(B, S, H, N)) * .3).astype(np.float32))


def test_config_and_the_stacked_tree_carry_across(lm):
    jm, jp, tm, tp = lm
    assert dataclasses.asdict(tconfigs.get_config(ARCH)) == \
        dataclasses.asdict(jconfigs.get_config(ARCH))
    assert dataclasses.asdict(tconfigs.get_reduced(ARCH)) == \
        dataclasses.asdict(jconfigs.get_reduced(ARCH))
    assert isinstance(tm, SSMLM)
    jleaves = dict(leaf_paths(jax.tree.map(np.asarray, jp)))
    tleaves = dict(leaf_paths(tp))
    assert jleaves.keys() == tleaves.keys()
    for path, leaf in tleaves.items():
        assert tuple(leaf.shape) == jleaves[path].shape, path
        if path[0] == "blocks":
            assert leaf.shape[0] == 3, path       # the layer axis
    assert tm.n_params == jm.n_params


def test_n_params_of_the_full_config():
    jm = jax_build(jconfigs.get_config(ARCH))
    tm = torch_build(tconfigs.get_config(ARCH))
    assert tm.n_params == jm.n_params
    assert 0.5e9 < tm.n_params < 1.1e9


@pytest.mark.parametrize("S,chunk,with_state", [(64, 16, False),
                                                (48, 16, True),
                                                (32, 32, False)])
def test_ssd_chunked_matches_jax(S, chunk, with_state):
    arrs = _ssd_inputs(2, S, 3, 8, 4, S + chunk)
    s0 = (np.random.default_rng(1).normal(size=(2, 3, 4, 8))
          .astype(np.float32) if with_state else None)
    jy, js = jssm.ssd_chunked(*map(jnp.asarray, arrs), chunk,
                              None if s0 is None else jnp.asarray(s0))
    ty, ts = tssm.ssd_chunked(*map(torch.from_numpy, arrs), chunk,
                              None if s0 is None else torch.from_numpy(s0))
    _close(ty, jy, 1e-5)
    _close(ts, js, 1e-5)


def test_ssd_via_kernel_matches_jax_and_ssd_chunked():
    """``ssd_via_kernel`` (the gate, then the plain version on the CPU)
    against the JAX one (the Pallas kernel in interpret mode) and the
    port's own ``ssd_chunked``, at the JAX test's shapes."""
    arrs = _ssd_inputs(1, 128, 2, 16, 8, 0)
    jy = jssm.ssd_via_kernel(*map(jnp.asarray, arrs), 32, interpret=True)
    ty = tssm.ssd_via_kernel(*map(torch.from_numpy, arrs), 32)
    assert ty.shape == (1, 128, 2, 16)
    _close(ty, jy, 1e-5)
    want, _ = tssm.ssd_chunked(*map(torch.from_numpy, arrs), 32)
    _close(ty, want.numpy(), 1e-5)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(2)
    u = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32)
    for state in (None, st):
        jo, jn = jrec._causal_conv(*map(jnp.asarray, (u, w, b)),
                                   None if state is None
                                   else jnp.asarray(state))
        to, tn = trec._causal_conv(*map(torch.from_numpy, (u, w, b)),
                                   None if state is None
                                   else torch.from_numpy(state))
        _close(to, jo, 1e-6)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_apply_ssm_block_matches_jax(lm):
    """The mixer over a prompt that is no multiple of the chunk (zero
    padding), and one decode step from a seeded state."""
    jm, jp, tm, tp = lm
    cfg = tm.cfg
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["ssm"])
    tl = {k: (v[0] if not isinstance(v, dict) else
              {kk: vv[0] for kk, vv in v.items()})
          for k, v in tp["blocks"]["ssm"].items()}
    x = np.random.default_rng(4).normal(size=(2, 37, 64)).astype(np.float32)
    jo, _ = jssm.apply_ssm_block(jl, jnp.asarray(x), cfg)
    to, none = tssm.apply_ssm_block(tl, torch.from_numpy(x), cfg)
    assert none is None
    _close(to, jo, 1e-5)
    rng = np.random.default_rng(5)
    shapes = tssm.ssm_cache_shape(cfg, 2)
    state = {k: rng.normal(size=s).astype(np.float32)
             for k, (s, _) in shapes.items()}
    jo, js = jssm.apply_ssm_block(jl, jnp.asarray(x[:, :1]), cfg,
                                  state={k: jnp.asarray(v)
                                         for k, v in state.items()})
    to, ts = tssm.apply_ssm_block(tl, torch.from_numpy(x[:, :1]), cfg,
                                  state={k: torch.from_numpy(v)
                                         for k, v in state.items()})
    _close(to, jo, 1e-5)
    for k in ("ssm", "conv"):
        _close(ts[k], js[k], 1e-5)


def test_apply_logits_match_jax(lm):
    jm, jp, tm, tp = lm
    toks = np.random.default_rng(6).integers(0, 256, size=(2, 40))
    jl, jaux = jm.apply(jp, jnp.asarray(toks, jnp.int32))
    tl, taux = tm.apply(tp, torch.from_numpy(toks))
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    V = tm.cfg.vocab
    _close(tl[..., :V], np.asarray(jl)[..., :V], 1e-4)
    assert float(taux) == float(jaux) == 0.0
    last, _ = tm.apply(tp, torch.from_numpy(toks), last_only=True)
    _close(last, tl[:, -1:].numpy(), 1e-6)    # one row: another BLAS path


def test_decode_replay_matches_jax_and_the_full_forward(lm):
    """``decode_step`` from the zeroed cache, token by token, as
    ``tests/test_models.py`` checks the JAX model: each step's logits
    against the JAX step's and the last against ``apply``'s."""
    jm, jp, tm, tp = lm
    V = tm.cfg.vocab
    toks = np.random.default_rng(7).integers(2, V, size=(2, 12))
    jc = jm.init_cache(2, 32)
    tc = tm.init_cache(2, 32, device="cpu")
    assert tm.cache_axes() == jm.cache_axes()
    for k in ("ssm", "conv"):
        assert tuple(tc["blocks"][k].shape) == jc["blocks"][k].shape
    for t in range(toks.shape[1] - 1):
        jo, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1],
                                                    jnp.int32), t)
        to, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]),
                                t)
        _close(to[..., :V], np.asarray(jo)[..., :V], 1e-4)
    for k in ("ssm", "conv"):
        _close(tc["blocks"][k], jc["blocks"][k], 1e-4)
    full, _ = tm.apply(tp, torch.from_numpy(toks))
    _close(to[:, -1, :V], full[:, -2, :V].numpy(), 1e-4)


def test_prefill_returns_the_zeroed_cache_as_jax_does(lm):
    """The reference's ``SSMLM.prefill`` returns ``init_cache``: the
    prompt's state is not carried into decode (ROADMAP section C).  The
    port holds to it: last-position logits as ``apply``'s, a zero cache
    the shape of JAX's."""
    jm, jp, tm, tp = lm
    V = tm.cfg.vocab
    toks = np.random.default_rng(8).integers(2, V, size=(1, 20))
    jl, jc = jm.prefill(jp, jnp.asarray(toks, jnp.int32), max_len=32)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=32)
    _close(tl[..., :V], np.asarray(jl)[..., :V], 1e-4)
    for k in ("ssm", "conv"):
        assert tuple(tc["blocks"][k].shape) == jc["blocks"][k].shape
        assert not np.asarray(jc["blocks"][k]).any()
        assert not tc["blocks"][k].any()
    # a correct prefill would carry state: one decode step from it
    # differs from the step the zeroed cache gives
    state = tm.init_cache(1, 32, device="cpu")
    for t in range(toks.shape[1]):
        _, state = tm.decode_step(tp, state, torch.from_numpy(
            toks[:, t:t + 1]), t)
    assert state["blocks"]["ssm"].abs().max() > 0


# -- serving ------------------------------------------------------------------

def _trace(vocab):
    """fig_serving.py's Poisson trace parameters."""
    return poisson_trace(seed=1, n_requests=12, mean_gap=3.0,
                         prompt_lens=(4, 28), max_new=(4, 12), vocab=vocab)


def test_dense_engine_matches_the_jax_engine():
    """The config's own bfloat16, the JAX init's weights: identical
    tokens and v4 metrics fields (both on a virtual TickClock)."""
    jc, tc = jconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)
    jm, tm = jax_build(jc), torch_build(tc)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tr = _trace(tc.vocab)
    geom = dict(n_slots=4, max_len=64, eos_id=-1)
    j = jax_replay(JaxDense(jm, jp, clock=JaxTickClock(), **geom), tr)
    t = replay(ServingEngine(tm, tp, clock=TickClock(), device="cpu",
                             **geom), tr)
    assert t["outputs"] == j["outputs"]
    assert_v4_fields_match(t["metrics"], j["metrics"])
    assert sum(len(o) for o in t["outputs"].values()) > 50


def test_launcher_serves_mamba2_on_the_dense_engine_and_refuses_paged():
    from repro_torch.launch import serve as launch
    done = launch.main(["--arch", ARCH, "--reduced", "--engine", "dense",
                        "--device", "cpu", "--requests", "3",
                        "--max-new-tokens", "4", "--max-len", "32"])
    assert len(done) == 3 and all(len(r.output) == 4 for r in done)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        launch.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
