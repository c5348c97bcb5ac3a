"""Port of the MoE family's kernel module, layer op and model layer
(``repro_torch.kernels.moe``, ``repro_torch.models.moe``) against the
JAX package on the same seeded numpy inputs (the Pallas kernel in
interpret mode), weights carried across with ``from_jax_numpy``.  The
MoE ``TransformerLM`` and the launcher: ``test_torch_model_moe.py``;
serving: ``test_torch_serving_moe.py``.

Tolerances:
  * ``compute_dispatch``: exact (integer code);
  * ``grouped_ffn`` and ``moe_ffn``: the kernel's own rule, written once
    beside ``moe_error`` in ``repro_torch/kernels/moe/ref.py`` (float32:
    1e-5 of the largest |output|; bfloat16: one bfloat16 step of each
    value plus 2^-8 of the largest |output|), since the plain version
    the CPU runs is what the CUDA kernel is held to on the card;
  * ``route``: expert indices exact, gates and the aux loss within 1e-6
    (float32 softmax rounded in the last bits);
  * ``apply_moe`` in float32: 1e-5 (the two sides sum the same float32
    products in another order); in bfloat16: 2^-6 of each value plus 1%
    of the largest |output| (each einsum rounds to bfloat16, and the
    frameworks may round to either neighbour);"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.core.families.moe import MoEConfig as JaxMoEConfig
from repro.kernels import moe as jmoe
from repro.models import moe as jax_moe_layer
from repro.models.params import init_params as jax_init_params

from repro_torch import configs as tconfigs
from repro_torch.core.families.moe import MoEConfig
from repro_torch.kernels.moe import (InvariantViolation, compute_dispatch,
                                     grouped_ffn, grouped_ffn_ref,
                                     moe_error, moe_ffn, moe_ffn_ref)
from repro_torch.models import from_jax_numpy
from repro_torch.models import moe as moe_layer

ARCH = "granite-moe-3b-a800m"
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _j(a, dt=torch.float32):
    return jnp.asarray(a, JDT[dt])


def _t(a, dt=torch.float32):
    return torch.from_numpy(np.array(a)).to(dt)


def _back(x, dt):
    """A JAX array -> torch tensor of ``dt`` (bf16 values pass float32
    exactly)."""
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(dt)


def _topk_idx(rng, T, K, E, skew):
    """(T, K) distinct expert indices per token, drawn with a skew toward
    low-numbered experts (so capacities overflow)."""
    logits = rng.normal(size=(T, E)) - skew * np.arange(E) / E
    return np.argsort(-logits, axis=1)[:, :K].astype(np.int32)


# -- compute_dispatch ----------------------------------------------------------

@pytest.mark.parametrize("T,K,E,C,skew", [
    (512, 2, 4, 200, 2.0),      # capacity below demand: drops
    (512, 8, 8, 400, 1.0),      # T·K = 4,096
    (100, 2, 40, 3, 4.0),       # 40 experts, tiny capacity
    (256, 8, 32, 80, 3.0),
    (64, 2, 16, 1, 0.0),        # one slot an expert
    (300, 8, 40, 120, 0.0),     # capacity above demand: no drop
])
def test_compute_dispatch_matches_jax_exactly(T, K, E, C, skew):
    idx = _topk_idx(np.random.default_rng(T + E), T, K, E, skew)
    jd, jk = jmoe.compute_dispatch(jnp.asarray(idx), E, C)
    td, tk = compute_dispatch(torch.from_numpy(idx), E, C)
    assert td.dtype == torch.int32 and tk.dtype == torch.bool
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    demand = np.bincount(idx.reshape(-1), minlength=E)
    assert (~tk).sum().item() == int(np.maximum(demand - C, 0).sum())


@pytest.mark.parametrize("G,T,K,E,C", [(3, 64, 2, 8, 12), (2, 40, 8, 32, 6)])
def test_compute_dispatch_over_groups_matches_jax_vmap(G, T, K, E, C):
    """A leading group axis gives each group its own tables, as the JAX
    layer's ``vmap`` of ``compute_dispatch`` does."""
    rng = np.random.default_rng(G * T)
    idx = np.stack([_topk_idx(rng, T, K, E, 2.0) for _ in range(G)])
    jd, jk = jax.vmap(lambda i: jmoe.compute_dispatch(i, E, C))(
        jnp.asarray(idx))
    td, tk = compute_dispatch(torch.from_numpy(idx), E, C)
    assert td.shape == tk.shape == (G, T, K)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert (~tk).any()


# -- grouped_ffn -----------------------------------------------------------------

GFFN_CASES = [
    # (E, C, DM, DF, block_t, block_f, fuse_gate, gates given)
    (2, 16, 64, 64, 8, 32, True, True),
    (2, 32, 64, 128, 16, 64, False, True),
    (1, 64, 32, 512, 64, 512, True, False),
    (3, 64, 64, 256, 8, 128, True, True),
    (2, 128, 48, 96, 64, 32, True, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", GFFN_CASES)
def test_grouped_ffn_plain_matches_jax_kernel(case, dtype):
    E, C, DM, DF, bt, bf, fuse, with_gates = case
    rng = np.random.default_rng(E * C + DF)
    x = rng.normal(size=(E, C, DM)).astype(np.float32)
    x[:, C // 2] = 0                               # empty capacity rows
    x[:, -1] = 0
    ws = [(rng.normal(size=s) * .1).astype(np.float32)
          for s in ((E, DM, DF), (E, DM, DF), (E, DF, DM))]
    g = rng.uniform(.2, 1, size=(E, C, 1)).astype(np.float32)
    gates = g if with_gates else None
    want = jmoe.grouped_ffn(
        _j(x, dtype), *(_j(w, dtype) for w in ws),
        None if gates is None else jnp.asarray(gates),
        cfg=JaxMoEConfig(bt, bf, fuse), interpret=True)
    got = grouped_ffn(_t(x, dtype), *(_t(w, dtype) for w in ws),
                      None if gates is None else _t(gates),
                      cfg=MoEConfig(bt, bf, fuse))
    assert got.dtype == dtype and got.shape == (E, C, DM)
    err, ok = moe_error(got, _back(want, dtype))
    assert ok, err
    assert not got[:, C // 2].any() and not got[:, -1].any()


def test_grouped_ffn_checks_the_blocks_as_jax_does():
    x, w = torch.zeros(2, 24, 64), torch.zeros(2, 64, 96)
    wd = torch.zeros(2, 96, 64)
    for cfg in (MoEConfig(16, 32), MoEConfig(8, 64)):
        with pytest.raises(ValueError, match="must divide blocks"):
            grouped_ffn(x, w, w, wd, cfg=cfg)
    assert grouped_ffn(x, w, w, wd, cfg=MoEConfig(8, 32)).shape == x.shape


# -- moe_ffn ---------------------------------------------------------------------

def _layer_inputs(seed, T, E, K, DM, DF, skew=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, DM)).astype(np.float32)
    ws = [(rng.normal(size=s) * .1).astype(np.float32)
          for s in ((E, DM, DF), (E, DM, DF), (E, DF, DM))]
    idx = _topk_idx(rng, T, K, E, skew)
    g = rng.uniform(.1, 1, size=(T, K)).astype(np.float32)
    return x, g / g.sum(1, keepdims=True), idx, ws


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("fuse,cf", [(True, 8.0), (True, 0.5),
                                     (False, 0.5)],
                         ids=["fused-nodrop", "fused-drops", "unfused-drops"])
def test_moe_ffn_matches_jax_and_the_dense_oracle(fuse, cf, dtype):
    T, E, K, DM, DF = 64, 8, 2, 64, 128
    x, g, idx, ws = _layer_inputs(7, T, E, K, DM, DF, skew=2.0)
    jcfg, tcfg = JaxMoEConfig(8, 64, fuse), MoEConfig(8, 64, fuse)
    want = jmoe.moe_ffn(_j(x, dtype), jnp.asarray(g), jnp.asarray(idx),
                        *(_j(w, dtype) for w in ws), cfg=jcfg,
                        capacity_factor=cf, interpret=True)
    tx, tw = _t(x, dtype), [_t(w, dtype) for w in ws]
    got = moe_ffn(tx, _t(g), torch.from_numpy(idx), *tw, cfg=tcfg,
                  capacity_factor=cf)
    err, ok = moe_error(got, _back(want, dtype))
    assert ok, err
    # the dense, capacity-free oracle through the keep mask: a dropped
    # pair contributes nothing
    C = jmoe.capacity_for(T, K, E, tcfg.block_t, cf)
    _, keep = compute_dispatch(torch.from_numpy(idx), E, C)
    assert bool((~keep).any()) == (cf < 1)
    ref = moe_ffn_ref(tx, _t(g) * keep, torch.from_numpy(idx), *tw)
    err, ok = moe_error(got, ref)
    assert ok, err


def test_moe_ffn_asks_the_gate_first(monkeypatch):
    """The layer op verifies (config, problem) with the shared engine
    before any kernel call, and a rejected config raises there."""
    from repro_torch.core.verify_engine import default_engine
    from repro_torch.kernels.moe import default_config
    gate, calls = default_engine(), []
    real = gate.verify

    def verify(family, cfg, prob, **kw):
        calls.append((family, cfg, prob))
        return real(family, cfg, prob, inject_bug="w_by_block_index")
    monkeypatch.setattr(gate, "verify", verify)
    x, g, idx, ws = _layer_inputs(3, 32, 4, 2, 64, 64)
    with pytest.raises(InvariantViolation, match="ARGUS rejected"):
        moe_ffn(_t(x), _t(g), torch.from_numpy(idx), *map(_t, ws))
    [(family, cfg, prob)] = calls
    assert family == "moe" and cfg == default_config(64, 64)
    assert dataclasses.astuple(prob) == (32, 64, 64, 4, 2, "f32")


def test_default_config_and_capacity_match_jax():
    from repro_torch.kernels.moe import capacity_for, default_config
    for dm, df in ((7168, 2048), (1536, 512), (64, 32), (64, 96), (64, 384)):
        assert dataclasses.astuple(default_config(dm, df)) == \
            dataclasses.astuple(jmoe.default_config(dm, df))
    for args in ((16384, 8, 32, 64), (16384, 8, 32, 8), (12, 2, 4, 8),
                 (4096, 8, 40, 128, 0.5)):
        assert capacity_for(*args) == jmoe.capacity_for(*args)


# -- the model layer -------------------------------------------------------------

def _granite(dtype="float32", **moe):
    jc = dataclasses.replace(jconfigs.get_reduced(ARCH), dtype=dtype)
    tc = dataclasses.replace(tconfigs.get_reduced(ARCH), dtype=dtype)
    if moe:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe))
    return jc, tc


DEEPSEEK = dict(n_experts=8, top_k=2, n_shared=1, d_ff_expert=32,
                capacity_factor=1.25, first_dense_layers=1, dense_d_ff=96,
                router_aux_free=True)
LAYER_CASES = {
    "granite": ({}, {}),
    "deepseek-style": (DEEPSEEK, {}),
    "geglu": (dict(capacity_factor=1.0), dict(ffn_type="geglu")),
}


def _layer(name, dtype="float32"):
    moe, extra = LAYER_CASES[name]
    jc, tc = _granite(dtype, **moe)
    jc, tc = (dataclasses.replace(jc, **extra),
              dataclasses.replace(tc, **extra))
    jp = jax_init_params(jax_moe_layer.moe_specs(jc), jax.random.PRNGKey(1))
    if "router_bias" in jp:          # a bias that changes the selection
        jp["router_bias"] = jnp.asarray(np.random.default_rng(2).normal(
            size=jp["router_bias"].shape) * 0.1, jnp.float32)
    tp = from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


@pytest.mark.parametrize("shape", [(2, 12), (5, 1)], ids=["grouped", "decode"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_apply_moe_matches_jax(name, dtype, shape):
    jc, tc, jp, tp = _layer(name, dtype)
    B, S = shape
    x = np.random.default_rng(B * S).normal(size=(B, S, tc.d_model))
    xj = jnp.asarray(x, jnp.dtype(jc.dtype))
    xt = torch.from_numpy(x.astype(np.float32)).to(
        torch.float32 if dtype == "float32" else torch.bfloat16)
    jg, ji, ja = jax_moe_layer.route(jp, xj.reshape(B * S, -1), jc)
    tg, ti, probs = moe_layer.route(tp, xt.reshape(B * S, -1), tc)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
    ta = moe_layer.load_balance_loss(probs, ti, tc.moe.n_experts)
    assert float(ta) == pytest.approx(float(ja), rel=1e-6, abs=1e-6)
    jo, jaux = jax_moe_layer.apply_moe(jp, xj, jc)
    to, taux = moe_layer.apply_moe(tp, xt, tc)
    assert to.shape == (B, S, tc.d_model) and to.dtype == xt.dtype
    want = np.asarray(jnp.asarray(jo, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(to.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(to.float().numpy(), want, rtol=2 ** -6,
                                   atol=0.01 * float(np.abs(want).max()))
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6, abs=1e-6)


def test_the_grouped_path_drops_what_jax_drops():
    """At capacity factor 1.25 the DeepSeek-style layer drops pairs in a
    12-token group; the port drops the same ones (its output matches
    JAX above) and they are a real share of the pairs."""
    jc, tc, jp, tp = _layer("deepseek-style")
    x = np.random.default_rng(24).normal(size=(2, 12, tc.d_model))
    _, idx, _ = moe_layer.route(tp, torch.from_numpy(
        x.astype(np.float32)).reshape(24, -1), tc)
    m = tc.moe
    C = max(8, int(-(-12 * m.top_k * m.capacity_factor // m.n_experts)
                   // 8 * 8))
    drops = int((~compute_dispatch(idx.reshape(2, 12, -1), m.n_experts,
                                   C)[1]).sum())
    assert drops > 0
