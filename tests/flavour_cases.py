"""Shared cases of ``test_torch_model_flavours.py`` (float32),
``test_torch_model_flavours_bf16.py`` and ``test_torch_model_mla.py``:
the reduced qwen3-1.7b config
with one flavour changed, the JAX init's weights with every bias leaf
drawn from a seeded normal, and the checks each flavour runs against the
JAX package.  The tolerances are stated in
``test_torch_model_flavours.py``."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.kernels.paged_attention import default_config as jax_pa_cfg
from repro.kernels.ragged_prefill import default_config as jax_rp_cfg
from repro.models import build as jax_build
from repro.models.config import MLASpec as JaxMLASpec, MoESpec as JaxMoESpec

from repro_torch import configs as tconfigs
from repro_torch.kernels.paged_attention import default_config as pa_cfg
from repro_torch.kernels.ragged_prefill import default_config as rp_cfg
from repro_torch.models import build as torch_build, from_jax_numpy
from repro_torch.models.config import MLASpec, MoESpec
from repro_torch.models.params import leaf_paths

ARCH = "qwen3-1.7b"
MLA = dict(kv_lora_rank=32, q_lora_rank=0, qk_nope_dim=16, qk_rope_dim=8,
           v_head_dim=16)
MOE = dict(n_experts=4, top_k=2, n_shared=1, d_ff_expert=32,
           capacity_factor=8.0)
# one change each to the reduced qwen3 config; "mla"/"moe" name a spec
FLAVOURS = {
    "layernorm": dict(norm_type="layernorm"),
    "geglu": dict(ffn_type="geglu"),
    "gelu": dict(ffn_type="gelu"),
    "qkv_bias": dict(qkv_bias=True),
    "partial_rotary": dict(rope_frac=0.25),
    "untied": dict(tie_embeddings=False),
    "scaled_embed": dict(scale_embed=True),
    "vlm": dict(family="vlm"),
    "mla": dict(attn_type="mla", mla=MLA),
    "mla_q_lora": dict(attn_type="mla", mla=dict(MLA, q_lora_rank=24)),
    "geglu_shared_experts": dict(family="moe", ffn_type="geglu", moe=MOE),
    "gelu_shared_experts": dict(family="moe", ffn_type="gelu", moe=MOE),
}
# the dense GQA flavours and the VLM family (test_torch_model_flavours*.py)
# and the MLA and shared-expert ones (test_torch_model_mla.py); bf16 skips
# the MoE flavours: a bf16 near-tie in the router may pick another expert
# on either side
GQA_FLAVOURS = [f for f in FLAVOURS if not {"mla", "moe"} & set(FLAVOURS[f])]
MLA_MOE_FLAVOURS = [f for f in FLAVOURS if f not in GQA_FLAVOURS]
BIASES = ("bias", "bq", "bk", "bv")


def flavour_cfg(pkg, flavour, dtype):
    change = dict(FLAVOURS[flavour], dtype=dtype)
    specs = ((JaxMLASpec, JaxMoESpec) if pkg is jconfigs
             else (MLASpec, MoESpec))
    if "mla" in change:
        change["mla"] = specs[0](**change["mla"])
    if "moe" in change:
        change["moe"] = specs[1](**change["moe"])
    return dataclasses.replace(pkg.get_reduced(ARCH), **change)


def weights(jm):
    """The JAX init's leaves as numpy, each bias leaf drawn anew."""
    rng = np.random.default_rng(7)
    out = {}
    for path, leaf in leaf_paths(jax.tree.map(np.asarray,
                                              jm.init(jax.random.PRNGKey(0)))):
        if path[-1] in BIASES:
            leaf = (0.5 * rng.normal(size=leaf.shape)).astype(leaf.dtype)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def make_pair(flavour, dtype):
    """(flavour, dtype, JAX model, its params, port model, its params)."""
    jm = jax_build(flavour_cfg(jconfigs, flavour, dtype))
    tm = torch_build(flavour_cfg(tconfigs, flavour, dtype))
    w = weights(jm)
    jp = jax.tree.map(jnp.asarray, w)
    tp = from_jax_numpy(w, device="cpu")
    return flavour, dtype, jm, jp, tm, tp


def as_np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def close_logits(got, want, dtype):
    want = as_np(want)
    big = float(np.abs(want).max())
    tol = 1e-4 + 1e-5 * big if dtype == "float32" else 0.01 * big
    np.testing.assert_allclose(as_np(got), want, rtol=tol, atol=tol)


def close_state(got, want, dtype):
    want = as_np(want)
    if dtype == "float32":
        np.testing.assert_allclose(as_np(got), want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(as_np(got), want, rtol=2 ** -6,
                                   atol=0.01 * float(np.abs(want).max()))


def tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(2, vocab, size=shape,
                                                dtype=np.int32)


def check_weights_and_parameter_counts(pair):
    flavour, dtype, jm, jp, tm, tp = pair
    assert tm.n_params == jm.n_params
    assert tm.n_active_params == jm.n_active_params
    flat = dict(leaf_paths(jax.tree.map(np.asarray, jp)))
    assert sorted(flat) == sorted(p for p, _ in leaf_paths(tp))
    if flavour in ("layernorm", "qkv_bias"):
        assert any(p[-1] in BIASES for p in flat)


def check_apply(pair):
    flavour, dtype, jm, jp, tm, tp = pair
    toks = tokens(0, (2, 12))
    want, jaux = jm.apply(jp, jnp.asarray(toks))
    got, aux = tm.apply(tp, torch.from_numpy(toks))
    assert got.dtype == torch.float32
    close_logits(got, want, dtype)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-6)


def check_prefill_then_decode(pair):
    flavour, dtype, jm, jp, tm, tp = pair
    toks = tokens(1, (2, 10))
    jl, jc = jm.prefill(jp, jnp.asarray(toks), 32)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), 32)
    close_logits(tl, jl, dtype)
    leaves = ("c_kv", "k_rope") if "mla" in flavour else ("k", "v")
    assert tuple(tc["blocks"]) == leaves
    for leaf in leaves:
        close_state(tc["blocks"][leaf], jc["blocks"][leaf], dtype)
    chunk = tokens(2, (2, 6))
    pos = np.asarray([10, 29], np.int32)     # row 1 clamped, as in JAX
    jl2, jc2 = jm.decode_chunk(jp, jc, jnp.asarray(chunk), jnp.asarray(pos))
    tl2, tc2 = tm.decode_chunk(tp, tc, torch.from_numpy(chunk),
                               torch.from_numpy(pos))
    close_logits(tl2, jl2, dtype)
    for leaf in leaves:
        close_state(tc2["blocks"][leaf], jc2["blocks"][leaf], dtype)
    one = tokens(3, (2, 1))
    jl3, _ = jm.decode_step(jp, jc2, jnp.asarray(one), jnp.int32(16))
    tl3, _ = tm.decode_step(tp, tc2, torch.from_numpy(one), 16)
    close_logits(tl3, jl3, dtype)


def _pools(jm, P, PS, dtype, seed):
    """(L, P, Hkv, PS, D) K/V pools, random on pages 1.., the null page 0
    all-zero, as JAX arrays and as tensors."""
    cfg = jm.cfg
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, P, cfg.n_kv_heads, PS, cfg.resolved_head_dim)
    jpool, tpool = {"blocks": {}}, {"blocks": {}}
    for leaf in ("k", "v"):
        a = rng.normal(size=shape).astype(np.float32)
        a[:, 0] = 0.0
        jpool["blocks"][leaf] = jnp.asarray(a, jnp.dtype(dtype))
        tpool["blocks"][leaf] = torch.from_numpy(a).to(getattr(torch, dtype))
    return jpool, tpool


def _packed(P, PS, spans, tables):
    """The engine's packing of (prefix, chunk) spans: both extents padded
    to 64 tokens, padding queries written to page P (dropped)."""
    pad = lambda t: -(-max(t, 1) // 64) * 64
    TQ, TK = pad(sum(n for _, n in spans)), pad(sum(p + n for p, n in spans))
    seg_q, pos_q = np.full(TQ, -1, np.int32), np.zeros(TQ, np.int32)
    seg_k, pos_k = np.full(TK, -1, np.int32), np.zeros(TK, np.int32)
    wphys, woffs = np.full(TQ, P, np.int32), np.zeros(TQ, np.int32)
    gphys, goffs = np.zeros(TK, np.int32), np.zeros(TK, np.int32)
    qt = kt = 0
    for j, ((p, n), table) in enumerate(zip(spans, tables)):
        table = np.asarray(table)
        qpos, kpos = np.arange(p, p + n), np.arange(p + n)
        seg_q[qt:qt + n], pos_q[qt:qt + n] = j, qpos
        wphys[qt:qt + n], woffs[qt:qt + n] = table[qpos // PS], qpos % PS
        seg_k[kt:kt + p + n], pos_k[kt:kt + p + n] = j, kpos
        gphys[kt:kt + p + n], goffs[kt:kt + p + n] = (table[kpos // PS],
                                                      kpos % PS)
        qt, kt = qt + n, kt + p + n
    return TQ, TK, (seg_q, pos_q, seg_k, pos_k, wphys, woffs, gphys, goffs)


def check_paged_kernel_paths(pair):
    """GQA: decode_step_paged and prefill_chunk_packed against the JAX
    kernels in interpret mode, logits and pools, the null page never
    written.  MLA: both entry points raise ValueError, as in JAX."""
    flavour, dtype, jm, jp, tm, tp = pair
    P, PS, NP = 16, 8, 4
    tables = np.asarray([[3, 5, 0, 0], [0, 0, 0, 0], [7, 0, 0, 0]],
                        np.int32)
    args = (tables, tokens(5, (3, 1)), np.asarray([9, 0, 0], np.int32),
            np.asarray([10, 0, 1], np.int32))
    if "mla" in flavour:
        jpool = jm.init_cache(P, PS)
        tpool = tm.init_cache(P, PS, device="cpu")
        with pytest.raises(ValueError, match="GQA"):
            jm.decode_step_paged(jp, jpool, *map(jnp.asarray, args))
        with pytest.raises(ValueError, match="GQA"):
            tm.decode_step_paged(tp, tpool, *map(torch.from_numpy, args))
        TQ, TK, meta = _packed(P, PS, [(0, 11)], [[1, 2, 0, 0]])
        toks = np.zeros((1, TQ), np.int32)
        with pytest.raises(ValueError, match="GQA"):
            jm.prefill_chunk_packed(jp, jpool, jnp.asarray(toks),
                                    *map(jnp.asarray, meta))
        with pytest.raises(ValueError, match="GQA"):
            tm.prefill_chunk_packed(tp, tpool, torch.from_numpy(toks),
                                    *map(torch.from_numpy, meta))
        return
    jpool, tpool = _pools(jm, P, PS, dtype, 4)
    jl, jpool2 = jm.decode_step_paged(
        jp, jpool, *map(jnp.asarray, args), kernel_cfg=jax_pa_cfg(NP),
        interpret=True)
    tl, tpool2 = tm.decode_step_paged(
        tp, tpool, *map(torch.from_numpy, args), kernel_cfg=pa_cfg(NP))
    close_logits(tl, jl, dtype)
    for leaf in ("k", "v"):
        close_state(tpool2["blocks"][leaf], jpool2["blocks"][leaf], dtype)
        assert float(tpool2["blocks"][leaf][:, 0].abs().max()) == 0.0

    jpool, tpool = _pools(jm, P, PS, dtype, 6)
    TQ, TK, meta = _packed(P, PS, [(0, 11), (8, 8), (13, 3)],
                           [[1, 2, 0, 0], [4, 6, 0, 0], [9, 10, 0, 0]])
    toks = np.zeros((1, TQ), np.int32)
    toks[0, :22] = tokens(7, (22,))
    jl, jpool2 = jm.prefill_chunk_packed(
        jp, jpool, jnp.asarray(toks), *map(jnp.asarray, meta),
        kernel_cfg=jax_rp_cfg(TQ, TK), interpret=True)
    tl, tpool2 = tm.prefill_chunk_packed(
        tp, tpool, torch.from_numpy(toks), *map(torch.from_numpy, meta),
        kernel_cfg=rp_cfg(TQ, TK))
    close_logits(tl[:, :22], jl[:, :22], dtype)
    for leaf in ("k", "v"):
        close_state(tpool2["blocks"][leaf], jpool2["blocks"][leaf], dtype)
        assert float(tpool2["blocks"][leaf][:, 0].abs().max()) == 0.0
