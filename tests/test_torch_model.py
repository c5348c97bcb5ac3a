"""Port of models/transformer (dense GQA): every serving-relevant entry
point of the port's TransformerLM against the JAX TransformerLM, with
the weights the JAX init made carried across through numpy
(``from_jax_numpy``), at the reduced qwen3-1.7b config.

Tolerances: float32 logits within 1e-4 (the two sides round their
float32 sums, rsqrt, exp and rope angles differently in the last bits)
and updated KV pools within 1e-5.  bfloat16 keeps 8 significant bits,
so one step is 2^-8..2^-7 of a value, and the two frameworks round a
bf16 matmul's or norm's output to either neighbour.  Such a rounding in
layer 1 moves layer 2's K/V by a few steps of the hidden state's scale,
not of each small element's own: bf16 KV pools are held within two
steps (rtol 2^-6) plus 0.5% of the pool's largest |value| (the observed
gap is under 0.2%), and bf16 logits, the sum of many such roundings,
within 1% of the batch's largest |logit| (observed under 0.4%)."""
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

from repro_torch import configs as tconfigs
from repro_torch.kernels.paged_attention import default_config as pa_cfg
from repro_torch.kernels.ragged_prefill import default_config as rp_cfg
from repro_torch.models import build as torch_build, from_jax_numpy

ARCH = "qwen3-1.7b"


def _cfgs(dtype):
    jc, tc = jconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)
    if dtype == "float32":
        jc = dataclasses.replace(jc, dtype="float32")
        tc = dataclasses.replace(tc, dtype="float32")
    return jc, tc


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    jc, tc = _cfgs(request.param)
    jm, tm = jax_build(jc), torch_build(tc)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return request.param, jm, jp, tm, tp


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _close_logits(got, want, dtype):
    want = _np(want)
    tol = 1e-4 if dtype == "float32" else 0.01 * float(np.abs(want).max())
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol)


def _close_pool(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5)
    else:
        want = _np(want)
        np.testing.assert_allclose(_np(got), want, rtol=2 ** -6,
                                   atol=0.005 * float(np.abs(want).max()))


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(2, vocab, size=shape,
                                                dtype=np.int32)


def test_weights_carry_across_exactly(pair):
    dtype, jm, jp, tm, tp = pair
    assert tm.n_params == jm.n_params
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    for path, leaf in flat_j.items():
        node = tp
        for k in path:
            node = node[k.key]
        assert node.dtype == {"bfloat16": torch.bfloat16,
                              "float32": torch.float32}[str(leaf.dtype)]
        np.testing.assert_array_equal(_np(node), _np(leaf))


def test_apply_matches(pair):
    dtype, jm, jp, tm, tp = pair
    toks = _tokens(0, (2, 12))
    want, _ = jm.apply(jp, jnp.asarray(toks))
    got, aux = tm.apply(tp, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close_logits(got, want, dtype)


def test_prefill_then_decode_chunk_match(pair):
    dtype, jm, jp, tm, tp = pair
    toks = _tokens(1, (2, 10))
    jl, jc = jm.prefill(jp, jnp.asarray(toks), 32)
    tl, tcache = tm.prefill(tp, torch.from_numpy(toks), 32)
    _close_logits(tl, jl, dtype)
    for leaf in ("k", "v"):
        _close_pool(tcache["blocks"][leaf], jc["blocks"][leaf], dtype)
    # per-row offsets; row 1's slab runs past max_len and is clamped,
    # as lax.dynamic_update_slice clamps it
    chunk = _tokens(2, (2, 6))
    pos = np.asarray([10, 29], np.int32)
    jl2, jc2 = jm.decode_chunk(jp, jc, jnp.asarray(chunk), jnp.asarray(pos))
    tl2, tc2 = tm.decode_chunk(tp, tcache, torch.from_numpy(chunk),
                               torch.from_numpy(pos))
    _close_logits(tl2, jl2, dtype)
    for leaf in ("k", "v"):
        _close_pool(tc2["blocks"][leaf], jc2["blocks"][leaf], dtype)
    # decode_step (scalar position)
    one = _tokens(3, (2, 1))
    jl3, _ = jm.decode_step(jp, jc2, jnp.asarray(one), jnp.int32(16))
    tl3, _ = tm.decode_step(tp, tc2, torch.from_numpy(one), 16)
    _close_logits(tl3, jl3, dtype)


def _pool(jm, P, PS, seed):
    """Pool leaves (L, P, Hkv, PS, D) with random content on pages 1.. and
    the null page 0 all-zero."""
    cfg = jm.cfg
    shape = (cfg.n_layers, P, cfg.n_kv_heads, PS, cfg.resolved_head_dim)
    rng = np.random.default_rng(seed)
    out = {}
    for leaf in ("k", "v"):
        a = rng.normal(size=shape).astype(np.float32)
        a[:, 0] = 0.0
        out[leaf] = a
    return out


def _pools_both(jm, pool_np, dtype):
    jdt = jnp.dtype(dtype)
    tdt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    jpool = {"blocks": {k: jnp.asarray(v, jdt) for k, v in pool_np.items()}}
    tpool = {"blocks": {k: torch.from_numpy(v).to(tdt)
                        for k, v in pool_np.items()}}
    return jpool, tpool


def test_decode_step_paged_matches_and_drops_inactive_writes(pair):
    dtype, jm, jp, tm, tp = pair
    P, PS, NP = 12, 8, 4
    jpool, tpool = _pools_both(jm, _pool(jm, P, PS, 4), dtype)
    # row 0 at position 9 (page 1), row 1 inactive, row 2 at position 0
    tables = np.asarray([[3, 5, 0, 0], [0, 0, 0, 0], [7, 0, 0, 0]],
                        np.int32)
    pos = np.asarray([9, 0, 0], np.int32)
    lengths = np.asarray([10, 0, 1], np.int32)
    toks = _tokens(5, (3, 1))
    jl, jpool2 = jm.decode_step_paged(
        jp, jpool, jnp.asarray(tables), jnp.asarray(toks), jnp.asarray(pos),
        jnp.asarray(lengths), kernel_cfg=jax_pa_cfg(NP), interpret=True)
    tl, tpool2 = tm.decode_step_paged(
        tp, tpool, torch.from_numpy(tables), torch.from_numpy(toks),
        torch.from_numpy(pos), torch.from_numpy(lengths),
        kernel_cfg=pa_cfg(NP))
    _close_logits(tl, jl, dtype)
    for leaf in ("k", "v"):
        got, want = tpool2["blocks"][leaf], jpool2["blocks"][leaf]
        _close_pool(got, want, dtype)
        # the inactive row wrote nothing: the null page is still zero
        assert float(got[:, 0].abs().max()) == 0.0
    # the inactive row reads nothing either: its logits are those of a
    # zero attention output, identical in both
    _close_logits(tl[1], jl[1], dtype)


def _packed_meta(P, PS, NP, spans, tables):
    """Engine-style packing of (prefix, chunk) spans (as
    PagedServingEngine._prefill_kernel builds it)."""
    pad = lambda t: -(-max(t, 1) // 64) * 64
    TQ = pad(sum(n for _, n in spans))
    TK = pad(sum(p + n for p, n in spans))
    seg_q = np.full(TQ, -1, np.int32)
    pos_q = np.zeros(TQ, np.int32)
    seg_k = np.full(TK, -1, np.int32)
    pos_k = np.zeros(TK, np.int32)
    wphys = np.full(TQ, P, np.int32)
    woffs = np.zeros(TQ, np.int32)
    gphys = np.zeros(TK, np.int32)
    goffs = np.zeros(TK, np.int32)
    qt = kt = 0
    for j, ((p, n), table) in enumerate(zip(spans, tables)):
        table = np.asarray(table)
        seg_q[qt:qt + n] = j
        qpos = np.arange(p, p + n)
        pos_q[qt:qt + n] = qpos
        wphys[qt:qt + n] = table[qpos // PS]
        woffs[qt:qt + n] = qpos % PS
        seg_k[kt:kt + p + n] = j
        kpos = np.arange(p + n)
        pos_k[kt:kt + p + n] = kpos
        gphys[kt:kt + p + n] = table[kpos // PS]
        goffs[kt:kt + p + n] = kpos % PS
        qt += n
        kt += p + n
    return TQ, TK, (seg_q, pos_q, seg_k, pos_k, wphys, woffs, gphys, goffs)


def test_prefill_chunk_packed_matches_and_drops_padding_writes(pair):
    dtype, jm, jp, tm, tp = pair
    P, PS, NP = 16, 8, 4
    jpool, tpool = _pools_both(jm, _pool(jm, P, PS, 6), dtype)
    spans = [(0, 11), (8, 8), (13, 3)]          # (prefix, chunk)
    tables = [[1, 2, 0, 0], [4, 6, 0, 0], [9, 10, 0, 0]]
    TQ, TK, meta = _packed_meta(P, PS, NP, spans, tables)
    toks = np.zeros((1, TQ), np.int32)
    toks[0, :22] = _tokens(7, (22,))
    jl, jpool2 = jm.prefill_chunk_packed(
        jp, jpool, jnp.asarray(toks), *(jnp.asarray(a) for a in meta),
        kernel_cfg=jax_rp_cfg(TQ, TK), interpret=True)
    tl, tpool2 = tm.prefill_chunk_packed(
        tp, tpool, torch.from_numpy(toks), *(torch.from_numpy(a)
                                             for a in meta),
        kernel_cfg=rp_cfg(TQ, TK))
    _close_logits(tl, jl, dtype)
    for leaf in ("k", "v"):
        got, want = tpool2["blocks"][leaf], jpool2["blocks"][leaf]
        _close_pool(got, want, dtype)
        # padding queries address page P (out of range): never written
        assert float(got[:, 0].abs().max()) == 0.0


def test_cache_layout_matches_jax(pair):
    dtype, jm, jp, tm, tp = pair
    jshape = jm.cache_shape(3, 16)
    tshape = tm.cache_shape(3, 16)
    for leaf in ("k", "v"):
        assert tuple(tshape["blocks"][leaf].shape) == \
            tuple(jshape["blocks"][leaf].shape)
    assert tm.cache_axes() == jm.cache_axes()
    c = tm.init_cache(3, 16, device="cpu")
    assert c["blocks"]["k"].shape == tshape["blocks"]["k"].shape
