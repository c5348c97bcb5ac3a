"""Port of kernels/ragged_prefill: the plain PyTorch version (what the
wrapper runs on CPU tensors) against the JAX Pallas kernel in interpret
mode and the JAX dense oracle on the same seeded numpy inputs; the
packing helpers and the tiling decisions against JAX's.

Tolerances: float32 2e-5 (the two sides sum the same products in
another order); bfloat16 outputs 1e-2, a little above one bfloat16 step
at |x| < 2 (2^-7): each side rounds its float32 result once."""
import itertools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels.ragged_prefill import packing as jpack
from repro.kernels.ragged_prefill import ragged_prefill_ref as jax_ref
from repro.kernels.ragged_prefill import default_config as jax_default
from repro.kernels.ragged_prefill import verified_config as jax_verified
from repro.kernels.ragged_prefill.ragged_prefill import \
    ragged_prefill as jax_kernel

from repro_torch.kernels.ragged_prefill import (RaggedPrefillConfig,
                                                default_config, packing,
                                                ragged_prefill_attend,
                                                ragged_prefill_ref,
                                                verified_config)
from repro_torch.kernels.ragged_prefill.ragged_prefill import \
    ragged_prefill

TOL = {"float32": 2e-5, "bfloat16": 1e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _packed(seed, chunks, prefixes, Hq, Hkv, D, pad=64):
    """Engine-style packing: segment j's queries are its fresh chunk at
    positions prefix..prefix+n, its keys positions 0..prefix+n; both
    buffers padded to ``pad`` (seg -1, pos 0)."""
    rng = np.random.default_rng(seed)
    TQ = -(-sum(chunks) // pad) * pad
    TK = -(-sum(p + n for p, n in zip(prefixes, chunks)) // pad) * pad
    seg_q = np.full(TQ, -1, np.int32)
    pos_q = np.zeros(TQ, np.int32)
    seg_k = np.full(TK, -1, np.int32)
    pos_k = np.zeros(TK, np.int32)
    qt = kt = 0
    for j, (p, n) in enumerate(zip(prefixes, chunks)):
        seg_q[qt:qt + n] = j
        pos_q[qt:qt + n] = np.arange(p, p + n)
        seg_k[kt:kt + p + n] = j
        pos_k[kt:kt + p + n] = np.arange(p + n)
        qt += n
        kt += p + n
    q = rng.normal(size=(Hq, TQ, D)).astype(np.float32)
    k = rng.normal(size=(Hkv, TK, D)).astype(np.float32)
    v = rng.normal(size=(Hkv, TK, D)).astype(np.float32)
    return q, k, v, seg_q, pos_q, seg_k, pos_k


def _run_both(case, dtype, cfg=None):
    q, k, v, sq, pq, sk, pk = case
    jx = [jnp.asarray(a, JDT[dtype]) for a in (q, k, v)]
    jm = [jnp.asarray(a) for a in (sq, pq, sk, pk)]
    tx = [torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v)]
    tm = [torch.from_numpy(a) for a in (sq, pq, sk, pk)]
    jcfg = jax_default(q.shape[1], k.shape[1])
    got = ragged_prefill(*tx, *tm, cfg=cfg or default_config(
        q.shape[1], k.shape[1]))
    kern = jax_kernel(*jx, *jm, cfg=jcfg, interpret=True)
    oracle = jax_ref(*jx, *jm)
    return got, kern, oracle


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (4, 4), (8, 2)])
def test_plain_version_matches_pallas_kernel_and_oracle(dtype, Hq, Hkv):
    """Three segments with prefixes (one chunk starts mid-sequence), a
    padded tail of queries (fully masked rows) and of keys."""
    case = _packed(0, chunks=[9, 17, 5], prefixes=[0, 12, 30], Hq=Hq,
                   Hkv=Hkv, D=16)
    got, kern, oracle = _run_both(case, dtype)
    tol = TOL[dtype]
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(_np(got), _np(kern), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), rtol=tol, atol=tol)
    # padding queries (seg -1) are fully masked: exact zeros
    pad_rows = case[3] < 0
    assert pad_rows.any()
    assert float(got[:, torch.from_numpy(pad_rows)].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv,D", [(4, 2, 96), (4, 2, 48), (16, 1, 16),
                                      (71, 1, 16)])
def test_plain_version_matches_pallas_kernel_at_every_geometry(dtype, Hq,
                                                               Hkv, D):
    """Head_dim 96 and 48, groups 16 and 71, which the kernel takes since
    it reads head_dim at run time (the group was already free): the
    plain version against the JAX kernel, padding rows zero."""
    case = _packed(4, chunks=[9, 17, 5], prefixes=[0, 12, 30], Hq=Hq,
                   Hkv=Hkv, D=D)
    got, kern, _ = _run_both(case, dtype)
    tol = TOL[dtype]
    assert got.dtype == TDT[dtype] and got.shape[-1] == D
    np.testing.assert_allclose(_np(got), _np(kern), rtol=tol, atol=tol)
    pad_rows = torch.from_numpy(case[3] < 0)
    assert float(got[:, pad_rows].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_poisoned_foreign_segment_never_leaks(dtype):
    """Poison segment 1's keys and values (and the padding keys) with
    1e6: segment 0's and segment 2's rows stay bit-identical."""
    case = _packed(1, chunks=[20, 30, 10], prefixes=[4, 0, 16], Hq=4,
                   Hkv=2, D=16)
    q, k, v, sq, pq, sk, pk = case
    k2, v2 = k.copy(), v.copy()
    foreign = (sk == 1) | (sk < 0)
    k2[:, foreign] = 1e6
    v2[:, foreign] = 1e6
    clean, kern, _ = _run_both(case, dtype)
    poisoned, _, _ = _run_both((q, k2, v2, sq, pq, sk, pk), dtype)
    keep = torch.from_numpy((sq == 0) | (sq == 2))
    assert torch.equal(clean[:, keep], poisoned[:, keep])
    np.testing.assert_allclose(_np(clean), _np(kern), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_attend_entry_and_tiling_errors():
    case = _packed(2, chunks=[33, 31], prefixes=[0, 64], Hq=4, Hkv=2,
                   D=16)
    q, k, v, sq, pq, sk, pk = (torch.from_numpy(a) for a in case)
    got = ragged_prefill_attend(q, k, v, sq, pq, sk, pk)
    want = ragged_prefill_ref(q, k, v, sq, pq, sk, pk)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="tile"):
        ragged_prefill(q, k, v, sq, pq, sk, pk,
                       cfg=RaggedPrefillConfig(block_q=48, block_kv=64))


def test_packing_helpers_equal_jax():
    rng = np.random.default_rng(7)
    for _ in range(20):
        lens = rng.integers(0, 9, size=int(rng.integers(1, 6)))
        total = int(lens.sum()) + int(rng.integers(0, 5))
        cu = packing.cu_seqlens(lens)
        np.testing.assert_array_equal(cu, jpack.cu_seqlens(lens))
        for fn in ("segment_ids_from_cu", "positions_from_cu"):
            np.testing.assert_array_equal(getattr(packing, fn)(cu, total),
                                          getattr(jpack, fn)(cu, total))
        np.testing.assert_array_equal(packing.lengths_from_cu(cu),
                                      jpack.lengths_from_cu(cu))
        rows = [rng.normal(size=(int(n), 3)) for n in lens]
        got, gcu = packing.pack_ragged(rows, total)
        want, wcu = jpack.pack_ragged(rows, total)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(gcu, wcu)
        for a, b in zip(packing.unpack_ragged(got, gcu),
                        jpack.unpack_ragged(want, wcu)):
            np.testing.assert_array_equal(a, b)
    for bad in ([1, 2], [0, 3, 2], [[0, 1]]):
        with pytest.raises(packing.PackingError):
            packing.validate_packing(np.asarray(bad))
        with pytest.raises(jpack.PackingError):
            jpack.validate_packing(np.asarray(bad))


def test_tiling_decisions_equal_jax():
    geoms = itertools.product([64, 128, 192, 40, 100], [64, 256, 576, 48],
                              [1, 3])
    for tq, tk, n in geoms:
        d, jd = default_config(tq, tk), jax_default(tq, tk)
        assert (d.block_q, d.block_kv) == (jd.block_q, jd.block_kv)
        got = verified_config(tq, tk, n, q_heads=4, kv_heads=2,
                              head_dim=16, dtype="f32")
        want = jax_verified(tq, tk, n, q_heads=4, kv_heads=2, head_dim=16,
                            dtype="f32")
        assert (got is None) == (want is None), (tq, tk, n)
        if got is not None:
            assert (got.block_q, got.block_kv) == (want.block_q,
                                                   want.block_kv)
