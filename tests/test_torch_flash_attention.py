"""Port of kernels/flash_attention: the port's validated ``mha`` and
``mha_decode`` (their plain versions on CPU tensors) against the JAX
package's ``mha`` / ``mha_decode`` with the Pallas kernels in interpret
mode, on the same seeded numpy inputs; the recompute backward against
``jax.vjp`` of the JAX ``mha``; and the gate in front of both.

Tolerances: float32 2e-5 (the JAX kernel tests' own: the same products
summed in another order, the online softmax's rescaling against one
softmax); bfloat16 1e-2, a little above one bfloat16 step at |x| < 2
(2^-7): the TPU kernel rounds p to bfloat16 before P·V and its output
once, the plain version rounds its float32 output once.  Gradients:
float32 1e-4 (a recompute of the same function, summed in another
order)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.kernels.flash_attention import mha as jax_mha
from repro.kernels.flash_attention import mha_decode as jax_mha_decode
from repro.kernels.flash_attention import default_config as jax_default
from repro_torch.core.families.flash_attention import FlashAttentionConfig
from repro_torch.core.families.flash_decode import FlashDecodeConfig
from repro_torch.core.verify_engine import default_engine
from repro_torch.kernels.flash_attention import (InvariantViolation,
                                                 default_config, mha,
                                                 mha_decode, mha_ref)

TOL = {"float32": 2e-5, "bfloat16": 1e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, B, Hq, Hkv, Sq, Skv, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Hq, Sq, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Skv, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Skv, D)).astype(np.float32))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


PREFILL = [
    # (Hq, Hkv, Sq, Skv, causal, blocks, dtype): GQA 1, 2 and 4; Sq !=
    # Skv, not multiples of the blocks; causal and not; bf16 and f32
    (2, 2, 24, 24, True, None, "float32"),
    (4, 2, 40, 56, True, (16, 16), "bfloat16"),
    (8, 2, 33, 20, True, (8, 8), "float32"),
    (4, 1, 17, 45, False, (16, 32), "bfloat16"),
    (2, 2, 40, 24, False, None, "float32"),
]


@pytest.mark.parametrize("case", range(len(PREFILL)))
def test_mha_matches_the_jax_kernel(case):
    Hq, Hkv, Sq, Skv, causal, blocks, dtype = PREFILL[case]
    q, k, v = _inputs(case, 1, Hq, Hkv, Sq, Skv, 16)
    cfg = FlashAttentionConfig(*blocks) if blocks else None
    got = mha(*(torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v)),
              cfg=cfg, causal=causal)
    jcfg = None
    if blocks:
        from repro.core.families.flash_attention import \
            FlashAttentionConfig as JCfg
        jcfg = JCfg(*blocks)
    want = jax_mha(*(jnp.asarray(a, JDT[dtype]) for a in (q, k, v)),
                   cfg=jcfg, causal=causal, interpret=True)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == (1, Hq, Sq, 16)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


# (Hq, Hkv, D, dtype): head_dim 96 and 48, groups 16 and 71 — the
# geometries the kernels take since they read head_dim and the group at
# run time
GEOMETRIES = [(4, 2, 96, "bfloat16"), (4, 2, 48, "float32"),
              (16, 1, 16, "bfloat16"), (71, 1, 16, "float32")]


@pytest.mark.parametrize("geom", GEOMETRIES, ids=str)
def test_mha_and_mha_decode_match_the_jax_kernels_at_every_geometry(geom):
    from repro.core.families.flash_attention import \
        FlashAttentionConfig as JCfg
    Hq, Hkv, D, dtype = geom
    q, k, v = _inputs(20 + D + Hq, 1, Hq, Hkv, 24, 40, D)
    tq, tk, tv = (torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, JDT[dtype]) for a in (q, k, v))
    got = mha(tq, tk, tv, cfg=FlashAttentionConfig(8, 8), causal=True)
    want = jax_mha(jq, jk, jv, cfg=JCfg(8, 8), causal=True, interpret=True)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == (1, Hq, 24, D)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])
    got = mha_decode(tq[:, :, :1].contiguous(), tk, tv, 33,
                     cfg=FlashDecodeConfig(4))
    want = jax_mha_decode(jq[:, :, :1], jk, jv, jnp.int32(33), cfg=None,
                          interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


DECODE = [
    # (Hq, Hkv, S, kv_len, kv_splits, dtype): kv_len < S, splits that
    # leave spans fully masked, GQA 1, 2 and 4
    (4, 2, 64, 64, 4, "bfloat16"),
    (4, 1, 64, 37, 8, "float32"),
    (2, 2, 48, 5, 3, "bfloat16"),
    (8, 2, 96, 90, None, "float32"),
]


@pytest.mark.parametrize("case", range(len(DECODE)))
def test_mha_decode_matches_the_jax_kernel(case):
    Hq, Hkv, S, kv_len, ns, dtype = DECODE[case]
    q, k, v = _inputs(10 + case, 2, Hq, Hkv, 1, S, 16)
    cfg = FlashDecodeConfig(ns) if ns else None
    got = mha_decode(*(torch.from_numpy(a).to(TDT[dtype])
                       for a in (q, k, v)), kv_len, cfg=cfg)
    jcfg = None
    if ns:
        from repro.core.families.flash_decode import \
            FlashDecodeConfig as JCfg
        jcfg = JCfg(ns)
    want = jax_mha_decode(*(jnp.asarray(a, JDT[dtype]) for a in (q, k, v)),
                          jnp.int32(kv_len), cfg=jcfg, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])
    # a kv_len given as a tensor is the same length
    again = mha_decode(*(torch.from_numpy(a).to(TDT[dtype])
                         for a in (q, k, v)),
                       torch.tensor(kv_len, dtype=torch.int32), cfg=cfg)
    assert torch.equal(got, again)


@pytest.mark.parametrize("causal", [True])
def test_backward_matches_jax_vjp(causal):
    q, k, v = _inputs(7, 1, 4, 2, 20, 28, 16)
    g = np.random.default_rng(8).normal(size=q.shape).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = mha(tq, tk, tv, cfg=FlashAttentionConfig(8, 8), causal=causal)
    out.backward(torch.from_numpy(g))
    # the JAX mha's custom_vjp backward is the vjp of its oracle; its
    # use_kernel=False path takes that vjp without tracing the
    # interpret-mode forward (held to the port's forward above)
    jout, vjp = jax.vjp(
        lambda a, b, c: jax_mha(a, b, c, causal=causal, use_kernel=False),
        *(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=2e-5, atol=2e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_the_gate_runs_before_the_kernel_and_resets_skip():
    eng = default_engine()
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 1, 2, 1, 16, 16,
                                                    16))
    before = eng.stats()["verify_calls"]
    cfg = FlashAttentionConfig(8, 8, causal_block_skip=True)
    mha(q, k, v, cfg=cfg, causal=False)
    assert eng.stats()["verify_calls"] == before + 1
    # a non-causal problem verifies the config with the skip off
    from repro_torch.core.families.flash_attention import \
        FlashAttentionProblem
    prob = FlashAttentionProblem(1, 2, 1, 16, 16, 16, False, "f32")
    assert eng._results.get(("flash_attention", FlashAttentionConfig(
        8, 8, causal_block_skip=False), prob, None)) is not None


def test_a_rejected_config_raises_before_any_launch(monkeypatch):
    """A config the gate rejects raises InvariantViolation (here a decode
    config whose spans overlap: the split_overlap bug injected into the
    family's program)."""
    import dataclasses
    from repro_torch.core.families import base
    from repro_torch.core.families.flash_decode import \
        build_flash_decode_program
    fam = base._REGISTRY["flash_decode"]
    monkeypatch.setitem(base._REGISTRY, "flash_decode", dataclasses.replace(
        fam, build_program=lambda c, p, inject_bug=None:
        build_flash_decode_program(c, p, inject_bug="split_overlap")))
    monkeypatch.setattr("repro_torch.core.verify_engine._DEFAULT", None)
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, 1, 2, 1, 1, 64, 16))
    with pytest.raises(InvariantViolation, match="KV_READ"):
        mha_decode(q, k, v, 64, cfg=FlashDecodeConfig(4))


def test_default_config_and_kv_split_rule_match_jax():
    for sq, skv in ((1, 1), (7, 300), (255, 127), (256, 128), (9000, 64)):
        assert tuple(vars(default_config(sq, skv, 64)).values()) == \
            tuple(vars(jax_default(sq, skv, 64)).values())
    # the kv_splits default steps down to a divisor of the cache, as in
    # the JAX package: S = 100 -> min(16, 100 // 128 -> 1) = 1
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, 1, 2, 1, 1, 100, 16))
    eng = default_engine()
    mha_decode(q, k, v, 100)
    from repro_torch.core.families.flash_decode import FlashDecodeProblem
    prob = FlashDecodeProblem(1, 2, 1, 100, 16, "f32")
    assert eng._results.get(("flash_decode", FlashDecodeConfig(1), prob,
                             None)) is not None


def test_the_plain_version_masks_as_the_jax_oracle():
    from repro.kernels.flash_attention import mha_ref as jax_ref
    q, k, v = _inputs(6, 2, 4, 2, 12, 30, 16)
    for causal, kv_len in ((True, None), (False, 17), (True, 9)):
        got = mha_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                      causal=causal, kv_len=kv_len)
        want = jax_ref(*(jnp.asarray(a) for a in (q, k, v)),
                       causal=causal, kv_len=kv_len)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


def test_the_stated_tolerance_catches_a_dropped_span():
    """Over 8192 keys |o| is ~0.02: a decode that lost 32 keys of one
    batch row stays inside the elementwise bound (1e-2 + 2^-7 |o|), but
    moves that row's error norm to a twelfth of its norm, which the row
    test of ``flash_error`` rejects (a sound bf16 kernel reads ~2^-8)."""
    from repro_torch.kernels.flash_attention import flash_error
    from repro_torch.kernels.flash_attention.ref import ATOL, RTOL
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(9, 2, 8, 1, 1, 8192, 128))
    want = mha_ref(q, k, v, causal=False)
    keep = torch.cat([torch.arange(4096), torch.arange(4128, 8192)])
    bad = want.clone()
    bad[1:] = mha_ref(q[1:], k[1:, :, keep], v[1:, :, keep], causal=False)
    w = want.float()
    assert bool(((bad.float() - w).abs()
                 <= ATOL[torch.bfloat16] + RTOL[torch.bfloat16] * w.abs())
                .all())
    err, row, ok = flash_error(bad, want)
    assert not ok and row > 0.05, (err, row)
    assert flash_error(want, want) == (0.0, 0.0, True)
