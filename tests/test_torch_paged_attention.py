"""Port of kernels/paged_attention: the plain PyTorch version (what the
wrapper runs on CPU tensors) against the JAX Pallas kernel in interpret
mode and the JAX dense oracle, on the same seeded numpy inputs; and the
port's concrete block-table gate against the JAX gate's decisions.

Tolerances: float32 2e-5 (the JAX kernel tests' own: the two sides sum
the same products in another order); bfloat16 outputs 1e-2, a little
above one bfloat16 step at |x| < 2 (2^-7), since each side rounds its
float32 result to bfloat16 once and may land on either neighbour."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.kernels.paged_attention import (InvariantViolation as JaxIV,
                                           paged_decode_ref as jax_ref,
                                           validate_block_tables as jax_vbt)
from repro.kernels.paged_attention import default_config as jax_default
from repro.kernels.paged_attention.paged_attention import \
    paged_decode as jax_kernel
from repro.models import build as jax_build

from repro_torch import configs as tconfigs
from repro_torch.kernels.paged_attention import (
    InvariantViolation, PagedAttentionConfig, default_config, gather_cache,
    paged_decode, paged_decode_pool, paged_decode_ref,
    validate_block_tables)
from repro_torch.models import build as torch_build

TOL = {"float32": 2e-5, "bfloat16": 1e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _case(seed, B, Hq, HK, NP, PS, D, P, lengths, table=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, 1, D)).astype(np.float32)
    kp = rng.normal(size=(P, HK, PS, D)).astype(np.float32)
    vp = rng.normal(size=(P, HK, PS, D)).astype(np.float32)
    if table is None:
        table = rng.integers(1, P, size=(B, NP))
    return (q, kp, vp, np.asarray(table, np.int32),
            np.asarray(lengths, np.int32))


def _both(case, dtype):
    q, kp, vp, table, lengths = case
    jx = [jnp.asarray(a, JDT[dtype]) for a in (q, kp, vp)]
    tx = [torch.from_numpy(a).to(TDT[dtype]) for a in (q, kp, vp)]
    return (jx + [jnp.asarray(table), jnp.asarray(lengths)],
            tx + [torch.from_numpy(table), torch.from_numpy(lengths)])


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,HK", [(2, 2), (4, 2), (8, 2)])
def test_plain_version_matches_pallas_kernel_and_oracle(dtype, Hq, HK):
    """Ragged lengths across G = 1, 2, 4: zero-length (inactive) row,
    mid-page, exact page boundary, boundary + 1, full span."""
    B, NP, PS, D, P = 5, 4, 8, 16, 12
    case = _case(0, B, Hq, HK, NP, PS, D, P,
                 [0, 5, PS * 2, PS * 2 + 1, NP * PS])
    (jq, jk, jv, jt, jl), (tq, tk, tv, tt, tl) = _both(case, dtype)
    got = paged_decode(tq, tk, tv, tt, tl)
    assert got.dtype == TDT[dtype] and got.shape == (B, Hq, 1, D)
    kern = jax_kernel(jq, jk, jv, jt, jl, cfg=jax_default(NP),
                      interpret=True)
    oracle = jax_ref(jq, jk, jv, jt, jl)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(kern), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), rtol=tol, atol=tol)
    assert float(got[0].abs().max()) == 0.0     # length 0: exact zeros


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_null_pages_and_poisoned_pages_never_reach_the_output(dtype):
    """Rows mapping the null page past their length, and every page the
    lengths say is unreadable poisoned with 1e6: bit-identical output."""
    B, Hq, HK, NP, PS, D, P = 2, 4, 2, 4, 8, 16, 10
    table = [[1, 2, 0, 0], [3, 4, 5, 0]]
    case = _case(1, B, Hq, HK, NP, PS, D, P, [PS + 3, 3 * PS], table)
    q, kp, vp, t, lens = case
    kp2, vp2 = kp.copy(), vp.copy()
    for pg in (0, 6, 7, 8, 9):
        kp2[pg] = 1e6
        vp2[pg] = 1e6
    kp2[2, :, 3:] = 1e6        # row 0's last page beyond its length
    vp2[2, :, 3:] = 1e6
    (_, _, _, jt, jl), (tq, tk, tv, tt, tl) = _both(case, dtype)
    clean = paged_decode(tq, tk, tv, tt, tl)
    _, (_, tk2, tv2, _, _) = _both((q, kp2, vp2, t, lens), dtype)
    poisoned = paged_decode(tq, tk2, tv2, tt, tl)
    assert torch.equal(clean, poisoned)
    jq, jk, jv = (jnp.asarray(a, JDT[dtype]) for a in (q, kp, vp))
    want = jax_kernel(jq, jk, jv, jt, jl, cfg=jax_default(NP),
                      interpret=True)
    np.testing.assert_allclose(_np(clean), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_pool_entry_and_default_config_match_jax():
    B, Hq, HK, NP, PS, D, P = 3, 4, 2, 6, 8, 16, 20
    case = _case(2, B, Hq, HK, NP, PS, D, P, [7, 0, 40])
    (jq, jk, jv, jt, jl), (tq, tk, tv, tt, tl) = _both(case, "float32")
    got = paged_decode_pool(tq, {"k": tk, "v": tv}, tt, tl)
    np.testing.assert_allclose(_np(got), _np(jax_ref(jq, jk, jv, jt, jl)),
                               rtol=2e-5, atol=2e-5)
    for n in range(1, 33):
        assert default_config(n).block_pages == jax_default(n).block_pages
    # the gate rejects a config that does not tile the table, as the JAX
    # gate does; the kernel's wrapper alone raises on it too
    with pytest.raises(InvariantViolation, match="block_pages"):
        paged_decode(tq, tk, tv, tt, tl,
                     cfg=PagedAttentionConfig(block_pages=4))
    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_decode as kernel_wrapper
    with pytest.raises(ValueError, match="block_pages"):
        kernel_wrapper(tq, tk, tv, tt, tl,
                       cfg=PagedAttentionConfig(block_pages=4))


def test_gather_cache_matches_jax():
    from repro.kernels.paged_attention import gather_cache as jax_gather
    rng = np.random.default_rng(0)
    pages = rng.normal(size=(6, 2, 4, 8)).astype(np.float32)
    table = np.asarray([[4, 0, 2], [1, 5, 3]], np.int32)
    got = gather_cache(torch.from_numpy(pages), torch.from_numpy(table))
    want = jax_gather(jnp.asarray(pages), jnp.asarray(table))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_oracle_without_lengths_matches_jax():
    case = _case(3, 2, 4, 2, 3, 8, 16, 9, [0, 0])
    (jq, jk, jv, jt, _), (tq, tk, tv, tt, _) = _both(case, "float32")
    np.testing.assert_allclose(_np(paged_decode_ref(tq, tk, tv, tt)),
                               _np(jax_ref(jq, jk, jv, jt)),
                               rtol=2e-5, atol=2e-5)


# -- the concrete block-table gate (cases of tests/test_serving.py) ----------

_OK = np.array([[1, 2, 0, 0], [3, 0, 0, 0]], np.int32)
_GATE_CASES = [
    # (tables, kwargs)
    (np.array([[0, 7]], np.int32), dict(page_size=8, pool_pages=4)),
    (np.array([[0, 1]], np.int32), dict(page_size=8, pool_pages=4)),
    (_OK, dict(page_size=8, pool_pages=8, lengths=np.array([16, 8]))),
    (_OK, dict(page_size=8, pool_pages=8, lengths=np.array([17, 8]))),
    (_OK, dict(page_size=8, pool_pages=8, lengths=np.array([16, 0]))),
    (np.array([[1, 0, 2, 0]], np.int32),
     dict(page_size=8, pool_pages=8, lengths=np.array([16]))),
    (_OK, dict(page_size=8, pool_pages=8, lengths=np.array([16]))),
    (np.array([[1, 2], [0, 0]], np.int32),
     dict(page_size=8, pool_pages=8, lengths=np.array([9, 0]))),
    (np.array([[-1, 2]], np.int32), dict(page_size=8, pool_pages=8)),
]


def _verdict(fn, exc, tables, model, kw):
    try:
        cfg = fn(tables, model=model, **kw)
    except exc as e:
        return ("reject", str(e))
    return ("accept", None if cfg is None else cfg.block_pages)


@pytest.mark.parametrize("case", range(len(_GATE_CASES)))
@pytest.mark.parametrize("with_model", [True, False])
def test_block_table_gate_decides_as_jax(case, with_model):
    tables, kw = _GATE_CASES[case]
    name = "qwen3-1.7b"
    jm = jax_build(jconfigs.get_reduced(name)) if with_model else None
    tm = torch_build(tconfigs.get_reduced(name)) if with_model else None
    want = _verdict(jax_vbt, JaxIV, tables, jm, kw)
    got = _verdict(validate_block_tables, InvariantViolation, tables, tm, kw)
    assert got == want
