"""The port's two serving gates against the JAX package's at the other
decoder-only architectures' full-width serving geometries, and the model
builder over every architecture the port carries.

The paged-decode gate (``validate_block_tables``) on an 8-row table of
128 pages of 16 tokens over a 768-page pool — ``chip_smoke.py``'s serve
phase — and the packed-prefill gate (``verified_config``) on packed
geometries that phase makes, at (query heads, KV heads, head_dim) of
stablelm-3b (32/32 x 80), gemma-7b (16/16 x 256), codeqwen1.5-7b (32/32
x 128) and chameleon-34b (64/8 x 128), group sizes 1 and 8, bf16 and
float32: both admit, with the same config, or both refuse.
deepseek-v2-lite-16b's MLA cache has no head mapping, so both gates
apply the concrete block-table checks only (a page outside the pool is
refused) and return no config."""
import dataclasses

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.kernels.paged_attention.ops import (
    InvariantViolation as JaxViolation, validate_block_tables as jax_paged)
from repro.kernels.ragged_prefill.ops import verified_config as jax_ragged
from repro.models import build as jax_build

from repro_torch import configs as tconfigs
from repro_torch.core.verify_engine import InvariantViolation
from repro_torch.kernels.paged_attention.ops import validate_block_tables
from repro_torch.kernels.ragged_prefill.ops import verified_config
from repro_torch.models import build as torch_build

HEADS = {"stablelm-3b": (32, 32, 80), "gemma-7b": (16, 16, 256),
         "codeqwen1.5-7b": (32, 32, 128), "chameleon-34b": (64, 8, 128)}
NEW_ARCHS = ["codeqwen1.5-7b", "stablelm-3b", "gemma-7b", "chameleon-34b",
             "deepseek-v2-lite-16b"]


def _table(pool_pages=768):
    t = np.zeros((8, 128), np.int32)
    t[0, :40] = np.arange(1, 41)
    t[3, :7] = np.arange(300, 307)
    t[7, :128] = np.arange(pool_pages - 128, pool_pages)
    return t


def _verdict(fn, violation, *args, **kw):
    try:
        cfg = fn(*args, **kw)
    except violation:
        return "refused"
    return dataclasses.asdict(cfg) if cfg is not None else None


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("arch", list(HEADS))
def test_paged_decode_gates_agree_at_full_width(arch, dtype):
    """The serving geometry is admitted on both sides at every head
    dim; a table that maps the page past the pool is refused on both."""
    H, K, D = HEADS[arch]
    geo = dict(page_size=16, pool_pages=768, q_heads=H, kv_heads=K,
               head_dim=D, dtype=dtype)
    want = _verdict(jax_paged, JaxViolation, _table(), **geo)
    got = _verdict(validate_block_tables, InvariantViolation, _table(),
                   **geo)
    assert want == got != "refused"
    bad = _table()
    bad[5, 0] = 768
    assert _verdict(jax_paged, JaxViolation, bad, **geo) == "refused"
    assert _verdict(validate_block_tables, InvariantViolation, bad,
                    **geo) == "refused"


# (packed queries, packed keys, sequences): a chunk alone, a half tick,
# phase 4's full tick of 8 chunks against their prefixes, a buffer the
# blocks cannot tile
PACKED = [(192, 192, 1), (1024, 2048, 4), (2048, 5120, 8), (2048, 3072, 8),
          (100, 200, 2)]


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("arch", list(HEADS))
def test_packed_prefill_gates_agree_at_full_width(arch, dtype):
    H, K, D = HEADS[arch]
    for TQ, TK, n in PACKED:
        want = jax_ragged(TQ, TK, n, q_heads=H, kv_heads=K, head_dim=D,
                          dtype=dtype)
        got = verified_config(TQ, TK, n, q_heads=H, kv_heads=K, head_dim=D,
                              dtype=dtype)
        assert (None if want is None else dataclasses.asdict(want)) == \
            (None if got is None else dataclasses.asdict(got)), (TQ, TK, n)
        assert (got is None) == (TQ == 100)


def test_mla_gets_the_range_check_only_on_both_sides():
    jm = jax_build(jconfigs.get_config("deepseek-v2-lite-16b"))
    tm = torch_build(tconfigs.get_config("deepseek-v2-lite-16b"))
    lengths = np.zeros(8, np.int32)
    lengths[[0, 3, 7]] = (40 * 16, 7 * 16 - 5, 128 * 16)
    for model, fn, violation in ((jm, jax_paged, JaxViolation),
                                 (tm, validate_block_tables,
                                  InvariantViolation)):
        assert fn(_table(), model=model, page_size=16, pool_pages=768,
                  lengths=lengths) is None
        with pytest.raises(violation, match="outside"):
            fn(_table(), model=model, page_size=16, pool_pages=700)
        short = lengths.copy()
        short[0] -= 16
        with pytest.raises(violation, match="maps 40 pages"):
            fn(_table(), model=model, page_size=16, pool_pages=768,
               lengths=short)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_every_new_architecture_builds_as_in_jax(arch, reduced):
    get = "get_reduced" if reduced else "get_config"
    tcfg, jcfg = getattr(tconfigs, get)(arch), getattr(jconfigs, get)(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    tm, jm = torch_build(tcfg), jax_build(jcfg)
    assert type(tm).__name__ == type(jm).__name__ == "TransformerLM"
    assert (tm.n_params, tm.n_active_params) == \
        (jm.n_params, jm.n_active_params)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ["recurrentgemma-2b",
                                  "seamless-m4t-large-v2"])
def test_the_hybrid_and_encdec_architectures_build_as_in_jax(arch, reduced):
    get = "get_reduced" if reduced else "get_config"
    tcfg, jcfg = getattr(tconfigs, get)(arch), getattr(jconfigs, get)(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    tm, jm = torch_build(tcfg), jax_build(jcfg)
    assert type(tm).__name__ == type(jm).__name__
    assert (tm.n_params, tm.n_active_params) == \
        (jm.n_params, jm.n_active_params)


def test_the_registry_carries_every_jax_architecture():
    assert set(tconfigs.ARCH_NAMES) == set(jconfigs.ARCH_NAMES)
