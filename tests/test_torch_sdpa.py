"""The port's ``sdpa`` (``repro_torch.models.components``) against the JAX
package's ``sdpa`` on the same seeded numpy q/k/v: the direct path below
1,024 query tokens and the KV-block scan at or above it (KV padded to a
multiple of 512 with sentinel positions), causal or not, with and
without a sliding window, GQA groups 1, 4 and 10, (Skv,) and (B, Skv)
KV positions, an MLA-shaped V narrower than q/k, float32 and bfloat16.

Tolerances: float32 within 2e-6 absolute plus 2e-6 of the value (both
sides sum the same float32 products in another order; outputs are of
size ~1).  bfloat16 within one bfloat16 step of JAX's value plus that
float32 tolerance (each side rounds its float32 result to bfloat16 once;
the float32 term covers outputs that cancel to ~1e-8, where a step of
the value is far below the float32 sums' own error).  On the scan path
both sides also round p to bfloat16 before P·V, and where the two exps
differ in their last float32 bit a p lands on the other bfloat16
neighbour: a few outputs in 10^5 then move by up to 2^-7 of max |v|
(one step of p is at most 2^-7 of p, and the p's of a row sum to 1).
There, at most 5e-4 of the outputs may exceed the step, and none that
bound."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.models import components as jcomp
from repro_torch.models import components as tcomp

JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (query heads, KV heads): GQA groups 1, 4 and 10 (recurrentgemma's MQA)
HEADS = {1: (2, 2), 4: (8, 2), 10: (10, 1)}
# KV lengths: none a multiple of the scan's 512-token block
SKV = {1: 700, 24: 600, 1024: 1100, 1100: 1100}


def _inputs(seed, B, Hq, Hkv, Sq, Skv, D, Dv=None):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Hq, Sq, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Skv, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Skv, Dv or D)).astype(np.float32))


def _both(q, k, v, dtype, **kw):
    """(JAX's output, the port's) as float32 numpy; positions in ``kw``
    are numpy arrays."""
    jkw = {n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    tkw = {n: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    jo = jcomp.sdpa(*(jnp.asarray(a, JAX_DT[dtype]) for a in (q, k, v)),
                    **jkw)
    to = tcomp.sdpa(*(torch.from_numpy(a).to(TORCH_DT[dtype])
                      for a in (q, k, v)), **tkw)
    assert to.dtype == TORCH_DT[dtype] and tuple(to.shape) == jo.shape
    return np.asarray(jo.astype(jnp.float32)), to.float().numpy()


def _close(got, want, dtype, v=None):
    """``v``: the scan path's V, whose bfloat16 p rounding allows the
    few flips the module docstring bounds."""
    d = np.abs(got - want)
    tol = 2e-6 + 2e-6 * np.abs(want)
    if dtype == "bfloat16":
        # one bfloat16 step at |want|: 2^(e-8) for |want| in [2^(e-1), 2^e)
        e = np.frexp(np.abs(want))[1]
        tol = tol + np.where(want == 0, 0.0, np.ldexp(1.0, e - 8))
    bad = d > tol
    if dtype == "bfloat16" and v is not None:
        flip = 2.0 ** -7 * np.abs(v).max()
        assert bad.mean() <= 5e-4, (f"{bad.sum()} of {bad.size} outputs "
                                    "beyond one bfloat16 step")
        bad = d > tol + flip
    assert not bad.any(), (f"{bad.sum()} of {bad.size} outputs off, max "
                           f"|port - jax| {d.max()}")


def _scan_v(Sq, v, dtype):
    """V as the scan path rounds it, where it takes that path."""
    if Sq < tcomp.FLASH_SDPA_THRESHOLD or dtype != "bfloat16":
        return None
    return np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 32, 256])
@pytest.mark.parametrize("Sq", [1, 24, 1024, 1100])
def test_sdpa_matches_jax(Sq, window, causal, dtype):
    """Both sides of FLASH_SDPA_THRESHOLD; the queries sit at the end of
    the KV range (at 1100 = Skv, the default positions)."""
    g = {0: 1, 32: 4, 256: 10}[window]
    Hq, Hkv = HEADS[g]
    Skv = SKV[Sq]
    q, k, v = _inputs(Sq + window, 1, Hq, Hkv, Sq, Skv, 16)
    kw = dict(causal=causal, window=window)
    if Sq != Skv:
        kw["q_positions"] = np.arange(Skv - Sq, Skv)
    want, got = _both(q, k, v, dtype, **kw)
    _close(got, want, dtype, _scan_v(Sq, v, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq", [1, 1024])
def test_per_row_kv_positions_match_jax(Sq, dtype):
    """(B, Skv) KV positions, as a decode ring holds them: each row's
    own permutation, some keys past the query (masked), a window."""
    B, Skv = 2, 900
    q, k, v = _inputs(5 + Sq, B, 8, 2, Sq, Skv, 16)
    rng = np.random.default_rng(6)
    kv_pos = np.stack([rng.permutation(Skv) for _ in range(B)])
    q_pos = np.stack([np.arange(Sq) + 700, np.arange(Sq) + 300])
    want, got = _both(q, k, v, dtype, causal=True, window=256,
                      q_positions=q_pos, kv_positions=kv_pos)
    _close(got, want, dtype, _scan_v(Sq, v, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq", [24, 1100])
def test_mla_shaped_v_matches_jax(Sq, dtype):
    """q/k of 24 channels (16 nope + 8 rope), V of 16, the MLA scale."""
    q, k, v = _inputs(7 + Sq, 1, 4, 4, Sq, 1100, 24, Dv=16)
    want, got = _both(q, k, v, dtype, causal=True, scale=24 ** -0.5,
                      q_positions=np.arange(1100 - Sq, 1100))
    assert got.shape[-1] == 16
    _close(got, want, dtype, _scan_v(Sq, v, dtype))


@pytest.mark.parametrize("Sq", [24, 1024])
def test_a_fully_masked_row_gives_what_jax_gives(Sq):
    """Queries at negative positions see no key: the direct path gives
    the mean of V (a softmax over -1e30 everywhere), the scan zeros (its
    l == 0 is set to 1), in both packages."""
    q, k, v = _inputs(9, 1, 4, 2, Sq, 600, 16)
    q_pos = np.arange(Sq) - 3               # rows 0..2 fully masked
    want, got = _both(q, k, v, "float32", causal=True, q_positions=q_pos)
    _close(got, want, "float32")
    masked = got[0, :, :3]                  # (heads, 3 rows, D)
    if Sq < tcomp.FLASH_SDPA_THRESHOLD:
        mean_v = np.repeat(v.mean(axis=2), 2, axis=1)[0]   # (Hq, D)
        np.testing.assert_allclose(masked, np.repeat(mean_v[:, None], 3, 1),
                                   rtol=1e-5, atol=1e-6)
    else:
        assert not masked.any() and not want[0, :, :3].any()
    assert np.abs(got[0, :, 3:]).max() > 0


def test_the_dispatch_threshold_and_block_are_jax_s():
    assert tcomp.FLASH_SDPA_THRESHOLD == jcomp.FLASH_SDPA_THRESHOLD == 1024
    assert tcomp.SDPA_KV_CHUNK == jcomp.SDPA_KV_CHUNK == 512
    assert tcomp._PAD_SENTINEL == jcomp._PAD_SENTINEL
