"""Port of the SSD family's kernel module (``repro_torch.kernels.ssd``)
against the JAX package on the same seeded numpy inputs, the Pallas
kernel in interpret mode: ``ssd`` (the plain version on the CPU) and
``ssd_ref`` with its final state.  The port's gate and loop on the
family: ``test_torch_gate_quant_ssd.py``; the model that uses it:
``test_torch_model_ssm.py``; the CUDA kernel on the card:
``test_torch_cuda.py``.

Inputs are made as the JAX tests make them: x ~ N(0, 1), da =
−|N(0, 1)|·0.1, B and C ~ 0.3·N(0, 1).  Tolerance: the kernel's own
rule, written once beside ``ssd_error`` in
``repro_torch/kernels/ssd/ref.py`` (float32: 1e-4·|y| plus 1e-4 of the
largest |y| per element, and 2e-4 of each row's norm; bfloat16: one
bfloat16 step of each value more), since
the plain version the CPU runs is what the CUDA kernel is held to on
the card; both sides compute in float32 and differ in the order of
their sums."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core.families.ssd import SSDConfig as JaxConfig
from repro.kernels import ssd as jssd

from repro_torch.core.families.ssd import SSDConfig
from repro_torch.kernels.ssd import (KERNEL, InvariantViolation, ssd,
                                     ssd_chunk_scan, ssd_error, ssd_ref)


def _inputs(BH, S, P, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(BH, S, P)).astype(np.float32),
            (-np.abs(rng.normal(size=(BH, S))) * .1).astype(np.float32),
            (rng.normal(size=(BH, S, N)) * .3).astype(np.float32),
            (rng.normal(size=(BH, S, N)) * .3).astype(np.float32))


def _cases():
    """Seeded (BH, S, P, N, chunk): chunks 16 to 128, one chunk and
    many, P and N not multiples of 16."""
    rng = np.random.default_rng(7)
    out = [(2, 256, 32, 16, 64), (1, 64, 16, 8, 64), (3, 96, 24, 12, 32)]
    while len(out) < 8:
        q = int(rng.choice((16, 32, 64, 128)))
        out.append((int(rng.integers(1, 4)), q * int(rng.integers(1, 5)),
                    int(rng.choice((8, 16, 32))),
                    int(rng.choice((8, 16))), q))
    return out


@pytest.mark.parametrize("case", _cases(), ids=str)
def test_ssd_and_its_plain_version_match_the_jax_package(case):
    BH, S, P, N, q = case
    arrs = _inputs(BH, S, P, N, sum(case))
    want = jssd.ssd(*map(jnp.asarray, arrs), cfg=JaxConfig(chunk=q),
                    interpret=True)
    want_ref, want_state = jssd.ssd_ref(*map(jnp.asarray, arrs), q)
    ts = [torch.from_numpy(a) for a in arrs]
    before = KERNEL.launches
    got = ssd(*ts, cfg=SSDConfig(chunk=q))
    assert KERNEL.launches == before
    back = lambda v: torch.from_numpy(np.array(v))
    assert ssd_error(got, back(want))[2], ssd_error(got, back(want))
    ref, state = ssd_ref(*ts, q)
    assert ssd_error(ref, back(want_ref))[2]
    assert state.shape == (BH, N, P) and state.dtype == torch.float32
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state),
                               rtol=1e-4, atol=1e-4)


def test_ssd_in_bfloat16_matches_the_jax_package():
    """x, B and C in bfloat16 (da float32): both compute in float32 and
    round y to bfloat16 once."""
    arrs = _inputs(2, 128, 32, 16, 3)
    jx = [jnp.asarray(a, jnp.bfloat16) if i != 1 else jnp.asarray(a)
          for i, a in enumerate(arrs)]
    want = jssd.ssd(*jx, cfg=JaxConfig(chunk=32), interpret=True)
    ts = [torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))
          for a in jx]
    ts = [t.bfloat16() if i != 1 else t for i, t in enumerate(ts)]
    got = ssd(*ts, cfg=SSDConfig(chunk=32))
    assert got.dtype == torch.bfloat16
    want_t = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    assert ssd_error(got, want_t.bfloat16())[2]


def test_the_default_chunk_is_the_jax_default():
    arrs = [torch.from_numpy(a) for a in _inputs(1, 64, 16, 8, 0)]
    assert torch.equal(ssd(*arrs), ssd_ref(*arrs, 64)[0])
    arrs = [torch.from_numpy(a) for a in _inputs(1, 256, 16, 8, 0)]
    assert torch.equal(ssd(*arrs), ssd_ref(*arrs, 128)[0])


def test_s_not_a_multiple_of_the_chunk_raises_as_in_jax():
    arrs = _inputs(1, 100, 16, 8, 1)
    with pytest.raises(ValueError, match="must divide chunk"):
        jssd.ssd(*map(jnp.asarray, arrs), cfg=JaxConfig(chunk=64),
                 interpret=True)
    ts = [torch.from_numpy(a) for a in arrs]
    with pytest.raises(ValueError, match="must divide chunk"):
        ssd(*ts, cfg=SSDConfig(chunk=64))
    with pytest.raises(ValueError, match="must divide chunk"):
        ssd_chunk_scan(*ts, cfg=SSDConfig(chunk=64))


def test_an_injected_chunk_bug_is_rejected_before_the_kernel(monkeypatch):
    """The gate sits in front of the kernel: a config the engine rejects
    raises InvariantViolation and the wrapper never runs."""
    from repro_torch.core import verify_engine
    from repro_torch.kernels.ssd import ops
    real = verify_engine.default_engine().verify
    monkeypatch.setattr(
        verify_engine.default_engine(), "verify",
        lambda fam, cfg, prob, **kw: real(fam, cfg, prob,
                                          inject_bug="b_chunk_offset"))
    called = []
    monkeypatch.setattr(ops, "ssd_chunk_scan",
                        lambda *a, **k: called.append(1))
    arrs = [torch.from_numpy(a) for a in _inputs(1, 128, 16, 8, 2)]
    with pytest.raises(InvariantViolation, match="ARGUS rejected"):
        ssd(*arrs, cfg=SSDConfig(chunk=32))
    assert not called


def test_the_stated_tolerance_catches_a_lost_state_or_a_wrong_chunk():
    """A kernel that resets the carried state at each chunk, or scans at
    another chunk than the gate verified, fails ``ssd_error``."""
    x, da, B, C = (torch.from_numpy(a) for a in _inputs(2, 256, 32, 16, 9))
    want = ssd_ref(x, da, B, C, 64)[0]
    assert ssd_error(want.clone(), want)[2]
    per_chunk = torch.cat([ssd_ref(x[:, i:i + 64], da[:, i:i + 64],
                                   B[:, i:i + 64], C[:, i:i + 64], 64)[0]
                           for i in range(0, 256, 64)], dim=1)
    assert not ssd_error(per_chunk, want)[2]
    # another chunk is the same function: the scan's result is chunk-free
    assert ssd_error(ssd_ref(x, da, B, C, 32)[0], want)[2]
    shifted = want.roll(1, dims=1)
    assert not ssd_error(shifted, want)[2]


def test_the_float64_reference_stands_where_a_row_cancels():
    """``ssd_ref(..., acc=torch.float64)`` is the same function (within
    ``ssd_error`` of the float32 reference and of the JAX one on seeded
    inputs); on a row whose terms cancel (the first row, (C_0·B_0) x_0
    with no state carried in, C_0·B_0 a millionth of the sum of its 130 products' sizes) the float32
    reference's own rounding breaks the row rule, which is why the card's
    checks of the kernel read the float64 one."""
    arrs = _inputs(2, 128, 16, 130, 5)
    x, da, B, C = (torch.from_numpy(a) for a in arrs)
    r32 = ssd_ref(x, da, B, C, 64)[0]
    r64, st64 = ssd_ref(x, da, B, C, 64, acc=torch.float64)
    assert r64.dtype == torch.float32 and st64.dtype == torch.float64
    assert ssd_error(r32, r64)[2]
    jax_ref = torch.from_numpy(np.array(jssd.ssd_ref(
        *map(jnp.asarray, arrs), 64)[0]))
    assert ssd_error(r64, jax_ref)[2]
    b, c = B[0, 0].double(), C[0, 0].double()
    i = int(c.abs().argmax())
    rest = (b * c).sum() - b[i] * c[i]
    b[i] = (1e-6 * (b * c).abs().sum() - rest) / c[i]
    B[0, 0] = b.float()
    r64 = ssd_ref(x, da, B, C, 64, acc=torch.float64)[0]
    err, row, ok = ssd_error(ssd_ref(x, da, B, C, 64)[0], r64)
    assert not ok and row > 2e-4, (err, row)
