"""Port of the quantized GEMM family's kernel module
(``repro_torch.kernels.quant_gemm``) against the JAX package on the same
seeded numpy inputs, the Pallas kernel in interpret mode.  The port's
gate and loop on the family: ``test_torch_gate_quant_ssd.py``; the CUDA
kernel against its plain version on the card: ``test_torch_cuda.py``.

Tolerances:
  * ``quantize_per_group``: bit-identical (the same float32 operations,
    each correctly rounded; ``torch.round`` and ``np.rint`` both round
    half to even);
  * ``quant_matmul``: the kernel's own rule, written once beside
    ``quant_error`` in ``repro_torch/kernels/quant_gemm/ref.py``
    (float32: 2e-5 of the largest |output|; bfloat16 output: one
    bfloat16 step of each value more), since the plain version the CPU
    runs is what the CUDA kernel is held to on the card.  The JAX
    kernel sums exact int32 partials scaled per K tile, the plain
    version dequantised float32 products: the same numbers rounded at
    other places."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core.families.quant_gemm import QuantGemmConfig as JaxConfig
from repro.core.verify_engine import VerificationEngine as JaxEngine
from repro.kernels import quant_gemm as jq

from repro_torch.core.families.quant_gemm import QuantGemmConfig
from repro_torch.kernels.quant_gemm import (InvariantViolation, KERNEL,
                                            default_config, quant_error,
                                            quant_gemm, quant_gemm_ref,
                                            quant_matmul,
                                            quantize_per_group)


def _inputs(rng, m, n, k, group, zero_group=False):
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    if zero_group:
        a[:, :group] = 0          # every row's first group all zero
        b[:, 0] = 0
    return a, b


@pytest.mark.parametrize("shape,group,axis,zero", [
    ((64, 256), 128, 1, False),
    ((37, 300), 128, 1, False),       # K not a multiple of the group
    ((300, 45), 64, 0, False),
    ((16, 96), 32, 1, True),          # all-zero groups: scale 1.0
    ((96, 8), 32, 0, True),
    ((5, 7, 130), 128, 2, False),     # a third axis, ragged
])
def test_quantize_per_group_is_bit_identical(shape, group, axis, zero):
    rng = np.random.default_rng(sum(shape) + group)
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    if zero:
        idx = [slice(None)] * len(shape)
        idx[axis] = slice(0, group)
        x[tuple(idx)] = 0
    jqv, jsv = jq.quantize_per_group(x, group, axis=axis)
    tqv, tsv = quantize_per_group(torch.from_numpy(x), group, axis=axis)
    assert tqv.dtype == torch.int8 and tsv.dtype == torch.float32
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(tsv.numpy(), np.asarray(jsv))
    if zero:
        assert (tsv.numpy() == 1.0).any()
    # a numpy array goes in as it is
    nqv, nsv = quantize_per_group(x, group, axis=axis)
    assert torch.equal(nqv, tqv) and torch.equal(nsv, tsv)


def _cases():
    """Seeded (m, n, k, group, bm, bn, bk) with bk | group: tiles 32 to
    128, ragged m, n and k (k not a multiple of the group)."""
    rng = np.random.default_rng(11)
    out = [(64, 128, 256, 128, 32, 64, 64),
           (100, 70, 300, 128, 32, 128, 64),   # ragged everything
           (32, 32, 64, 32, 32, 32, 32)]       # one group per K tile
    while len(out) < 8:
        group = int(rng.choice((32, 64, 128)))
        bk = int(rng.choice([b for b in (32, 64, 128) if group % b == 0]))
        out.append((int(rng.integers(1, 4)) * 32 + int(rng.integers(0, 9)),
                    int(rng.integers(1, 4)) * 32,
                    int(rng.integers(1, 4)) * group
                    + int(rng.choice((0, 16))),
                    group, int(rng.choice((32, 64))),
                    int(rng.choice((32, 64, 128))), bk))
    return out


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", _cases(), ids=str)
def test_quant_matmul_matches_the_jax_kernel(case, out_dtype):
    m, n, k, group, bm, bn, bk = case
    rng = np.random.default_rng(m * n + k)
    a, b = _inputs(rng, m, n, k, group)
    aq, sa = jq.quantize_per_group(a, group, axis=1)
    bq, sb = jq.quantize_per_group(b, group, axis=0)
    want = jq.quant_matmul(aq, bq, sa, sb, group=group,
                           cfg=JaxConfig(bm, bn, bk),
                           out_dtype=getattr(jnp, out_dtype),
                           interpret=True)
    t = lambda v: torch.from_numpy(np.array(v))
    dt = getattr(torch, out_dtype)
    before = KERNEL.launches
    got = quant_matmul(t(aq), t(bq), t(sa), t(sb), group=group,
                       cfg=QuantGemmConfig(bm, bn, bk), out_dtype=dt)
    assert KERNEL.launches == before          # the CPU runs no kernel
    assert got.dtype == dt and got.shape == (m, n)
    want_t = torch.from_numpy(np.array(want, np.float32)).to(dt)
    err, ok = quant_error(got, want_t)
    assert ok, err
    # and against the port's plain version, which it is on the CPU
    assert torch.equal(got, quant_gemm_ref(t(aq), t(bq), t(sa), t(sb),
                                           group=group, out_dtype=dt))


def test_default_config_is_the_jax_rule():
    for m, n, k, group in ((8192, 8192, 8192, 128), (17, 64, 300, 100),
                           (1, 4, 64, 96), (200, 33, 512, 256),
                           (64, 64, 64, 48)):
        got = default_config(m, n, k, group)
        want = jq.default_config(m, n, k, group)
        assert (got.bm, got.bn, got.bk, got.precision) == \
            (want.bm, want.bn, want.bk, want.precision)


def test_bk_not_dividing_the_group_raises_as_in_jax():
    """The gate rejects the config (its program cannot be built: each K
    tile needs one scale); the wrapper refuses it before any launch."""
    rng = np.random.default_rng(3)
    a, b = _inputs(rng, 64, 64, 256, 128)
    aq, sa = quantize_per_group(torch.from_numpy(a), 128, axis=1)
    bq, sb = quantize_per_group(torch.from_numpy(b), 128, axis=0)
    with pytest.raises(InvariantViolation, match="ARGUS rejected"):
        quant_matmul(aq, bq, sa, sb, group=128,
                     cfg=QuantGemmConfig(bk=96))
    with pytest.raises(ValueError, match="must divide the scale group"):
        quant_gemm(aq, bq, sa, sb, group=128, cfg=QuantGemmConfig(bk=96))
    from repro.kernels.quant_gemm.ops import \
        InvariantViolation as JaxViolation
    with pytest.raises(JaxViolation, match="ARGUS rejected"):
        jq.quant_matmul(*(jnp.asarray(v.numpy())
                          for v in (aq, bq, sa, sb)),
                        group=128, cfg=JaxConfig(bk=96), interpret=True)
    res = JaxEngine().verify("quant_gemm", JaxConfig(bk=96),
                             jq.ops.QuantGemmProblem(64, 64, 256, 128))
    assert res.build_error is not None


def test_an_fp8_problem_passes_the_gate_and_the_kernel_refuses_it():
    a = torch.zeros(32, 64).to(torch.float8_e4m3fn)
    b = torch.zeros(64, 32).to(torch.float8_e4m3fn)
    sa, sb = torch.ones(32, 1), torch.ones(1, 32)
    with pytest.raises(TypeError, match="int8"):
        quant_matmul(a, b, sa, sb, group=64,
                     cfg=QuantGemmConfig(32, 32, 32))


def test_wrapper_refuses_wrong_scale_shapes():
    aq = torch.zeros(32, 256, dtype=torch.int8)
    bq = torch.zeros(256, 32, dtype=torch.int8)
    with pytest.raises(ValueError, match="scales"):
        quant_gemm(aq, bq, torch.ones(32, 1), torch.ones(2, 32), group=128)


def test_the_stated_tolerance_catches_a_scale_of_the_wrong_group():
    """A kernel that applies the next K-group's scales, or drops one
    group's partial, lands far outside ``quant_error``."""
    rng = np.random.default_rng(5)
    a, b = _inputs(rng, 128, 128, 1024, 128)
    aq, sa = quantize_per_group(torch.from_numpy(a), 128, axis=1)
    bq, sb = quantize_per_group(torch.from_numpy(b), 128, axis=0)
    want = quant_gemm_ref(aq, bq, sa, sb, group=128)
    assert quant_error(want.clone(), want)[1]
    shifted = quant_gemm_ref(aq, bq, sa.roll(1, dims=1), sb, group=128)
    assert not quant_error(shifted, want)[1]
    dropped = quant_gemm_ref(aq[:, 128:], bq[128:], sa[:, 1:], sb[1:],
                             group=128)
    assert not quant_error(dropped, want)[1]
    assert not quant_error(want.bfloat16(), want.bfloat16() * 1.02)[1]
