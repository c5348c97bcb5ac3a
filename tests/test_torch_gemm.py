"""The port's GEMM module (``repro_torch.kernels.gemm``) against the JAX
package's (``repro.kernels.gemm``, its Pallas kernel in interpret mode),
on the same seeded numpy inputs.  On CPU tensors the port's ``matmul``
runs the kernel's plain version.

Tolerances: float32 rtol 1e-5 with an absolute 1e-5 of the largest
output (the same products summed in another order: the rounding is of
the partial sums, which are of the output's scale, so an output near
zero keeps only an absolute bound); bfloat16 one bfloat16 step of the
output (both round a float32 sum to bfloat16 once, and may land on
neighbouring values)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import gemm as jgemm
from repro.core.families.gemm import GemmConfig as JaxConfig
from repro_torch.core.families.gemm import GemmConfig
from repro_torch.kernels import gemm as pgemm
from repro_torch.kernels.gemm import (KERNEL, InvariantViolation,
                                      default_config, matmul, matmul_ref)

CASES = [
    # (m, n, k, cfg fields)
    ("default", 64, 128, 256, None),
    ("split_k2", 64, 128, 512, dict(bm=64, bn=128, bk=128, split_k=2)),
    ("split_k4", 32, 128, 512, dict(bm=32, bn=128, bk=128, split_k=4)),
    ("stagger", 96, 256, 384, dict(bm=32, bn=128, bk=128, stagger_k=True)),
    ("ragged", 200, 300, 520, dict(bm=64, bn=128, bk=128)),
    ("ragged_stagger", 72, 136, 200, dict(bm=32, bn=128, bk=64,
                                          stagger_k=True)),
]
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (None, jnp.bfloat16, torch.bfloat16)}


def _inputs(m, n, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(k, n)).astype(np.float32))


def _bf16_step(x: np.ndarray) -> np.ndarray:
    """One bfloat16 step (ulp) at each value's magnitude."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,m,n,k,fields", CASES,
                         ids=[c[0] for c in CASES])
def test_matmul_matches_the_jax_kernel(name, m, n, k, fields, dtype):
    a, b = _inputs(m, n, k, seed=len(name))
    _, jdt, tdt = DTYPES[dtype]
    jcfg = JaxConfig(**fields) if fields else None
    pcfg = GemmConfig(**fields) if fields else None
    want = np.asarray(jgemm.matmul(jnp.asarray(a, jdt), jnp.asarray(b, jdt),
                                   cfg=jcfg, interpret=True),
                      dtype=np.float32)
    before = KERNEL.launches
    got = matmul(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt),
                 cfg=pcfg)
    assert KERNEL.launches == before        # CPU: the plain version
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    else:
        assert np.all(np.abs(got - want) <= _bf16_step(want))


def test_split_k_partials_sum_to_the_same_result():
    a, b = _inputs(32, 128, 1024, seed=3)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    base = matmul(at, bt, cfg=GemmConfig(bm=32, bk=128))
    for split in (2, 4, 8):
        got = matmul(at, bt, cfg=GemmConfig(bm=32, bk=128, split_k=split))
        torch.testing.assert_close(got, base, rtol=1e-5,
                                   atol=1e-5 * float(base.abs().max()))


@pytest.mark.parametrize("m,n,k", [(1, 1, 1), (8, 8, 8), (100, 50, 300),
                                   (128, 128, 4096), (256, 256, 8192),
                                   (8192, 8192, 8192), (2048, 77, 4096),
                                   (5, 4096, 128)])
def test_default_config_matches_the_jax_rule(m, n, k):
    from repro.kernels.gemm.ops import default_config as jax_default
    assert dataclasses.astuple(default_config(m, n, k)) == \
        dataclasses.astuple(jax_default(m, n, k))


def test_out_dtype():
    a, b = _inputs(16, 128, 128, seed=4)
    at = torch.from_numpy(a).to(torch.bfloat16)
    bt = torch.from_numpy(b).to(torch.bfloat16)
    got = matmul(at, bt, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, at.float() @ bt.float())
    assert matmul_ref(at, bt).dtype == torch.bfloat16


def test_an_invalid_config_raises_before_any_launch(monkeypatch):
    """split_k=5 on a 3-K-block problem: the gate rejects it with a
    rendered report, and the kernel wrapper is never called."""
    called = []
    monkeypatch.setattr(pgemm.ops, "gemm",
                        lambda *a, **kw: called.append(1))
    a = torch.zeros(128, 384)
    b = torch.zeros(384, 128)
    before = KERNEL.launches
    with pytest.raises(InvariantViolation, match="split_k must divide"):
        matmul(a, b, cfg=GemmConfig(split_k=5))
    assert called == [] and KERNEL.launches == before
    # the JAX gate rejects it the same way
    with pytest.raises(jgemm.InvariantViolation,
                       match="split_k must divide"):
        jgemm.matmul(jnp.zeros((128, 384)), jnp.zeros((384, 128)),
                     cfg=JaxConfig(split_k=5), interpret=True)


def test_an_injected_data_flow_fault_is_rejected_by_the_gate():
    """The gate's verdict on a mis-lowered program names the failing
    assertion in its report."""
    from repro_torch.core.verify_engine import default_engine
    res = default_engine().verify(
        "gemm", GemmConfig(), pgemm.ops.GemmProblem(256, 256, 256, "f32"),
        inject_bug="swap_b_index")
    assert not res.hard_ok
    assert "FAIL" in res.render() and "assert_conform" in res.render()


def test_the_wrapper_checks_shapes_and_split():
    with pytest.raises(ValueError, match="do not multiply"):
        pgemm.gemm(torch.zeros(4, 5), torch.zeros(4, 5))
    with pytest.raises(ValueError, match="split_k must divide"):
        pgemm.gemm(torch.zeros(8, 8), torch.zeros(8, 8),
                   cfg=GemmConfig(bk=128, split_k=2))
    with pytest.raises(ValueError, match="2-D"):
        matmul(torch.zeros(2, 3, 4), torch.zeros(4, 5))


def test_the_validated_problem_names_the_dtype():
    seen = []
    from repro_torch.core.verify_engine import default_engine
    eng = default_engine()
    orig = eng.verify

    def spy(family, cfg, prob, **kw):
        seen.append(prob)
        return orig(family, cfg, prob, **kw)

    eng.verify = spy
    try:
        matmul(torch.zeros(16, 32, dtype=torch.bfloat16),
               torch.zeros(32, 8, dtype=torch.bfloat16))
    finally:
        del eng.verify
    assert seen[-1].dtype == "bf16" and (seen[-1].m, seen[-1].n,
                                         seen[-1].k) == (16, 8, 32)
