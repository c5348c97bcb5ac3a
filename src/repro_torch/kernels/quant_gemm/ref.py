"""Plain PyTorch versions of the quantized GEMM family: the per-group
quantiser and the dequantise-then-matmul oracle that the CPU path, the
tests, the family's ``reference_check`` and ``chip_smoke.py`` use.  A
port of the JAX package's ``kernels/quant_gemm/ref.py``;
:func:`quantize_per_group` gives the JAX helper's bits (``np.rint`` is
round-half-to-even, as ``torch.round``; every division is one correctly
rounded float32 operation on both sides)."""
from __future__ import annotations

import torch

F32 = torch.float32


def quantize_per_group(x, group: int, axis: int):
    """Symmetric int8 quantization with one f32 scale per ``group``
    coordinates along ``axis``.  Returns (q_int8, scales) on x's device,
    with scales shaped like ``x`` but with the quantized axis reduced to
    ceil(extent/group); an all-zero group gets the scale 1.0."""
    x = torch.as_tensor(x).to(F32)
    n = x.shape[axis]
    ng = -(-n // group)
    pad = ng * group - n
    if pad:
        shape = list(x.shape)
        shape[axis] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=axis)
    shape = list(x.shape)
    shape[axis:axis + 1] = [ng, group]
    xg = x.reshape(shape)
    amax = xg.abs().amax(dim=axis + 1, keepdim=True)
    scales = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xg / scales), -127, 127).to(torch.int8)
    q = q.reshape(x.shape).narrow(axis, 0, n)
    return q.contiguous(), scales.squeeze(axis + 1).contiguous()


def _expand(scales: torch.Tensor, group: int, n: int, axis: int
            ) -> torch.Tensor:
    return scales.repeat_interleave(group, dim=axis).narrow(axis, 0, n)


def quant_gemm_ref(a: torch.Tensor, b: torch.Tensor, sa: torch.Tensor,
                   sb: torch.Tensor, *, group: int,
                   out_dtype=torch.float32) -> torch.Tensor:
    """Dequantize-then-matmul in f32 (the kernel's numerics contract:
    each element scaled by its own (row, K-group) x (K-group, col) pair).
    On a CUDA tensor the product is a float32 ``torch.matmul`` (TF32
    stays off, ``repro_torch.device.resolve_device``)."""
    k = a.shape[1]
    a_f = a.to(F32) * _expand(sa.to(F32), group, k, 1)
    b_f = b.to(F32) * _expand(sb.to(F32), group, k, 0)
    return torch.matmul(a_f, b_f).to(out_dtype)


# How far the quant-GEMM kernel may be from ``quant_gemm_ref`` on the same
# inputs, elementwise, with M the largest |output|: float32 2e-5·M — the
# kernel's int32 partial of each bk block is exact and only the float32
# sum of the scaled block partials rounds, while the plain version rounds
# every dequantised product and sums K of them in another order (float32
# without TF32); measured on an H100 at 8192^3 with 128-wide groups, the
# two were 4.5e-6·M apart, so the bound keeps a factor of four.
# bfloat16 output: in addition one bfloat16 step of the value
# (2^-7·|y|), since each side rounds its float32 result once and may land
# on the neighbouring value.  A scale applied to the wrong K-group, row
# or column, or a dropped bk block, moves outputs by a sizeable share of
# M (one group of 64 moves each output by ~1/8 of its scale) and fails
# at any output scale.
RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}
MTOL = 2e-5


def quant_error(got: torch.Tensor, want: torch.Tensor):
    """(max |got - want|, within the tolerance above); ``want`` is the
    plain version's output."""
    w = want.to(F32)
    err = (got.to(F32) - w).abs()
    floor = MTOL * max(float(w.abs().max()), 1e-30)
    ok = bool((err <= RTOL[want.dtype] * w.abs() + floor).all())
    return float(err.max()), ok
