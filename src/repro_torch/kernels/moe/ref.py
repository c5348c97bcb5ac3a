"""Plain PyTorch versions of the fused MoE family: the oracles the CPU
path, the tests, the family's ``reference_check`` and ``chip_smoke.py``
use.  They are never run on the card path.  A port of the JAX package's
``kernels/moe/ref.py``, with its rounding points: ``act`` is rounded to
x's dtype before the down product, and the router gate scales the
float32 product before the final cast."""
from __future__ import annotations

import torch

F32 = torch.float32


def silu(x: torch.Tensor) -> torch.Tensor:
    """x / (1 + exp(-x)) in float32 (the JAX package's ``jax_silu``)."""
    xf = x.to(F32)
    return xf / (1.0 + torch.exp(-xf))


def swiglu_ref(hg: torch.Tensor, hu: torch.Tensor) -> torch.Tensor:
    return silu(hg) * hu


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of ``idx`` over ``n`` classes (``jax_one_hot``)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(F32)


def grouped_ffn_ref(x_routed: torch.Tensor, wg: torch.Tensor,
                    wu: torch.Tensor, wd: torch.Tensor,
                    gates_routed=None) -> torch.Tensor:
    """Oracle for the grouped-FFN kernel.

    x_routed: (E, C, DM); wg, wu: (E, DM, DF); wd: (E, DF, DM);
    gates_routed: optional (E, C, 1) gate scaling.  Returns x's dtype."""
    xf = x_routed.to(F32)
    hg = torch.einsum("ecd,edf->ecf", xf, wg.to(F32))
    hu = torch.einsum("ecd,edf->ecf", xf, wu.to(F32))
    act = silu(hg) * hu
    y = torch.einsum("ecf,efd->ecd", act.to(x_routed.dtype).to(F32),
                     wd.to(F32))
    if gates_routed is not None:
        y = y * gates_routed.to(F32)
    return y.to(x_routed.dtype)


def moe_ffn_ref(x: torch.Tensor, gates: torch.Tensor,
                expert_idx: torch.Tensor, wg: torch.Tensor,
                wu: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """Dense oracle for the whole MoE layer, capacity-free.

    x: (T, DM); gates: (T, K) f32; expert_idx: (T, K) int; wg, wu:
    (E, DM, DF); wd: (E, DF, DM).  Every token visits every expert and
    the routing masks select contributions: exact, O(T·E) products."""
    E = wg.shape[0]
    xf = x.to(F32)
    hg = torch.einsum("td,edf->etf", xf, wg.to(F32))
    hu = torch.einsum("td,edf->etf", xf, wu.to(F32))
    act = silu(hg) * hu
    y_e = torch.einsum("etf,efd->etd", act.to(x.dtype).to(F32),
                       wd.to(F32))                      # (E, T, DM)
    w = (one_hot(expert_idx, E) * gates.to(F32)[..., None]).sum(dim=1)
    out = torch.einsum("te,etd->td", w, y_e)
    return out.to(x.dtype)


# How far the grouped-FFN kernel may be from ``grouped_ffn_ref`` on the
# same inputs, elementwise, with M the largest |output|:
#   float32: 1e-5·M — the same products summed in another order;
#   bfloat16: 2^-7·|y| + 2^-8·M — each side rounds its float32 output to
#   bfloat16 once and may land on the neighbouring value (one step is
#   2^-7 of the value at most), and ``act`` is rounded to bfloat16 on
#   both sides from float32 sums taken in another order, so a few of
#   its d_ff values per row may sit one step apart (each moves y by
#   about 2^-8 of one term, far below 2^-8·M).
# The floor scales with M, so a kernel that drops or repeats a block of
# d_ff, whose error is a sizeable share of every output, fails at any
# output scale.
RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}
MTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}


def moe_error(got: torch.Tensor, want: torch.Tensor):
    """(max |got - want|, within the tolerance above); ``want`` is the
    plain version's output."""
    dt = want.dtype
    w = want.to(F32)
    err = (got.to(F32) - w).abs()
    floor = MTOL[dt] * max(float(w.abs().max()), 1e-30)
    ok = bool((err <= RTOL[dt] * w.abs() + floor).all())
    return float(err.max()), ok
