"""Plain PyTorch version of the SSD (Mamba-2) chunk kernel: the oracle
the CPU path, the tests, the family's ``reference_check`` and
``chip_smoke.py`` use.  A port of the JAX package's
``kernels/ssd/ref.py``."""
from __future__ import annotations

import torch

F32 = torch.float32


def _segsum(da: torch.Tensor) -> torch.Tensor:
    """da: (..., q) -> L[..., i, j] = sum_{k in (j, i]} da_k, -inf above."""
    q = da.shape[-1]
    cs = torch.cumsum(da, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool, device=da.device))
    return torch.where(mask, diff, torch.tensor(float("-inf"),
                                                dtype=da.dtype,
                                                device=da.device))


def ssd_ref(x: torch.Tensor, da: torch.Tensor, Bm: torch.Tensor,
            Cm: torch.Tensor, chunk: int, acc: torch.dtype = F32):
    """Chunked SSD scan, sequential-over-chunks oracle.

    x: (BH, S, P); da: (BH, S) log-decays (<= 0); Bm, Cm: (BH, S, N).
    Returns y: (BH, S, P) in x's dtype, final_state: (BH, N, P) in
    ``acc``, the type every sum is taken in (float32, as the JAX
    reference; float64 where a check needs the reference's own rounding
    out of the way, see ``ssd_error``).
    """
    BH, S, P = x.shape
    N = Bm.shape[-1]
    nc = S // chunk
    q = chunk
    xc = x.reshape(BH, nc, q, P).to(acc)
    dac = da.reshape(BH, nc, q).to(acc)
    Bc = Bm.reshape(BH, nc, q, N).to(acc)
    Cc = Cm.reshape(BH, nc, q, N).to(acc)

    L = torch.exp(_segsum(dac))                            # (BH,nc,q,q)
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc) * L
    y_intra = torch.einsum("bcqk,bckp->bcqp", scores, xc)

    dacs = torch.cumsum(dac, dim=-1)
    decay_to_end = torch.exp(dacs[..., -1:] - dacs)        # (BH,nc,q)
    chunk_state = torch.einsum("bcqn,bcq,bcqp->bcnp", Bc, decay_to_end, xc)
    chunk_decay = torch.exp(dacs[..., -1])                 # (BH,nc)

    ys = []
    state = torch.zeros(BH, N, P, dtype=acc, device=x.device)
    for c in range(nc):
        y_inter = torch.einsum("bqn,bq,bnp->bqp", Cc[:, c],
                               torch.exp(dacs[:, c]), state)
        ys.append(y_intra[:, c] + y_inter)
        state = chunk_decay[:, c][:, None, None] * state + chunk_state[:, c]
    y = torch.stack(ys, dim=1).reshape(BH, S, P)
    return y.to(x.dtype), state


# How far the SSD kernel may be from ``ssd_ref`` on the same inputs, with
# M the largest |y|: each element |err| <= RTOL·|y| + MTOL·M, and each
# (bh, position) row of P outputs together: the error's norm within
# ROW_RTOL of the row's norm.
# float32: 1e-4·|y| + 1e-4·M, rows 2e-4.  Both sides compute in float32
# and differ in the order of their sums: the cumulative decays (a warp
# scan in the kernel, torch.cumsum in the plain version), the products
# (in the kernel three TF32 tensor-core products a float32 product,
# hi·hi + hi·lo + lo·hi, within ~2^-20 of it — one TF32 product alone
# misses these limits, tests/test_torch_ssd_tiling.py — in another
# order).  A decay weight exp(cs_i - cs_j) is taken from
# two sums of up to a chunk of log decays, each rounded at |cs|'s scale,
# so its relative error grows with |cs|.  Measured on an H100: at the
# JAX tests' inputs (da ~ -0.08 a step; 64 x 8192 x 64 x 128) rows up
# to 1.5e-6 apart and elements 2.1e-5; at mamba2-780m's first layer (da
# ~ -0.7 a step, |cs| ~ 180 over a 256-chunk) rows 4.5e-5 and elements
# 2.3e-3 at outputs of tens — an element's error follows the terms
# that cancel into it, not its own size, hence the floor at M.  The
# JAX tests' allclose at 2e-3 on outputs of ~3 is as loose as this
# floor; ``base.REF_TOL["f32"]`` of 1e-4 holds only at the milder decays.
# bfloat16 (x, B and C in bfloat16, computed in float32, y rounded once):
# 2^-7·|y| + 2^-8·M, rows 2^-7 — each side rounds its float32 y to
# bfloat16 once and may land on the neighbouring value.  A kernel that
# drops the carried state, reads B or x from the wrong chunk, or shifts
# the causal mask moves whole rows by a tenth of their norm or more.
# The row rule reads a row's error against its own norm, so on a row
# whose terms nearly cancel it holds the reference to the same digits as
# the kernel: a chunk's first row is (C_0·B_0) x_0, and where the N
# products of C_0·B_0 sum to far less than their sizes do, the float32
# plain version's own rounding can exceed ROW_RTOL (chip_smoke.py's
# d_state 130 cases report both sides' row errors against float64).  The
# card's checks of the kernel therefore hold it to ``ssd_ref(...,
# acc=torch.float64)``: the same tolerances, against a reference whose
# own rounding is far below them.
RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
MTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -8}
ROW_RTOL = {torch.float32: 2e-4, torch.bfloat16: 2.0 ** -7}


def ssd_error(got: torch.Tensor, want: torch.Tensor):
    """(max |got - want|, the worst row's error norm over its norm,
    within the tolerances above); ``want`` is the plain version."""
    dt = want.dtype
    w = want.to(F32)
    err = got.to(F32) - w
    floor = MTOL[dt] * max(float(w.abs().max()), 1e-30)
    elem = bool((err.abs() <= RTOL[dt] * w.abs() + floor).all())
    row = float((err.norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max())
    return float(err.abs().max()), row, elem and row <= ROW_RTOL[dt]
