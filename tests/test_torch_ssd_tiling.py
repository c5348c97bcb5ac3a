"""The chunk-parallel SSD kernel, emulated in PyTorch on the CPU and held
to the JAX package's Pallas kernel in interpret mode on the same seeded
numpy inputs.

The CUDA kernel (``ssd_chunk_scan.cu``: ``ssd_state_kernel``,
``ssd_pass_kernel``, ``ssd_scan_kernel``) cannot run here; what it
computes differently from the TPU kernel can.  The emulation follows its
three launches and rounding points:

* each chunk's cumulative decays by the kernel's warp scan (a lane sums
  a run of positions, a Hillis-Steele scan over the 32 runs' totals
  gives their offsets), in float32;
* (1) each chunk's own state contribution ``Bᵀ·(exp(cs_end − cs) ⊙ x)``,
  (2) the recurrence ``S <- exp(cs_end)·S + bx`` in chunk order (one
  fused multiply-add), and (3) ``y = exp(cs_i)·(C_i·S)`` then, key block
  by key block at or below the query block, ``s = (C_i·B_jᵀ) ⊙ L`` and
  ``y += s·x_j``;
* every product in 8-deep steps (the k of ``mma.sync.m16n8k8``) with
  each float32 operand split as hi = tf32(a), TF32 rounding done
  bitwise (to nearest, ties away from zero, the 13 low bits cleared),
  and lo = a − hi, of which the tensor core reads the top 19 bits (the
  13 low bits dropped): lo·hi and hi·lo, then hi·hi, each step's sum
  rounded to float32 (the products of two TF32 values are exact in
  float32);
* a d_state above 128 in state panels of 128 rows (``NPANEL``): the
  chunk states a panel's rows at a time (rows independent of each
  other), C·S and C·Bᵀ summed panel after panel, each panel's 8-deep
  steps in order, which is the same walk, step for step, as one over the
  whole padded state dim; so the emulation runs it as one.

A control runs the same walk with one TF32 product (hi·hi alone): it
misses ``ssd_error``'s float32 limits where 3xTF32 meets them, which is
why the kernel takes three.

Tolerance: ``ssd_error`` (``repro_torch/kernels/ssd/ref.py``), the rule
the card holds the kernel to against its plain version; the final state
(the pass's last ``S``, which the kernel does not return) against
``ssd_ref``'s within the same rule."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core.families.ssd import SSDConfig as JaxConfig
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref
from repro.kernels.ssd.ssd import ssd_chunk_scan as jax_ssd_chunk_scan
from repro_torch.core.families import ssd as fs
from repro_torch.kernels.ssd import ssd_error, ssd_ref

F32, F64 = torch.float32, torch.float64
BR, PT = fs.BLOCK_ROWS, fs.P_TILE


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: to nearest, ties away from zero (the magnitude
    bits rounded up at half), the 13 low bits cleared."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x1000) & 0xFFFFE000
    u = torch.where(u >= 1 << 31, u - (1 << 32), u)
    return u.to(torch.int32).view(F32)


def truncate(x: torch.Tensor) -> torch.Tensor:
    """The TF32 operand the tensor core reads from float32 bits: the 13
    low bits dropped."""
    u = x.contiguous().view(torch.int32) & -0x2000
    return u.view(F32)


def split(x):
    hi = tf32(x)
    return hi, truncate(x - hi)


def mma_walk(acc, a, b, products=3):
    """acc (m, n) float32 += a (m, k) · b (k, n), k in 8-deep steps, each
    step's TF32 products in float64 (exact) added to acc and rounded to
    float32: lo·hi, hi·lo, hi·hi (``products`` 1: hi·hi alone)."""
    ah, al = split(a)
    bh, bl = split(b)
    for k0 in range(0, a.shape[1], 8):
        ks = slice(k0, k0 + 8)
        pairs = ((al, bh), (ah, bl), (ah, bh)) if products == 3 \
            else ((ah, bh),)
        for x, y in pairs:
            acc = (acc.to(F64) + x[:, ks].to(F64) @ y[ks].to(F64)).to(F32)
    return acc


def warp_cumsum(da):
    """``chunk_cumsum``: da (q,) over rows padded to whole 64-row blocks;
    lane l sums positions [l·per, l·per + per) in order, then the
    shuffle scan of the 32 totals."""
    q = da.shape[0]
    qr = -(-q // BR) * BR
    per = qr // 32
    d = torch.zeros(qr, dtype=F32)
    d[:q] = da
    runs = d.reshape(32, per)
    cs = torch.zeros(32, per, dtype=F32)
    run = torch.zeros(32, dtype=F32)
    for e in range(per):
        run = run + runs[:, e]
        cs[:, e] = run
    incl = run.clone()
    off = 1
    while off < 32:
        prev = incl.clone()
        incl[off:] = prev[off:] + prev[:-off]
        off *= 2
    excl = torch.cat([torch.zeros(1, dtype=F32), incl[:-1]])
    return (cs + excl[:, None]).reshape(qr)


def _pad(t, rows, cols=None):
    out = torch.zeros(rows, t.shape[1] if cols is None else cols, dtype=F32)
    out[:t.shape[0], :t.shape[1]] = t
    return out


def emulate_ssd(x, da, Bm, Cm, chunk, products=3):
    """The three launches for every (bh, chunk); returns y in x's dtype
    and the final state."""
    BH, S, P = x.shape
    N = Bm.shape[-1]
    q, nc = chunk, S // chunk
    qr = -(-q // BR) * BR
    npad = -(-N // fs.N_GRAIN) * fs.N_GRAIN
    y = torch.zeros(BH, S, P, dtype=F32)
    final = torch.zeros(BH, N, P, dtype=F32)
    for bh in range(BH):
        cs_all, states = [], []
        # (1) chunk states
        for c in range(nc):
            rows = slice(c * q, (c + 1) * q)
            cs = warp_cumsum(da[bh, rows].to(F32))
            cs_end = cs[q - 1]
            dte = torch.zeros(qr, dtype=F32)
            dte[:q] = torch.exp(cs_end - cs[:q])
            xb = _pad(x[bh, rows].to(F32), qr) * dte[:, None]
            bb = _pad(Bm[bh, rows].to(F32), qr, npad)
            bx = mma_walk(torch.zeros(npad, P, dtype=F32), bb.t(), xb,
                          products)
            cs_all.append(cs)
            states.append(bx[:N])
        # (2) the pass: fma(exp(cs_end), S, bx) in chunk order
        s = torch.zeros(N, P, dtype=F32)
        entering = []
        for c in range(nc):
            entering.append(s)
            dec = torch.exp(cs_all[c][q - 1])
            s = (dec.to(F64) * s.to(F64) + states[c].to(F64)).to(F32)
        final[bh] = s
        # (3) the scan, query block by query block
        for c in range(nc):
            rows = slice(c * q, (c + 1) * q)
            cs = cs_all[c]
            cc = _pad(Cm[bh, rows].to(F32), qr, npad)
            bb = _pad(Bm[bh, rows].to(F32), qr, npad)
            xx = _pad(x[bh, rows].to(F32), qr)
            st = _pad(entering[c], npad)
            for i0 in range(0, qr, BR):
                qs = slice(i0, i0 + BR)
                acc = mma_walk(torch.zeros(BR, P, dtype=F32), cc[qs], st,
                               products)
                i = torch.arange(i0, i0 + BR)
                acc = acc * torch.where(i < q, torch.exp(cs[i]),
                                        torch.zeros(()))[:, None]
                for j0 in range(0, i0 + BR, BR):
                    ks = slice(j0, j0 + BR)
                    sc = mma_walk(torch.zeros(BR, BR, dtype=F32), cc[qs],
                                  bb[ks].t(), products)
                    j = torch.arange(j0, j0 + BR)
                    keep = (j[None, :] <= i[:, None]) & (i[:, None] < q)
                    L = torch.exp(cs[i][:, None] - cs[j][None, :])
                    sc = torch.where(keep, sc * L, torch.zeros(()))
                    acc = mma_walk(acc, sc, xx[ks], products)
                n = min(BR, q - i0)
                y[bh, c * q + i0:c * q + i0 + n] = acc[:n]
    return y.to(x.dtype), final


def _inputs(BH, S, P, N, seed, decay=0.1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(BH, S, P)).astype(np.float32),
            (-np.abs(rng.normal(size=(BH, S))) * decay).astype(np.float32),
            (rng.normal(size=(BH, S, N)) * .3).astype(np.float32),
            (rng.normal(size=(BH, S, N)) * .3).astype(np.float32))


def _jax(arrs, q, dtype):
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x, da, B, C = (jnp.asarray(a) for a in arrs)
    out = jax_ssd_chunk_scan(x.astype(jd), da, B.astype(jd), C.astype(jd),
                             cfg=JaxConfig(chunk=q), interpret=True)
    return torch.from_numpy(np.array(jnp.asarray(out, jnp.float32))) \
        .to(dtype)


CASES = [
    # (BH, S, P, N, chunk, decay): many chunks; a chunk of two and of
    # four 64-row blocks; chunk 96 with P 24 and N 12 (off every grain);
    # mamba2's decays (da ~ -0.7 a step) over a long chunk
    (2, 512, 32, 16, 64, 0.1),
    (1, 512, 64, 64, 128, 0.1),
    (1, 512, 16, 32, 256, 0.1),
    (2, 480, 24, 12, 96, 0.1),
    (1, 512, 64, 128, 256, 0.7),
    # state panels: d_state 256 (two of 128) and 130 (136: 128 and 8)
    (1, 256, 16, 256, 128, 0.1),
    (1, 256, 24, 130, 64, 0.1),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: (
    f"BH{c[0]}-S{c[1]}-P{c[2]}-N{c[3]}-q{c[4]}-da{c[5]}"))
def test_the_three_passes_stay_within_the_tolerance_of_the_tpu_kernel(
        case, dtype):
    BH, S, P, N, q, decay = case
    arrs = _inputs(BH, S, P, N, sum(case[:5]), decay)
    x, da, B, C = (torch.from_numpy(a) for a in arrs)
    x, B, C = x.to(dtype), B.to(dtype), C.to(dtype)
    got, state = emulate_ssd(x, da, B, C, q)
    want = _jax(arrs, q, dtype)
    err, row, ok = ssd_error(got, want)
    assert ok, (err, row)
    # and the plain version the card holds the kernel to, with its state
    plain, plain_state = ssd_ref(x, da, B, C, q)
    assert ssd_error(got, plain)[2]
    assert ssd_error(state, plain_state)[2]
    if dtype == torch.float32:
        _, jstate = jax_ssd_ref(*(jnp.asarray(a) for a in arrs), q)
        assert ssd_error(state, torch.from_numpy(np.array(jstate)))[2]


def test_one_tf32_product_misses_the_float32_tolerance():
    """hi·hi alone rounds each operand to TF32 (2^-11): the rows move by
    more than ``ssd_error``'s 2e-4 where the three products stay within
    it."""
    arrs = _inputs(1, 256, 64, 128, 11)
    x, da, B, C = (torch.from_numpy(a) for a in arrs)
    want = _jax(arrs, 128, torch.float32)
    three, _ = emulate_ssd(x, da, B, C, 128)
    one, _ = emulate_ssd(x, da, B, C, 128, products=1)
    assert ssd_error(three, want)[2]
    err, row, ok = ssd_error(one, want)
    assert not ok and row > 2e-4, (err, row)


def test_tf32_rounding_is_to_nearest_ties_away():
    """One TF32 unit at 1.0 is 2^-10: values a quarter, a half and three
    quarters of a unit above 1 round down, away (up) and up; negative
    values mirror them; the 13 low bits are cleared.  hi + lo (lo as the
    tensor core reads it) is within 2^-21 of x."""
    u = 2.0 ** -10
    x = torch.tensor([1 + u / 4, 1 + u / 2, 1 + 3 * u / 4, 1 + u + u / 2,
                      -(1 + u / 2)], dtype=F32)
    assert tf32(x).tolist() == [1.0, 1 + u, 1 + u, 1 + 2 * u, -(1 + u)]
    r = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    assert not (tf32(r).view(torch.int32) & 0x1FFF).any()
    hi, lo = split(r)
    assert ((hi + lo - r).abs() <= r.abs() * 2.0 ** -21).all()
    assert not (lo.view(torch.int32) & 0x1FFF).any()


def test_the_warp_scan_is_a_cumsum():
    d = torch.from_numpy(-np.abs(np.random.default_rng(2).normal(
        size=96)).astype(np.float32) * .7)
    cs = warp_cumsum(d)
    assert cs.shape == (128,)
    assert torch.allclose(cs[:96], torch.cumsum(d.double(), 0).float(),
                          rtol=1e-5, atol=1e-5)
    # past q the runs add zeros: the chunk's total, to rounding
    assert torch.allclose(cs[96:], cs[95].expand(32), rtol=1e-6)
