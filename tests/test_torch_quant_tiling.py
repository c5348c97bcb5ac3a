"""The wgmma instance of the quantized GEMM kernel, emulated in PyTorch on
the CPU and held to the JAX package's Pallas kernel in interpret mode on
the same seeded numpy inputs.

The CUDA kernel (``quant_gemm.cu``, ``transpose_kernel`` then
``quant_wgmma_kernel``) cannot run here; what it computes differently
from the TPU kernel can.  The emulation follows its walk and rounding
points:

* the call first writes Bᵀ (n, k), K-major, in 64 x 64-byte tiles
  (wgmma takes 8-bit operands K-major only);
* a CTA owns a 128 x 128 output tile and walks K in 128-deep stages,
  zero past m, n and k (TMA's zero fill), each stage holding four rows
  of sb from group k0 / group on (zero past the last group);
* each bk-deep block's int32 partial is exact; it is converted to float
  by the magic-number trick, exact for |p| <= 2^22 (a bk <= 128 block of
  int8 reaches at most 128·128·128 = 2^21), and promoted as
  ``acc = fma(f32(p) · sa, sb, acc)``, block by block in K order — the
  TPU kernel's ``acc += f32(p) * sa * sb``.

The promotion is elementwise and the blocks go in K order on both
instances, so the tile (128 x 128 on wgmma, 64 x 64 on mma.sync) does
not enter the arithmetic: the two are bit-identical at one bk, which
the card checks (``chip_smoke.py`` phase 10a).

Tolerance: ``quant_error`` (``repro_torch/kernels/quant_gemm/ref.py``),
the rule the card holds the kernel to against its plain version."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core.families.quant_gemm import QuantGemmConfig as JaxConfig
from repro.kernels.quant_gemm.quant_gemm import quant_gemm as jax_quant_gemm
from repro_torch.core.families import quant_gemm as fq
from repro_torch.core.families.quant_gemm import (QuantGemmConfig,
                                                  QuantGemmProblem)
from repro_torch.kernels.quant_gemm import (quant_error, quant_gemm_ref,
                                            quantize_per_group)

ROWS, COLS, DEPTH = fq.WGMMA_ROWS, fq.WGMMA_COLS, fq.WGMMA_DEPTH
MAGIC, MAGIC_F = 0x4B400000, 12582912.0


def exact_float(p: torch.Tensor) -> torch.Tensor:
    """The kernel's ``exact_float``: int32 p added to the bits of
    1.5·2^23, read as float32, less 1.5·2^23."""
    bits = (p.to(torch.int64) + MAGIC).to(torch.int32)
    return bits.view(torch.float32) - torch.tensor(MAGIC_F)


def promote(acc, p, sa, sb):
    """fma(f32(p) · sa, sb, acc): the product rounded once, the fused
    multiply-add rounded once (in float64 the product of two floats is
    exact)."""
    ps = exact_float(p) * sa
    return (ps.double() * sb.double() + acc.double()).float()


def transpose_walk(b: torch.Tensor) -> torch.Tensor:
    """``transpose_kernel``: 64 (k) x 64 (n) tiles, each row of Bᵀ
    written as 16-byte vectors gathered from the tile's columns."""
    k, n = b.shape
    bt = torch.empty(n, k, dtype=b.dtype)
    for n0 in range(0, n, 64):
        for k0 in range(0, k, 64):
            tile = b[k0:k0 + 64, n0:n0 + 64]
            for c in range(0, tile.shape[0], 16):
                bt[n0:n0 + tile.shape[1], k0 + c:k0 + c + 16] = \
                    tile[c:c + 16].t()
    return bt


def emulate_quant_wgmma(a, b, sa, sb, group, cfg, out_dtype=torch.float32):
    """``quant_wgmma_kernel``'s walk, CTA tile by CTA tile."""
    m, k = a.shape
    n = b.shape[1]
    bk = cfg.bk
    assert fq.is_wgmma(cfg, QuantGemmProblem(m, n, k, group))
    ng, nk = -(-k // group), -(-k // bk)
    n_stages = -(-k // DEPTH)
    bt = transpose_walk(b)
    # zero fill past m, n, k and past the last group, as TMA's
    pad = lambda t, r, c: torch.nn.functional.pad(
        t, (0, c - t.shape[1], 0, r - t.shape[0]))
    mp, np_, kp = -(-m // ROWS) * ROWS, -(-n // COLS) * COLS, \
        n_stages * DEPTH
    A = pad(a.to(torch.int64), mp, kp)
    Bt = pad(bt.to(torch.int64), np_, kp)
    SB = pad(sb, ng + fq.WGMMA_SB_ROWS, np_)
    SA = pad(sa, mp, ng)          # the kernel reads 0 past m
    out = torch.empty(m, n, dtype=out_dtype)
    for row0 in range(0, m, ROWS):
        for col0 in range(0, n, COLS):
            acc = torch.zeros(ROWS, COLS)
            for s in range(n_stages):
                k0 = s * DEPTH
                a_s = A[row0:row0 + ROWS, k0:k0 + DEPTH]
                b_s = Bt[col0:col0 + COLS, k0:k0 + DEPTH]
                g0 = k0 // group
                sb_s = SB[g0:g0 + fq.WGMMA_SB_ROWS, col0:col0 + COLS]
                for j in range(DEPTH // bk):
                    t = s * (DEPTH // bk) + j
                    if t >= nk:
                        break
                    ks = slice(j * bk, (j + 1) * bk)
                    part = (a_s[:, ks] @ b_s[:, ks].t()).to(torch.int32)
                    grp = t * bk // group
                    acc = promote(acc, part,
                                  SA[row0:row0 + ROWS, grp][:, None],
                                  sb_s[grp - g0][None, :])
            out[row0:row0 + ROWS, col0:col0 + COLS] = \
                acc[:min(ROWS, m - row0), :min(COLS, n - col0)].to(out_dtype)
    return out


def emulate_mma_sync(a, b, sa, sb, group, bk, out_dtype=torch.float32):
    """The mma.sync instance's arithmetic: each bk block's exact partial
    converted by ``cvt`` and promoted with the same expression, in K
    order (its 64 x 64 tiles do not enter the arithmetic)."""
    m, k = a.shape
    acc = torch.zeros(m, b.shape[1])
    for t in range(-(-k // bk)):
        ks = slice(t * bk, min(k, (t + 1) * bk))
        part = a[:, ks].to(torch.int64) @ b[ks].to(torch.int64)
        grp = t * bk // group
        ps = part.to(torch.float32) * sa[:, grp][:, None]
        acc = (ps.double() * sb[grp][None, :].double()
               + acc.double()).float()
    return acc.to(out_dtype)


def _inputs(m, n, k, group, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32))
    aq, sa = quantize_per_group(a, group, axis=1)
    bq, sb = quantize_per_group(b, group, axis=0)
    return aq, bq, sa, sb


def _jax(aq, bq, sa, sb, group, cfg, out_dtype):
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    out = jax_quant_gemm(*(jnp.asarray(t.numpy()) for t in (aq, bq, sa, sb)),
                         group=group, cfg=JaxConfig(cfg.bm, cfg.bn, cfg.bk),
                         out_dtype=jd[out_dtype], interpret=True)
    return torch.from_numpy(np.array(jnp.asarray(out, jnp.float32))) \
        .to(out_dtype)


CASES = [
    # (m, n, k, group, bm, bn, bk, out): groups 128 and 64, bk 32 / 64 /
    # 128, a config tile of several CTA tiles, m ragged against the
    # 128-row tile (40, 200), n and k ragged against 128 (multiples of
    # 16), bf16 output
    (256, 256, 512, 128, 128, 128, 128, torch.float32),
    (256, 128, 512, 128, 128, 128, 64, torch.float32),
    (128, 256, 384, 64, 256, 128, 64, torch.float32),
    (200, 256, 256, 64, 128, 256, 32, torch.float32),
    (40, 256, 256, 128, 128, 128, 128, torch.float32),
    (136, 144, 400, 128, 128, 128, 32, torch.float32),
    (256, 256, 512, 128, 128, 128, 128, torch.bfloat16),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: (
    f"{c[0]}x{c[1]}x{c[2]}-g{c[3]}-{c[4]}x{c[5]}x{c[6]}-"
    f"{str(c[7]).split('.')[-1]}"))
def test_the_wgmma_walk_stays_within_the_tolerance_of_the_tpu_kernel(case):
    m, n, k, group, bm, bn, bk, od = case
    aq, bq, sa, sb = _inputs(m, n, k, group, m + n + k + bk)
    cfg = QuantGemmConfig(bm, bn, bk)
    got = emulate_quant_wgmma(aq, bq, sa, sb, group, cfg, od)
    want = _jax(aq, bq, sa, sb, group, cfg, od)
    err, ok = quant_error(got, want)
    assert ok, err
    # and the plain version the card holds the kernel to
    assert quant_error(got, quant_gemm_ref(aq, bq, sa, sb, group=group,
                                           out_dtype=od))[1]
    # the mma.sync instance at the same bk: bit-identical
    assert torch.equal(got, emulate_mma_sync(aq, bq, sa, sb, group, bk, od))


def test_the_transpose_is_k_major():
    rng = np.random.default_rng(3)
    b = torch.from_numpy(rng.integers(-128, 128, size=(208, 144),
                                      dtype=np.int8))
    assert torch.equal(transpose_walk(b), b.t().contiguous())


def test_the_magic_number_conversion_is_exact_where_a_block_reaches():
    """A bk <= 128 block of int8 (-128..127) sums at most 128 products
    of |a·b| <= 2^14: |p| <= 2^21.  The conversion is exact there, and
    on to ±2^22 (bk 256 would reach that, so the wgmma instance takes
    bk <= 128 only)."""
    p = torch.arange(-(1 << 21), (1 << 21) + 1, dtype=torch.int32)
    assert torch.equal(exact_float(p), p.to(torch.float32))
    edge = torch.tensor([-(1 << 22), (1 << 22) - 1, 1 << 22],
                        dtype=torch.int32)
    assert torch.equal(exact_float(edge), edge.to(torch.float32))
    assert max(fq.WGMMA_BK) * 128 * 128 <= 1 << 21
    # the largest partials a block can reach
    a = torch.full((1, 128), -128, dtype=torch.int64)
    assert int(a @ a.t()) == 1 << 21


def test_a_scale_of_the_wrong_group_fails_the_tolerance():
    """The emulation with sb read one group off fails ``quant_error``:
    the promotion's scale pairing is what the check sees."""
    aq, bq, sa, sb = _inputs(128, 128, 512, 128, 5)
    cfg = QuantGemmConfig()
    want = quant_gemm_ref(aq, bq, sa, sb, group=128)
    wrong = emulate_quant_wgmma(aq, bq, sa, sb.roll(1, dims=0), 128, cfg)
    assert not quant_error(wrong, want)[1]


@pytest.mark.parametrize("field,value,wgmma", [
    (None, None, True),            # the example: 128 x 128 x 128
    ("bk", 64, True), ("bk", 32, True),
    ("bm", 256, True), ("bn", 384, True),
    ("bk", 256, False),            # |p| could reach 2^22
    ("bm", 64, False), ("bm", 32, False), ("bn", 64, False),
    ("k", 1000, False),            # rows not 16-byte multiples (TMA)
    ("n", 1000, False),
    ("dtype", "fp8", False),
])
def test_is_wgmma_routes_as_the_kernel_does(field, value, wgmma):
    """int8, bm and bn multiples of 128, bk 32 / 64 / 128, k and n
    multiples of 16 run on wgmma; everything else on mma.sync."""
    cfg = QuantGemmConfig(128, 128, 128)
    prob = QuantGemmProblem(8192, 8192, 8192, 256)
    if field in ("bm", "bn", "bk"):
        cfg = QuantGemmConfig(**{**cfg.__dict__, field: value})
    elif field is not None:
        prob = QuantGemmProblem(**{**prob.__dict__, field: value})
    assert fq.is_wgmma(cfg, prob) == wgmma
    assert fq.cta_tile(cfg, prob) == ((128, 128) if wgmma
                                      else fq.mma_tile(cfg))
    assert fq.instance_name(cfg, prob).split()[0] == \
        ("wgmma" if wgmma else "mma.sync")
