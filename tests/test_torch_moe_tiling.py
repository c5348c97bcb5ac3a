"""The wgmma instance of the grouped-FFN kernel, emulated in PyTorch on the
CPU and held to the JAX package's Pallas kernel in interpret mode on the
same seeded numpy inputs.

The CUDA kernel (``grouped_ffn.cu``, ``ffn_wgmma_kernel``) cannot run
here; what it computes differently from the TPU kernel can.  The
emulation follows its tiles and rounding points:

* gate/up: a CTA owns BM = 128 rows of one expert (64 where block_t is no
  multiple of 128) and 128 d_ff columns of wg and of wu, staged as four
  64-column panels ([wg0 wg1 wu0 wu1] at BM 128, [wg0 wu0 wg1 wu1] at BM
  64, where consumer warpgroup i takes panels 2i and 2i + 1); each
  warpgroup's product walks d_model in 64-deep stages, summed in
  float32; hg at a column of its product pairs with hu half the
  product's width later (128 columns at BM 128, 64 at BM 64), and
  act = hg / (1 + exp(-hg)) * hu is rounded to bf16;
* down: BM x 256 tiles of d_model (the last one's panels past d_model
  never stored), d_ff walked in 64-deep stages in the TPU's f order,
  each row scaled by its gate in float32 before the one rounding.

The work list (expert by expert, then config tile, then CTA tile)
orders the CTAs, not the arithmetic: every output is summed by one CTA.

Tolerance: ``moe_error`` (``repro_torch/kernels/moe/ref.py``), the rule
the card holds the kernel to against its plain version: one bfloat16
step of each value plus 2^-8 of the largest |output| (act rounds to
bfloat16 on both sides from float32 sums taken in another order)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core.families.moe import MoEConfig as JaxMoEConfig
from repro.kernels import moe as jmoe
from repro_torch.core.families import moe as fm
from repro_torch.core.families.moe import MoEConfig
from repro_torch.kernels.moe import grouped_ffn_ref, moe_error
from repro_torch.kernels.moe.moe import instance_problem

DEPTH = fm.WGMMA_DEPTH


def _inputs(seed, E, C, DM, DF):
    """x ~ N(0, 1) with two empty capacity rows an expert (1 and C-1),
    weights scaled by 1/sqrt(fan-in), gates in [0.2, 1), as bf16."""
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16()
    x = rng.normal(size=(E, C, DM))
    x[:, 1] = 0
    x[:, -1] = 0
    ws = [rng.normal(size=sh) * sh[1] ** -0.5
          for sh in ((E, DM, DF), (E, DM, DF), (E, DF, DM))]
    gates = torch.from_numpy(
        rng.uniform(0.2, 1.0, size=(E, C, 1)).astype(np.float32))
    return bf(x), [bf(w) for w in ws], gates


def _staged(a, w, k, rows, cols):
    """One warpgroup's float32 product over its rows and staged columns,
    the depth walked in 64-deep stages."""
    acc = torch.zeros(len(rows), len(cols))
    for k0 in range(0, k, DEPTH):
        ks = slice(k0, min(k, k0 + DEPTH))
        acc += a[rows, ks] @ w[ks][:, cols]
    return acc


def emulate_ffn_wgmma(x, wg, wu, wd, gates, cfg):
    """``ffn_wgmma_kernel``'s two launches, CTA tile by CTA tile."""
    E, C, DM = x.shape
    DF = wg.shape[-1]
    assert fm.is_wgmma(cfg, instance_problem(x, wg))
    BM, TU, TD = fm.cta_tiles(cfg, DM, True)
    fuse = cfg.fuse_gate and gates is not None
    xf, wgf, wuf, wdf = (t.float() for t in (x, wg, wu, wd))
    act = torch.zeros(E, C, DF, dtype=torch.bfloat16)
    y = torch.zeros(E, C, DM, dtype=torch.bfloat16)
    # gate/up: the staged panels (source, 64-column half) in ring order,
    # and each consumer warpgroup's (row offset, rows, panels)
    order = ([(0, 0), (0, 1), (1, 0), (1, 1)] if BM == 128
             else [(0, 0), (1, 0), (0, 1), (1, 1)])
    groups = ([(0, 64, (0, 1, 2, 3)), (64, 64, (0, 1, 2, 3))] if BM == 128
              else [(0, 64, (0, 1)), (0, 64, (2, 3))])
    for e in range(E):
        for r0 in range(0, C, BM):
            for c0 in range(0, DF, TU):
                w = torch.cat([(wgf, wuf)[s][e][:, c0 + 64 * h:
                                                c0 + 64 * h + 64]
                               for s, h in order], 1)          # (DM, 256)
                for off, n, panels in groups:
                    rows = torch.arange(r0 + off, min(C, r0 + off + n))
                    if not len(rows):
                        continue
                    cols = torch.cat([torch.arange(64 * p, 64 * p + 64)
                                      for p in panels])
                    acc = _staged(xf[e], w, DM, rows, cols)
                    half = acc.shape[1] // 2
                    hg, hu = acc[:, :half], acc[:, half:]
                    a = (hg / (1 + torch.exp(-hg)) * hu).bfloat16()
                    # the warpgroup's wg columns: its panels' first half
                    first = [order[p] for p in panels[:len(panels) // 2]]
                    dst = torch.cat([torch.arange(c0 + 64 * h, c0 + 64 * h
                                                  + 64) for _, h in first])
                    act[e, rows[:, None], dst[None]] = a
    actf = act.float()
    for e in range(E):
        for r0 in range(0, C, BM):
            for c0 in range(0, DM, TD):
                for off, n, cols in ((0, 64, range(0, TD)),
                                     (64, 64, range(0, TD))) if BM == 128 \
                        else ((0, 64, range(0, TD // 2)),
                              (0, 64, range(TD // 2, TD))):
                    rows = torch.arange(r0 + off, min(C, r0 + off + n))
                    cc = torch.tensor([c0 + c for c in cols if c0 + c < DM])
                    if not len(rows) or not len(cc):
                        continue
                    acc = _staged(actf[e], wdf[e], DF, rows, cc)
                    if fuse:
                        acc = acc * gates[e, rows]
                    y[e, rows[:, None], cc[None]] = acc.bfloat16()
    return y


def _jax(x, ws, gates, cfg):
    jx = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (x, *ws)]
    jc = JaxMoEConfig(cfg.block_t, cfg.block_f, cfg.fuse_gate)
    g = None if gates is None else jnp.asarray(gates.numpy())
    out = jmoe.grouped_ffn(*jx, g, cfg=jc, interpret=True)
    return torch.from_numpy(np.array(jnp.asarray(out, jnp.float32)))


CASES = [
    # (E, C, DM, DF, cfg fields, gated): 128- and 64-row CTAs, a config
    # tile of several CTA tiles, d_model 576 (the last down tile one
    # panel wide), one expert, gates None and fuse off
    (4, 256, 512, 512, dict(block_t=128, block_f=256), True),
    (3, 192, 256, 384, dict(block_t=64, block_f=128), True),
    (2, 256, 576, 256, dict(block_t=256, block_f=256), True),
    (1, 128, 256, 256, dict(block_t=128, block_f=128), True),
    (2, 128, 512, 256, dict(block_t=64, block_f=256), False),
    (2, 256, 256, 512, dict(block_t=128, block_f=512, fuse_gate=False),
     True),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: (
    f"E{c[0]}-C{c[1]}-{c[2]}x{c[3]}-" + "-".join(
        f"{k}{v}" for k, v in c[4].items()) + ("" if c[5] else "-nogate")))
def test_the_wgmma_walk_stays_within_the_tolerance_of_the_tpu_kernel(case):
    E, C, DM, DF, fields, gated = case
    x, ws, gates = _inputs(E * C + DM, E, C, DM, DF)
    gates = gates if gated else None
    cfg = MoEConfig(**fields)
    got = emulate_ffn_wgmma(x, *ws, gates, cfg)
    want = _jax(x, ws, gates, cfg)
    err, ok = moe_error(got, want.bfloat16())
    assert ok, err
    # and the plain version the card holds the kernel to
    plain = grouped_ffn_ref(x, *ws, gates if cfg.fuse_gate else None)
    assert moe_error(got, plain)[1]
    assert not got[:, 1].any() and not got[:, -1].any()


def test_gate_and_up_pair_in_the_accumulator():
    """The thread holding hg[r, j] holds hu[r, j] 64 registers later at
    BM 128 (its warpgroup's product is [wg 128 | wu 128] columns wide,
    two registers a column pair of 8 columns), 32 at BM 64 ([wg 64 | wu
    64]): column c of an m64nN accumulator is register 4·(c // 8) +
    (c % 2) (+2 for the second row), so a shift of N/2 columns is N/4
    registers."""
    for n in (256, 128):
        reg = lambda c: 4 * (c // 8) + c % 2
        assert all(reg(c + n // 2) - reg(c) == n // 4
                   for c in range(n // 2))


def test_the_instance_follows_the_config_and_the_widths():
    """bf16 with block_t a multiple of 64, block_f of 128 and d_model of
    64 runs on wgmma; the family example's block_t 8, block_t 16 and 32,
    f32 and odd widths keep the mma.sync / FMA instance."""
    prob = fm.MoEProblem(16384, 7168, 2048, 32, 8, "bf16")
    assert fm.is_wgmma(MoEConfig(64, 512), prob)
    assert fm.is_wgmma(MoEConfig(128, 128), prob)
    for cfg in (MoEConfig(8), MoEConfig(16, 512), MoEConfig(32, 512),
                MoEConfig(128, 64), MoEConfig(96, 512)):
        assert not fm.is_wgmma(cfg, prob)
    assert not fm.is_wgmma(MoEConfig(128, 512),
                           fm.MoEProblem(16384, 96, 2048, 32, 8, "bf16"))
    assert not fm.is_wgmma(MoEConfig(128, 512),
                           fm.MoEProblem(16384, 7168, 2048, 32, 8, "f32"))
