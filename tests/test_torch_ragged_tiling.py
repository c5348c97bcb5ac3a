"""The blocked arithmetic of the two redesigned kernels, emulated in
PyTorch on the CPU and held to the JAX package's Pallas kernels in
interpret mode on the same seeded numpy inputs.

The CUDA kernels cannot run here; what they compute differently from
the TPU kernels can.  The emulations follow their rounding points:

* ragged prefill's bf16 wgmma instance (``ragged_prefill.cu``,
  ``ragged_wgmma_kernel``): a CTA of 128 packed queries of one head
  walks only the key tiles (128 keys, 64 at width 256) whose metadata
  summary may admit one of its pairs (the kernel's live list, decided
  from each tile's segment and position range), in order; head_dim D in
  the tiles of the least width of 64, 128 and 256 columns at or above
  it, columns D.. zero (TMA's fill) and not stored; S = Q·Kᵀ in float32
  from bf16
  products; the mask; the running max once a tile in log2 units; p in
  float32, l summing it; P·V as p_hi·V + p_lo·V with p_hi = bf16(p) and
  p_lo = bf16(p - p_hi), V exact in bf16, summed in float32, held also
  against a control that takes p_hi alone.  Tolerance:
  bfloat16 outputs within 1e-2 of the TPU kernel's (``TOL["bfloat16"]``
  in ``chip_smoke.py``, which holds the kernel to its plain version on
  the card): each side rounds its float32 result to bfloat16 once, and
  one bfloat16 step at |x| < 2 is 2^-7.
* the GEMM's wgmma instances (``gemm.cu``, ``gemm_wgmma_kernel``): each
  128 x TN CTA tile walks its config tile's K blocks in the config's
  order (``stagger_k``) or its split's range (``split_k``, float32
  partials summed after), each block in 64-deep stages, the last one
  shorter, accumulating in float32.  Tolerance: a float32 output within
  ``GEMM_REL`` = 1e-5 of the largest |output| (``chip_smoke.py``): the
  same exact bf16 products summed in another order."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core.families.gemm import GemmConfig as JaxGemmConfig
from repro.kernels import gemm as jgemm
from repro.kernels.ragged_prefill import default_config as jax_default
from repro.kernels.ragged_prefill.ragged_prefill import \
    ragged_prefill as jax_ragged
from repro_torch.core.families import gemm as fg
from repro_torch.core.families import ragged_prefill as fr
from repro_torch.core.families.gemm import GemmConfig, GemmProblem
from repro_torch.core.kernelspec import tile_width
from repro_torch.kernels.ragged_prefill.ref import (P_SPLIT_MISMATCH,
                                                    mismatch_share)

NEG = -1e30
LOG2E = 1.4426950408889634
TOL_BF16 = 1e-2
GEMM_REL = 1e-5


# -- ragged prefill ----------------------------------------------------------

def _packed(seed, chunks, prefixes, Hq, Hkv, D, tail=0):
    """Engine-style packing (both extents padded to 64 tokens, then
    ``tail`` more padding keys): segment j's queries are its chunk at
    positions prefix..prefix+n, its keys positions 0..prefix+n."""
    rng = np.random.default_rng(seed)
    pad = lambda t: -(-t // 64) * 64
    TQ = pad(sum(chunks))
    TK = pad(sum(p + n for p, n in zip(prefixes, chunks))) + tail
    seg_q = np.full(TQ, -1, np.int32)
    pos_q = np.zeros(TQ, np.int32)
    seg_k = np.full(TK, -1, np.int32)
    pos_k = np.zeros(TK, np.int32)
    qt = kt = 0
    for j, (p, n) in enumerate(zip(prefixes, chunks)):
        seg_q[qt:qt + n] = j
        pos_q[qt:qt + n] = np.arange(p, p + n)
        seg_k[kt:kt + p + n] = j
        pos_k[kt:kt + p + n] = np.arange(p + n)
        qt += n
        kt += p + n
    bf = lambda s: torch.from_numpy(
        rng.normal(size=s).astype(np.float32)).bfloat16()
    return (bf((Hq, TQ, D)), bf((Hkv, TK, D)), bf((Hkv, TK, D)),
            seg_q, pos_q, seg_k, pos_k)


def _summary(seg, pos):
    """The kernel's metadata summary of a set of tokens: (least segment
    with padding as -1, least and greatest real segment, least and
    greatest real position)."""
    real = seg >= 0
    if not real.any():
        return int(seg.min()), 2 ** 31 - 1, -1, 2 ** 31 - 1, -2 ** 31
    return (int(seg.min()), int(seg[real].min()), int(seg[real].max()),
            int(pos[real].min()), int(pos[real].max()))


def live_tiles(seg_q, pos_q, seg_k, pos_k, q0, TQ, bk=fr.WGMMA_BK):
    """The ``bk``-key tiles the CTA of queries [q0, q0 + 128) walks: a
    tile whose real segments overlap the rows' and whose first position
    is not past the rows' last."""
    rows = np.arange(q0, q0 + fr.WGMMA_BQ)
    sq = np.where(rows < TQ, seg_q[np.minimum(rows, TQ - 1)], -1)
    pq = np.where(rows < TQ, pos_q[np.minimum(rows, TQ - 1)], 0)
    _, c_smin, c_smax, _, c_pmax = _summary(sq, pq)
    TK = len(seg_k)
    out = []
    for t in range(-(-TK // bk)):
        keys = np.arange(t * bk, (t + 1) * bk)
        sk = np.where(keys < TK, seg_k[np.minimum(keys, TK - 1)], -1)
        pk = np.where(keys < TK, pos_k[np.minimum(keys, TK - 1)], 0)
        _, smin, smax, pmin, _ = _summary(sk, pk)
        if smax >= 0 and smax >= c_smin and smin <= c_smax \
                and pmin <= c_pmax:
            out.append(t)
    return out


def emulate_ragged_wgmma(q, k, v, seg_q, pos_q, seg_k, pos_k, *,
                         p_terms=2, round_out=True):
    """``ragged_wgmma_kernel``'s rounding points, CTA by CTA.  With
    ``p_terms=1`` P·V takes p_hi alone (the control the split is held
    against); with ``round_out=False`` the float32 output before its
    rounding to bf16."""
    Hq, TQ, D = q.shape
    Hkv, TK, _ = k.shape
    G = Hq // Hkv
    _, bk = fr.kernel_blocks(fr.RaggedPrefillProblem(1, TK, Hq, Hkv, D,
                                                     "bf16"))
    # rows of the kernel's tiles (64, 128 or 256 columns), the columns
    # past D TMA's zero fill
    pad = lambda t: torch.nn.functional.pad(t.float(),
                                            (0, tile_width(D) - D))
    kf = pad(k).repeat_interleave(G, 0)
    vf = pad(v).repeat_interleave(G, 0)
    sl2 = D ** -0.5 * LOG2E
    sq, pq = torch.from_numpy(seg_q), torch.from_numpy(pos_q)
    sk, pk = torch.from_numpy(seg_k), torch.from_numpy(pos_k)
    out = torch.zeros(Hq, TQ, D)
    for q0 in range(0, TQ, fr.WGMMA_BQ):
        rows = slice(q0, min(q0 + fr.WGMMA_BQ, TQ))
        qq = pad(q[:, rows])
        m = torch.full(qq.shape[:-1] + (1,), NEG)
        l = torch.zeros_like(m)
        o = torch.zeros(qq.shape)
        for t in live_tiles(seg_q, pos_q, seg_k, pos_k, q0, TQ, bk):
            keys = slice(t * bk, min((t + 1) * bk, TK))
            ok = ((sq[rows, None] == sk[None, keys]) & (sq[rows, None] >= 0)
                  & (pk[None, keys] <= pq[rows, None]))
            s = qq @ kf[:, keys].transpose(-1, -2)
            x = torch.where(ok, s * sl2, torch.tensor(NEG))
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.where(ok, torch.exp2(x - m_new), torch.tensor(0.0))
            p_hi = p.bfloat16().float()
            p_lo = (p - p_hi).bfloat16().float()
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha + p_hi @ vf[:, keys]
            if p_terms == 2:
                o = o + p_lo @ vf[:, keys]
            m = m_new
        out[:, rows] = (o / torch.where(l == 0, torch.ones_like(l),
                                        l))[..., :D]
    return out.bfloat16() if round_out else out


def _jax_ragged(q, k, v, seg_q, pos_q, seg_k, pos_k, dtype=jnp.bfloat16):
    """The TPU kernel in interpret mode; with ``dtype=jnp.float32`` on
    float32 copies of the bf16 inputs, its float32 output before any
    bf16 rounding."""
    jx = [jnp.asarray(t.float().numpy(), dtype) for t in (q, k, v)]
    jm = [jnp.asarray(a) for a in (seg_q, pos_q, seg_k, pos_k)]
    cfg = jax_default(q.shape[1], k.shape[1])
    out = jax_ragged(*jx, *jm, cfg=cfg, interpret=True)
    return torch.from_numpy(np.asarray(out, np.float32))


RAGGED = [
    # (Hq, Hkv, D, chunks, prefixes, tail): qwen3's and granite's head
    # counts; G = 1, 2, 3 and 8; segments shorter than a tile and
    # starting mid-tile; prefixes up to 768; a 64-row query tail (the
    # second warpgroup all padding) and all-padding key tiles
    (16, 8, 128, [200, 56], [768, 0], 0),
    (24, 8, 64, [40, 64, 7, 100], [0, 30, 200, 64], 128),
    (4, 4, 64, [130, 5, 60], [300, 700, 0], 256),
    (6, 2, 128, [3, 125, 64], [0, 100, 600], 0),
    (8, 1, 64, [64, 64], [768, 128], 128),
    # stablelm-3b's head_dim 80 (D = 128's tiles, zero-filled past 80)
    # and gemma-7b's 256 (64-key tiles), G = 1 and 2
    (4, 4, 80, [130, 5, 60], [300, 700, 0], 256),
    (2, 1, 256, [40, 64, 7, 100], [0, 30, 200, 64], 64),
    # every head_dim and group: 96 (128-column tiles), 48 and 24
    # (64-column, 24 with a half-zero last k step), 136 (256-column,
    # 64-key tiles); G 16 and 71
    (8, 2, 96, [130, 5, 60], [300, 100, 0], 0),
    (4, 2, 48, [40, 64, 7], [0, 30, 200], 64),
    (2, 2, 24, [100, 28], [64, 0], 0),
    (2, 1, 136, [40, 64, 7], [0, 30, 200], 0),
    (16, 1, 64, [60, 40], [100, 0], 0),
    (71, 1, 64, [30, 20], [40, 0], 0),
]


@pytest.mark.parametrize("case", RAGGED, ids=lambda c: (
    f"{c[0]}-{c[1]}x{c[2]}-" + "_".join(map(str, c[3]))))
def test_ragged_wgmma_tiles_stay_within_the_tolerance_of_the_tpu_kernel(
        case):
    Hq, Hkv, D, chunks, prefixes, tail = case
    q, k, v, sq, pq, sk, pk = _packed(sum(chunks), chunks, prefixes, Hq,
                                      Hkv, D, tail)
    assert fr.is_wgmma(fr.RaggedPrefillProblem(len(chunks), k.shape[1], Hq,
                                               Hkv, D, "bf16"))
    got = emulate_ragged_wgmma(q, k, v, sq, pq, sk, pk)
    want = _jax_ragged(q, k, v, sq, pq, sk, pk)
    err = float((got.float() - want).abs().max())
    assert err <= TOL_BF16, err
    assert not got[:, torch.from_numpy(sq) < 0].any()


# The emulated float32 output's largest row error, relative to the row's
# norm, against the TPU kernel's float32 output: the split gives 3.3-4.0e-6
# over RAGGED, p_hi alone 2.2-2.6e-3.
SPLIT_ROW_REL = 2.0 ** -14


@pytest.mark.parametrize("case", RAGGED, ids=lambda c: (
    f"{c[0]}-{c[1]}x{c[2]}-" + "_".join(map(str, c[3]))))
def test_p_split_keeps_float32_accuracy_where_p_hi_alone_does_not(case):
    """The control of the split P·V: the emulation with p_hi + p_lo and
    with p_hi alone, each held to the TPU kernel in float32 (before the
    bf16 rounding, by each row's relative error) and at the bf16 output
    (by the share of outputs that differ from the kernel's bf16 rounding
    of its float32 result, ``P_SPLIT_MISMATCH``, which the card checks
    too).  The split passes both limits; p_hi alone fails both."""
    Hq, Hkv, D, chunks, prefixes, tail = case
    q, k, v, sq, pq, sk, pk = _packed(sum(chunks), chunks, prefixes, Hq,
                                      Hkv, D, tail)
    want = _jax_ragged(q, k, v, sq, pq, sk, pk, dtype=jnp.float32)
    real = torch.from_numpy(sq)
    rows = real >= 0
    got = {n: emulate_ragged_wgmma(q, k, v, sq, pq, sk, pk, p_terms=n,
                                   round_out=False) for n in (2, 1)}
    rel = {n: float(((g - want)[:, rows].norm(dim=-1)
                     / want[:, rows].norm(dim=-1)).max())
           for n, g in got.items()}
    share = {n: mismatch_share(g.bfloat16(), want.bfloat16(), real)
             for n, g in got.items()}
    assert rel[2] <= SPLIT_ROW_REL < rel[1], rel
    assert share[2] <= P_SPLIT_MISMATCH < share[1], share


def test_the_walk_skips_what_admits_nothing_and_keeps_every_admitted_pair():
    """The live list is exact: every admitted (query, key) pair of a CTA
    lies in one of its live tiles, and at the serving tick's packing a
    CTA walks about its segment's prefix, not the whole buffer."""
    chunks, prefixes = [256] * 7 + [200], [0, 256, 512, 768] * 2
    _, _, _, sq, pq, sk, pk = _packed(0, chunks, prefixes, 1, 1, 64)
    TQ, TK = len(sq), len(sk)
    walked = 0
    for q0 in range(0, TQ, fr.WGMMA_BQ):
        tiles = set(live_tiles(sq, pq, sk, pk, q0, TQ))
        rows = np.arange(q0, min(q0 + fr.WGMMA_BQ, TQ))
        ok = ((sq[rows, None] == sk[None, :]) & (sq[rows, None] >= 0)
              & (pk[None, :] <= pq[rows, None]))
        assert set(np.nonzero(ok.any(0))[0] // fr.WGMMA_BK) <= tiles
        walked += len(tiles)
    n_tiles = -(-TK // fr.WGMMA_BK)
    assert walked < 0.2 * n_tiles * (TQ // fr.WGMMA_BQ)


def test_the_walk_at_head_dim_256_takes_64_key_tiles():
    """At head_dim 256 the kernel's key tiles are 64 keys: the live list
    over them is exact too, and at the serving tick's packing it walks
    no more keys than the 128-key list does."""
    chunks, prefixes = [256] * 7 + [200], [0, 256, 512, 768] * 2
    _, _, _, sq, pq, sk, pk = _packed(0, chunks, prefixes, 1, 1, 8)
    prob = fr.RaggedPrefillProblem(8, len(sk), 16, 16, 256, "bf16")
    assert fr.kernel_blocks(prob) == (128, 64)
    TQ = len(sq)
    for q0 in range(0, TQ, fr.WGMMA_BQ):
        t64 = live_tiles(sq, pq, sk, pk, q0, TQ, 64)
        t128 = live_tiles(sq, pq, sk, pk, q0, TQ)
        rows = np.arange(q0, min(q0 + fr.WGMMA_BQ, TQ))
        ok = ((sq[rows, None] == sk[None, :]) & (sq[rows, None] >= 0)
              & (pk[None, :] <= pq[rows, None]))
        assert set(np.nonzero(ok.any(0))[0] // 64) <= set(t64)
        assert 64 * len(t64) <= 128 * len(t128)


def test_p_split_in_two_bf16_terms_keeps_float32_accuracy():
    """p_hi + p_lo is within 2^-16 of p relatively (each term rounds to
    8 significant bits: the residual of the second is at most 2^-9 of
    p - p_hi, itself at most 2^-9 of p), where p_hi alone is within
    2^-9 only."""
    p = torch.from_numpy(np.random.default_rng(0).uniform(
        1e-6, 1.0, 100_000).astype(np.float32))
    p_hi = p.bfloat16().float()
    p_lo = (p - p_hi).bfloat16().float()
    assert float(((p_hi + p_lo - p).abs() / p).max()) <= 2.0 ** -16
    assert float(((p_hi - p).abs() / p).max()) > 2.0 ** -12


# -- GEMM ----------------------------------------------------------------------

def emulate_gemm_wgmma(a, b, cfg: GemmConfig):
    """``gemm_wgmma_kernel``'s K walk: each CTA tile of each config tile
    over its K blocks in the config's order, in 64-deep stages."""
    m, k = a.shape
    n = b.shape[1]
    tm, tn = fg.cta_tile(cfg, GemmProblem(m, n, k, "bf16"))
    nk_total = -(-k // cfg.bk)
    split = max(cfg.split_k, 1)
    nk = nk_total // split
    af, bf = a.float(), b.float()
    parts = torch.zeros(split, m, n)
    for s in range(split):
        for ti in range(-(-m // cfg.bm)):
            for tj in range(-(-n // cfg.bn)):
                for r0 in range(ti * cfg.bm, min(m, ti * cfg.bm + cfg.bm),
                                tm):
                    for c0 in range(tj * cfg.bn,
                                    min(n, tj * cfg.bn + cfg.bn), tn):
                        rows, cols = slice(r0, r0 + tm), slice(c0, c0 + tn)
                        acc = torch.zeros(min(tm, m - r0), min(tn, n - c0))
                        for t in range(nk):
                            kb = (s * nk + t if split > 1 else
                                  (t + ti + tj) % nk_total if cfg.stagger_k
                                  else t)
                            for k0 in range(kb * cfg.bk,
                                            min(k, kb * cfg.bk + cfg.bk),
                                            fg.WGMMA_DEPTH):
                                ks = slice(k0, min(k, k0 + fg.WGMMA_DEPTH))
                                acc += af[rows, ks] @ bf[ks, cols]
                        parts[s, rows, cols] = acc
    return parts.sum(0)


GEMM = [
    # (m, n, k, cfg fields): a ragged edge in m, n and k (the last K block
    # shorter than a stage), stagger over a config tile of several CTA
    # tiles, split_k 2 and 4
    (200, 384, 328, dict(bm=128, bn=256, bk=128, stagger_k=True)),
    (256, 512, 640, dict(bm=256, bn=512, bk=192, stagger_k=True)),
    (128, 256, 1024, dict(bm=128, bn=128, bk=128, split_k=2)),
    (256, 128, 1024, dict(bm=128, bn=128, bk=64, split_k=4)),
]


@pytest.mark.parametrize("m,n,k,fields", GEMM)
def test_gemm_stage_walk_stays_within_the_tolerance_of_the_tpu_kernel(
        m, n, k, fields):
    rng = np.random.default_rng(m + n + k)
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).bfloat16()
    cfg = GemmConfig(**fields)
    assert fg.is_wgmma(cfg, GemmProblem(m, n, k, "bf16"))
    got = emulate_gemm_wgmma(a, b, cfg)
    want = np.asarray(jgemm.matmul(
        jnp.asarray(a.float().numpy(), jnp.bfloat16),
        jnp.asarray(b.float().numpy(), jnp.bfloat16),
        cfg=JaxGemmConfig(**fields), out_dtype=jnp.float32, interpret=True),
        np.float32)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= GEMM_REL * float(np.abs(want).max()), err
