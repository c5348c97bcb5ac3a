"""The split page walk of the paged-decode kernel, emulated in PyTorch on
the CPU and held to the JAX package's Pallas kernel in interpret mode on
the same seeded numpy inputs.

The CUDA kernel (``paged_decode.cu``) cannot run here; what it computes
differently from the TPU kernel can.  The emulation follows its rounding
points:

* each row's pages are cut into spans of ``span_pages`` pages (from the
  shapes alone), a span walks its valid positions in tiles of
  ``tile_tokens`` rows — the whole pages that fit a tile, each in a slot
  of ``page_slot`` rows (the rest of the tile masked), or tile-sized
  chunks of a longer page (its last chunk short) — and the spans' (m, l,
  o) partials merge by log-sum-exp, a row of no valid position giving
  zeros;
* the bf16 tensor-core instance (every head_dim, in tiles of 64, 128 or
  256 columns): in each tile four warps (two at width 256) each take 16
  (widths 128, 256) or 32 (width 64) rows with their own running max
  (exp2 with log2(e) folded in), scores of rows without a valid position
  are -1e30, p is float32 and P·V takes p_hi = bf16(p) and p_lo =
  bf16(p - p_hi), V exact in bf16, summed in float32 (held also against
  a control that takes p_hi alone); the warps merge at the span's end;
* the CUDA-core instance (float32): one running max a tile for each
  head, p float32 against V cast up;
* the panel route (a head_dim off the 16-byte grain or above 256): pages
  packed without slots in tiles of 64 positions (bf16: four warps of 16
  rows on mma.sync, exp2, p split as on the tensor cores) or 32 (float32:
  one running max a tile), S summed over 64-column chunks of D, zero
  columns past D, and the output in panels of 64 or 256 columns, each
  recomputing the same S: each panel's columns are the emulation's.

A group above 8 runs as several CTAs of up to 8 heads each, which read
the same pages; each head's arithmetic is the same, so the emulation
walks all heads at once.

Tolerances: bfloat16 outputs within 1e-2 of the TPU kernel's
(``TOL["bfloat16"]`` in ``chip_smoke.py``, which holds the kernel to its
plain version on the card: each side rounds its float32 result to
bfloat16 once, and one bfloat16 step at |x| < 2 is 2^-7); float32 within
2e-5 (the same products summed in another order, as in
``test_torch_paged_attention.py``)."""
import inspect

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core.families.paged_attention import \
    PagedAttentionConfig as JaxConfig
from repro.kernels.paged_attention.paged_attention import \
    paged_decode as jax_kernel
from repro_torch.core.families import paged_attention as pa
from repro_torch.core.kernelspec import tile_width
from repro_torch.kernels.paged_attention.ref import (P_SPLIT_MISMATCH,
                                                     mismatch_share)

NEG = -1e30
LOG2E = 1.4426950408889634
TOL = {torch.bfloat16: 1e-2, torch.float32: 2e-5}


def _consumers(D, sz=2):
    """Consumer warps of the tensor-core instance (``Tc<W>::kConsumers``):
    four, two at width 256, whose 16 KB tile is two 16-row slabs; four
    on the panel route's 64-position tile."""
    if pa.is_panel(D, sz):
        return 4
    return 2 if tile_width(D) == 256 else 4


def _tiles(begin, end, PS, T, slot):
    """``paged_decode.cu``'s ``Walk``: for each tile of the span's walk
    over positions [begin, end), the position each of its T rows holds
    (-1 for none)."""
    out = []
    if end <= begin:
        return out
    if PS <= T:
        pp = T // slot
        for t0 in range(begin, end, pp * PS):
            r = np.arange(T)
            j, o = r // slot, r % slot
            pos = t0 + j * PS + o
            out.append(np.where((o < PS) & (j < pp) & (pos < end), pos, -1))
        return out
    for pg0 in range(begin, end, PS):
        for c0 in range(0, PS, T):
            if pg0 + c0 >= end:
                break
            r = np.arange(T)
            pos = pg0 + c0 + r
            out.append(np.where((c0 + r < PS) & (pos < end), pos, -1))
    return out


def _cdiv(a, b):
    return -(-a // b)


def _inputs(seed, B, Hq, Hkv, D, PS, NP, lengths, dtype):
    """Seeded normals; a table of distinct pages for each row's mapped
    prefix, the null page 0 past it, as the serving engine maps them."""
    rng = np.random.default_rng(seed)
    P = B * NP + 1
    q = rng.normal(size=(B, Hq, 1, D)).astype(np.float32)
    kp = rng.normal(size=(P, Hkv, PS, D)).astype(np.float32)
    vp = rng.normal(size=(P, Hkv, PS, D)).astype(np.float32)
    perm = rng.permutation(P - 1) + 1
    table = np.zeros((B, NP), np.int32)
    for b, n in enumerate(lengths):
        table[b, :_cdiv(n, PS)] = perm[b * NP:b * NP + _cdiv(n, PS)]
    t = lambda a: torch.from_numpy(a).to(dtype)
    return (t(q), t(kp), t(vp), torch.from_numpy(table),
            torch.tensor(lengths, dtype=torch.int32))


def emulate_paged(q, kp, vp, table, lengths, *, p_terms=2, round_out=True,
                  sp=None):
    """``paged_decode.cu``'s rounding points, span by span and tile by
    tile; ``sp`` overrides the span's pages (default: ``span_pages``);
    with ``p_terms=1`` the tensor-core P·V takes p_hi alone; with
    ``round_out=False`` the float32 output before its rounding."""
    B, Hq, _, D = q.shape
    P, Hkv, PS, _ = kp.shape
    NP = table.shape[1]
    G = Hq // Hkv
    sz = q.element_size()
    # the tensor-core arithmetic: the TMA instance, and the panel route's
    # bf16 mma.sync
    tc = sz == 2 and (pa.tensor_cores(D, sz) or pa.is_panel(D, sz))
    T = pa.tile_tokens(D, sz)
    slot = pa.page_slot(PS, D, sz)
    sp = sp or pa.span_pages(B, Hkv, NP, PS, D, sz, G)
    ns = _cdiv(NP, sp)
    assert sp % pa.pages_per_step(PS, D, sz) == 0
    scale = D ** -0.5
    out = torch.zeros(B, Hq, D)
    for b in range(B):
        L = max(0, min(int(lengths[b]), NP * PS))
        # the row's pages through the table; a page wholly past the
        # length is never read (zeros here)
        live = _cdiv(L, PS)
        k = torch.zeros(Hkv, NP * PS, D)
        v = torch.zeros(Hkv, NP * PS, D)
        for j in range(live):
            k[:, j * PS:(j + 1) * PS] = kp[int(table[b, j])].float()
            v[:, j * PS:(j + 1) * PS] = vp[int(table[b, j])].float()
        k = k.repeat_interleave(G, 0)
        v = v.repeat_interleave(G, 0)
        qb = q[b, :, 0].float()                               # (Hq, D)
        parts = []
        for s in range(ns):
            begin, end = s * sp * PS, min((s + 1) * sp * PS, L)
            slices = _consumers(D, sz) if tc else 1
            m = torch.full((slices, Hq, 1), NEG)
            l = torch.zeros(slices, Hq, 1)
            o = torch.zeros(slices, Hq, D)
            for tile in _tiles(begin, end, PS, T, slot):
                for w in range(slices):
                    rows = torch.from_numpy(
                        tile[w * T // slices:(w + 1) * T // slices])
                    ok = (rows >= 0)[None]
                    idx = rows.clamp(min=0)
                    x = (qb[:, None] * k[:, idx]).sum(-1) * scale
                    x = torch.where(ok, x, torch.tensor(NEG))
                    m_new = torch.maximum(m[w], x.amax(-1, keepdim=True))
                    vv = torch.where(ok[..., None], v[:, idx], 0.0)
                    if tc:
                        alpha = torch.exp2((m[w] - m_new) * LOG2E)
                        p = torch.where(ok, torch.exp2((x - m_new) * LOG2E),
                                        torch.tensor(0.0))
                        p_hi = p.bfloat16().float()
                        pv = (p_hi[..., None] * vv).sum(1)
                        if p_terms == 2:
                            p_lo = (p - p_hi).bfloat16().float()
                            pv = pv + (p_lo[..., None] * vv).sum(1)
                    else:
                        alpha = torch.exp(m[w] - m_new)
                        p = torch.where(ok, torch.exp(x - m_new),
                                        torch.tensor(0.0))
                        pv = (p[..., None] * vv).sum(1)
                    l[w] = l[w] * alpha + p.sum(-1, keepdim=True)
                    o[w] = o[w] * alpha + pv
                    m[w] = m_new
            mm = m.amax(0)
            f = torch.exp(m - mm)
            parts.append((mm, (l * f).sum(0), (o * f).sum(0)))
        mg = torch.stack([p[0] for p in parts]).amax(0)
        lg = sum(p[1] * torch.exp(p[0] - mg) for p in parts)
        og = sum(p[2] * torch.exp(p[0] - mg) for p in parts)
        out[b] = og / torch.where(lg == 0, torch.ones_like(lg), lg)
    out = out[:, :, None]
    return out.to(q.dtype) if round_out else out


def _jax(q, kp, vp, table, lengths, dtype=None):
    """The TPU kernel in interpret mode; with ``dtype=jnp.float32`` on
    float32 copies of the inputs, its float32 output before any bf16
    rounding."""
    dt = dtype or (jnp.bfloat16 if q.dtype == torch.bfloat16
                   else jnp.float32)
    jx = [jnp.asarray(t.float().numpy(), dt) for t in (q, kp, vp)]
    out = jax_kernel(*jx, jnp.asarray(table.numpy()),
                     jnp.asarray(lengths.numpy()), cfg=JaxConfig(1),
                     interpret=True)
    return torch.from_numpy(np.array(out, np.float32))


CASES = [
    # (Hq, Hkv, D, PS, NP, lengths, dtype, span pages or None): qwen3's
    # and granite's heads; G 1, 2, 3, 8; pages of 8, 16, 32, 64 and 128
    # tokens (128: a page spans two tiles); lengths 0, 1, mid-page,
    # mid-tile, the full table, spans wholly past the length
    (16, 8, 128, 16, 32, [0, 1, 77, 512], torch.bfloat16, None),
    (24, 8, 64, 8, 64, [511, 200, 130, 33], torch.bfloat16, None),
    (8, 1, 128, 128, 6, [768, 700, 129, 64, 0], torch.bfloat16, None),
    (6, 2, 64, 32, 16, [512, 300, 1], torch.bfloat16, None),
    (8, 8, 128, 64, 8, [512, 65, 448], torch.bfloat16, None),
    # spans of several tiles at a small batch
    (16, 8, 128, 16, 32, [512, 300, 65, 0], torch.bfloat16, 8),
    (24, 8, 64, 8, 64, [512, 257, 3], torch.bfloat16, 32),
    # the CUDA-core instance: float32, bf16 at head_dim 32
    (4, 2, 128, 16, 12, [192, 100, 17, 0], torch.float32, None),
    (16, 8, 128, 128, 4, [512, 130], torch.float32, None),
    (4, 2, 32, 8, 16, [128, 5], torch.bfloat16, None),
    # the tensor-core instance at stablelm-3b's head_dim 80 (64-position
    # tiles) and gemma-7b's 256 (32 positions, two warps): pages of 8, 16
    # and 64 tokens and of 128 (two and four tiles), G 1, 2 and 4, lengths
    # 0, 1, mid-page, mid-tile
    (8, 8, 80, 16, 16, [0, 1, 77, 256], torch.bfloat16, None),
    (8, 2, 80, 64, 8, [512, 65, 1], torch.bfloat16, None),
    (4, 4, 256, 8, 16, [128, 0, 1, 77], torch.bfloat16, None),
    (2, 1, 256, 128, 4, [512, 129, 64], torch.bfloat16, None),
    # every head_dim, group and page: head_dim 96 (128-column tiles) and
    # 48 (64-column), G 16 and 71 (two and nine head blocks), pages of 2
    # (8-row slots), 24 (two 24-row slots a 64-row tile) and 512 tokens
    # (eight 64-row chunks a page), in bf16 and float32
    (8, 2, 96, 16, 8, [0, 1, 77, 128], torch.bfloat16, None),
    (4, 2, 48, 24, 6, [144, 25, 0], torch.bfloat16, None),
    (16, 1, 64, 2, 32, [64, 3, 0], torch.bfloat16, None),
    (71, 1, 64, 16, 4, [64, 17], torch.bfloat16, None),
    (4, 2, 128, 512, 2, [1024, 513, 1], torch.bfloat16, None),
    (4, 2, 96, 24, 6, [144, 49, 0], torch.float32, None),
    (16, 1, 48, 2, 32, [64, 5], torch.float32, None),
    (71, 1, 64, 512, 2, [1024, 1], torch.float32, None),
    # the panel route: bf16 head_dim 100 (rows of 200 bytes, 8-byte
    # copies), 33 (odd: 2-byte copies) and 320 (two 256-column panels),
    # float32 50 (8-byte copies) and 320 with 128-token pages (four
    # 32-row chunks a page)
    (16, 8, 100, 16, 8, [0, 1, 77, 128], torch.bfloat16, None),
    (8, 4, 33, 8, 8, [64, 9, 0], torch.bfloat16, None),
    (4, 2, 320, 16, 6, [96, 17, 0], torch.bfloat16, None),
    (4, 2, 50, 16, 6, [96, 33, 0], torch.float32, None),
    (4, 2, 320, 128, 2, [256, 129], torch.float32, None),
]


def _id(c):
    return (f"{c[0]}-{c[1]}x{c[2]}-ps{c[3]}-"
            f"{'bf16' if c[6] == torch.bfloat16 else 'f32'}"
            + (f"-sp{c[7]}" if c[7] else ""))


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_the_split_walk_stays_within_the_tolerance_of_the_tpu_kernel(case):
    Hq, Hkv, D, PS, NP, lengths, dtype, sp = case
    assert pa.pages_per_step(PS, D, torch.tensor([], dtype=dtype)
                             .element_size())
    args = _inputs(sum(lengths), len(lengths), Hq, Hkv, D, PS, NP,
                   lengths, dtype)
    got = emulate_paged(*args, sp=sp)
    want = _jax(*args)
    err = float((got.float() - want).abs().max())
    assert err <= TOL[dtype], err
    for b, n in enumerate(lengths):
        if n == 0:
            assert not got[b].any()


# The emulated float32 output's largest row error, relative to the row's
# norm, against the TPU kernel's float32 output: the split gives
# 2.0-3.0e-6 over these cases, p_hi alone 1.4-2.0e-3 (and 0.09-0.26%
# against 21-35% of the bf16 outputs off the TPU kernel's).
SPLIT_ROW_REL = 2.0 ** -14

TC_CASES = [c for c in CASES if c[6] == torch.bfloat16 and c[2] >= 64
            and c[0] <= 16]


@pytest.mark.parametrize("case", TC_CASES, ids=_id)
def test_p_split_keeps_float32_accuracy_where_p_hi_alone_does_not(case):
    """The control of the split P·V: the emulation with p_hi + p_lo and
    with p_hi alone, each held to the TPU kernel in float32 (before the
    bf16 rounding, by each row's relative error) and at the bf16 output
    (by the share of outputs that differ from the kernel's bf16 rounding
    of its float32 result, ``P_SPLIT_MISMATCH``, which the card checks
    too).  The split passes both limits; p_hi alone fails both."""
    Hq, Hkv, D, PS, NP, lengths, dtype, sp = case
    args = _inputs(sum(lengths), len(lengths), Hq, Hkv, D, PS, NP,
                   lengths, dtype)
    want = _jax(*args, dtype=jnp.float32)
    live = args[4] > 0
    got = {n: emulate_paged(*args, p_terms=n, round_out=False, sp=sp)
           for n in (2, 1)}
    rel = {n: float(((g - want)[live].norm(dim=-1)
                     / want[live].norm(dim=-1)).max())
           for n, g in got.items()}
    share = {n: mismatch_share(g.bfloat16(), want.bfloat16(), args[4])
             for n, g in got.items()}
    assert rel[2] <= SPLIT_ROW_REL < rel[1], rel
    assert share[2] <= P_SPLIT_MISMATCH < share[1], share


def test_the_number_of_spans_depends_on_the_shapes_alone():
    """span_pages reads shapes only (the host never reads the lengths),
    a span is whole tiles, and the split aims at ``SPAN_TARGET_CTAS``
    CTAs without cutting a row finer than one tile a span."""
    params = list(inspect.signature(pa.span_pages).parameters)
    assert params == ["batch", "kv_heads", "pages_per_seq", "page_size",
                      "head_dim", "itemsize", "group"]
    for B, Hkv, NP, PS, D, sz, G in ((8, 8, 128, 16, 128, 2, 2),
                                     (8, 8, 128, 16, 64, 2, 3),
                                     (32, 1, 64, 128, 128, 2, 8),
                                     (8, 8, 125, 16, 128, 2, 2),
                                     (3, 2, 6, 16, 128, 4, 4),
                                     (8, 2, 85, 24, 128, 2, 16),
                                     (4, 1, 16, 512, 64, 2, 71),
                                     (2, 2, 512, 2, 96, 2, 12)):
        step = pa.pages_per_step(PS, D, sz)
        sp = pa.span_pages(B, Hkv, NP, PS, D, sz, G)
        assert sp % step == 0
        ns = _cdiv(NP, sp)
        ctas = B * Hkv * pa.head_blocks(G)
        assert ctas * ns < pa.SPAN_TARGET_CTAS + ctas * (sp // step)
        assert sp == step or ctas * _cdiv(NP, sp - step) \
            > pa.SPAN_TARGET_CTAS


def test_pages_past_the_length_are_never_read():
    """Poisoned pages past each row's length, in its last page's tail
    and on the null page leave the emulated walk bit-identical: the walk
    masks scores to -1e30, gives them p = 0 and zero V rows."""
    args = _inputs(5, 4, 16, 8, 128, 16, 32, [0, 1, 77, 512],
                   torch.bfloat16)
    q, kp, vp, table, lengths = args
    kp2, vp2 = kp.clone(), vp.clone()
    mapped = {int(t) for b, n in enumerate(lengths.tolist())
              for t in table[b, :_cdiv(n, 16)]}
    for p in range(kp.shape[0]):
        if p not in mapped:
            kp2[p] = 1e6
            vp2[p] = 1e6
    for b, n in enumerate(lengths.tolist()):
        if n % 16:
            last = int(table[b, n // 16])
            kp2[last, :, n % 16:] = 1e6
            vp2[last, :, n % 16:] = 1e6
    assert torch.equal(emulate_paged(*args),
                       emulate_paged(q, kp2, vp2, table, lengths))
