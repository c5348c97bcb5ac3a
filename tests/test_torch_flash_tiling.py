"""The flash kernels' blocked arithmetic, emulated in PyTorch on the CPU
and held to the JAX package's Pallas kernels in interpret mode on the
same seeded numpy inputs, within the tolerance stated beside
``flash_error`` (``repro_torch/kernels/flash_attention/ref.py``).

The CUDA kernels cannot run here; what they compute differently from
the TPU kernels can.  The emulation follows their rounding points:

* prefill (``flash_attention.cu``): each query row walks the keys in
  the CTA's key tiles (128 keys on the 128- and 64-row bf16 tiles, 64
  at width 256 and on the 32- and 16-row ones: ``key_tile``), updating
  its running max
  once a tile in log2 units (exp2 with log2(e) folded into the scale),
  p rounded to v's type against that max, l summing the float32 p;
* decode (``flash_decode.cu``): each span is read in tiles of
  ``tile_tokens`` positions, each of four warps (two at width 256)
  keeping its own running
  (m, l, o) over its slice of every tile; the warps merge in float32 at
  the span's end, and the spans' partials merge by ``combine`` (the
  plain version of the combine kernel);
* the panel route of both (a head_dim off the 16-byte grain or above
  256, ``panel_attention.cuh``): the prefill over 64-key chunks in bf16
  and 32 in f32 (``key_tile`` of ``route_tile``), the decode over
  64-position tiles in four 16-row warp slices (bf16) or 32-position
  tiles (f32); S over 64-column chunks of D (the same sums), each output
  panel recomputing the same S, so each panel's columns are the
  emulation's.

So these cases check the tolerance argument beside ``flash_error`` for
the kernels' tile sizes: Sq and Skv ragged against 128, Skv < Sq,
groups 1, 2, 4, 8, 16 and 71, head_dim 48, 64, 96, 128 and 136 (the
three tile widths), kv_len 0, kv_len not a multiple of the tile, and
spans shorter than a tile.  A head_dim below its width only adds zero
columns, which change no sum: the emulation runs at head_dim itself."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels.flash_attention import mha as jax_mha
from repro.kernels.flash_attention import mha_decode as jax_mha_decode
from repro.core.families.flash_attention import \
    FlashAttentionConfig as JaxFACfg
from repro.core.families.flash_decode import FlashDecodeConfig as JaxFDCfg
from repro_torch.core.families import flash_attention as fa
from repro_torch.core.families import flash_decode as fd
from repro_torch.core.kernelspec import on_grain
from repro_torch.kernels.flash_attention import flash_error, mha_decode
from repro_torch.kernels.flash_attention.decode import combine

NEG = -1e30
LOG2E = 1.4426950408889634
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(seed, B, Hq, Hkv, Sq, Skv, D, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .to(dtype) for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D),
                                 (B, Hkv, Skv, D))]


def _jax(t):
    return jnp.asarray(t.float().numpy(), JDT[t.dtype])


def _torch(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _online(q, k, v, blocks, scale):
    """Online softmax of q (..., R, D) over key blocks, in order: each a
    pair (indices into k, v (..., N, D), the mask of admitted pairs,
    broadcast to the scores); the max in natural-log units, exp2 with
    log2(e) folded in.  Returns float32 (m, l, o), o unnormalised."""
    m = torch.full(q.shape[:-1] + (1,), NEG)
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape[:-1] + (v.shape[-1],))
    for idx, ok in blocks:
        kk, vv = k[..., idx, :].float(), v[..., idx, :]
        s = torch.where(ok, (q.float() @ kk.transpose(-1, -2)) * scale,
                        torch.tensor(NEG))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * LOG2E)
        p = torch.where(ok, torch.exp2((s - m_new) * LOG2E),
                        torch.tensor(0.0))
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(vv.dtype).float() @ vv.float()
        m = m_new
    return m, l, o


def emulate_prefill(q, k, v, *, causal, key_tile):
    """``flash_attention.cu``: every query row over the key tiles."""
    G = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    Sq, Skv = q.shape[2], k.shape[2]
    qpos = torch.arange(Sq)[:, None]
    blocks = []
    for k0 in range(0, Skv, key_tile):
        idx = torch.arange(k0, min(k0 + key_tile, Skv))
        blocks.append((idx, qpos >= idx[None, :] if causal
                       else torch.ones(1, len(idx), dtype=torch.bool)))
    _, l, o = _online(q, k, v, blocks, q.shape[-1] ** -0.5)
    return (o / torch.where(l == 0, torch.ones_like(l), l)).to(q.dtype)


def emulate_decode(q, k, v, kv_len, ns):
    """``flash_decode.cu``: each span in tiles, four warps (bf16; one
    walk in f32) each over its slice of every tile, merged; the spans'
    partials merged by ``combine``."""
    B, Hq, _, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    T = fd.tile_tokens(D, q.element_size())
    warps = (1 if q.dtype != torch.bfloat16
             else 4 if not on_grain(D, 2)
             else 2 if fd.tile_width(D) == 256 else 4)
    slab = T // warps
    span, length = S // ns, max(0, min(kv_len, S))
    o_p, m_p, l_p = [], [], []
    for s in range(ns):
        begin, end = s * span, min(s * span + span, length)
        n_tiles = -(-(end - begin) // T) if end > begin else 0
        m_w, l_w, o_w = [], [], []
        for w in range(warps):
            blocks = []
            for i in range(n_tiles):
                pos = begin + i * T + w * slab + torch.arange(slab)
                blocks.append((pos.clamp(max=S - 1), (pos < end)[None, :]))
            m, l, o = _online(q, k, v, blocks, D ** -0.5)
            m_w.append(m)
            l_w.append(l)
            o_w.append(o)
        m = torch.stack(m_w).amax(0)
        f = [torch.exp(mw - m) for mw in m_w]
        o_p.append(sum(ow * fw for ow, fw in zip(o_w, f)))
        l_p.append(sum(lw * fw for lw, fw in zip(l_w, f)))
        m_p.append(m)
    o = torch.stack(o_p, dim=2).reshape(B * Hq, ns, D)
    m = torch.stack(m_p, dim=2).reshape(B * Hq, ns, 1)
    l = torch.stack(l_p, dim=2).reshape(B * Hq, ns, 1)
    return combine(o, m, l).reshape(B, Hq, 1, D).to(q.dtype)


PREFILL = [
    # (B, Hq, Hkv, Sq, Skv, D, causal, block_q, dtype): block_q 128 and
    # 64 walk 128-key tiles, 32 64-key chunks; Sq and Skv ragged against
    # 128, Skv < Sq, groups 1, 2 and 4
    (1, 2, 1, 200, 300, 64, True, 128, torch.bfloat16),
    (1, 4, 2, 257, 129, 128, True, 64, torch.bfloat16),
    (1, 2, 2, 130, 390, 64, False, 128, torch.bfloat16),
    (1, 4, 1, 200, 300, 128, True, 32, torch.bfloat16),
    (1, 2, 1, 150, 260, 64, True, 128, torch.float32),
    # head_dim 96 and 48, 136 (width 256: 64-key wgmma tiles), G 16
    (1, 2, 2, 200, 300, 96, True, 128, torch.bfloat16),
    (1, 4, 2, 130, 200, 48, False, 16, torch.bfloat16),
    (1, 2, 1, 200, 300, 136, True, 64, torch.bfloat16),
    (1, 16, 1, 130, 130, 64, True, 128, torch.bfloat16),
    (1, 2, 1, 150, 260, 96, True, 32, torch.float32),
    # the panel route: bf16 head_dim 100, 33 (odd) and 320 (two panels),
    # float32 50 and 320
    (1, 4, 2, 200, 150, 100, True, 128, torch.bfloat16),
    (1, 2, 1, 130, 200, 33, False, 64, torch.bfloat16),
    (1, 2, 1, 150, 130, 320, True, 128, torch.bfloat16),
    (1, 2, 1, 150, 130, 50, True, 64, torch.float32),
    (1, 2, 1, 100, 130, 320, False, 32, torch.float32),
]


@pytest.mark.parametrize("case", PREFILL, ids=lambda c: "x".join(
    map(str, c[:6])) + f"-bq{c[7]}-{str(c[8])[6:]}")
def test_prefill_tiles_stay_within_the_tolerance_of_the_tpu_kernel(case):
    B, Hq, Hkv, Sq, Skv, D, causal, bq, dt = case
    q, k, v = _inputs(Sq + Skv, B, Hq, Hkv, Sq, Skv, D, dt)
    dn = "bf16" if dt == torch.bfloat16 else "f32"
    tile = fa.key_tile(fa.route_tile(bq, D, dn), dn, D)
    got = emulate_prefill(q, k, v, causal=causal, key_tile=tile)
    want = _torch(jax_mha(_jax(q), _jax(k), _jax(v),
                          cfg=JaxFACfg(block_q=64, block_kv=64),
                          causal=causal, interpret=True), dt)
    err, row, ok = flash_error(got, want)
    assert ok, (tile, err, row)


DECODE = [
    # (B, Hq, Hkv, S, D, kv_len, kv_splits, dtype): groups 8, 2, 4 and 1;
    # kv_len not a multiple of the tile (64 positions at D 128, 128 at
    # 64), kv_len 0, spans shorter than a tile
    (1, 8, 1, 512, 128, 300, 4, torch.bfloat16),
    (1, 4, 2, 512, 64, 512, 2, torch.bfloat16),
    (1, 4, 1, 256, 128, 0, 2, torch.bfloat16),
    (2, 1, 1, 256, 64, 200, 8, torch.bfloat16),
    (1, 4, 1, 1024, 128, 1000, 32, torch.bfloat16),
    (1, 8, 2, 512, 128, 450, 4, torch.float32),
    # head_dim 96 and 48, 136 (width 256: 32-position tiles, two warps),
    # G 16 and 71
    (1, 4, 2, 512, 96, 300, 4, torch.bfloat16),
    (1, 4, 1, 256, 48, 200, 2, torch.bfloat16),
    (1, 2, 1, 256, 136, 250, 2, torch.bfloat16),
    (1, 16, 1, 512, 128, 400, 4, torch.bfloat16),
    (1, 71, 1, 256, 64, 200, 2, torch.bfloat16),
    (1, 71, 1, 256, 48, 130, 2, torch.float32),
    # the panel route: bf16 head_dim 100, 33 and 320, float32 50 and 320
    (1, 8, 2, 512, 100, 300, 4, torch.bfloat16),
    (1, 4, 1, 256, 33, 200, 2, torch.bfloat16),
    (1, 4, 2, 256, 320, 250, 2, torch.bfloat16),
    (1, 4, 2, 256, 50, 130, 2, torch.float32),
    (1, 2, 1, 256, 320, 100, 2, torch.float32),
]


@pytest.mark.parametrize("case", DECODE, ids=lambda c: "x".join(
    map(str, c[:7])) + f"-{str(c[7])[6:]}")
def test_decode_tiles_stay_within_the_tolerance_of_the_tpu_kernel(case):
    B, Hq, Hkv, S, D, kv_len, ns, dt = case
    q, k, v = _inputs(S + kv_len, B, Hq, Hkv, 1, S, D, dt)
    got = emulate_decode(q, k, v, kv_len, ns)
    want = _torch(jax_mha_decode(_jax(q), _jax(k), _jax(v),
                                 jnp.int32(kv_len), cfg=JaxFDCfg(ns),
                                 interpret=True), dt)
    err, row, ok = flash_error(got, want)
    assert ok, (err, row)
    if kv_len == 0:
        assert not want.any() and not got.any()


def test_mha_decode_on_the_cpu_writes_zeros_at_kv_len_zero():
    """No valid position: the TPU kernel's spans all have l = 0 and its
    combine writes zeros; the port's CPU path writes them too (the plain
    softmax over an all-masked row would average V)."""
    q, k, v = _inputs(3, 2, 4, 2, 1, 64, 16, torch.float32)
    got = mha_decode(q, k, v, 0, cfg=fd.FlashDecodeConfig(4))
    want = jax_mha_decode(_jax(q), _jax(k), _jax(v), jnp.int32(0),
                          cfg=JaxFDCfg(4), interpret=True)
    assert not np.asarray(want).any()
    assert torch.equal(got, torch.zeros_like(q))
