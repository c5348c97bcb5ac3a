"""Dense masked oracle for ragged-prefill attention — the plain PyTorch
version of the CUDA kernel, and the port of the JAX package's
``kernels/ragged_prefill/ref.py``.

One full (TQ, TK) score rectangle per head, masked by the same
segment/causal/padding predicate the kernel applies, with an explicit
mask multiply and zero-denominator guard (a plain softmax over an
all-``-1e30`` row would emit a uniform average over garbage instead of
zeros).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
F32 = torch.float32


def admit_mask(seg_q, pos_q, seg_k, pos_k) -> torch.Tensor:
    """(TQ, TK) bool: seg_q == seg_k ∧ pos_k <= pos_q ∧ both segs >= 0."""
    sq = seg_q.to(torch.int32)[:, None]
    pq = pos_q.to(torch.int32)[:, None]
    sk = seg_k.to(torch.int32)[None, :]
    pk = pos_k.to(torch.int32)[None, :]
    return (sq == sk) & (pk <= pq) & (sq >= 0) & (sk >= 0)


def ragged_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       seg_q: torch.Tensor, pos_q: torch.Tensor,
                       seg_k: torch.Tensor, pos_k: torch.Tensor, *,
                       scale=None) -> torch.Tensor:
    """Same contract as the kernel: q (Hq, TQ, D), k/v (Hkv, TK, D),
    seg/pos (TQ,)/(TK,) int32 (seg -1 on padding).  Returns
    (Hq, TQ, D) in q's dtype."""
    Hq, TQ, D = q.shape
    Hkv, TK, _ = k.shape
    G = Hq // Hkv
    scale = float(scale if scale is not None else D ** -0.5)

    kf = torch.repeat_interleave(k, G, dim=0)   # (Hq, TK, D) GQA broadcast
    vf = torch.repeat_interleave(v, G, dim=0)
    s = torch.einsum("htd,hsd->hts", q.to(F32), kf.to(F32)) * scale

    mask = admit_mask(seg_q, pos_q, seg_k, pos_k)[None]
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=F32,
                                          device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m) * mask.to(F32)
    den = e.sum(dim=-1, keepdim=True)
    p = e / torch.where(den == 0.0, torch.ones_like(den), den)
    o = torch.einsum("hts,hsd->htd", p, vf.to(F32))
    return o.to(q.dtype)


# The bf16 wgmma kernel keeps p at float32 accuracy (P·V as p_hi·V +
# p_lo·V, p_lo = bf16(p - p_hi)), so its bf16 output rounds to the plain
# version's bf16 value almost everywhere: 0.2% of the outputs differ in
# the CPU emulation (tests/test_torch_ragged_tiling.py), where rounding p
# to bf16 alone moves o by about 2^-10 before the output's rounding and
# 36-38% of the outputs by a bf16 step.  The share allowed to differ:
P_SPLIT_MISMATCH = 0.02


def mismatch_share(got: torch.Tensor, want: torch.Tensor,
                   seg_q: torch.Tensor) -> float:
    """The share of the real query rows' outputs (seg_q >= 0) whose value
    in ``got`` differs from ``want``'s, both in one dtype."""
    real = seg_q >= 0
    return float((got[:, real] != want[:, real]).float().mean())
