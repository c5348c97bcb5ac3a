"""Dense-decode oracle for the paged-attention family — the plain
PyTorch version of the CUDA kernel, and the port of the JAX package's
``kernels/paged_attention/ref.py``: flatten the pages through the block
table, then plain masked softmax decode attention in float32."""
from __future__ import annotations

import torch

from ..ragged_prefill.ref import P_SPLIT_MISMATCH  # noqa: F401

F32 = torch.float32
NEG_INF = -1e30


def gather_cache(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(P, HK, PS, D) pool + (B, NP) table -> dense (B, HK, NP·PS, D)."""
    g = pages[table.long()]                # (B, NP, HK, PS, D)
    B, NP, HK, PS, D = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(B, HK, NP * PS, D)


def paged_decode_ref(q, k_pages, v_pages, table, lengths=None, *,
                     scale=None):
    """q: (B, Hq, 1, D); pools (P, HK, PS, D); table (B, NP); optional
    lengths (B,) logical tokens per sequence — positions at or beyond a
    sequence's length (every null-page position included) are masked out
    of the softmax; a zero-length sequence yields a zero output row."""
    B, Hq, _, D = q.shape
    HK = k_pages.shape[1]
    G = Hq // HK
    scale = scale if scale is not None else D ** -0.5
    k = gather_cache(k_pages, table)       # (B, HK, S, D)
    v = gather_cache(v_pages, table)
    kq = torch.repeat_interleave(k, G, dim=1)   # (B, Hq, S, D)
    vq = torch.repeat_interleave(v, G, dim=1)
    s = torch.einsum("bhqd,bhsd->bhqs", q.to(F32), kq.to(F32)) * scale
    if lengths is not None:
        S = kq.shape[2]
        mask = (torch.arange(S, device=q.device)[None, None, None, :]
                < lengths.to(torch.int32)[:, None, None, None])
        s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=F32,
                                              device=q.device))
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
    else:
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(den == 0.0, torch.ones_like(den), den)
    o = torch.einsum("bhqs,bhsd->bhqd", p, vq.to(F32))
    return o.to(q.dtype)


# The bf16 tensor-core instance keeps p at float32 accuracy (P·V as
# p_hi·V + p_lo·V, p_lo = bf16(p - p_hi)), as ragged prefill's wgmma
# instance does, so its bf16 output rounds to the plain version's bf16
# value almost everywhere, where rounding p to bf16 alone moves a fifth
# to a third of the outputs by a bf16 step (the CPU emulation in
# tests/test_torch_paged_tiling.py measures both); the share allowed to
# differ is ragged prefill's ``P_SPLIT_MISMATCH``.


def mismatch_share(got: torch.Tensor, want: torch.Tensor,
                   lengths: torch.Tensor) -> float:
    """The share of the outputs of rows with a position (length > 0)
    whose value in ``got`` differs from ``want``'s, both in one dtype."""
    live = lengths.to(got.device) > 0
    return float((got[live] != want[live]).float().mean())
