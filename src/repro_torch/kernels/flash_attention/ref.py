"""Plain PyTorch version of flash attention (GQA, causal): the oracle the
CPU path, the tests, the family's ``reference_check`` and the backward
pass use.  It is never run on the card path.  A port of the JAX
package's ``kernels/flash_attention/ref.py``."""
from __future__ import annotations

import torch


def _softmax(s: torch.Tensor) -> torch.Tensor:
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    return p / p.sum(dim=-1, keepdim=True)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, scale=None, kv_len=None) -> torch.Tensor:
    """O = softmax(Q Kᵀ · scale) V, float32 internally.

    q: (B, Hq, Sq, D);  k, v: (B, Hkv, Skv, D) with Hq % Hkv == 0.
    Under ``causal`` a pair needs qpos >= kpos (top-left alignment);
    ``kv_len`` masks key positions >= kv_len.  Masked scores are -1e30.
    Returns q's dtype."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    group = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    kr = k.repeat_interleave(group, dim=1).float()
    vr = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    neg = torch.tensor(-1e30, dtype=torch.float32, device=q.device)
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, neg)
    if kv_len is not None and int(kv_len) < Skv:
        s = torch.where(torch.arange(Skv, device=q.device)[None, :]
                        < int(kv_len), s, neg)
    p = _softmax(s)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vr)
    return out.to(q.dtype)


# How far a flash kernel may be from ``mha_ref`` on the same inputs.
# Each element: float32 1e-4 (the same products summed in another order);
# bfloat16 1e-2 plus one bfloat16 step of the value (2^-7 |o|): the kernel
# rounds p to bfloat16 before P·V, against the running max of its key
# tile (128 keys on the wgmma CTAs, 64 on the others; a warp's 16 or 32
# positions of a 64- or 128-position tile in decode;
# tests/test_torch_flash_tiling.py emulates both against the TPU
# kernels), where the plain version keeps p in float32, and each
# rounds its output once, so the two may land on neighbouring values (a
# step of 2^-6 at |o| >= 2, which early causal rows reach).  Each query
# row, its D outputs together: the error's norm within ROW_RTOL of the
# row's norm.  In bfloat16 p's rounding moves each weight by at most
# 2^-8 of itself and the output's rounding each value by 2^-8, so a
# sound row is off by a few 2^-9 of its norm, never near 2^-6.  The row
# test holds where the elementwise floor cannot: over thousands of keys
# |o| is ~0.02, and a kernel that drops or repeats a span of keys moves
# whole rows by a tenth or more of their norm while staying under 1e-2.
ATOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}
ROW_RTOL = {torch.float32: 1e-3, torch.bfloat16: 2.0 ** -6}


def flash_error(got: torch.Tensor, want: torch.Tensor):
    """(max |got - want|, the worst row's error norm over its norm,
    within the tolerances above); ``want`` is the plain version."""
    dt = want.dtype
    w = want.float()
    err = got.float() - w
    elem = bool((err.abs() <= ATOL[dt] + RTOL[dt] * w.abs()).all())
    row = float((err.norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max())
    return float(err.abs().max()), row, elem and row <= ROW_RTOL[dt]
