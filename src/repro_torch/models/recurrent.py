"""Pieces of the JAX package's ``models/recurrent.py`` that the ported
families use: the depthwise causal convolution of the Mamba-2 mixer.
The RG-LRU blocks of the recurrent and hybrid families wait for ROADMAP
item A8."""
from __future__ import annotations

from typing import Optional

import torch

from .components import F32


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d.  u: (B,S,W); w: (cw,W).  With ``state``
    ((B, cw-1, W), decode) prepends it instead of zero padding; returns
    (out, new_state).  Shifted multiply-adds in float32, as in the JAX
    package: ``F.conv1d`` would run float32 through cuDNN in TF32."""
    cw = w.shape[0]
    if state is None:
        pad = u.new_zeros((u.shape[0], cw - 1, u.shape[2]))
    else:
        pad = state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)                  # (B, S+cw-1, W)
    out = torch.zeros(u.shape, dtype=F32, device=u.device)
    for i in range(cw):
        out = out + full[:, i:i + u.shape[1], :].to(F32) * w[i]
    out = out + b
    new_state = full[:, -(cw - 1):, :] if cw > 1 else pad
    return out.to(u.dtype), new_state
