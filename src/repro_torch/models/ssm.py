"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060), attention-free.

The port of the JAX package's ``models/ssm.py``.  Training/prefill uses
the chunked SSD algorithm (:func:`ssd_chunked`): within-chunk terms are
masked "attention-like" products, across-chunk terms pass a (H, N, P)
state through a sequential pass over the chunks (a Python loop here,
``lax.scan`` there).  Decode is a single state update.  As in the JAX
package, :func:`apply_ssm_block` computes its SSD core with the plain
:func:`ssd_chunked`; :func:`ssd_via_kernel` routes the same core through
the validated SSD kernel (``repro_torch.kernels.ssd``: the CUDA kernel
on the card, its plain version on the CPU).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.parallel.api import per_shard, reshape

from .components import F32, dtype_of
from .config import ModelConfig
from .params import ParamSpec
from .recurrent import _causal_conv


def ssm_block_specs(cfg: ModelConfig) -> Dict:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    G, N = s.n_groups, s.d_state
    dt = dtype_of(cfg.dtype)
    conv_ch = d_inner + 2 * G * N
    return {
        # in_proj emits [z, x, B, C, dt]
        "w_in": ParamSpec((cfg.d_model, 2 * d_inner + 2 * G * N + H), dt,
                          ("embed", "mlp")),
        "conv": ParamSpec((s.conv_width, conv_ch), F32, (None, "mlp"),
                          "normal", 1.0 / math.sqrt(s.conv_width)),
        "conv_b": ParamSpec((conv_ch,), F32, ("mlp",), "zeros"),
        "a_log": ParamSpec((H,), F32, (None,), "zeros"),
        "dt_bias": ParamSpec((H,), F32, (None,), "zeros"),
        "d_skip": ParamSpec((H,), F32, (None,), "ones"),
        "gate_norm": {"scale": ParamSpec((d_inner,), F32, ("mlp",), "ones")},
        "w_out": ParamSpec((d_inner, cfg.d_model), dt, ("mlp", "embed")),
    }


def _segsum(da: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise decay sums.  da: (..., Q) ->
    L[..., i, j] = Σ_{k∈(j, i]} da_k  for i ≥ j, −inf otherwise."""
    Q = da.shape[-1]
    cs = torch.cumsum(da, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]          # (..., i, j)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=da.device))
    return torch.where(mask, diff, torch.tensor(float("-inf"), dtype=F32,
                                                device=da.device))


def ssd_chunked(xh: torch.Tensor, da: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int,
                state0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD core.  xh: (B,S,H,P); da: (B,S,H) log-decay (≤0);
    Bm, Cm: (B,S,H,N) (groups already broadcast).  Returns (y, final_state)
    with y: (B,S,H,P), state: (B,H,N,P).  Independent per batch row and
    head: under DTensor each rank runs it on its own blocks
    (``parallel.api.per_shard``)."""
    return per_shard(
        lambda *a: _ssd_chunked(*a[:4], chunk, a[4]),
        (xh, da, Bm, Cm, state0),
        ((0, 2), (0, 2), (0, 2), (0, 2), (0, 1)), ((0, 2), (0, 1)))


def _ssd_chunked(xh, da, Bm, Cm, chunk, state0):
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError("sequence must divide the SSD chunk")
    nc = S // chunk
    q = chunk
    xc = xh.reshape(Bsz, nc, q, H, P)
    dac = da.reshape(Bsz, nc, q, H)
    Bc = Bm.reshape(Bsz, nc, q, H, N)
    Cc = Cm.reshape(Bsz, nc, q, H, N)

    # 1) intra-chunk (dual "attention" form)
    L = torch.exp(_segsum(dac.permute(0, 1, 3, 2)))       # (B,nc,H,q,q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Cc, Bc)   # (B,nc,H,q,q)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", scores * L, xc)

    # 2) chunk states: decay-to-end weighted outer products
    dacs = torch.cumsum(dac, dim=2)                       # (B,nc,q,H)
    decay_to_end = torch.exp(dacs[:, :, -1:, :] - dacs)   # (B,nc,q,H)
    chunk_state = torch.einsum("bckhn,bckh,bckhp->bchnp",
                               Bc, decay_to_end, xc)      # (B,nc,H,N,P)

    # 3) inter-chunk sequential state pass
    chunk_decay = torch.exp(dacs[:, :, -1, :])            # (B,nc,H)
    s = (torch.zeros_like(chunk_state[:, 0], dtype=F32)
         if state0 is None else state0.to(F32))
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = chunk_decay[:, c][..., None, None] * s \
            + chunk_state[:, c].to(F32)
    s_prevs = torch.stack(s_prevs, dim=1)                 # (B,nc,H,N,P)

    # 4) contribution of the carried state into each chunk
    state_decay = torch.exp(dacs)                         # (B,nc,q,H)
    y_inter = torch.einsum("bcqhn,bcqh,bchnp->bcqhp",
                           Cc, state_decay, s_prevs)
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y, s


def ssd_via_kernel(xh: torch.Tensor, da: torch.Tensor, Bh: torch.Tensor,
                   Ch: torch.Tensor, chunk: int) -> torch.Tensor:
    """Route the SSD core through the validated SSD kernel
    (``repro_torch.kernels.ssd.ssd``: the gate, then the CUDA kernel on
    CUDA tensors or its plain version on CPU tensors).  xh: (B,S,H,P);
    da: (B,S,H); Bh, Ch: (B,S,H,N) -> y (B,S,H,P)."""
    from repro_torch.core.families.ssd import SSDConfig
    from repro_torch.kernels.ssd import ssd as ssd_kernel
    B_, S, H, P = xh.shape

    def fold(t):
        return t.movedim(2, 1).reshape(B_ * H, S, *t.shape[3:]).contiguous()
    y = ssd_kernel(fold(xh), da.movedim(2, 1).reshape(B_ * H, S), fold(Bh),
                   fold(Ch), cfg=SSDConfig(chunk=chunk))
    return y.reshape(B_, H, S, P).movedim(1, 2)


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def ssd_operands(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                 conv_state: Optional[torch.Tensor] = None):
    """The mixer up to its SSD core: in_proj, the causal conv over
    [x, B, C], the step sizes.  Returns (z, xh, da, Bh, Ch, dtf,
    new_conv) with xh (B,S,H,P) the dt-scaled input, da (B,S,H) the log
    decays and Bh, Ch (B,S,H,N), all float32."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    P, G, N = s.head_dim, s.n_groups, s.d_state
    B_, S, _ = x.shape

    zxbcdt = x @ p["w_in"]
    z, xin, Bm, Cm, dt = torch.split(
        zxbcdt, [d_inner, d_inner, G * N, G * N, H], dim=-1)

    # causal depthwise conv over [x, B, C]
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    conv_out, new_conv = _causal_conv(conv_in, p["conv"], p["conv_b"],
                                      conv_state)
    conv_out = _silu(conv_out.to(F32)).to(x.dtype)
    xin, Bm, Cm = torch.split(conv_out, [d_inner, G * N, G * N], dim=-1)

    # jax.nn.softplus is logaddexp(x, 0); F.softplus cuts over at 20
    dtf = torch.logaddexp(dt.to(F32) + p["dt_bias"],
                          torch.zeros((), dtype=F32, device=x.device))
    A = -torch.exp(p["a_log"])                              # (H,)
    da = dtf * A                                            # log decay

    xh = (xin.reshape(B_, S, H, P).to(F32)
          * dtf[..., None])                                 # dt-scaled input
    rep = H // G
    Bh = Bm.reshape(B_, S, G, N).repeat_interleave(rep, dim=2).to(F32)
    Ch = Cm.reshape(B_, S, G, N).repeat_interleave(rep, dim=2).to(F32)
    return z, xh, da, Bh, Ch, new_conv


def apply_ssm_block(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                    state: Optional[Dict] = None
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full Mamba-2 mixer.  ``state``: {"ssm": (B,H,N,P), "conv":
    (B,cw-1,conv_ch)} for decode (S==1)."""
    d_inner = cfg.ssm.expand * cfg.d_model
    B_, S, _ = x.shape
    z, xh, da, Bh, Ch, new_conv = ssd_operands(
        p, x, cfg, state["conv"] if state is not None else None)

    # the SSD core is independent per batch row and head: under DTensor
    # each rank runs it on its own blocks (parallel.api.per_shard)
    if state is None:
        q = min(cfg.ssm.chunk, S)
        y = per_shard(lambda *a: _ssd_padded(*a, q), (xh, da, Bh, Ch),
                      ((0, 2),) * 4, ((0, 2),))
        new_state = None
    else:
        y, s_new = per_shard(
            _ssd_step, (torch.exp(da)[:, 0], state["ssm"], Bh[:, 0],
                        xh[:, 0], Ch[:, 0]), ((0, 1),) * 5,
            ((0, 2), (0, 1)))
        new_state = {"ssm": s_new, "conv": new_conv}

    y = y + xh * p["d_skip"][:, None]                       # D skip
    y = reshape(y, B_, S, d_inner)
    # gated RMS norm (mamba2)
    zf = _silu(z.to(F32))
    yn = y * zf
    var = (yn * yn).mean(-1, keepdim=True)
    yn = yn * torch.rsqrt(var + cfg.norm_eps) * p["gate_norm"]["scale"]
    return yn.to(x.dtype) @ p["w_out"], new_state


def _ssd_padded(xh, da, Bh, Ch, q):
    """The SSD core's output over a sequence zero-padded to a chunk
    multiple: padded steps have x=0 (no state contribution) and da=0
    (decay 1), so the state is unaffected."""
    S = xh.shape[1]
    pad = (-S) % q
    if not pad:
        return _ssd_chunked(xh, da, Bh, Ch, q, None)[0]
    padf = lambda t: F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
    y, _ = _ssd_chunked(padf(xh), padf(da), padf(Bh), padf(Ch), q, None)
    return y[:, :S]


def _ssd_step(a_t, ssm, B0, x0, C0):
    """One decode step of the SSD state: (y (B,1,H,P), new state)."""
    s_new = (a_t[..., None, None] * ssm.to(F32)
             + torch.einsum("bhn,bhp->bhnp", B0, x0))
    y = torch.einsum("bhn,bhnp->bhp", C0, s_new)[:, None]
    return y, s_new


def ssm_cache_shape(cfg: ModelConfig, batch: int):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.n_groups * s.d_state
    return {
        "ssm": ((batch, H, s.d_state, s.head_dim), "float32"),
        "conv": ((batch, s.conv_width - 1, conv_ch), cfg.dtype),
    }
