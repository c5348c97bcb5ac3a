"""The decoder family: GQA decoders served through the paged engine's
two kernel calls, as Hugging Face's ``StableLmForCausalLM`` and
``GraniteMoeForCausalLM`` compute them.

A configuration file names its family module under ``family``; the
module is the one part of the benchmark that knows the architecture and
reads the ``model`` block's keys:

* :func:`port_fields`: the port's ModelConfig fields the block fixes,
  which :func:`bench.spec.port_config` compares with the port's config;
* :func:`published`: the weights the port serves as the published model
  reads them;
* :class:`Reference`: the plain forward pass that :mod:`bench.check`
  holds the served tokens to, in float32 and as the float8 control;
* :func:`shape`: the work a tick and each kernel's calls need, which
  :mod:`bench.readers` reads;
* ``KERNELS``: the port's kernel modules that set-up builds.

It imports nothing of the program.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from bench.roofline import DTYPE_BYTES

KERNELS = ("repro_torch.kernels.paged_attention",
           "repro_torch.kernels.ragged_prefill")


# -- the port's configuration -------------------------------------------------

def port_fields(m: Dict) -> Dict:
    """The port's ModelConfig fields that the ``model`` block fixes; the
    MoE spec (``moe``) as a dict of its own fields, or None for a dense
    block.  The port has no multipliers: the weights carry them
    (:func:`published`)."""
    layernorm = "layer_norm_eps" in m
    want = {
        "n_layers": m["num_hidden_layers"], "d_model": m["hidden_size"],
        "n_heads": m["num_attention_heads"],
        "n_kv_heads": m["num_key_value_heads"],
        "resolved_head_dim": m.get("head_dim") or (
            m["hidden_size"] // m["num_attention_heads"]),
        "vocab": m["vocab_size"],
        "norm_type": "layernorm" if layernorm else "rmsnorm",
        "norm_eps": m["layer_norm_eps" if layernorm else "rms_norm_eps"],
        "rope_frac": m.get("partial_rotary_factor", 1.0),
        "rope_theta": m.get("rope_theta", 10000.0),
        "tie_embeddings": m.get("tie_word_embeddings", False),
        "qkv_bias": m.get("attention_bias", m.get("use_qkv_bias", False)),
        "ffn_type": "swiglu" if m.get("hidden_act") == "silu" else None,
        "dtype": m.get("torch_dtype", "bfloat16"),
        "scale_embed": False, "qk_norm": False, "attn_type": "gqa",
    }
    if "num_local_experts" not in m:
        want.update(d_ff=m["intermediate_size"], moe=None)
    else:
        want["moe"] = dict(n_experts=m["num_local_experts"],
                           top_k=m["num_experts_per_tok"],
                           d_ff_expert=m["intermediate_size"], n_shared=0,
                           first_dense_layers=0)
    return want


# -- the weights as published -------------------------------------------------
#
# The port has no muP multipliers (granite's ``embedding_multiplier``,
# ``attention_multiplier``, ``residual_multiplier``, ``logits_scaling``):
# it scales attention by 1/sqrt(head_dim) and nothing else.  Each
# multiplier is linear in one weight, so the weights drawn by
# bench/weights.py are the port's, with the multipliers folded in, and
# :func:`published` divides them back out, in float32, for the
# reference, which applies the multipliers as the published model does.
# Both then compute one function.

def _scaled(t: torch.Tensor, c: float) -> torch.Tensor:
    return t if c == 1.0 else t.to(torch.float32) * c


def published(params: Dict, model: Dict) -> Dict:
    """``params`` (the weights the port serves) as the published model,
    whose sizes and multipliers are ``model`` (Hugging Face's keys),
    reads them: each weight that a multiplier scales divided by it."""
    hd = int(model.get("head_dim")
             or model["hidden_size"] // model["num_attention_heads"])
    emb = float(model.get("embedding_multiplier", 1.0))
    attn = float(model.get("attention_multiplier", hd ** -0.5))
    res = float(model.get("residual_multiplier", 1.0))
    logit = float(model.get("logits_scaling", 1.0))
    # logits = norm(x) @ head / logits_scaling, and a tied head is the
    # token table, which embedding_multiplier's fold divided
    head = logit * (emb if model.get("tie_word_embeddings") else 1.0)
    blocks = dict(params["blocks"])
    blocks["attn"] = dict(blocks["attn"],
                          wq=_scaled(blocks["attn"]["wq"], hd ** -0.5 / attn),
                          wo=_scaled(blocks["attn"]["wo"], 1.0 / res))
    ffn = "moe" if "moe" in blocks else "ffn"
    blocks[ffn] = dict(blocks[ffn], wd=_scaled(blocks[ffn]["wd"], 1.0 / res))
    return dict(params,
                embed=dict(params["embed"],
                           tok=_scaled(params["embed"]["tok"], 1.0 / emb)),
                blocks=blocks,
                ln_f={k: _scaled(v, head) for k, v in params["ln_f"].items()})


# -- the plain reference ------------------------------------------------------
#
# Written from the published descriptions of Hugging Face's
# ``StableLmForCausalLM`` (stablelm-3b-4e1t: LayerNorm with bias, partial
# rotary over the first ``partial_rotary_factor`` of each head, SwiGLU,
# untied head) and ``GraniteMoeForCausalLM`` (granite-3.0-*-a800m: RMS
# norm, GQA, rotary, ``embedding_multiplier``, ``attention_multiplier``,
# ``residual_multiplier`` and ``logits_scaling``, top-k routing with a
# softmax over the chosen logits and no capacity, so no token is
# dropped).  The configuration file's ``model`` block gives every size
# and multiplier under those keys.
#
# It reads only the weights and tokens that the benchmark made, in the
# parameter layout the benchmark hands to both sides (``embed.tok``,
# ``blocks.attn.wq`` ...).  Matmuls and cuDNN run without TF32.  Layer by
# layer, each layer's weights cast to float32 once: attention one
# request at a time, queries in blocks; the feed-forward (dense or
# experts), which reads each token alone, over every request's tokens
# at once.
#
# ``precision="fp8"`` is the control: the operands of every product
# (weights, activations, queries, keys and values) rounded to float8
# e4m3 with a scale per row or column, products summed in float32.

F32 = torch.float32
Q_BLOCK = 1024
FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with an absmax scale along ``dim``."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(F32) * s


class Reference:
    """The published model's logits, in float32 (or as the float8
    control), from a ``model`` block and weights as :func:`published`
    gives them."""

    def __init__(self, model: Dict, params: Dict, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        m = model
        self.fp8 = precision == "fp8"
        self.layers = int(m["num_hidden_layers"])
        self.d = int(m["hidden_size"])
        self.heads = int(m["num_attention_heads"])
        self.kv_heads = int(m["num_key_value_heads"])
        self.hd = int(m.get("head_dim") or self.d // self.heads)
        self.vocab = int(m["vocab_size"])
        self.layernorm = "layer_norm_eps" in m
        self.eps = float(m["layer_norm_eps"] if self.layernorm
                         else m["rms_norm_eps"])
        rot = int(self.hd * float(m.get("partial_rotary_factor", 1.0)))
        self.rot = rot - rot % 2
        self.theta = float(m.get("rope_theta", 10000.0))
        self.emb_mult = float(m.get("embedding_multiplier", 1.0))
        self.attn_scale = float(m.get("attention_multiplier",
                                      self.hd ** -0.5))
        self.res_mult = float(m.get("residual_multiplier", 1.0))
        self.logit_scale = float(m.get("logits_scaling", 1.0))
        self.experts = int(m.get("num_local_experts", 0))
        self.top_k = int(m.get("num_experts_per_tok", 0))
        self.tied = bool(m.get("tie_word_embeddings", False))
        self.p = params

    # -- pieces ---------------------------------------------------------------
    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            x, w = _fp8(x, -1), _fp8(w, 0)
        return x @ w

    def _norm(self, x, scale, bias=None):
        if self.layernorm:
            x = x - x.mean(-1, keepdim=True)
        y = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps)
        y = y * scale.to(F32)
        return y + bias.to(F32) if bias is not None else y

    def _rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (H, S, hd): rotate-half rotary over the first ``rot``
        channels of each head."""
        if self.rot == 0:
            return x
        inv = self.theta ** (-torch.arange(0, self.rot, 2, dtype=F32,
                                           device=x.device) / self.rot)
        ang = pos.to(F32)[:, None] * inv[None, :]
        emb = torch.cat([ang, ang], dim=-1)
        cos, sin = emb.cos(), emb.sin()
        xr, xp = x[..., :self.rot], x[..., self.rot:]
        half = self.rot // 2
        rh = torch.cat([-xr[..., half:], xr[..., :half]], dim=-1)
        return torch.cat([xr * cos + rh * sin, xp], dim=-1)

    def _attention(self, h, w, pos):
        S = h.shape[0]
        H, Hk, hd = self.heads, self.kv_heads, self.hd
        q = self._mm(h, w["wq"].reshape(self.d, H * hd))
        k = self._mm(h, w["wk"].reshape(self.d, Hk * hd))
        v = self._mm(h, w["wv"].reshape(self.d, Hk * hd))
        q = self._rope(q.reshape(S, H, hd).transpose(0, 1), pos)
        k = self._rope(k.reshape(S, Hk, hd).transpose(0, 1), pos)
        v = v.reshape(S, Hk, hd).transpose(0, 1)
        g = H // Hk
        k = k.repeat_interleave(g, dim=0)          # head h reads KV h // g
        v = v.repeat_interleave(g, dim=0)
        if self.fp8:
            q, k, v = _fp8(q, -1), _fp8(k, -1), _fp8(v, 1)
        out = torch.empty_like(q)
        for q0 in range(0, S, Q_BLOCK):
            qb = q[:, q0:q0 + Q_BLOCK]
            s = (qb @ k.transpose(1, 2)) * self.attn_scale
            qi = torch.arange(q0, q0 + qb.shape[1], device=h.device)
            causal = qi[:, None] >= torch.arange(S, device=h.device)[None]
            s = s.masked_fill(~causal, float("-inf"))
            out[:, q0:q0 + Q_BLOCK] = torch.softmax(s, dim=-1) @ v
        o = out.transpose(0, 1).reshape(S, H * hd)
        return self._mm(o, w["wo"].reshape(H * hd, self.d))

    def _ffn(self, h, w):
        if "moe" not in w:
            f = w["ffn"]
            return self._mm(torch.nn.functional.silu(self._mm(h, f["wg"]))
                            * self._mm(h, f["wu"]), f["wd"])
        e = w["moe"]
        logits = self._mm(h, e["router"])
        top, idx = torch.topk(logits, self.top_k, dim=-1)
        gates = torch.softmax(top, dim=-1)
        out = torch.zeros_like(h)
        for x in range(self.experts):
            tok, slot = torch.nonzero(idx == x, as_tuple=True)
            if tok.numel() == 0:
                continue
            hx = h[tok]
            y = self._mm(torch.nn.functional.silu(self._mm(hx, e["wg"][x]))
                         * self._mm(hx, e["wu"][x]), e["wd"][x])
            out.index_add_(0, tok, y * gates[tok, slot, None])
        return out

    def _layer_weights(self, i: int) -> Dict:
        def f32(t):
            if isinstance(t, dict):
                return {k: f32(v) for k, v in t.items()}
            return t[i].to(F32)
        return f32(self.p["blocks"])

    # -- forward --------------------------------------------------------------
    def logits(self, sequences: Sequence[torch.Tensor],
               positions: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """For each token sequence (S,) the float32 logits (n, vocab) at
        its ``positions`` (n,): the prediction of the token after each."""
        p = self.p
        lens = [int(t.shape[0]) for t in sequences]
        x = torch.cat([p["embed"]["tok"][t.long()].to(F32) * self.emb_mult
                       for t in sequences])
        pos = [torch.arange(n, device=x.device) for n in lens]
        for i in range(self.layers):
            w = self._layer_weights(i)
            xs = list(torch.split(x, lens))
            for r, xr in enumerate(xs):
                h = self._norm(xr, w["ln_attn"]["scale"],
                               w["ln_attn"].get("bias"))
                xs[r] = xr + self._attention(h, w["attn"], pos[r]) \
                    * self.res_mult
            x = torch.cat(xs)
            del xs
            h = self._norm(x, w["ln_ffn"]["scale"], w["ln_ffn"].get("bias"))
            x = x + self._ffn(h, w) * self.res_mult
            del w, h
        head = (p["embed"]["tok"].T if self.tied
                else p["embed"]["unembed"])[:, :self.vocab].to(F32)
        out = []
        for xr, at in zip(torch.split(x, lens), positions):
            h = self._norm(xr[at.long()], p["ln_f"]["scale"],
                           p["ln_f"].get("bias"))
            out.append(self._mm(h, head) / self.logit_scale)
        return out


# -- the work a tick needs ----------------------------------------------------

@dataclass(frozen=True)
class Shape:
    """The sizes of a decoder that the counts read (Hugging Face keys of
    a configuration file's ``model`` block)."""
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    experts: int = 0
    top_k: int = 0
    dtype: str = "bfloat16"

    @classmethod
    def of(cls, m: Dict) -> "Shape":
        heads = int(m["num_attention_heads"])
        return cls(layers=int(m["num_hidden_layers"]),
                   d_model=int(m["hidden_size"]), heads=heads,
                   kv_heads=int(m["num_key_value_heads"]),
                   head_dim=int(m.get("head_dim")
                                or int(m["hidden_size"]) // heads),
                   d_ff=int(m["intermediate_size"]),
                   vocab=int(m["vocab_size"]),
                   experts=int(m.get("num_local_experts", 0)),
                   top_k=int(m.get("num_experts_per_tok", 0)),
                   dtype=m.get("torch_dtype", "bfloat16"))

    @property
    def elt(self) -> int:
        return DTYPE_BYTES[self.dtype]

    @property
    def attn_params(self) -> int:
        """q, k, v and o projections of one layer."""
        return self.d_model * self.head_dim * (2 * self.heads
                                               + 2 * self.kv_heads)

    @property
    def expert_params(self) -> int:
        """One gated FFN (gate, up, down): an expert's, or the dense
        FFN's."""
        return 3 * self.d_model * self.d_ff

    @property
    def router_params(self) -> int:
        return self.d_model * self.experts

    @property
    def kv_bytes(self) -> int:
        """Key and value bytes of one token in one layer."""
        return 2 * self.kv_heads * self.head_dim * self.elt

    def ffn_per_token(self) -> int:
        """FFN parameters one token multiplies in one layer."""
        if self.experts:
            return self.top_k * self.expert_params + self.router_params
        return self.expert_params

    def ffn_read(self, tokens: int) -> int:
        """FFN parameters a tick reads in one layer for ``tokens``
        tokens: an expert only where some token can be routed to it."""
        if self.experts:
            used = min(self.experts, self.top_k * tokens)
            return used * self.expert_params + self.router_params
        return self.expert_params

    def tick_work(self, decode_lengths: Sequence[int] = (),
                  prefill_spans: Iterable = (), logits_rows: int = 0):
        """(FLOPs, bytes) one tick needs (:func:`tick_work`)."""
        return tick_work(self, decode_lengths=decode_lengths,
                         prefill_spans=prefill_spans,
                         logits_rows=logits_rows)

    def kernel_work(self, kernel: str, tick: Dict
                    ) -> Optional[Tuple[float, float]]:
        """(FLOPs, bytes) of all of ``kernel``'s calls in a tick record,
        one a layer; None where the tick made none."""
        if kernel == "paged_decode" and tick["decode_lengths"]:
            w = paged_decode_work(self, tick["decode_lengths"])
        elif kernel == "ragged_prefill" and tick["prefill_spans"]:
            w = ragged_prefill_work(self, tick["prefill_spans"])
        else:
            return None
        return self.layers * w[0], self.layers * w[1]


def shape(model: Dict) -> Shape:
    """The counts of a configuration's ``model`` block."""
    return Shape.of(model)


def tick_work(shape: Shape, *, decode_lengths: Sequence[int] = (),
              prefill_spans: Iterable = (), logits_rows: int = 0):
    """(FLOPs, bytes) one tick needs.

    ``decode_lengths``: each decode row's length, the token it writes
    included; ``prefill_spans``: (prefix, chunk) token counts of each
    prompt chunk; ``logits_rows``: rows whose logits the engine reads."""
    s = shape
    spans = list(prefill_spans)
    n_dec = len(decode_lengths)
    n_pre = sum(n for _, n in spans)
    tokens = n_dec + n_pre
    if tokens == 0:
        return 0.0, 0.0
    # attention pairs: a decode row's query against each of its keys; a
    # chunk's query at position q against the q + 1 keys up to it
    pairs = sum(decode_lengths) + sum(
        (p + 1 + p + n) * n // 2 for p, n in spans)
    per_token = s.attn_params + s.ffn_per_token()
    flops = s.layers * (2 * per_token * tokens
                        + 4 * s.heads * s.head_dim * pairs)
    flops += 2 * s.d_model * s.vocab * logits_rows
    weights = s.layers * (s.attn_params + s.ffn_read(tokens))
    weights += s.d_model * s.vocab * (logits_rows > 0)
    kv_read = sum(decode_lengths) + sum(p + n for p, n in spans)
    n_bytes = (weights * s.elt + tokens * s.d_model * s.elt
               + s.layers * s.kv_bytes * (kv_read + tokens)
               + logits_rows * s.vocab * 4)
    return float(flops), float(n_bytes)


def paged_decode_work(shape: Shape, lengths: Sequence[int]):
    """(FLOPs, bytes) of one ``paged_decode`` call (one layer): each
    row's keys and values at its length read once, its queries read and
    its output written once."""
    s = shape
    total = sum(lengths)
    flops = 4 * s.heads * s.head_dim * total
    n_bytes = (total * s.kv_bytes
               + 2 * len(lengths) * s.heads * s.head_dim * s.elt)
    return float(flops), float(n_bytes)


def ragged_prefill_work(shape: Shape, spans: Iterable):
    """(FLOPs, bytes) of one ``ragged_prefill`` call (one layer): the
    admitted (query, key) pairs times the heads times 4 · head_dim, and
    the packed queries, keys, values and output each moved once."""
    s = shape
    spans = list(spans)
    pairs = sum((p + 1 + p + n) * n // 2 for p, n in spans)
    tq = sum(n for _, n in spans)
    tk = sum(p + n for p, n in spans)
    flops = 4 * s.heads * s.head_dim * pairs
    n_bytes = (tk * s.kv_bytes + 2 * tq * s.heads * s.head_dim * s.elt)
    return float(flops), float(n_bytes)
