"""Plain float32 forward pass of the benchmark's decoders.

Written from the published descriptions of Hugging Face's
``StableLmForCausalLM`` (stablelm-3b-4e1t: LayerNorm with bias, partial
rotary over the first ``partial_rotary_factor`` of each head, SwiGLU,
untied head) and ``GraniteMoeForCausalLM`` (granite-3.0-*-a800m: RMS
norm, GQA, rotary, ``embedding_multiplier``, ``attention_multiplier``,
``residual_multiplier`` and ``logits_scaling``, top-k routing with a
softmax over the chosen logits and no capacity, so no token is
dropped).  The configuration file's ``model`` block gives every size
and multiplier under those keys.

It imports nothing of the program: it reads only the weights and
tokens that the benchmark made, in the parameter layout the benchmark
hands to both sides (``embed.tok``, ``blocks.attn.wq`` ...).  Matmuls
and cuDNN run without TF32.  Layer by layer, each layer's weights cast
to float32 once: attention one request at a time, queries in blocks;
the feed-forward (dense or experts), which reads each token alone, over
every request's tokens at once.

``precision="fp8"`` is the control: the operands of every product
(weights, activations, queries, keys and values) rounded to float8
e4m3 with a scale per row or column, products summed in float32.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

F32 = torch.float32
Q_BLOCK = 1024
FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with an absmax scale along ``dim``."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(F32) * s


class Reference:
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


def served_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor
                ) -> torch.Tensor:
    """How far each served token's logit lies below the reference's best
    at its position (0 where the reference ranks it first)."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(1, tokens.long()[:, None])[:, 0]
    return best - got

