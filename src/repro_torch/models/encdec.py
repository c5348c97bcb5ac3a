"""Encoder–decoder backbone (seamless-m4t family) — the port of the JAX
package's ``models/encdec.py``.

The speech frontend is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings ``(B, S_enc, d_model)``; the text decoder
is a causal stack with cross-attention.  Parameters are the JAX
package's tree (encoder and decoder layers each stacked along a leading
"layers" axis); Python loops over the layers take the place of
``lax.scan``.  Decode caches: the self-attention KV (written in place at
each step) and the cross-attention KV, computed once from the encoder
output by :meth:`EncDecLM.prefill`, which takes frame embeddings and
returns the cache only — so the serving engines, which prefill token
prompts, do not serve this family (nor does the JAX package's).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.device import DeviceLike
from repro_torch.parallel.api import constrain_activations

from . import attention as attn_mod
from .components import (F32, _heads_proj, apply_ffn, apply_norm,
                         attention_specs, attn_out, dtype_of, embed,
                         embed_specs, ffn_specs, norm_specs, qkv_project,
                         sdpa, unembed)
from .config import ModelConfig
from .params import (ParamSpec, abstract_params, axes_tree, init_params,
                     param_count)
from .transformer import ShapeDtype, layer_slice, remat_call, stack_specs, \
    unstack, zero_cache


def _xattn_specs(cfg: ModelConfig) -> Dict:
    hd = cfg.resolved_head_dim
    dt = dtype_of(cfg.dtype)
    return {
        "wq": ParamSpec((cfg.d_model, cfg.n_heads, hd), dt,
                        ("embed", "heads", "head_dim")),
        "wk": ParamSpec((cfg.d_model, cfg.n_kv_heads, hd), dt,
                        ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((cfg.d_model, cfg.n_kv_heads, hd), dt,
                        ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((cfg.n_heads, hd, cfg.d_model), dt,
                        ("heads", "head_dim", "embed")),
    }


def _enc_layer_specs(cfg: ModelConfig) -> Dict:
    return {"ln_attn": norm_specs(cfg), "attn": attention_specs(cfg),
            "ln_ffn": norm_specs(cfg), "ffn": ffn_specs(cfg)}


def _dec_layer_specs(cfg: ModelConfig) -> Dict:
    return {"ln_self": norm_specs(cfg), "self": attention_specs(cfg),
            "ln_x": norm_specs(cfg), "xattn": _xattn_specs(cfg),
            "ln_ffn": norm_specs(cfg), "ffn": ffn_specs(cfg)}


def _cross_attention(p: Dict, x: torch.Tensor, enc_k: torch.Tensor,
                     enc_v: torch.Tensor) -> torch.Tensor:
    q = _heads_proj(x, p["wq"])
    o = sdpa(q, enc_k, enc_v, causal=False)
    return attn_out(p, o)


def _cross_kv(p: Dict, enc_out: torch.Tensor):
    return _heads_proj(enc_out, p["wk"]), _heads_proj(enc_out, p["wv"])


class EncDecLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.specs: Dict = {
            "embed": embed_specs(cfg),
            "enc": stack_specs(_enc_layer_specs(cfg), cfg.enc_layers),
            "dec": stack_specs(_dec_layer_specs(cfg), cfg.n_layers),
            "ln_enc": norm_specs(cfg),
            "ln_f": norm_specs(cfg),
        }
        self.n_params = param_count(self.specs)
        self.n_active_params = self.n_params

    def _stack(self, tree: Dict, name: str, n: int):
        for i in range(n):
            yield layer_slice(tree[name], i)

    # -- encoder ---------------------------------------------------------------
    def _enc_layer(self, p: Dict, x: torch.Tensor, positions):
        cfg = self.cfg
        h = apply_norm(p["ln_attn"], x, cfg)
        q, k, v = qkv_project(p["attn"], h, cfg, positions)
        o = sdpa(q, k, v, causal=False)
        x = constrain_activations(x + attn_out(p["attn"], o))
        h = apply_norm(p["ln_ffn"], x, cfg)
        return constrain_activations(x + apply_ffn(p["ffn"], h, cfg))

    def encode(self, params: Dict, enc_embeds: torch.Tensor,
               remat: bool = True) -> torch.Tensor:
        """Frame embeddings (B, S_enc, D) -> encoder output (B, S_enc, D):
        non-causal self-attention layers, then ``ln_enc``.  ``remat``:
        each layer is recomputed in the backward pass
        (``transformer.remat_call``)."""
        cfg = self.cfg
        positions = torch.arange(enc_embeds.shape[1],
                                 device=enc_embeds.device)
        x = enc_embeds
        for p in unstack(params["enc"], cfg.enc_layers):
            x = constrain_activations(x)
            x = remat_call(remat, self._enc_layer, p, x, positions)
        return apply_norm(params["ln_enc"], x, cfg)

    # -- decoder ---------------------------------------------------------------
    def _dec_layer(self, p: Dict, x, positions, enc_k, enc_v, cache, pos0):
        """One decoder layer; ``cache`` (decode) is written in place at
        ``pos0``."""
        cfg = self.cfg
        h = apply_norm(p["ln_self"], x, cfg)
        q, k, v = qkv_project(p["self"], h, cfg, positions)
        if cache is not None:
            k = attn_mod.cache_update(cache["k"], k, pos0, 2)
            v = attn_mod.cache_update(cache["v"], v, pos0, 2)
            kv_pos = torch.arange(k.shape[2], device=x.device)
        else:
            kv_pos = None
        o = sdpa(q, k, v, causal=True, kv_positions=kv_pos,
                 q_positions=positions)
        x = constrain_activations(x + attn_out(p["self"], o))
        h = apply_norm(p["ln_x"], x, cfg)
        x = constrain_activations(
            x + _cross_attention(p["xattn"], h, enc_k, enc_v))
        h = apply_norm(p["ln_ffn"], x, cfg)
        return constrain_activations(x + apply_ffn(p["ffn"], h, cfg))

    def _head(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        x = apply_norm(params["ln_f"], x, self.cfg)
        return unembed(params["embed"], x, self.cfg)

    def _apply_dec_layer(self, p: Dict, x: torch.Tensor, positions,
                         enc_out: torch.Tensor) -> torch.Tensor:
        """A decoder layer of ``apply``, its cross K/V from ``enc_out``."""
        ek, ev = _cross_kv(p["xattn"], enc_out)
        return self._dec_layer(p, x, positions, ek, ev, None, 0)

    def apply(self, params: Dict, tokens: torch.Tensor, *,
              enc_embeds: torch.Tensor, positions=None, remat: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced decode over ``tokens`` given the encoder's
        frame embeddings.  -> (logits (B,S,V) f32, a zero aux loss).
        ``remat``: each encoder and decoder layer (the latter with its
        cross K/V) is recomputed in the backward pass."""
        cfg = self.cfg
        enc_out = self.encode(params, enc_embeds, remat)
        x = embed(params["embed"], tokens, cfg)
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        for p in unstack(params["dec"], cfg.n_layers):
            x = constrain_activations(x)
            x = remat_call(remat, self._apply_dec_layer, p, x, positions,
                           enc_out)
        return self._head(params, x), \
            torch.zeros((), dtype=F32, device=x.device)

    # -- serving -----------------------------------------------------------------
    def cache_shape(self, batch: int, max_len: int, enc_len: int = 0) -> Dict:
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        L = cfg.n_layers
        dt = dtype_of(cfg.dtype)
        enc_len = enc_len or max_len
        kv = (L, batch, cfg.n_kv_heads, max_len, hd)
        xkv = (L, batch, cfg.n_kv_heads, enc_len, hd)
        return {"self": {"k": ShapeDtype(kv, dt), "v": ShapeDtype(kv, dt)},
                "cross": {"k": ShapeDtype(xkv, dt),
                          "v": ShapeDtype(xkv, dt)}}

    def cache_axes(self) -> Dict:
        kv = ("layers", "batch", "kv_heads", "kv_seq", "head_dim")
        return {"self": {"k": kv, "v": kv},
                "cross": {"k": kv, "v": kv}}

    def init_cache(self, batch: int, max_len: int, enc_len: int = 0,
                   device: DeviceLike = "cuda", like=None) -> Dict:
        return zero_cache(self.cache_shape(batch, max_len, enc_len), device,
                          self.cache_axes(), like)

    def prefill(self, params: Dict, enc_embeds: torch.Tensor,
                max_len: int) -> Dict:
        """Encode, and compute each decoder layer's cross K/V once: the
        cache (zeroed self-attention KV, the cross K/V in the model's
        type) and nothing else."""
        enc_out = self.encode(params, enc_embeds, remat=False)
        B, S_enc = enc_embeds.shape[:2]
        cache = self.init_cache(B, max_len, S_enc,
                                device=enc_embeds.device, like=enc_embeds)
        for i, p in enumerate(self._stack(params, "dec", self.cfg.n_layers)):
            xk, xv = _cross_kv(p["xattn"], enc_out)
            cache["cross"]["k"][i].copy_(xk)
            cache["cross"]["v"][i].copy_(xv)
        return cache

    def decode_step(self, params: Dict, cache: Dict, tokens: torch.Tensor,
                    pos) -> Tuple[torch.Tensor, Dict]:
        """tokens: (B, 1); pos: scalar, or (B,) per-row write offsets.
        Returns (logits (B,1,V), cache with its self-attention KV updated
        in place)."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, cfg)
        pos_t = torch.as_tensor(pos, device=x.device)
        positions = (pos_t[:, None] if pos_t.ndim == 1
                     else pos_t.expand(x.shape[0], 1))
        layers = zip(self._stack(params, "dec", cfg.n_layers),
                     self._stack(cache, "self", cfg.n_layers),
                     cache["cross"]["k"], cache["cross"]["v"])
        for p, sc, xk, xv in layers:
            x = self._dec_layer(p, x, positions, xk, xv, sc, pos)
        return self._head(params, x), cache

    def init(self, seed: int, device: DeviceLike = "cuda") -> Dict:
        """Fresh parameters from seeded ``torch.Generator``s."""
        return init_params(self.specs, seed, device)

    def abstract(self) -> Dict:
        """ShapeDtype stand-ins of the parameters (the dry-run's)."""
        return abstract_params(self.specs)

    def axes(self) -> Dict:
        """The parameters' logical axes."""
        return axes_tree(self.specs)

    def scan_trips(self) -> int:
        # the JAX encoder and decoder scans share one trip count
        return max(self.cfg.n_layers, self.cfg.enc_layers)
