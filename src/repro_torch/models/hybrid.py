"""Hybrid LM (RecurrentGemma): (rec, rec, local-attn) pattern groups —
the port of the JAX package's ``models/hybrid.py``.

Parameters are the JAX package's tree: the pattern's layers ``l0`` ..
``l{p-1}`` under ``groups``, each leaf stacked along a leading axis of
``n_groups``, then the remainder layers ``rem_{i}`` unstacked.  A Python
loop over the groups takes the place of ``lax.scan``.  Every layer is
``x += mixer(norm(x)); x += ffn(norm(x))``.  Decode updates the cache
(RG-LRU states and local-attention rings) in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike
from repro_torch.parallel.api import constrain_activations

from .components import (F32, apply_ffn, apply_norm, dtype_of, embed,
                         embed_specs, ffn_specs, norm_specs, unembed)
from .config import ModelConfig
from .params import abstract_params, axes_tree, init_params, \
    param_count
from .recurrent import (apply_local_attn, apply_rglru_block,
                        local_attn_cache_shape, local_attn_specs,
                        rglru_block_specs, rglru_cache_shape)
from .transformer import ShapeDtype, layer_slice, remat_call, stack_specs, \
    unstack, zero_cache


def _layer_specs(cfg: ModelConfig, kind: str) -> Dict:
    return {
        "ln_mix": norm_specs(cfg),
        "mix": (rglru_block_specs(cfg) if kind == "rec"
                else local_attn_specs(cfg)),
        "ln_ffn": norm_specs(cfg),
        "ffn": ffn_specs(cfg),
    }


def _apply_layer(p: Dict, x: torch.Tensor, positions, cfg: ModelConfig,
                 kind: str, cache: Optional[Dict], pos0) -> torch.Tensor:
    """One layer; ``cache`` (decode) is updated in place."""
    h = apply_norm(p["ln_mix"], x, cfg)
    if kind == "rec":
        o, new_state = apply_rglru_block(p["mix"], h, cfg, state=cache)
        if cache is not None:
            for k in ("h", "conv"):
                cache[k].copy_(new_state[k])
    else:
        o, _ = apply_local_attn(p["mix"], h, positions, cfg, cache=cache,
                                pos0=pos0)
    x = constrain_activations(x + o)
    h = apply_norm(p["ln_ffn"], x, cfg)
    return constrain_activations(x + apply_ffn(p["ffn"], h, cfg))


class HybridLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        pat = cfg.recurrent.pattern
        self.pattern = pat
        self.n_groups = cfg.n_layers // len(pat)
        self.rem = [pat[i] for i in range(cfg.n_layers
                                          - self.n_groups * len(pat))]
        group = {f"l{i}": _layer_specs(cfg, k) for i, k in enumerate(pat)}
        self.specs: Dict = {"embed": embed_specs(cfg),
                            "groups": stack_specs(group, self.n_groups)}
        for i, k in enumerate(self.rem):
            self.specs[f"rem_{i}"] = _layer_specs(cfg, k)
        self.specs["ln_f"] = norm_specs(cfg)
        self.n_params = param_count(self.specs)
        self.n_active_params = self.n_params

    def _layers(self, tree: Dict):
        """(layer's slice of ``tree``, its kind) for every layer in order:
        the groups' pattern layers, then the remainder.  ``tree`` is the
        parameters or a cache."""
        for g in range(self.n_groups):
            gt = layer_slice(tree["groups"], g)
            for i, kind in enumerate(self.pattern):
                yield gt[f"l{i}"], kind
        for i, kind in enumerate(self.rem):
            yield tree[f"rem_{i}"], kind

    def _head(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        x = apply_norm(params["ln_f"], x, self.cfg)
        return unembed(params["embed"], x, self.cfg)

    def apply(self, params: Dict, tokens: Optional[torch.Tensor] = None, *,
              inputs_embeds: Optional[torch.Tensor] = None,
              positions: Optional[torch.Tensor] = None, remat: bool = True,
              last_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (logits (B,S,V) f32 — (B,1,V) with ``last_only`` — and a
        zero aux loss).  ``inputs_embeds`` (B, S, D) stands in for the
        embedded ``tokens``; ``positions`` (S,) default to ``arange(S)``;
        ``remat``: each layer is recomputed in the backward pass
        (``transformer.remat_call``)."""
        cfg = self.cfg
        x = (embed(params["embed"], tokens, cfg)
             if inputs_embeds is None else inputs_embeds)
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        layers = [(gp[f"l{i}"], kind)
                  for gp in unstack(params["groups"], self.n_groups)
                  for i, kind in enumerate(self.pattern)]
        layers += [(params[f"rem_{i}"], kind)
                   for i, kind in enumerate(self.rem)]
        for p, kind in layers:
            x = constrain_activations(x)
            x = remat_call(remat, _apply_layer, p, x, positions, cfg, kind,
                           None, 0)
        if last_only:
            x = x[:, -1:]
        return self._head(params, x), \
            torch.zeros((), dtype=F32, device=x.device)

    # -- serving -------------------------------------------------------------
    def _cache_shape_one(self, kind: str, batch: int):
        return (rglru_cache_shape(self.cfg, batch) if kind == "rec"
                else local_attn_cache_shape(self.cfg, batch))

    def cache_shape(self, batch: int, max_len: int) -> Dict:
        del max_len  # state size is context-free (the point of this arch)
        out: Dict = {"groups": {}}
        for i, kind in enumerate(self.pattern):
            out["groups"][f"l{i}"] = {
                k: ShapeDtype((self.n_groups,) + s, dtype_of(d))
                for k, (s, d) in self._cache_shape_one(kind, batch).items()}
        for i, kind in enumerate(self.rem):
            out[f"rem_{i}"] = {
                k: ShapeDtype(s, dtype_of(d))
                for k, (s, d) in self._cache_shape_one(kind, batch).items()}
        return out

    def _cache_axes_one(self, kind: str):
        if kind == "rec":
            return {"h": ("batch", "mlp"), "conv": ("batch", None, "mlp")}
        return {"k": ("batch", "kv_heads", "kv_seq", "head_dim"),
                "v": ("batch", "kv_heads", "kv_seq", "head_dim"),
                "pos": ("batch", None)}

    def cache_axes(self) -> Dict:
        out: Dict = {"groups": {}}
        for i, kind in enumerate(self.pattern):
            out["groups"][f"l{i}"] = {
                k: ("layers",) + v
                for k, v in self._cache_axes_one(kind).items()}
        for i, kind in enumerate(self.rem):
            out[f"rem_{i}"] = self._cache_axes_one(kind)
        return out

    def init_cache(self, batch: int, max_len: int,
                   device: DeviceLike = "cuda", like=None) -> Dict:
        return zero_cache(self.cache_shape(batch, max_len), device,
                          self.cache_axes(), like)

    def decode_step(self, params: Dict, cache: Dict, tokens: torch.Tensor,
                    pos) -> Tuple[torch.Tensor, Dict]:
        """tokens: (B, 1); pos: scalar, or (B,) per-row positions.
        Returns (logits (B,1,V), cache updated in place)."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, cfg)
        pos_t = torch.as_tensor(pos, device=x.device)
        positions = (pos_t[:, None] if pos_t.ndim == 1
                     else pos_t.expand(x.shape[0], 1))
        for (p, kind), (c, _) in zip(self._layers(params),
                                     self._layers(cache)):
            x = _apply_layer(p, x, positions, cfg, kind, c, pos)
        return self._head(params, x), cache

    def prefill(self, params: Dict, tokens: torch.Tensor, max_len: int
                ) -> Tuple[torch.Tensor, Dict]:
        """Last-position logits of the prompt and a cache — the zeroed
        cache, as the JAX package's ``HybridLM.prefill`` returns: the
        prompt's states and ring are not carried into decode (a defect of
        the reference, kept so the two agree; ROADMAP section C)."""
        logits, _ = self.apply(params, tokens, remat=False, last_only=True)
        return logits, self.init_cache(tokens.shape[0], max_len,
                                       device=tokens.device, like=tokens)

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
        return max(self.n_groups, 1)
