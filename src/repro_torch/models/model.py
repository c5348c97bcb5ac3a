"""Model facade: ``build(cfg)`` returns the family's LM object — the port
of the JAX package's ``models/model.py``.  The dense, MoE and VLM
families are built as :class:`TransformerLM` (GQA or MLA attention),
the SSM family as :class:`SSMLM`, the hybrid family (RecurrentGemma) as
:class:`~repro_torch.models.hybrid.HybridLM` and the encoder-decoder
and audio families (seamless-m4t) as
:class:`~repro_torch.models.encdec.EncDecLM`."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.device import DeviceLike

from .components import F32, apply_norm, dtype_of, embed, embed_specs, \
    norm_specs, unembed
from .config import ModelConfig
from .encdec import EncDecLM
from .hybrid import HybridLM
from .params import init_params, param_count
from .ssm import apply_ssm_block, ssm_block_specs, ssm_cache_shape
from .transformer import ShapeDtype, TransformerLM, layer_slice, \
    stack_specs, zero_cache


class SSMLM:
    """Pure Mamba-2 stack: x += mixer(norm(x)) per layer.  Parameters
    are the JAX package's tree (the blocks stacked along a leading
    "layers" axis); a Python loop over the layers takes the place of
    ``lax.scan``.  The JAX package pins each layer's activations to its
    mesh (``constrain_activations``); the port has no sharding yet
    (ROADMAP item A10), so that step is left out."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        layer = {"ln": norm_specs(cfg), "ssm": ssm_block_specs(cfg)}
        self.specs: Dict = {
            "embed": embed_specs(cfg),
            "blocks": stack_specs(layer, cfg.n_layers),
            "ln_f": norm_specs(cfg),
        }
        self.n_params = param_count(self.specs)
        self.n_active_params = self.n_params

    def _layers(self, tree: Dict):
        for i in range(self.cfg.n_layers):
            yield layer_slice(tree["blocks"], i)

    def apply(self, params: Dict, tokens: torch.Tensor, *,
              last_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (logits (B,S,V) f32 — (B,1,V) with ``last_only`` — and a
        zero aux loss)."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, cfg)
        for p in self._layers(params):
            h = apply_norm(p["ln"], x, cfg)
            o, _ = apply_ssm_block(p["ssm"], h, cfg)
            x = x + o
        if last_only:
            x = x[:, -1:]
        x = apply_norm(params["ln_f"], x, cfg)
        return unembed(params["embed"], x, cfg), \
            torch.zeros((), dtype=F32, device=x.device)

    def cache_shape(self, batch: int, max_len: int) -> Dict:
        del max_len  # O(1)-in-context state
        shapes = ssm_cache_shape(self.cfg, batch)
        return {"blocks": {
            k: ShapeDtype((self.cfg.n_layers,) + s, dtype_of(d))
            for k, (s, d) in shapes.items()}}

    def cache_axes(self) -> Dict:
        return {"blocks": {
            "ssm": ("layers", "batch", "heads", None, None),
            "conv": ("layers", "batch", None, "mlp"),
        }}

    def init_cache(self, batch: int, max_len: int,
                   device: DeviceLike = "cuda") -> Dict:
        return zero_cache(self.cache_shape(batch, max_len), device)

    def decode_step(self, params: Dict, cache: Dict, tokens: torch.Tensor,
                    pos) -> Tuple[torch.Tensor, Dict]:
        """tokens: (B, 1); ``pos`` is not read (the state is the
        context).  Returns (logits (B,1,V), cache updated in place)."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, cfg)
        for p, c in zip(self._layers(params), self._layers(cache)):
            h = apply_norm(p["ln"], x, cfg)
            o, nc = apply_ssm_block(p["ssm"], h, cfg, state=c)
            x = x + o
            for k in ("ssm", "conv"):
                c[k].copy_(nc[k])
        x = apply_norm(params["ln_f"], x, cfg)
        return unembed(params["embed"], x, cfg), cache

    def prefill(self, params: Dict, tokens: torch.Tensor, max_len: int
                ) -> Tuple[torch.Tensor, Dict]:
        """Last-position logits of the prompt and a cache — the zeroed
        cache, as the JAX package's ``SSMLM.prefill`` returns: the
        prompt's SSM and conv state is not carried into decode (a defect
        of the reference, kept so the two agree; ROADMAP section C)."""
        logits, _ = self.apply(params, tokens, last_only=True)
        return logits, self.init_cache(tokens.shape[0], max_len,
                                       device=tokens.device)

    def init(self, seed: int, device: DeviceLike = "cuda") -> Dict:
        """Fresh parameters from seeded ``torch.Generator``s."""
        return init_params(self.specs, seed, device)


def build(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "vlm"):
        return TransformerLM(cfg)
    if cfg.family == "ssm":
        return SSMLM(cfg)
    if cfg.family == "hybrid":
        return HybridLM(cfg)
    if cfg.family in ("encdec", "audio"):
        return EncDecLM(cfg)
    raise ValueError(f"unknown model family {cfg.family!r}")
