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
from repro_torch.parallel.api import constrain_activations, gather_last

from .components import F32, apply_norm, dtype_of, embed, embed_specs, \
    norm_specs, unembed
from .config import ModelConfig
from .encdec import EncDecLM
from .hybrid import HybridLM
from .params import abstract_params, axes_tree, init_params, \
    param_count
from .ssm import apply_ssm_block, ssm_block_specs, ssm_cache_shape
from .transformer import ShapeDtype, TransformerLM, layer_slice, \
    remat_call, stack_specs, unstack, zero_cache


class SSMLM:
    """Pure Mamba-2 stack: x += mixer(norm(x)) per layer.  Parameters
    are the JAX package's tree (the blocks stacked along a leading
    "layers" axis); a Python loop over the layers takes the place of
    ``lax.scan``.  As in JAX, each layer's input activation is pinned
    to the installed activation spec (``constrain_activations``)."""

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

    def _layer(self, p: Dict, x: torch.Tensor) -> torch.Tensor:
        h = apply_norm(p["ln"], x, self.cfg)
        o, _ = apply_ssm_block(p["ssm"], h, self.cfg)
        return constrain_activations(x + o)

    def apply(self, params: Dict, tokens: torch.Tensor, *,
              remat: bool = True,
              last_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (logits (B,S,V) f32 — (B,1,V) with ``last_only`` — and a
        zero aux loss).  ``remat``: each layer is recomputed in the
        backward pass (``transformer.remat_call``)."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, cfg)
        for p in unstack(params["blocks"], cfg.n_layers):
            x = constrain_activations(x)
            x = remat_call(remat, self._layer, p, x)
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
                   device: DeviceLike = "cuda", like=None) -> Dict:
        return zero_cache(self.cache_shape(batch, max_len), device,
                          self.cache_axes(), like)

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
        return self.cfg.n_layers


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


def lm_loss(model, params: Dict, batch: Dict, *, aux_weight: float = 0.01,
            remat: bool = True) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross-entropy + MoE aux loss, as the JAX package's
    ``lm_loss``.  batch: {"tokens": (B,S)} plus an optional "mask"
    (B, S-1) over the targets and "enc_embeds" (encoder-decoder, audio)
    or "inputs_embeds" (B, S, D) (VLM).  Returns (loss, {"ce", "aux"}).

    The row max is held out of the gradient (``.detach()``, JAX's
    ``stop_gradient``).  The target logit is gathered from the shifted
    logits; JAX sums ``shifted * one_hot(tgt)`` over the vocabulary, a
    sum with one non-zero term, so both give the same float32 value, and
    the gather builds no (B, S, V) one-hot (5 GB for qwen3-1.7b at
    8 x 1,024 tokens)."""
    tokens = batch["tokens"]
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    if "enc_embeds" in batch:
        logits, aux = model.apply(params, inp, enc_embeds=batch["enc_embeds"],
                                  remat=remat)
    elif "inputs_embeds" in batch:
        logits, aux = model.apply(
            params, inputs_embeds=batch["inputs_embeds"][:, :-1],
            remat=remat)
    else:
        logits, aux = model.apply(params, inp, remat=remat)
    logits = logits.to(F32)
    m = logits.amax(dim=-1, keepdim=True).detach()
    shifted = logits - m
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
    tgt_logit = gather_last(shifted, tgt.long()[..., None])[..., 0]
    ll = tgt_logit - lse
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(tgt, dtype=F32)
    mask = mask.to(F32)
    loss = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}
