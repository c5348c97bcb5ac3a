"""Decoder-only transformer stack — the dense GQA family.

The port of the JAX package's ``models/transformer.py`` for
``family="dense"``.  Parameters are the same nested dict, with each
block leaf stacked along a leading "layers" axis; a Python loop over
the layers takes the place of ``lax.scan``.

KV caches and page pools are updated **in place** (JAX returns new
arrays; the port writes into the tensors it was given and returns
them), so a serving engine holds one pool for its whole life.  Writes
that the JAX package drops (``.at[...].set(mode="drop")`` with an
out-of-range page index, for inactive decode rows and padding prefill
queries) are masked out explicitly here and never touch the pool, so
the reserved null page 0 stays all-zero.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

from . import attention as attn_mod
from .components import (F32, apply_ffn, apply_norm, attention_specs,
                         attn_out, dtype_of, embed, embed_specs, ffn_specs,
                         norm_specs, qkv_project, sdpa, unembed)
from .config import ModelConfig
from .params import ParamSpec, init_params, param_count


class ShapeDtype(NamedTuple):
    """Shape and dtype of one cache leaf (``jax.ShapeDtypeStruct``'s
    counterpart)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def stack_specs(specs: Dict, n: int) -> Dict:
    """Add a leading stacked-layers axis to every leaf spec."""
    if isinstance(specs, ParamSpec):
        return ParamSpec((n,) + specs.shape, specs.dtype,
                         ("layers",) + (specs.axes or
                                        (None,) * len(specs.shape)),
                         specs.init, specs.scale)
    return {k: stack_specs(v, n) for k, v in specs.items()}


def block_specs(cfg: ModelConfig) -> Dict:
    return {
        "ln_attn": norm_specs(cfg),
        "attn": attention_specs(cfg),
        "ln_ffn": norm_specs(cfg),
        "ffn": ffn_specs(cfg),
    }


def layer_slice(tree, i: int):
    """Layer ``i`` of a layer-stacked tree (views, not copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def _self_attention(p: Dict, x: torch.Tensor, positions, cfg: ModelConfig,
                    cache: Optional[Dict], pos0) -> torch.Tensor:
    """Attention output (B, S, D); ``cache`` is written in place."""
    q, k, v = qkv_project(p, x, cfg, positions)
    if cache is not None:
        k_all = attn_mod.cache_update(cache["k"], k, pos0, 2)
        v_all = attn_mod.cache_update(cache["v"], v, pos0, 2)
        kv_pos = torch.arange(k_all.shape[2], device=x.device)
    else:
        k_all, v_all, kv_pos = k, v, None
    o = sdpa(q, k_all, v_all, q_positions=positions, kv_positions=kv_pos)
    return attn_out(p, o)


def _ffn_residual(p: Dict, x: torch.Tensor, cfg: ModelConfig):
    h = apply_norm(p["ln_ffn"], x, cfg)
    return x + apply_ffn(p["ffn"], h, cfg)


def apply_block(p: Dict, x: torch.Tensor, positions, cfg: ModelConfig, *,
                cache: Optional[Dict] = None, pos0=0) -> torch.Tensor:
    h = apply_norm(p["ln_attn"], x, cfg)
    x = x + _self_attention(p["attn"], h, positions, cfg, cache, pos0)
    return _ffn_residual(p, x, cfg)


def _paged_self_attention(p: Dict, x: torch.Tensor, positions, cfg,
                          leaf: Dict, tables, lengths, writes, *,
                          kernel_cfg) -> torch.Tensor:
    """Single-token decode attention straight off one layer's page-pool
    leaf: write the fresh K/V into their (physical page, offset) homes,
    then run the length-masked paged-attention kernel over the pool.  No
    dense gather ever materializes.  ``writes`` = (rows, phys, offs) of
    the active rows only: inactive rows write nothing."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    q, k, v = qkv_project(p, x, cfg, positions)        # k/v: (B, HK, 1, hd)
    rows, phys, off = writes
    leaf["k"][phys, :, off] = k[rows, :, 0, :].to(leaf["k"].dtype)
    leaf["v"][phys, :, off] = v[rows, :, 0, :].to(leaf["v"].dtype)
    o = pa_ops.paged_decode(q, leaf["k"], leaf["v"], tables, lengths,
                            cfg=kernel_cfg)
    return attn_out(p, o)


def _packed_prefill_attention(p: Dict, x: torch.Tensor, positions, cfg,
                              leaf: Dict, meta, writes, *,
                              kernel_cfg) -> torch.Tensor:
    """Ragged chunked-prefill attention for one layer, straight off the
    page pool: write the chunk's fresh K/V to their (physical page,
    offset) homes (``writes`` = (query index, phys, offs) of the real
    queries; padding queries write nothing), token-gather the packed KV
    (every pending sequence's prefix + fresh chunk; padding KV slots
    address the null page) and run the segment/causal-masked
    ragged-prefill kernel.  x: (1, TQ, D_model)."""
    from repro_torch.kernels.ragged_prefill.ragged_prefill import \
        ragged_prefill
    seg_q, pos_q, seg_k, pos_k, gather_phys, gather_offs = meta
    q, k, v = qkv_project(p, x, cfg, positions)    # k/v: (1, HK, TQ, hd)
    idx, wphys, woffs = writes
    leaf["k"][wphys, :, woffs] = k[0][:, idx].transpose(0, 1).to(
        leaf["k"].dtype)
    leaf["v"][wphys, :, woffs] = v[0][:, idx].transpose(0, 1).to(
        leaf["v"].dtype)
    # token-granular packed-KV gather (TK rows), not a dense view
    kp = leaf["k"][gather_phys, :, gather_offs].transpose(0, 1).contiguous()
    vp = leaf["v"][gather_phys, :, gather_offs].transpose(0, 1).contiguous()
    o = ragged_prefill(q[0].contiguous(), kp, vp, seg_q, pos_q, seg_k,
                       pos_k, cfg=kernel_cfg)
    return attn_out(p, o[None])


class TransformerLM:
    """Decoder-only LM (dense GQA family)."""

    def __init__(self, cfg: ModelConfig):
        if cfg.attn_type != "gqa" or cfg.moe is not None:
            raise NotImplementedError(
                f"{cfg.name}: only dense GQA decoders are ported so far "
                "(MoE and MLA: ROADMAP, port item A6)")
        unported = [f for f, ok in (
            ("norm_type", cfg.norm_type == "rmsnorm"),
            ("ffn_type", cfg.ffn_type == "swiglu"),
            ("qkv_bias", not cfg.qkv_bias),
            ("rope_frac", cfg.rope_frac == 1.0),
            ("tie_embeddings", cfg.tie_embeddings),
            ("scale_embed", not cfg.scale_embed)) if not ok]
        if unported:
            raise NotImplementedError(
                f"{cfg.name}: {', '.join(unported)} not ported yet (the "
                "other architectures: ROADMAP, port item A8)")
        self.cfg = cfg
        self.n_layers = cfg.n_layers
        self.specs: Dict = {
            "embed": embed_specs(cfg),
            "blocks": stack_specs(block_specs(cfg), cfg.n_layers),
            "ln_f": norm_specs(cfg),
        }
        self.n_params = param_count(self.specs)

    def _blocks(self, params: Dict, x: torch.Tensor, fn) -> torch.Tensor:
        for i in range(self.n_layers):
            x = fn(layer_slice(params["blocks"], i), x, i)
        return x

    def _head(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        x = apply_norm(params["ln_f"], x, self.cfg)
        return unembed(params["embed"], x, self.cfg)

    # -- forward -------------------------------------------------------------
    def apply(self, params: Dict, tokens: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (logits (B,S,V) f32, aux_loss (0 for the dense family))."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, cfg)
        positions = torch.arange(x.shape[1], device=x.device)
        x = self._blocks(params, x, lambda p, x, i: apply_block(
            p, x, positions, cfg))
        return self._head(params, x), torch.zeros((), dtype=F32,
                                                  device=x.device)

    # -- serving -------------------------------------------------------------
    def cache_shape(self, batch: int, max_len: int) -> Dict:
        shp = attn_mod.gqa_cache_shape(self.cfg, batch, max_len)
        dt = dtype_of(self.cfg.dtype)
        return {"blocks": {k: ShapeDtype((self.n_layers,) + v, dt)
                           for k, v in shp.items()}}

    def cache_axes(self) -> Dict:
        ax = ("layers", "batch", "kv_heads", "kv_seq", "head_dim")
        return {"blocks": {"k": ax, "v": ax}}

    def init_cache(self, batch: int, max_len: int,
                   device: DeviceLike = "cuda") -> Dict:
        dev = resolve_device(device)
        return {"blocks": {
            k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
            for k, s in self.cache_shape(batch, max_len)["blocks"].items()}}

    def decode_step(self, params: Dict, cache: Dict, tokens: torch.Tensor,
                    pos: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """tokens: (B, 1); pos: scalar, or (B,) per-slot write offsets.
        Returns (logits (B,1,V), cache updated in place)."""
        return self.decode_chunk(params, cache, tokens, pos)

    def decode_chunk(self, params: Dict, cache: Dict, tokens: torch.Tensor,
                     pos: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """Multi-token decode: tokens (B, S) written at per-row offsets
        ``pos`` ((B,) int, or scalar), causal within the chunk and
        attending to the whole cache prefix — the chunked-prefill step
        of the gather path.  Returns (logits (B, S, V), cache updated in
        place)."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, cfg)
        B, S = tokens.shape
        offs = torch.arange(S, dtype=torch.int32, device=x.device)
        pos = torch.as_tensor(pos, device=x.device)
        positions = (pos[:, None] + offs if pos.ndim == 1
                     else (pos + offs).expand(B, S))
        x = self._blocks(params, x, lambda p, x, i: apply_block(
            p, x, positions, cfg, cache=layer_slice(cache["blocks"], i),
            pos0=pos))
        return self._head(params, x), cache

    def decode_step_paged(self, params: Dict, pool: Dict,
                          tables: torch.Tensor, tokens: torch.Tensor,
                          pos: torch.Tensor, lengths: torch.Tensor, *,
                          kernel_cfg=None) -> Tuple[torch.Tensor, Dict]:
        """Single-token decode straight off the page pool: no dense
        gather.  ``pool`` is the :class:`repro_torch.serve.pool.KVPool`
        storage tree, ``tables`` the (B, NP) int32 block tables, ``pos``
        the (B,) write positions and ``lengths`` the (B,) int32 logical
        lengths *including* the token being written (0 for inactive
        rows — they write nothing and read nothing).  Returns (logits
        (B, 1, V), pool updated in place)."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, cfg)
        PS = pool["blocks"]["k"].shape[3]
        pos = pos.to(torch.int64)
        positions = pos[:, None]
        # writes of active rows only: the JAX package redirects inactive
        # rows past the pool and lets mode="drop" discard them
        rows = torch.nonzero(lengths > 0).squeeze(1)
        phys = tables[rows, pos[rows] // PS].long()
        writes = (rows, phys, pos[rows] % PS)
        x = self._blocks(params, x, lambda p, x, i: self._paged_block(
            p, x, positions, layer_slice(pool["blocks"], i), tables,
            lengths, writes, kernel_cfg))
        return self._head(params, x), pool

    def _paged_block(self, p, x, positions, leaf, tables, lengths, writes,
                     kernel_cfg):
        h = apply_norm(p["ln_attn"], x, self.cfg)
        x = x + _paged_self_attention(p["attn"], h, positions, self.cfg,
                                      leaf, tables, lengths, writes,
                                      kernel_cfg=kernel_cfg)
        return _ffn_residual(p, x, self.cfg)

    def prefill_chunk_packed(self, params: Dict, pool: Dict,
                             tokens: torch.Tensor, seg_q: torch.Tensor,
                             pos_q: torch.Tensor, seg_k: torch.Tensor,
                             pos_k: torch.Tensor, write_phys: torch.Tensor,
                             write_offs: torch.Tensor,
                             gather_phys: torch.Tensor,
                             gather_offs: torch.Tensor, *,
                             kernel_cfg=None) -> Tuple[torch.Tensor, Dict]:
        """Kernel-path chunked prefill: every pending sequence's prompt
        chunk packed into one (1, TQ) ragged buffer, attended through
        the segment/causal-masked ragged-prefill kernel straight off the
        page pool — no dense view.  ``tokens`` are the packed chunk
        tokens; ``seg_q/pos_q`` ((TQ,) int32) their owning sequence and
        absolute in-sequence position (seg -1 on padding); ``seg_k/
        pos_k`` ((TK,) int32) the packed-KV metadata covering each
        sequence's prefix *plus* the fresh chunk; ``write_phys/
        write_offs`` ((TQ,)) each chunk token's (physical page, offset)
        home (out of the pool's range on padding: not written);
        ``gather_phys/gather_offs`` ((TK,)) each packed-KV token's
        address (null page on padding).  The kernel is called directly,
        not through ``ops``: the engine resolved ``kernel_cfg`` already.
        Returns (logits (1, TQ, V), pool updated in place)."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, cfg)
        positions = torch.clamp(pos_q, min=0)[None, :]
        P, PS = pool["blocks"]["k"].shape[1], pool["blocks"]["k"].shape[3]
        keep = ((write_phys >= 0) & (write_phys < P)
                & (write_offs >= 0) & (write_offs < PS))
        idx = torch.nonzero(keep).squeeze(1)
        writes = (idx, write_phys[idx].long(), write_offs[idx].long())
        meta = (seg_q, pos_q, seg_k, pos_k, gather_phys.long(),
                gather_offs.long())
        x = self._blocks(params, x, lambda p, x, i: self._packed_block(
            p, x, positions, layer_slice(pool["blocks"], i), meta, writes,
            kernel_cfg))
        return self._head(params, x), pool

    def _packed_block(self, p, x, positions, leaf, meta, writes,
                      kernel_cfg):
        h = apply_norm(p["ln_attn"], x, self.cfg)
        x = x + _packed_prefill_attention(p["attn"], h, positions, self.cfg,
                                          leaf, meta, writes,
                                          kernel_cfg=kernel_cfg)
        return _ffn_residual(p, x, self.cfg)

    def prefill(self, params: Dict, tokens: torch.Tensor, max_len: int
                ) -> Tuple[torch.Tensor, Dict]:
        """Run the prompt, building a fresh cache on the tokens' device.
        tokens: (B, S).  Returns (last-position logits (B, 1, V), cache)."""
        cfg = self.cfg
        B, S = tokens.shape
        cache = self.init_cache(B, max_len, device=tokens.device)
        x = embed(params["embed"], tokens, cfg)
        positions = torch.arange(S, device=x.device)
        x = self._blocks(params, x, lambda p, x, i: apply_block(
            p, x, positions, cfg, cache=layer_slice(cache["blocks"], i),
            pos0=0))
        # last-position logits only: full-sequence logits are (B, S, V)
        return self._head(params, x[:, -1:]), cache

    # -- params ---------------------------------------------------------------
    def init(self, seed: int, device: DeviceLike = "cuda") -> Dict:
        """Fresh parameters from seeded ``torch.Generator``s."""
        return init_params(self.specs, seed, device)
