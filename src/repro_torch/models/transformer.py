"""Decoder-only transformer stack — the dense, MoE and VLM families, GQA
or MLA attention.

The port of the JAX package's ``models/transformer.py``.  Parameters
are the same nested dict: the leading dense layers of an MoE config
(``first_dense_layers``) as ``front_{i}``, then the blocks, each leaf
stacked along a leading "layers" axis; a Python loop over the layers
takes the place of ``lax.scan``.  An MoE block's FFN is
:func:`repro_torch.models.moe.moe_forward` (capacity-dispatched experts
when a call carries several tokens a row, every expert densely at one
token a row), as in the JAX package.  A VLM (chameleon) is this stack
over a vocabulary that holds its image tokens; ``apply`` also takes
precomputed ``inputs_embeds``.

KV caches and page pools are updated **in place** (JAX returns new
arrays; the port writes into the tensors it was given and returns
them), so a serving engine holds one pool for its whole life.  Writes
that the JAX package drops (``.at[...].set(mode="drop")`` with an
out-of-range page index, for inactive decode rows and padding prefill
queries) leave the pool as they find it: padding prefill queries are
masked out, and inactive decode rows write zeros into offset 0 of the
reserved null page 0, so that page stays all-zero and the decode call
holds no host sync (:meth:`TransformerLM.decode_step_paged` replays as
a CUDA graph).  An MLA cache holds the latent
``c_kv`` and the roped key ``k_rope`` a position, with no heads axis:
the paged kernel paths (``decode_step_paged``, ``prefill_chunk_packed``)
take GQA caches only and raise for MLA, whose ticks stay on the gather
paths, as in the JAX package.

The two paged serving calls are traced (:mod:`repro_torch.obs`):
``model.decode`` / ``model.prefill`` over ``model.embed``, each layer's
``model.attn`` (norm, QKV, rotary, KV write, the kernel and the
O-projection) and ``model.ffn`` or ``model.moe``, and ``model.head``
(the final norm and the unembed); with the obs switch on, a layer's
spans carry its index.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import obs as _obs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.parallel.api import constrain_activations, shard_state

from . import attention as attn_mod
from .components import (F32, apply_ffn, apply_norm, attention_specs,
                         attn_out, dtype_of, embed, embed_specs, ffn_specs,
                         norm_specs, qkv_project, sdpa, unembed)
from .config import ModelConfig
from .moe import load_balance_loss, moe_forward, moe_specs
from .params import (ParamSpec, ShapeDtype, abstract_params, axes_tree,
                     init_params, param_count)


def stack_specs(specs: Dict, n: int) -> Dict:
    """Add a leading stacked-layers axis to every leaf spec."""
    if isinstance(specs, ParamSpec):
        return ParamSpec((n,) + specs.shape, specs.dtype,
                         ("layers",) + (specs.axes or
                                        (None,) * len(specs.shape)),
                         specs.init, specs.scale)
    return {k: stack_specs(v, n) for k, v in specs.items()}


def _attn_specs(cfg: ModelConfig) -> Dict:
    if cfg.attn_type == "mla":
        return attn_mod.mla_specs(cfg)
    return attention_specs(cfg)


def block_specs(cfg: ModelConfig, *, moe_layer: bool = False) -> Dict:
    s = {
        "ln_attn": norm_specs(cfg),
        "attn": _attn_specs(cfg),
        "ln_ffn": norm_specs(cfg),
    }
    if moe_layer:
        s["moe"] = moe_specs(cfg)
    else:
        d_ff = cfg.d_ff
        if cfg.moe is not None and cfg.moe.first_dense_layers:
            d_ff = cfg.moe.dense_d_ff or cfg.d_ff
        s["ffn"] = ffn_specs(cfg, d_ff=d_ff)
    return s


def zero_cache(shapes: Dict, device: DeviceLike = "cuda", axes=None,
               like=None) -> Dict:
    """A cache tree of zeros from a ``cache_shape`` tree of
    :class:`ShapeDtype` leaves (nested dicts of any depth), on
    ``device``.  When ``like`` (the input the cache is built for) is a
    DTensor, the cache is placed on its mesh by the logical ``axes`` and
    the installed rules (``parallel.api.shard_state``)."""
    if axes is not None:
        sharded = shard_state(shapes, axes, like)
        if sharded is not None:
            return sharded
    dev = resolve_device(device)

    def zeros(node):
        if isinstance(node, dict):
            return {k: zeros(v) for k, v in node.items()}
        return torch.zeros(node.shape, dtype=node.dtype, device=dev)
    return zeros(shapes)


def layer_slice(tree, i: int):
    """Layer ``i`` of a layer-stacked tree (views, not copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def unstack(tree, n: int):
    """The ``n`` layers of a layer-stacked tree, each leaf split once by
    ``torch.unbind`` (views).  In a backward pass a stacked leaf's
    gradient is then stacked once from its layers'; indexing layer by
    layer (:func:`layer_slice`) would add a zero-filled copy of the
    whole stack for every layer."""
    if isinstance(tree, dict):
        per_key = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return torch.unbind(tree, 0)


def _needs_grad(node) -> bool:
    if isinstance(node, torch.Tensor):
        return node.requires_grad
    if isinstance(node, dict):
        return any(_needs_grad(v) for v in node.values())
    return False


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``; under ``torch.utils.checkpoint`` when ``remat`` is
    set, grad is enabled and a tensor of ``args`` requires it, as the JAX
    package wraps its scanned block in ``jax.checkpoint``: the block's
    activations are recomputed in the backward pass instead of kept.
    Otherwise (serving, a forward without trainable tensors) it is a
    plain call."""
    if remat and torch.is_grad_enabled() and any(map(_needs_grad, args)):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _self_attention(p: Dict, x: torch.Tensor, positions, cfg: ModelConfig,
                    cache: Optional[Dict], pos0) -> torch.Tensor:
    """Attention output (B, S, D); ``cache`` is written in place."""
    if cfg.attn_type == "mla":
        c_kv, k_r = attn_mod.mla_latents(p, x, positions, cfg)
        if cache is not None:
            c_all = attn_mod.cache_update(cache["c_kv"], c_kv, pos0, 1)
            kr_all = attn_mod.cache_update(cache["k_rope"], k_r, pos0, 1)
            kv_pos = torch.arange(c_all.shape[1], device=x.device)
        else:
            c_all, kr_all, kv_pos = c_kv, k_r, None
        return attn_mod.mla_attention(p, x, c_all, kr_all, positions, cfg,
                                      kv_positions=kv_pos)
    q, k, v = qkv_project(p, x, cfg, positions)
    if cache is not None:
        k_all = attn_mod.cache_update(cache["k"], k, pos0, 2)
        v_all = attn_mod.cache_update(cache["v"], v, pos0, 2)
        kv_pos = torch.arange(k_all.shape[2], device=x.device)
    else:
        k_all, v_all, kv_pos = k, v, None
    o = sdpa(q, k_all, v_all, causal=True, q_positions=positions,
             kv_positions=kv_pos)
    return attn_out(p, o)


def _ffn_residual(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                  moe_layer: bool) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """x + FFN(norm(x)), and an MoE layer's routing (router probs, expert
    indices), from which :meth:`TransformerLM.apply` sums the aux loss
    (None for a dense FFN).  The serving paths drop the routing: they
    compute no aux loss."""
    h = apply_norm(p["ln_ffn"], x, cfg)
    if moe_layer:
        f, probs, idx = moe_forward(p["moe"], h, cfg)
        return constrain_activations(x + f), (probs, idx)
    return constrain_activations(x + apply_ffn(p["ffn"], h, cfg)), None


def apply_block(p: Dict, x: torch.Tensor, positions, cfg: ModelConfig, *,
                moe_layer: bool = False, cache: Optional[Dict] = None,
                pos0=0) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """-> (block output, an MoE layer's routing or None)."""
    h = apply_norm(p["ln_attn"], x, cfg)
    x = constrain_activations(
        x + _self_attention(p["attn"], h, positions, cfg, cache, pos0))
    return _ffn_residual(p, x, cfg, moe_layer)


def _block_with_aux(p: Dict, x: torch.Tensor, positions, cfg: ModelConfig,
                 moe_layer: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """A block of the forward pass and its MoE load-balancing aux loss
    (0 for a dense FFN), computed inside the block so that it passes
    through a checkpointed call."""
    x, routing = apply_block(p, x, positions, cfg, moe_layer=moe_layer)
    if routing is None:
        return x, torch.zeros((), dtype=F32, device=x.device)
    return x, load_balance_loss(*routing, cfg.moe.n_experts)


def _paged_self_attention(p: Dict, x: torch.Tensor, positions, cfg,
                          leaf: Dict, tables, lengths, writes, *,
                          kernel_cfg) -> torch.Tensor:
    """Single-token decode attention straight off one layer's page-pool
    leaf: write the fresh K/V into their (physical page, offset) homes,
    then run the length-masked paged-attention kernel over the pool.  No
    dense gather ever materializes.  ``writes`` = (live, phys, offs) of
    every row: an inactive row (``live`` false) writes zeros into offset
    0 of the null page, which so stays zero."""
    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_decode
    q, k, v = qkv_project(p, x, cfg, positions)        # k/v: (B, HK, 1, hd)
    live, phys, off = writes
    for name, new in (("k", k), ("v", v)):
        leaf[name][phys, :, off] = new[:, :, 0, :].masked_fill(
            ~live, 0).to(leaf[name].dtype)
    # kernel_cfg was verified by the engine once for this batch geometry
    # (serve/engine.py); no per-layer gate call
    o = paged_decode(q, leaf["k"], leaf["v"], tables, lengths,
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
    """Decoder-only LM (families: dense, moe, vlm)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        m = cfg.moe
        self.n_dense_front = m.first_dense_layers if m else 0
        self.n_scanned = cfg.n_layers - self.n_dense_front
        self.is_moe = m is not None
        self.specs: Dict = {"embed": embed_specs(cfg)}
        for i in range(self.n_dense_front):
            self.specs[f"front_{i}"] = block_specs(cfg)
        self.specs["blocks"] = stack_specs(
            block_specs(cfg, moe_layer=self.is_moe), self.n_scanned)
        self.specs["ln_f"] = norm_specs(cfg)
        self.n_params = param_count(self.specs)
        self.n_active_params = self._active_params()

    def _active_params(self) -> int:
        cfg = self.cfg
        m = cfg.moe
        if m is None:
            return self.n_params
        per_expert = param_count(moe_specs(cfg)) - param_count(
            {"r": ParamSpec((cfg.d_model, m.n_experts), F32)})
        shared = (param_count(ffn_specs(cfg, m.n_shared * m.d_ff_expert))
                  if m.n_shared else 0)
        routed_all = per_expert - shared
        routed_active = routed_all * m.top_k // m.n_experts
        inactive = (routed_all - routed_active) * self.n_scanned
        return self.n_params - inactive

    def _layers(self, tree: Dict):
        """(layer i's slice of ``tree``, whether layer i is an MoE layer)
        for every layer in order: the dense front layers, then the
        stacked blocks.  ``tree`` is the parameters, a cache or a pool."""
        for i in range(self.n_dense_front):
            yield tree[f"front_{i}"], False
        for i in range(self.n_scanned):
            yield layer_slice(tree["blocks"], i), self.is_moe

    def _blocks(self, params: Dict, x: torch.Tensor, fn,
                state: Optional[Dict] = None) -> torch.Tensor:
        """Run ``fn(layer index, layer params, x, moe_layer, layer
        state)`` over the layers; ``state`` is a cache or pool tree
        (None: no state)."""
        layers = self._layers(state) if state is not None else None
        for i, (p, moe_layer) in enumerate(self._layers(params)):
            x = fn(i, p, x, moe_layer,
                   next(layers)[0] if layers is not None else None)
        return x

    def _head(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        with _obs.span("model.head"):
            x = apply_norm(params["ln_f"], x, self.cfg)
            return unembed(params["embed"], x, self.cfg)

    def _served_block(self, attend, i: int, p: Dict, x: torch.Tensor,
                      moe_layer: bool, leaf: Dict) -> torch.Tensor:
        """Layer ``i`` of a paged serving call (a :meth:`_blocks` step):
        ``x + attend(attention params, norm(x), pool leaf)`` as the span
        ``model.attn``, then the FFN residual as ``model.ffn`` /
        ``model.moe``."""
        with _obs.span("model.attn") as sp:
            if _obs.enabled():
                sp.set(layer=i)
            x = x + attend(p["attn"], apply_norm(p["ln_attn"], x, self.cfg),
                           leaf)
        with _obs.span("model.moe" if moe_layer else "model.ffn") as sp:
            if _obs.enabled():
                sp.set(layer=i)
            return _ffn_residual(p, x, self.cfg, moe_layer)[0]

    # -- forward -------------------------------------------------------------
    def apply(self, params: Dict, tokens: Optional[torch.Tensor] = None, *,
              inputs_embeds: Optional[torch.Tensor] = None,
              positions: Optional[torch.Tensor] = None,
              remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (logits (B,S,V) f32, the MoE layers' summed aux loss (0 for
        the dense family)).  ``inputs_embeds`` (B, S, D) in the model's
        type stands in for the embedded ``tokens``; ``positions`` (S,)
        or (B, S) default to ``arange(S)``.  ``remat``: each layer is
        recomputed in the backward pass (:func:`remat_call`)."""
        cfg = self.cfg
        x = (embed(params["embed"], tokens, cfg)
             if inputs_embeds is None else inputs_embeds)
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        aux_total = torch.zeros((), dtype=F32, device=x.device)
        layers = [(params[f"front_{i}"], False)
                  for i in range(self.n_dense_front)]
        layers += [(p, self.is_moe)
                   for p in unstack(params["blocks"], self.n_scanned)]
        for p, moe_layer in layers:
            x = constrain_activations(x)
            x, aux = remat_call(remat, _block_with_aux, p, x, positions, cfg,
                                moe_layer)
            aux_total = aux_total + aux
        return self._head(params, x), aux_total

    # -- serving -------------------------------------------------------------
    def cache_shape(self, batch: int, max_len: int) -> Dict:
        shp = (attn_mod.mla_cache_shape(self.cfg, batch, max_len)
               if self.cfg.attn_type == "mla"
               else attn_mod.gqa_cache_shape(self.cfg, batch, max_len))
        dt = dtype_of(self.cfg.dtype)
        out: Dict = {f"front_{i}": {k: ShapeDtype(v, dt)
                                    for k, v in shp.items()}
                     for i in range(self.n_dense_front)}
        out["blocks"] = {k: ShapeDtype((self.n_scanned,) + v, dt)
                         for k, v in shp.items()}
        return out

    def cache_axes(self) -> Dict:
        if self.cfg.attn_type == "mla":
            ax = {"c_kv": ("batch", "kv_seq", "kv_lora"),
                  "k_rope": ("batch", "kv_seq", None)}
        else:
            gqa = ("batch", "kv_heads", "kv_seq", "head_dim")
            ax = {"k": gqa, "v": gqa}
        out: Dict = {f"front_{i}": dict(ax)
                     for i in range(self.n_dense_front)}
        out["blocks"] = {k: ("layers",) + v for k, v in ax.items()}
        return out

    def init_cache(self, batch: int, max_len: int,
                   device: DeviceLike = "cuda", like=None) -> Dict:
        return zero_cache(self.cache_shape(batch, max_len), device,
                          self.cache_axes(), like)

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
        pos_t = torch.as_tensor(pos, device=x.device)
        positions = (pos_t[:, None] + offs if pos_t.ndim == 1
                     else (pos_t + offs).expand(B, S))
        # the write offset as given: an int stays one (cache_update)
        x = self._blocks(params, x, lambda _, p, x, moe_layer, c: apply_block(
            p, x, positions, cfg, moe_layer=moe_layer, cache=c,
            pos0=pos)[0], cache)
        return self._head(params, x), cache

    def decode_step_paged(self, params: Dict, pool: Dict,
                          tables: torch.Tensor, tokens: torch.Tensor,
                          pos: torch.Tensor, lengths: torch.Tensor, *,
                          kernel_cfg=None, graph=None
                          ) -> Tuple[torch.Tensor, Dict]:
        """Single-token decode straight off the page pool: no dense
        gather.  ``pool`` is the :class:`repro_torch.serve.pool.KVPool`
        storage tree, ``tables`` the (B, NP) int32 block tables, ``pos``
        the (B,) write positions and ``lengths`` the (B,) int32 logical
        lengths *including* the token being written (0 for inactive
        rows — they read nothing, and write zeros into the null page
        only).  Returns (logits (B, 1, V), pool updated in place).  GQA
        caches only: an MLA cache has no heads axis and stays on the
        gather path.

        ``graph``, a :class:`~repro_torch.models.decode_graph.DecodeGraph`,
        replays the call as one CUDA graph on CUDA tensors (captured on
        its first call and again whenever the geometry, the pool, the
        parameters or ``kernel_cfg`` change); None, or CPU tensors, run
        it eagerly.  Both run the same body, with no host sync inside."""
        if self.cfg.attn_type == "mla":
            raise ValueError("paged kernel decode requires a GQA cache")
        with _obs.span("model.decode") as sp:
            inputs = (tables, tokens, pos, lengths)
            if graph is None or not tables.is_cuda:
                mode = "eager"
                logits = self._decode_paged(params, pool, *inputs,
                                            kernel_cfg=kernel_cfg)
            else:
                logits, mode = graph(self._decode_paged, params, pool,
                                     inputs, kernel_cfg)
            if _obs.enabled():
                sp.set(graph=mode)
        return logits, pool

    def _decode_paged(self, params: Dict, pool: Dict, tables, tokens, pos,
                      lengths, *, kernel_cfg) -> torch.Tensor:
        """The body of :meth:`decode_step_paged`: its logits."""
        cfg = self.cfg
        with _obs.span("model.embed"):
            x = embed(params["embed"], tokens, cfg)
        PS = self._page_size(pool)
        # every row writes, at a place its own tensors give: an inactive
        # row at offset 0 of the null page (the JAX package redirects it
        # past the pool and lets mode="drop" discard it)
        positions = pos.to(torch.int64)[:, None]
        live = lengths > 0
        at = positions[:, 0] * live
        rows = torch.arange(tables.shape[0], device=tables.device)
        phys = tables[rows, at // PS].long() * live
        writes = (live[:, None, None], phys, at % PS)

        def attend(p, h, leaf):
            return _paged_self_attention(p, h, positions, cfg, leaf,
                                         tables, lengths, writes,
                                         kernel_cfg=kernel_cfg)
        x = self._blocks(params, x, partial(self._served_block, attend),
                         pool)
        return self._head(params, x)

    def _page_size(self, pool: Dict) -> int:
        leaf = next(self._layers(pool))[0]["k"]    # (P, Hkv, PS, hd)
        return leaf.shape[2]

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
        Returns (logits (1, TQ, V), pool updated in place).  GQA caches
        only, as ``decode_step_paged``."""
        cfg = self.cfg
        if cfg.attn_type == "mla":
            raise ValueError("packed kernel prefill requires a GQA cache")
        with _obs.span("model.prefill"):
            with _obs.span("model.embed"):
                x = embed(params["embed"], tokens, cfg)
            positions = torch.clamp(pos_q, min=0)[None, :]
            P, _, PS, _ = next(self._layers(pool))[0]["k"].shape
            keep = ((write_phys >= 0) & (write_phys < P)
                    & (write_offs >= 0) & (write_offs < PS))
            idx = torch.nonzero(keep).squeeze(1)
            writes = (idx, write_phys[idx].long(), write_offs[idx].long())
            meta = (seg_q, pos_q, seg_k, pos_k, gather_phys.long(),
                    gather_offs.long())

            def attend(p, h, leaf):
                return _packed_prefill_attention(p, h, positions, cfg, leaf,
                                                 meta, writes,
                                                 kernel_cfg=kernel_cfg)
            x = self._blocks(params, x, partial(self._served_block, attend),
                             pool)
            logits = self._head(params, x)
        return logits, pool

    def prefill(self, params: Dict, tokens: torch.Tensor, max_len: int
                ) -> Tuple[torch.Tensor, Dict]:
        """Run the prompt, building a fresh cache on the tokens' device.
        tokens: (B, S).  Returns (last-position logits (B, 1, V), cache)."""
        cfg = self.cfg
        B, S = tokens.shape
        cache = self.init_cache(B, max_len, device=tokens.device,
                                like=tokens)
        x = embed(params["embed"], tokens, cfg)
        positions = torch.arange(S, device=x.device)
        x = self._blocks(params, x, lambda _, p, x, moe_layer, c: apply_block(
            p, x, positions, cfg, moe_layer=moe_layer, cache=c,
            pos0=0)[0], cache)
        # last-position logits only: full-sequence logits are (B, S, V)
        return self._head(params, x[:, -1:]), cache

    # -- params ---------------------------------------------------------------
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
        """The JAX package's layer-scan trip count (the dry-run records
        it; the port's eager loop runs every layer, so nothing is scaled
        by it)."""
        return max(self.n_scanned, 1)
