"""Unified model configuration covering all 10 assigned architectures.

A copy of the JAX package's ``models/config.py``: the dataclasses are
field-for-field the same, so a config converts by ``dataclasses.asdict``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0      # leading dense layers (DeepSeek style)
    dense_d_ff: int = 0              # d_ff of those dense layers
    router_aux_free: bool = False    # DeepSeek aux-loss-free bias balancing


@dataclass(frozen=True)
class MLASpec:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0             # 0 = dense q projection
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMSpec:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256


@dataclass(frozen=True)
class RecurrentSpec:
    lru_width: int = 0               # 0 = d_model
    conv_width: int = 4
    window: int = 2048               # local-attention window
    pattern: Tuple[str, ...] = ("rec", "rec", "attn")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 = d_model // n_heads
    # attention flavor
    attn_type: str = "gqa"           # gqa | mla
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_frac: float = 1.0           # partial rotary (stablelm: 0.25)
    rope_theta: float = 10000.0
    # norm / ffn flavor
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    ffn_type: str = "swiglu"         # swiglu | geglu | gelu
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    scale_embed: bool = False        # gemma: embed * sqrt(d_model)
    # sub-specs
    moe: Optional[MoESpec] = None
    mla: Optional[MLASpec] = None
    ssm: Optional[SSMSpec] = None
    recurrent: Optional[RecurrentSpec] = None
    # encoder-decoder
    enc_layers: int = 0              # >0 => enc-dec; n_layers = decoder depth
    # frontend stub (vlm/audio): inputs may be precomputed embeddings
    frontend: str = "none"           # none | audio_frames | vq_tokens
    # numerics
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a 128 multiple, as in the JAX package (the
        pad columns are masked out of the logits)."""
        return -(-self.vocab // 128) * 128
