"""stablelm-3b  [dense]  — partial rotary (25%), LayerNorm
[hf:stabilityai/stablelm-*; unverified]

A copy of the JAX package's ``configs/stablelm_3b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=6912, vocab=50304,
    norm_type="layernorm", rope_frac=0.25,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256,
        norm_type="layernorm", rope_frac=0.25,
    )
