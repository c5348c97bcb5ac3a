"""codeqwen1.5-7b  [dense]  — qwen1.5 arch (qkv bias)  [hf:Qwen/CodeQwen1.5-7B]

A copy of the JAX package's ``configs/codeqwen1_5_7b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=13440, vocab=92416,
    qkv_bias=True, rope_theta=1e6,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256,
        qkv_bias=True, rope_theta=1e6,
    )
