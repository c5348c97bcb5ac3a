"""qwen3-1.7b  [dense]  — qk_norm, GQA  [hf:Qwen/Qwen3-*; hf]

A copy of the JAX package's ``configs/qwen3_1_7b.py``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    head_dim=128, d_ff=6144, vocab=151936,
    qk_norm=True, tie_embeddings=True, rope_theta=1e6,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=256,
        qk_norm=True, tie_embeddings=True, rope_theta=1e6,
    )
