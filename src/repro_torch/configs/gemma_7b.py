"""gemma-7b  [dense]  — GeGLU, head_dim=256  [arXiv:2403.08295; hf]

A copy of the JAX package's ``configs/gemma_7b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16,
    head_dim=256, d_ff=24576, vocab=256000,
    ffn_type="geglu", tie_embeddings=True, scale_embed=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=32, d_ff=256, vocab=256,
        ffn_type="geglu", tie_embeddings=True, scale_embed=True,
    )
