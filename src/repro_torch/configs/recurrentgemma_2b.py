"""recurrentgemma-2b  [hybrid]  — RG-LRU + local attention, 1:2 pattern
[arXiv:2402.19427; hf].

26L d_model=2560, 10 query heads and 1 KV head of 256, d_ff 7680 (GeGLU),
vocab 256000, RG-LRU width 2560, a 2048-token local-attention window,
(rec, rec, attn) groups.  A copy of the JAX package's
``configs/recurrentgemma_2b.py``."""
from repro_torch.models.config import ModelConfig, RecurrentSpec

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    head_dim=256, d_ff=7680, vocab=256000,
    ffn_type="geglu", tie_embeddings=True, scale_embed=True,
    recurrent=RecurrentSpec(lru_width=2560, conv_width=4, window=2048,
                            pattern=("rec", "rec", "attn")),
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=1,
        head_dim=16, d_ff=128, vocab=256,
        ffn_type="geglu", tie_embeddings=True, scale_embed=True,
        recurrent=RecurrentSpec(lru_width=64, conv_width=4, window=32,
                                pattern=("rec", "rec", "attn")),
    )
