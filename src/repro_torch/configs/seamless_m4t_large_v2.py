"""seamless-m4t-large-v2  [audio]  — enc-dec backbone  [arXiv:2308.11596; hf]

24 encoder + 24 decoder layers (the text-to-text path of the large-v2
release), d_model=1024, 16 heads, d_ff=8192 (GELU), vocab=256206.
Backbone only: the speech frontend is a stub — the encoder takes
precomputed frame embeddings (B, S, d_model).  A copy of the JAX
package's ``configs/seamless_m4t_large_v2.py``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206,
    ffn_type="gelu", frontend="audio_frames",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2-smoke", family="audio",
        n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256,
        ffn_type="gelu", frontend="audio_frames",
    )
