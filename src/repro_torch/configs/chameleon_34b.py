"""chameleon-34b  [vlm]  — early-fusion, VQ image tokens, qk-norm
[arXiv:2405.09818; unverified].

Frontend stub: images enter as VQ token ids inside the shared 65536
vocab; the VQ-GAN tokenizer itself is out of scope, so the model takes
token ids covering both modalities.

A copy of the JAX package's ``configs/chameleon_34b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    head_dim=128, d_ff=22016, vocab=65536,
    qk_norm=True, frontend="vq_tokens",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        head_dim=8, d_ff=128, vocab=512,
        qk_norm=True, frontend="vq_tokens",
    )
