"""granite-moe-3b-a800m  [moe]  [hf:ibm-granite/granite-3.0-*-base; hf]

32L d_model=1536 24H (GQA kv=8) d_ff_expert=512 vocab=49155, 40 experts
top-8.  A copy of the JAX package's ``configs/granite_moe_3b_a800m.py``
(which follows the model card's header, 40 experts top-8)."""
from repro_torch.models.config import ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab=49155, head_dim=64,
    tie_embeddings=True,
    moe=MoESpec(n_experts=40, top_k=8, n_shared=0, d_ff_expert=512),
)


def reduced() -> ModelConfig:
    # capacity_factor 8: no token is dropped at the reduced shapes, so a
    # packed prefill gives every token the same experts whichever tokens
    # share its chunk
    return ModelConfig(
        name="granite-moe-3b-a800m-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab=256, head_dim=16,
        tie_embeddings=True,
        moe=MoESpec(n_experts=4, top_k=2, n_shared=0, d_ff_expert=32,
                    capacity_factor=8.0),
    )
