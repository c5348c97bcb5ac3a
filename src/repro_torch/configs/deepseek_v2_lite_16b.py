"""deepseek-v2-lite-16b  [moe]  — MLA + DeepSeekMoE  [arXiv:2405.04434; hf]

27L d_model=2048 16H d_ff_expert=1408 vocab=102400, MoE 64 routed top-6 +
2 shared, MLA kv_lora=512 (64 routed experts, as V2-Lite; the full V2
has 160).

A copy of the JAX package's ``configs/deepseek_v2_lite_16b.py``.
"""
from repro_torch.models.config import MLASpec, ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab=102400,
    attn_type="mla",
    mla=MLASpec(kv_lora_rank=512, q_lora_rank=0, qk_nope_dim=128,
                qk_rope_dim=64, v_head_dim=128),
    moe=MoESpec(n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408,
                first_dense_layers=1, dense_d_ff=10944,
                router_aux_free=True),
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256,
        attn_type="mla",
        mla=MLASpec(kv_lora_rank=32, q_lora_rank=0, qk_nope_dim=16,
                    qk_rope_dim=8, v_head_dim=16),
        # capacity_factor 8: drop-free routing so decode-vs-full-forward
        # consistency is exact in smoke tests (capacity drops are batch-
        # context dependent by design in capacity MoE)
        moe=MoESpec(n_experts=4, top_k=2, n_shared=1, d_ff_expert=32,
                    first_dense_layers=1, dense_d_ff=128,
                    router_aux_free=True, capacity_factor=8.0),
    )
