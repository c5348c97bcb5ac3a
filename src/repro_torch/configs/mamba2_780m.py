"""mamba2-780m  [ssm]  — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified].

48L d_model=1536, d_state 128, head_dim 64, expand 2 (48 heads), chunk
256, vocab 50280.  A copy of the JAX package's
``configs/mamba2_780m.py``."""
from repro_torch.models.config import ModelConfig, SSMSpec

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, tie_embeddings=True,
    ssm=SSMSpec(d_state=128, expand=2, head_dim=64, n_groups=1,
                conv_width=4, chunk=256),
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m-smoke", family="ssm",
        n_layers=3, d_model=64, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=256, tie_embeddings=True,
        ssm=SSMSpec(d_state=16, expand=2, head_dim=16, n_groups=1,
                    conv_width=4, chunk=16),
    )
