from .config import ModelConfig
from .model import SSMLM, build
from .params import from_jax_numpy, init_params
from .transformer import TransformerLM

__all__ = ["ModelConfig", "build", "TransformerLM", "SSMLM",
           "from_jax_numpy", "init_params"]
