from .config import ModelConfig
from .encdec import EncDecLM
from .hybrid import HybridLM
from .model import SSMLM, build
from .params import from_jax_numpy, init_params
from .transformer import TransformerLM

__all__ = ["ModelConfig", "build", "TransformerLM", "SSMLM", "HybridLM",
           "EncDecLM", "from_jax_numpy", "init_params"]
