from .decode import KERNEL as DECODE_KERNEL
from .flash_attention import KERNEL
from .ops import InvariantViolation, default_config, mha, mha_decode
from .ref import flash_error, mha_ref

__all__ = ["mha", "mha_decode", "mha_ref", "flash_error", "default_config",
           "InvariantViolation", "KERNEL", "DECODE_KERNEL"]
