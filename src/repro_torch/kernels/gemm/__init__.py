from .gemm import KERNEL, gemm
from .ops import InvariantViolation, default_config, matmul
from .ref import matmul_ref

__all__ = ["matmul", "matmul_ref", "default_config", "InvariantViolation",
           "gemm", "KERNEL"]
