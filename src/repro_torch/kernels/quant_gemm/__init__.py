from .ops import InvariantViolation, default_config, quant_matmul
from .quant_gemm import KERNEL, quant_gemm
from .ref import quant_error, quant_gemm_ref, quantize_per_group
from .ref import quant_gemm_ref as quant_matmul_ref

__all__ = ["quant_matmul", "quant_matmul_ref", "quant_gemm_ref", "quantize_per_group",
           "quant_error", "default_config", "InvariantViolation",
           "quant_gemm", "KERNEL"]
