from .moe import KERNEL, compute_dispatch, grouped_ffn
from .ops import InvariantViolation, capacity_for, default_config, moe_ffn
from .ref import grouped_ffn_ref, moe_error, moe_ffn_ref

__all__ = ["moe_ffn", "moe_ffn_ref", "grouped_ffn", "grouped_ffn_ref",
           "moe_error", "compute_dispatch", "capacity_for",
           "default_config", "InvariantViolation", "KERNEL"]
