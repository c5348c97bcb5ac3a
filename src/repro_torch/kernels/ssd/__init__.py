from .ops import InvariantViolation, ssd
from .ref import ssd_error, ssd_ref
from .ssd import KERNEL, ssd_chunk_scan

__all__ = ["ssd", "ssd_ref", "ssd_error", "ssd_chunk_scan",
           "InvariantViolation", "KERNEL"]
