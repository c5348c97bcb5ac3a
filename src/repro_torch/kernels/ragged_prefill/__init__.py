from .ops import default_config, ragged_prefill_attend, verified_config
from .packing import (PackingError, cu_seqlens, lengths_from_cu,
                      pack_ragged, positions_from_cu, ragged_metadata,
                      segment_ids_from_cu, unpack_ragged,
                      validate_packing)
from .ragged_prefill import KERNEL, RaggedPrefillConfig
from .ref import ragged_prefill_ref

__all__ = ["ragged_prefill_attend", "ragged_prefill_ref",
           "default_config", "verified_config",
           "PackingError", "cu_seqlens", "lengths_from_cu",
           "segment_ids_from_cu", "positions_from_cu", "ragged_metadata",
           "pack_ragged", "unpack_ragged", "validate_packing",
           "RaggedPrefillConfig", "KERNEL"]
