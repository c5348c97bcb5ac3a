from .ops import (InvariantViolation, default_config, paged_decode,
                  paged_decode_pool, validate_block_tables)
from .paged_attention import KERNEL, PagedAttentionConfig
from .ref import gather_cache, paged_decode_ref

__all__ = ["paged_decode", "paged_decode_pool", "paged_decode_ref",
           "gather_cache", "default_config", "InvariantViolation",
           "validate_block_tables", "PagedAttentionConfig", "KERNEL"]
