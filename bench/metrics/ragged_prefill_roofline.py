"""ragged_prefill's share of its roofline in the profiled stretch, in %."""
from bench.readers import ragged_prefill_roofline as read  # noqa: F401
