"""paged_decode's share of its roofline in the profiled stretch, in %."""
from bench.readers import paged_decode_roofline as read  # noqa: F401
