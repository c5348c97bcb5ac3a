"""Tokens generated in the window over its seconds (host clock)."""
from bench.readers import output_tokens_per_s as read  # noqa: F401
