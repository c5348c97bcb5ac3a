"""Prompt tokens prefilled in the window over its seconds (host clock)."""
from bench.readers import prompt_tokens_per_s as read  # noqa: F401
