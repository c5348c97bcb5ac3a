"""95th percentile of every gap between consecutive tokens of a request
in the window, each token timed at the end of the tick that read it."""
from bench.readers import tpot_p95_ms as read  # noqa: F401
