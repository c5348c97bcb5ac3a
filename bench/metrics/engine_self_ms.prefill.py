"""The serving engine's own host time a tick (serve/engine.py, pool.py):
its wall time less the model's calls, the wait for their tokens and
the gate, mean over the window's ticks."""
from bench.readers import engine_self_ms as read  # noqa: F401
