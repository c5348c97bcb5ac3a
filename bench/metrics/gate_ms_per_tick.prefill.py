"""Host time inside the gate's verify on the serving path, per tick
(each new packed prefill geometry is verified once)."""
from bench.readers import gate_ms_per_tick as read  # noqa: F401
