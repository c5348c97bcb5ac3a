"""Share of the profiled stretch with no operation on the device, in %."""
from bench.readers import device_idle as read  # noqa: F401
