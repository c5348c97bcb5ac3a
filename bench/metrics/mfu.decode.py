"""The whole step's share of the chip's peak, in %: the least time the
ticks' needed work takes (bench/roofline.py) over their wall time."""
from bench.readers import mfu as read  # noqa: F401
