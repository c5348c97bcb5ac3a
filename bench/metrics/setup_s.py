"""Seconds from process start to the window's opening: loading, the
kernels' build where it runs, weights, the batch filled and prefilled."""
from bench.readers import setup_s as read  # noqa: F401
