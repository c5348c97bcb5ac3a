"""Observability: spans, mergeable histograms, Prometheus/Perfetto
export — stdlib-only copies of the JAX package's ``repro.obs``.

A global tracer whose ``span()`` is a true no-op when disabled and,
while enabled, also a ``torch.profiler`` range under a recording
profiler (:mod:`.tracer`), fixed-bucket log2 histograms whose merge is
element-wise add (:mod:`.hist`), and text/HTTP exposition
(:mod:`.export`).  Consumed by the serving engines and the launcher.
"""
from .hist import LogHistogram, bucket_index, bucket_upper
from .tracer import (TickClock, Tracer, disable, enable, enabled, span,
                     tracer, well_nested)

__all__ = ["LogHistogram", "bucket_index", "bucket_upper", "TickClock",
           "Tracer", "disable", "enable", "enabled", "span", "tracer",
           "well_nested"]
