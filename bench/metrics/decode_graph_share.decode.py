"""Share of the window's kernel decode ticks whose decode call replayed
the engine's CUDA graph, in %: the engine's ``decode_graph_replays``
over its ``kernel_decode_ticks``."""
from bench.readers import _ticks


def read(run):
    ticks = _ticks(run)
    if not ticks or "decode_graph_replays" not in ticks[0]:
        return None
    n = sum(t["kernel_decode_ticks"] for t in ticks)
    return 100.0 * sum(t["decode_graph_replays"] for t in ticks) / n \
        if n else None
