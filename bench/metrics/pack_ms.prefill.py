"""Host time a tick building the kernels' inputs and copying them to
the card (block tables, the packed prefill arrays, their concrete
checks), mean over the window's ticks: the engine's ``pack_us``."""
from bench.readers import _ticks


def read(run):
    ticks = _ticks(run)
    if not ticks or "pack_us" not in ticks[0]:
        return None
    return sum(t["pack_us"] for t in ticks) / len(ticks) / 1e3
