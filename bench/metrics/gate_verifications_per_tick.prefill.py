"""Runs of the ARGUS gate on the serving path a tick (a memo miss of a
packed prefill, decode or gather geometry), mean over the window's
ticks: the engine's ``gate_verifications`` counter."""
from bench.readers import _ticks


def read(run):
    ticks = _ticks(run)
    if not ticks or "gate_verifications" not in ticks[0]:
        return None
    return sum(t["gate_verifications"] for t in ticks) / len(ticks)
