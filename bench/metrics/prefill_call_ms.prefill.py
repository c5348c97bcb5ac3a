"""Host time in prefill_chunk_packed, mean over the window's ticks that
made the call: the engine's ``prefill_model_us``.  It holds the call's
eager launches and every wait for the device inside the call (the
nonzero of the rows that write, the MoE's data-dependent dispatch), and
in a traced run the wrapper's synchronise after the call as well."""
from bench.readers import _ticks


def read(run):
    calls = [t["prefill_model_us"] for t in _ticks(run)
             if t.get("kernel_prefill_ticks") and "prefill_model_us" in t]
    return sum(calls) / len(calls) / 1e3 if calls else None
