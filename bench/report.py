"""The result line of a run, and its numbers compared beside their
limits."""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from bench import spec
from bench.readers import busy_s

TOP = 10


def metrics(cell: spec.Cell, run, trace: bool) -> Dict:
    """The cell's end-to-end metrics (``trace`` off) or per-layer ones
    (on), each read by its reader; a metric with nothing to read is left
    out."""
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(cell.root, m["name"])(run)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def device(cell: spec.Cell, run, trace: bool, dev: torch.device) -> Dict:
    d = {"platform": "gpu" if dev.type == "cuda" else dev.type,
         "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                  else "cpu"),
         "count": cell.chips, "memory_peak_bytes": run.memory_peak_bytes}
    if trace and run.profile is not None:
        d["busy_s"] = busy_s(run.profile)
        d["window_s"] = run.profile["wall_s"]
    return d


def _label(name: str) -> str:
    return name[len("bench."):] if name.startswith("bench.") else name


def breakdown(profile: Dict) -> Dict:
    """The device operations that took most time in the profiled
    stretch, and its idle time by what the host was doing then (the
    benchmark's span the gap falls in, else the engine's own code)."""
    by_op: Dict[str, float] = {}
    for n, s, e in profile["device"]:
        by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e6
    gaps: Dict[str, float] = {}
    end = None
    for _, s, e in sorted(profile["device"], key=lambda x: x[1]):
        if end is not None and s > end:
            mid = (s + end) / 2
            who = [h for h in profile["host"] if h[1] <= mid <= h[2]]
            label = (_label(min(who, key=lambda h: h[2] - h[1])[0])
                     if who else "serve.engine")
            gaps[label] = gaps.get(label, 0.0) + (s - end) / 1e6
        end = e if end is None else max(end, e)
    top = lambda d: [[k[:120], v] for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(by_op), "idle_gaps": top(gaps)}


def window_fifths(run) -> Dict:
    """The window in fifths by time: ticks, mean tick ms, prompt and
    generated tokens, rows decoded a tick; a drift shows here."""
    out = {k: [0] * 5 for k in ("ticks", "tick_ms", "prompt_tokens",
                                "tokens", "decode_rows")}
    for t in run.ticks:
        i = min(4, int(5 * (t["t0"] - run.window_open) / run.window_s))
        out["ticks"][i] += 1
        out["tick_ms"][i] += (t["t1"] - t["t0"]) * 1e3
        out["prompt_tokens"][i] += t["prefill_tokens"]
        out["tokens"][i] += t["tokens"]
        out["decode_rows"][i] += t["decode_tokens"]
    for i, n in enumerate(out["ticks"]):
        if n:
            out["tick_ms"][i] /= n
            out["decode_rows"][i] /= n
    return out


def _num(v):
    return None if isinstance(v, float) and not math.isfinite(v) else v


def line(cell: spec.Cell, out: Dict, trace: bool, dev: torch.device
         ) -> Dict:
    run = out["run"]
    res = {"correct": out["correct"], "attempted": out["attempted"],
           "failed": out["failed"], "metrics": metrics(cell, run, trace),
           "device": device(cell, run, trace, dev)}
    if trace and run.profile is not None:
        res["breakdown"] = breakdown(run.profile)
        res["profile"] = {k: run.profile[k] for k in (
            "kept", "attempt", "ticks", "clock", "launches", "kept_launches")}
    res["build_s"] = run.build_s
    res["window"] = window_fifths(run)
    res["checks"] = {k: {kk: _num(vv) for kk, vv in c.items()}
                     for k, c in out["checks"].items()}
    return res


def check_lines(checks: Dict) -> List[str]:
    return [f"check {k}: {c['value']} (limit {c['rule']} {c['limit']})"
            for k, c in checks.items()]
