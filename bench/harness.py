"""One run of one cell: set-up, the measured window, the check.

The entry that the window drives is the port's
``PagedServingEngine.step()`` on both kernel paths.  Set-up builds the
kernels that the configuration's family names, draws the weights,
fills the batch from the cell's traffic and runs it until every row has
prefilled; then the window runs ``engine.step()`` for ``seconds``, the
queue kept topped up from the traffic so that it never empties.

With ``trace`` the run also records, from the benchmark's own wrappers
around the model's two calls and the gate's ``verify``, each tick's
host time in them, the wait for its tokens and the work its calls were
given, and profiles a bounded stretch of ticks (:func:`_profile`).
Without it nothing wraps the engine: each tick is timed from outside,
and a token's time is the end of the tick that produced it (each tick
ends in a device-to-host read of its tokens).

Once the window has closed and the peak memory is read, the engine's
pool is freed and a sample of the requests finished in the window is
held to the family's plain reference (:mod:`bench.check`).
"""
from __future__ import annotations

import gc
import importlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bench import check, spec, weights
from bench.traffic import Traffic

FILL_MAX_TICKS = 1000
PROFILE_ATTEMPTS = 3
# the profiler's device span of a stretch against the same stretch
# between CUDA events: a stretch outside these is taken again
CLOCK_BOUNDS = (0.97, 1.03)


class Run:
    """What a run recorded; the metric readers read it."""

    def __init__(self, cell: spec.Cell, shape, trace: bool):
        self.cell = cell
        self.shape = shape            # the family's shape(model)
        self.trace = trace
        self.setup_s = 0.0
        self.build_s = 0.0
        self.window_s = 0.0
        self.ticks: List[Dict] = []
        self.token_times: Dict[int, List[float]] = {}
        self.window_open = 0.0
        self.profile: Optional[Dict] = None
        self.memory_peak_bytes = 0


# -- the program ----------------------------------------------------------------

def _engine(model, params, mix: Dict, device):
    from repro_torch.serve import KVPool, PagedServingEngine
    e = mix["engine"]
    token_bytes = KVPool.dense_reserved_bytes(model, 1, e["page_size"]) \
        // e["page_size"]
    pool_pages = int(float(e["pool_gib"]) * 2**30
                     // (token_bytes * e["page_size"]))
    return PagedServingEngine(
        model, params, pool_pages=pool_pages, page_size=e["page_size"],
        max_batch=e["max_batch"], max_len=e["max_len"],
        prefill_chunk=e["prefill_chunk"], eos_id=-1, decode_path="kernel",
        prefill_path="kernel", device=device)


class _Feed:
    """The cell's backlog into the engine's queue: the first batch at
    once, then enough to keep the queue ``depth`` deep."""

    def __init__(self, engine, traffic: Traffic, depth: int):
        from repro_torch.serve import Request
        self.engine = engine
        self.stream = traffic.stream()
        self.depth = depth
        self.first_batch = traffic.first_batch
        self.next = next(self.stream)
        self._request = Request

    def top_up(self) -> None:
        while (self.next.rid < self.first_batch
               or len(self.engine.queue) < self.depth):
            a = self.next
            self.engine.submit(self._request(a.rid, a.prompt,
                                             max_new_tokens=a.max_new_tokens))
            self.next = next(self.stream)


class _Tokens:
    """Each request's token times (the end of each tick that produced
    one, once per token) and the engine row it last decoded in."""

    def __init__(self, engine, times: Dict[int, List[float]]):
        self.engine = engine
        self.times = times
        self.rows: Dict[int, int] = {}
        self.seen: Dict[int, int] = {}
        self.n_finished = 0

    def record(self, t: float) -> int:
        for i, s in enumerate(self.engine.rows):
            if s is not None:
                self.rows[s.req.rid] = i
        reqs = [s.req for s in self.engine.active]
        reqs += self.engine.finished[self.n_finished:]
        self.n_finished = len(self.engine.finished)
        new = 0
        for r in reqs:
            n = len(r.output) - self.seen.get(r.rid, 0)
            if n > 0:
                self.times.setdefault(r.rid, []).extend([t] * n)
                self.seen[r.rid] = len(r.output)
                new += n
        return new


# -- spans of the traced run ------------------------------------------------------

class _Spans:
    """The traced run's wrappers: the model's two serving calls (host
    time in the call, then the wait for its tokens, and the work it was
    given) and the gate's ``verify``; each tick's record is ``tick``."""

    def __init__(self, model, sync):
        from repro_torch.core.verify_engine import default_engine
        self.model = model
        self.gate = default_engine()
        self.sync = sync
        self.tick: Optional[Dict] = None
        self._real = (model.decode_step_paged, model.prefill_chunk_packed,
                      self.gate.verify)
        model.decode_step_paged = self._decode
        model.prefill_chunk_packed = self._prefill
        self.gate.verify = self._verify

    def close(self) -> None:
        del self.model.decode_step_paged, self.model.prefill_chunk_packed
        del self.gate.verify

    def _call(self, kind: str, fn, args, kwargs):
        rec = self.tick
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench.model.{kind}"):
            out = fn(*args, **kwargs)
        t1 = time.perf_counter()
        with torch.profiler.record_function("bench.wait"):
            self.sync()
        t2 = time.perf_counter()
        if rec is not None:
            rec["model"].append((kind, t1 - t0, t2 - t1))
        return out

    def _decode(self, *args, **kwargs):
        if self.tick is not None:
            t0 = time.perf_counter()
            lengths = args[5].cpu().numpy()
            self.tick["decode_lengths"] = [int(x) for x in lengths if x > 0]
            self.tick["instr_s"] += time.perf_counter() - t0
        return self._call("decode", self._real[0], args, kwargs)

    def _prefill(self, *args, **kwargs):
        if self.tick is not None:
            t0 = time.perf_counter()
            seg, pos = args[3].cpu().numpy(), args[4].cpu().numpy()
            self.tick["prefill_spans"] = [
                (int(pos[seg == j].min()), int((seg == j).sum()))
                for j in np.unique(seg[seg >= 0])]
            self.tick["instr_s"] += time.perf_counter() - t0
        return self._call("prefill", self._real[1], args, kwargs)

    def _verify(self, *args, **kwargs):
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.gate"):
            out = self._real[2](*args, **kwargs)
        if self.tick is not None:
            self.tick["gate_s"] += time.perf_counter() - t0
        return out


def _new_tick(t0: float) -> Dict:
    return dict(t0=t0, t1=t0, model=[], gate_s=0.0, instr_s=0.0,
                decode_lengths=[], prefill_spans=[], profiled=False)


# -- the window --------------------------------------------------------------------

def _step(engine, feed, tokens, spans, counters_before):
    feed.top_up()
    rec = _new_tick(time.perf_counter())
    if spans is not None:
        spans.tick = rec
    engine.step()
    rec["t1"] = time.perf_counter()
    if spans is not None:
        spans.tick = None
    c = engine.metrics.counters
    rec.update({k: c[k] - counters_before[k] for k in c})
    counters_before.update(c)
    rec["tokens"] = tokens.record(rec["t1"])
    return rec


def _profile(engine, feed, tokens, spans, run, counters, n_ticks: int,
             device) -> Dict:
    """Profile ``n_ticks`` ticks under ``torch.profiler``, the profiler's
    kept launches of the two serving kernels held to their launch
    counters and its device span to CUDA events; a stretch that fails
    either is taken again, at most ``PROFILE_ATTEMPTS`` times.  Returns
    the last stretch taken; its ``kept`` says whether it passed."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import paged_attention, ragged_prefill
    kernels = {"paged_decode": paged_attention.KERNEL,
               "ragged_prefill": ragged_prefill.KERNEL}
    scratch = torch.zeros(1, device=device)
    for attempt in range(PROFILE_ATTEMPTS):
        before = {k: v.launches for k, v in kernels.items()}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        recs = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):         # the profiler drops a window's
                scratch.add_(1)        # first kernels
            torch.cuda.synchronize()
            with torch.profiler.record_function("bench.stretch"):
                t0 = time.perf_counter()
                ev[0].record()
                scratch.add_(1)
                for _ in range(n_ticks):
                    rec = _step(engine, feed, tokens, spans, counters)
                    rec["profiled"] = True
                    recs.append(rec)
                scratch.add_(1)
                ev[1].record()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
        run.ticks.extend(recs)
        launches = {k: v.launches - before[k] for k, v in kernels.items()}
        out = _read_profile(prof, t1 - t0, ev[0].elapsed_time(ev[1]) / 1e3,
                            launches, len(recs))
        out["attempt"] = attempt + 1
        if out["kept"]:
            break
    return out


def _read_profile(prof, wall_s, cuda_s, launches, n_ticks) -> Dict:
    events = list(prof.events())
    stretch = [e for e in events if e.name == "bench.stretch"]
    start = stretch[0].time_range.start if stretch else 0.0
    # device operations; a record_function range also shows on the
    # device's timeline, as a user annotation
    dev = sorted(((e.name, e.time_range.start, e.time_range.end)
                  for e in events
                  if "cuda" in str(getattr(e, "device_type", "")).lower()
                  and not getattr(e, "is_user_annotation", False)
                  and not e.name.startswith("bench.")
                  and e.time_range.start >= start), key=lambda e: e[1])
    host = [(e.name, e.time_range.start, e.time_range.end)
            for e in events if e.name.startswith("bench.")
            and e.name != "bench.stretch"]
    span_s = (dev[-1][2] - dev[0][1]) / 1e6 if dev else 0.0
    clock = span_s / cuda_s if cuda_s > 0 else 0.0
    kept_launches = {
        "paged_decode": sum("paged_decode" in n or "decode_bf16_panel" in n
                            or "decode_f32_panel" in n for n, *_ in dev),
        "ragged_prefill": sum("ragged_" in n or "prefill_bf16_panel" in n
                              or "prefill_f32_panel" in n for n, *_ in dev),
    }
    kept = (bool(dev) and kept_launches == launches
            and CLOCK_BOUNDS[0] <= clock <= CLOCK_BOUNDS[1])
    return dict(kept=kept, device=dev, host=host, wall_s=wall_s,
                cuda_s=cuda_s, clock=clock, launches=launches,
                kept_launches=kept_launches, ticks=n_ticks)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process: Optional[float] = None,
             program_hook=None) -> Dict:
    """One run; returns the result line's fields.  ``program_hook``,
    called with the engine once set-up has built it, lets a test break
    the timed path underneath."""
    t_start = time.perf_counter() if t_process is None else t_process
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    from repro_torch.kernels import build_all
    from repro_torch.models import build
    cfg = spec.port_config(cell.config, cell.root)
    run = Run(cell, cell.family.shape(cell.config["model"]), trace)
    if on_card:
        t0 = time.perf_counter()
        build_all([importlib.import_module(k).KERNEL
                   for k in cell.family.KERNELS])
        run.build_s = time.perf_counter() - t0
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    model = build(cfg)
    params = weights.make(model.specs, seed, dev,
                          cell.config.get("init_std"))
    engine = _engine(model, params, cell.traffic, dev)
    if program_hook is not None:
        program_hook(engine)
    traffic = Traffic(cell.traffic, seed, cfg.vocab)
    feed = _Feed(engine, traffic, depth=engine.max_batch)
    tokens = _Tokens(engine, run.token_times)
    counters = dict(engine.metrics.counters)

    # set-up: fill the batch and run it until every request of the first
    # batch has prefilled (a later row may be prefilling: in a mix of
    # long prompts and short outputs some row always is)
    for _ in range(FILL_MAX_TICKS):
        _step(engine, feed, tokens, None, counters)
        first = [r for r in engine.queue + [s.req for s in engine.active]
                 if r.rid < engine.max_batch]
        if not any(not r.output for r in first):
            break
    else:
        raise RuntimeError("set-up did not prefill the first batch")
    # then the mix's warm-up ticks: completions and admissions reach
    # their steady interleaving, and the first geometries are verified
    for _ in range(int(cell.traffic.get("warmup_ticks", 0))):
        _step(engine, feed, tokens, None, counters)
    sync()

    spans = _Spans(model, sync) if trace else None
    n_profile = int(cell.traffic.get("profile_ticks", 4))
    run.window_open = t_open = time.perf_counter()
    run.setup_s = t_open - t_start
    n_finished_open = len(engine.finished)
    try:
        while time.perf_counter() - t_open < seconds:
            run.ticks.append(_step(engine, feed, tokens, spans, counters))
        if trace and on_card:
            # the window's last ticks: once the profiler has run, CUDA
            # launches stay slower for the rest of the process
            run.profile = _profile(engine, feed, tokens, spans, run,
                                   counters, n_profile, dev)
    finally:
        if spans is not None:
            spans.close()
    run.window_s = run.ticks[-1]["t1"] - t_open
    if on_card:
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    finished = engine.finished[n_finished_open:]
    rows = tokens.rows
    off_kernels = sum((t["decode_tokens"] > 0) - t["kernel_decode_ticks"]
                      + (t["prefill_tokens"] > 0) - t["kernel_prefill_ticks"]
                      for t in run.ticks)

    # the program's state goes before the reference runs
    del engine, feed, tokens, spans
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    result = check.judge(cell, params=params, finished=finished, rows=rows,
                         seed=seed, off_kernel_ticks=off_kernels)
    result.update(run=run, params=params)
    return result
