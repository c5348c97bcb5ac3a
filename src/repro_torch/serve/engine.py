"""Continuous-batching serving engines: dense slots and paged pool.

The port of the JAX package's ``serve/engine.py``.  Two engines share
one request model and one metrics contract:

:class:`ServingEngine` — the dense baseline.  A fixed decode batch of
``n_slots`` sequences, each reserving a dense ``max_len`` cache slab;
free slots refill from the queue via single-sequence one-shot prefill.
Kept as the oracle the paged engine must match token-for-token.  It
alone serves the SSM and hybrid families, whose caches (recurrent states
and fixed-size attention rings) a page pool cannot hold, as in the JAX
package.  Neither engine serves the encoder-decoder family: its prefill
takes frame embeddings, not a token prompt.

:class:`PagedServingEngine` — the production layout.  KV lives in a
shared block-table page pool (:mod:`repro_torch.serve.pool`): admission
is driven by pool headroom rather than slot reservation, prompts
prefill in fixed-size chunks interleaved with decode ticks, and pool
pressure preempts the most recently admitted other sequence back to the
queue (recompute-style resume: deterministic greedy decode makes the
continuation identical).

``decode_path="kernel"`` runs each decode tick through the CUDA
paged-attention kernel straight over the pool
(:meth:`~repro_torch.models.transformer.TransformerLM.decode_step_paged`)
— zero dense-view bytes (the ``gather_bytes`` counter stays at 0 on
decode ticks); on a CUDA device that call is captured once per batch
geometry as a CUDA graph and replayed on every tick
(:class:`~repro_torch.models.decode_graph.DecodeGraph`).  Per-sequence
``lengths`` are re-validated against each row's mapped page count every
kernel tick.  ``prefill_path="kernel"``
packs the tick's prompt chunks ragged and attends them through the
CUDA ragged-prefill kernel straight off the pool
(:meth:`~repro_torch.models.transformer.TransformerLM
.prefill_chunk_packed`).  Each batch geometry (decode) and packed
geometry (prefill) is verified once by the ARGUS gate, memoized as in
the JAX engine; between geometry changes only the concrete checks run.
When the model cannot be paged-attended or the gate rejects the
geometry, a tick falls back to the gather path (``decode_chunk`` over a
dense view), as in the JAX package; the
``kernel_decode_ticks`` / ``kernel_prefill_ticks`` counters say which
ticks did not.  A kernel that fails to build or launch raises: nothing
catches it.

Kernel configs come from the fleet tuner's ``dispatch_table.json``
(:mod:`repro_torch.core.tuning.dispatch`), as in the JAX engines: pass
``dispatch_table=`` (a path, a dict or a loaded table) and the engine
installs it process-wide, so every validated kernel entry point it
reaches resolves its config from the tuned table's shape buckets — at
the exact problem, verified — before the shape-adaptive default.  The
table is read where the engine already resolves a config once per
geometry (the decode batch geometry, each packed prefill geometry, the
gather path's gate).  The install is process-global, as in the JAX
package: one table per process, last install wins; without
``dispatch_table=`` an engine takes the table already installed, if
any.

Both engines decode greedily and take ``device=`` (default ``"cuda"``;
see :func:`repro_torch.device.resolve_device`); the model's parameters
must already live there.

Tracing (:mod:`repro_torch.obs`): the paged engine's tick is the span
``serve.tick`` over ``serve.admit``, ``serve.prefill_chunk`` and
``serve.decode_tick``; inside them ``serve.gate`` (a gate run on a memo
miss), ``serve.pack`` (a tick's kernel inputs built on the host and
copied) and ``serve.tokens`` (the device-to-host read of the tick's
tokens, the host's one wait for the device); the model's own spans
nest under those.  Each span is live only while the obs switch is on
(and a ``torch.profiler`` range too while a profiler records).  The
gate runs and the host time of the gate, the packing, the model's two
kernel-path calls (their launches and any wait for the device inside
them) and the token reads are counted always, in the metrics' v5
counters (:data:`repro_torch.serve.metrics.HOST_COUNTERS`),
from ``time.perf_counter`` (never the injectable clock, so the v4
fields stay a function of the call sequence under a ``TickClock``),
beside v6's replays and captures of the decode call's CUDA graph.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch.core.tuning import dispatch as _dispatch
from repro_torch.device import DeviceLike, device_of, resolve_device
from repro_torch.models.decode_graph import DecodeGraph
from repro_torch.models.params import leaf_paths

from .metrics import HOST_COUNTERS, ServingMetrics
from .pool import KVPool, PageAllocator, PoolExhausted, pages_needed


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 32
    output: List[int] = field(default_factory=list)
    done: bool = False
    error: Optional[str] = None
    trace_id: Optional[str] = None   # span correlation id (defaults rid)

    @property
    def trace_name(self) -> str:
        return self.trace_id or f"req-{self.rid}"


@dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0          # next write offset in the cache


def _engine_device(params, device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    have = device_of(params)
    if have is not None and have.type != dev.type:
        raise ValueError(f"parameters live on {have}, engine device is "
                         f"{dev}")
    return dev


def _refuse_encdec(model) -> None:
    """The engines prefill token prompts; an encoder-decoder model
    prefills from frame embeddings and returns a cache only, so neither
    engine serves it (the JAX package's engines fail on it too)."""
    if model.cfg.family in ("encdec", "audio"):
        raise NotImplementedError(
            f"{model.cfg.name}: the serving engines prefill token prompts, "
            "but EncDecLM.prefill takes the encoder's frame embeddings and "
            "returns a cache only, no logits")


def _argmax_rows(logits: torch.Tensor) -> List[int]:
    """Greedy token of each row of (N, V) logits, first index on ties
    (as ``jnp.argmax``); one device-to-host copy."""
    return torch.argmax(logits, dim=-1).tolist()


def _us_since(t0: float, now: Optional[float] = None) -> int:
    """Host microseconds from ``t0`` to ``now`` (``time.perf_counter``
    readings; ``now`` defaults to the present)."""
    return round(((time.perf_counter() if now is None else now) - t0) * 1e6)


def _stamps(tick: int) -> Dict[str, float]:
    """A request's latency stamps at submission: the tick, and the host
    second for the microsecond histograms."""
    now = time.perf_counter()
    return {"submit": tick, "queued": tick, "submit_s": now,
            "queued_s": now}


def _record_tpots(metrics: ServingMetrics, lats: List[Dict[str, float]],
                  tick: int, now: float) -> None:
    """A generated token at ``tick`` (host second ``now``) for each
    request of ``lats``: its gap to the request's previous token, in
    ticks and in microseconds.  Rows whose previous token came on one
    tick share a gap, which is recorded once for all of them."""
    gaps: Dict[Tuple[float, float], int] = {}
    for lat in lats:
        key = (lat.get("last", tick), lat.get("last_s", now))
        gaps[key] = gaps.get(key, 0) + 1
        lat["last"], lat["last_s"] = tick, now
    for (last, last_s), n in gaps.items():
        metrics.record_latency("tpot", tick - last, n)
        metrics.record_latency("tpot_us", _us_since(last_s, now), n)


class _Timed:
    """``with _Timed(host, key, name):`` runs the block as the span
    ``name`` and adds its host microseconds to ``host[key]``."""

    __slots__ = ("_host", "_key", "_span", "_t0")

    def __init__(self, host: Dict[str, int], key: str, name: str):
        self._host, self._key = host, key
        self._span = _obs.span(name)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self._span.__enter__()

    def __exit__(self, exc_type, exc, tb):
        self._span.__exit__(exc_type, exc, tb)
        self._host[self._key] += _us_since(self._t0)
        return False


def _read_tokens(host: Dict[str, int], logits: torch.Tensor) -> List[int]:
    """:func:`_argmax_rows` as the ``serve.tokens`` span, counted in
    ``token_wait_us``."""
    with _Timed(host, "token_wait_us", "serve.tokens"):
        return _argmax_rows(logits)


class ServingEngine:
    """Dense-slab slot engine (the paged engine's token oracle)."""

    def __init__(self, model, params, *, n_slots: int = 4,
                 max_len: int = 512, eos_id: int = 1,
                 dispatch_table=None, clock=None,
                 device: DeviceLike = "cuda"):
        _refuse_encdec(model)
        self.model = model
        self.params = params
        self.device = _engine_device(params, device)
        # tuned kernel configs: install the fleet dispatch table so the
        # validated kernel entry points consult it (process-wide)
        self.dispatch = (_dispatch.install(dispatch_table)
                         if dispatch_table is not None
                         else _dispatch.active())
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        # step-time clock (seconds): injectable so benchmarks can pass a
        # virtual TickClock and keep reports byte-identical
        self._clock = clock or time.perf_counter
        # rid -> tick stamps, and host-second stamps ("*_s") for the
        # microsecond latencies
        self._lat: Dict[int, Dict[str, float]] = {}
        self._host = dict.fromkeys(HOST_COUNTERS, 0)   # this tick's
        self.cache = model.init_cache(n_slots, max_len, device=self.device)
        self.slots = [_Slot() for _ in range(n_slots)]
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.metrics = ServingMetrics(capacity=n_slots, kind="dense")

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # -- API ---------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self._lat[req.rid] = _stamps(self.metrics.counters["ticks"])
        self.queue.append(req)

    def _insert_cache(self, slot: int, src_cache: Dict) -> None:
        """Copy a batch-1 prefill cache into slot ``slot``.  The batch
        axis position per leaf comes from the model's cache_axes(), a
        tree of any depth (the hybrid family's is three levels deep)."""
        for (_, ax), (_, dst), (_, src) in zip(
                leaf_paths(self.model.cache_axes()), leaf_paths(self.cache),
                leaf_paths(src_cache)):
            b = ax.index("batch")
            dst.select(b, slot).copy_(src.select(b, 0))

    def _admit(self) -> Dict[str, int]:
        admitted = prefill_tokens = 0
        tick = self.metrics.counters["ticks"]
        for i, s in enumerate(self.slots):
            if s.req is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            lat = self._lat.setdefault(req.rid, _stamps(tick))
            self.metrics.record_latency("queue_wait", tick - lat["queued"])
            self.metrics.record_latency(
                "queue_wait_us", _us_since(lat["queued_s"]))
            toks = self._t(np.asarray([req.prompt], np.int32))
            logits, cache1 = self.model.prefill(self.params, toks,
                                                self.max_len)
            self._insert_cache(i, cache1)
            nxt = _read_tokens(self._host, logits[:, -1])[0]
            req.output.append(nxt)
            s.req, s.pos = req, len(req.prompt)
            admitted += 1
            prefill_tokens += len(req.prompt)
            # one-shot prefill emits the first token at admission: both
            # queue-wait and TTFT resolve on this tick
            self.metrics.record_latency("ttft", tick - lat["submit"])
            now = time.perf_counter()
            self.metrics.record_latency(
                "ttft_us", _us_since(lat["submit_s"], now))
            lat["last"], lat["last_s"] = tick, now
        return {"admitted": admitted, "prefill_tokens": prefill_tokens}

    def step(self) -> int:
        """One engine tick: admit, decode, retire.  Returns #active."""
        t0 = self._clock()
        adm = self._admit()
        tick = self.metrics.counters["ticks"]
        active = [i for i, s in enumerate(self.slots) if s.req is not None]
        finished = 0
        if active:
            tokens = np.zeros((self.n_slots, 1), np.int32)
            pos_vec = np.zeros((self.n_slots,), np.int32)
            for i in active:
                tokens[i, 0] = self.slots[i].req.output[-1]
                pos_vec[i] = self.slots[i].pos
            logits, self.cache = self.model.decode_step(
                self.params, self.cache, self._t(tokens), self._t(pos_vec))
            nxt_all = _read_tokens(self._host, logits[:, -1])
            now = time.perf_counter()
            lats = []
            for i in active:
                s = self.slots[i]
                nxt = nxt_all[i]
                s.req.output.append(nxt)
                s.pos += 1
                lat = self._lat.get(s.req.rid)
                if lat is not None:
                    lats.append(lat)
                # retire once the final writable position (max_len-1) has
                # been used: s.pos is the *next* write offset
                exhausted = (len(s.req.output) >= s.req.max_new_tokens
                             or nxt == self.eos_id
                             or s.pos >= self.max_len)
                if exhausted:
                    s.req.done = True
                    self.finished.append(s.req)
                    self._lat.pop(s.req.rid, None)
                    s.req = None
                    finished += 1
            _record_tpots(self.metrics, lats, tick, now)
        occ = sum(1 for s in self.slots if s.req is not None)
        self.metrics.record_tick(
            queue_depth=len(self.queue), active=occ, occupancy=occ,
            decode_tokens=len(active), finished=finished,
            step_time_us=int((self._clock() - t0) * 1e6), **adm,
            **self._host)
        self._host = dict.fromkeys(HOST_COUNTERS, 0)
        return len(active)

    def run(self, max_ticks: int = 10_000) -> List[Request]:
        for _ in range(max_ticks):
            if not self.queue and all(s.req is None for s in self.slots):
                break
            self.step()
        return self.finished


# ---------------------------------------------------------------------------
# Paged engine
# ---------------------------------------------------------------------------

@dataclass
class _Seq:
    req: Request
    ctx: List[int]            # prompt (+ regenerated output on resume)
    pos: int = 0              # tokens whose KV is in the pool
    prefilled: bool = False
    admitted_at: int = 0      # admission stamp (preemption order)
    resumed: bool = False     # re-admitted after a preemption


class PagedServingEngine:
    """Paged continuous batching over a shared block-table KV pool.

    ``max_batch`` bounds the decode call's width; admission is governed
    by pool headroom: a request is admitted the moment the free list can
    hold its prompt plus one decode page.  ``max_len`` (logical
    positions per sequence) must be a multiple of ``page_size`` so the
    gathered view's kv length equals the dense engine's — that is what
    makes the two engines token-identical on the same trace.
    """

    def __init__(self, model, params, *, pool_pages: int,
                 page_size: int = 16, max_batch: int = 8,
                 max_len: int = 512, prefill_chunk: int = 32,
                 eos_id: int = 1, dispatch_table=None,
                 decode_path: str = "gather",
                 prefill_path: str = "gather",
                 clock=None, device: DeviceLike = "cuda"):
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} must be a multiple of "
                             f"page_size {page_size}")
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if decode_path not in ("gather", "kernel"):
            raise ValueError(f"decode_path must be 'gather' or 'kernel', "
                             f"got {decode_path!r}")
        if prefill_path not in ("gather", "kernel"):
            raise ValueError(f"prefill_path must be 'gather' or 'kernel', "
                             f"got {prefill_path!r}")
        _refuse_encdec(model)
        self.model = model
        self.params = params
        self.device = _engine_device(params, device)
        self.dispatch = (_dispatch.install(dispatch_table)
                         if dispatch_table is not None
                         else _dispatch.active())
        self.page_size = page_size
        self.max_batch = max_batch
        self.max_len = max_len
        self.pages_per_seq = max_len // page_size
        self.prefill_chunk = min(prefill_chunk, max_len)
        self.eos_id = eos_id
        self.alloc = PageAllocator(pool_pages, page_size)
        self.kv = KVPool(model, pool_pages, page_size, device=self.device)
        self.rows: List[Optional[_Seq]] = [None] * max_batch
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.metrics = ServingMetrics(capacity=self.alloc.usable_pages,
                                      kind="paged")
        self._chunk = getattr(model, "decode_chunk", None)
        self._clock = clock or time.perf_counter
        # rid -> tick stamps, and host-second stamps ("*_s") for the
        # microsecond latencies
        self._lat: Dict[int, Dict[str, float]] = {}
        self._host = dict.fromkeys(HOST_COUNTERS, 0)   # this tick's
        self._admission_stamp = 0
        # kernel decode path: config resolved per batch geometry; dense-
        # view bytes for the gather-path traffic accounting
        self.decode_path = decode_path
        self._kernel_sig = None
        self._kernel_cfg = None
        # the kernel decode call's CUDA graph, one per batch geometry
        self._decode_graph: Optional[DecodeGraph] = None
        # the gather path's gate: verified once per batch geometry
        self._table_sig = None
        # the pool's type: the paged kernel's step (what the gate
        # verifies) depends on it
        leaf = next((t for g in self.kv.storage.values()
                     for t in g.values()), None)
        self._pool_dtype = ("bf16" if leaf is not None
                            and leaf.dtype == torch.bfloat16 else "f32")
        self._view_bytes = KVPool.dense_reserved_bytes(
            model, max_batch, max_len)
        # kernel prefill path: config memoized per packed geometry; per-
        # token pool bytes for the packed-KV gather accounting
        self.prefill_path = prefill_path
        self._prefill_cfgs: Dict = {}
        self._token_bytes = KVPool.dense_reserved_bytes(
            model, 1, page_size) // page_size

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # -- API ---------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self._lat[req.rid] = _stamps(self.metrics.counters["ticks"])
        self.queue.append(req)

    @property
    def active(self) -> List[_Seq]:
        return [s for s in self.rows if s is not None]

    # -- admission ----------------------------------------------------------
    def _seq_id(self, s: _Seq) -> int:
        return s.admitted_at

    def _admit(self) -> Dict[str, int]:
        admitted = 0
        tick = self.metrics.counters["ticks"]
        while self.queue:
            req = self.queue[0]
            row = next((i for i, r in enumerate(self.rows) if r is None),
                       None)
            if row is None:
                break
            ctx = list(req.prompt) + list(req.output)
            need = pages_needed(len(ctx) + 1, self.page_size)
            if need > self.alloc.usable_pages or len(ctx) >= self.max_len:
                # can never fit: reject rather than wedge the queue
                self.queue.pop(0)
                req.done, req.error = True, "request exceeds pool capacity"
                self.finished.append(req)
                self._lat.pop(req.rid, None)
                continue
            if need > self.alloc.free_pages:
                break                      # headroom gate: wait for pages
            self._admission_stamp += 1
            seq = _Seq(req=req, ctx=ctx,
                       admitted_at=self._admission_stamp,
                       resumed=bool(req.output))
            self.queue.pop(0)
            self.alloc.ensure(self._seq_id(seq), len(ctx) + 1)
            self.rows[row] = seq
            admitted += 1
            lat = self._lat.setdefault(req.rid, _stamps(tick))
            wait = tick - lat.get("queued", tick)
            self.metrics.record_latency("queue_wait", wait)
            self.metrics.record_latency("queue_wait_us",
                                        _us_since(lat["queued_s"]))
            if _obs.enabled():
                with _obs.span("serve.admit_request") as sp:
                    sp.set(trace_id=req.trace_name, wait_ticks=wait,
                           resumed=seq.resumed)
        return {"admitted": admitted}

    # -- pool pressure -------------------------------------------------------
    def _preempt_for(self, seq: _Seq, n_tokens: int) -> int:
        """Grow seq's table to hold ``n_tokens``, evicting the most
        recently admitted *other* sequence back to the queue when the
        free list runs dry.  Returns the number of preemptions."""
        preempted = 0
        while True:
            try:
                self.alloc.ensure(self._seq_id(seq), n_tokens)
                return preempted
            except PoolExhausted:
                victims = [s for s in self.active
                           if s is not seq and not s.req.done]
                if not victims:
                    raise PoolExhausted(
                        f"rid {seq.req.rid} needs "
                        f"{pages_needed(n_tokens, self.page_size)} pages; "
                        "pool exhausted with nothing evictable")
                self._evict(max(victims, key=lambda s: s.admitted_at))
                preempted += 1

    def _evict(self, victim: _Seq) -> None:
        """Recompute-style preemption: drop the victim's pages and requeue
        it at the front; on re-admission its context is re-prefilled as
        prompt + generated-so-far, and greedy decode continues
        identically."""
        sp = _obs.span("serve.preempt")
        with sp:
            if _obs.enabled():
                sp.set(trace_id=victim.req.trace_name, pos=victim.pos)
            self.alloc.free_seq(self._seq_id(victim))
            self.rows[self.rows.index(victim)] = None
            self.queue.insert(0, victim.req)
        # queue-wait restarts at the eviction tick (TTFT keeps running)
        lat = self._lat.get(victim.req.rid)
        if lat is not None:
            lat["queued"] = self.metrics.counters["ticks"]
            lat["queued_s"] = time.perf_counter()

    # -- gather through the validated block tables ---------------------------
    def _tables(self) -> np.ndarray:
        t = np.zeros((self.max_batch, self.pages_per_seq), np.int32)
        for i, s in enumerate(self.rows):
            if s is not None:
                t[i] = self.alloc.table_row(self._seq_id(s),
                                            self.pages_per_seq)
        return t

    def _gate(self, path: str, geometry, verify, *args, **kwargs):
        """``verify(*args, **kwargs)``: a run of the ARGUS gate on a memo
        miss of the ``path`` geometry, as the span ``serve.gate``,
        counted in ``gate_verifications`` and ``gate_us``."""
        self._host["gate_verifications"] += 1
        with _Timed(self._host, "gate_us", "serve.gate") as sp:
            if _obs.enabled():
                sp.set(path=path, geometry=geometry)
            return verify(*args, **kwargs)

    def _gather(self) -> Dict:
        with _Timed(self._host, "pack_us", "serve.pack"):
            tables = self._tables()
        sig = (tables.shape, self.alloc.n_pages)
        if sig != self._table_sig:
            # ARGUS gate: verify the paged_attention family's indirection
            # invariants for this batch geometry (config resolved from the
            # installed dispatch table) before the gather consumes it
            from repro_torch.kernels.paged_attention.ops import \
                validate_block_tables
            self._gate("gather", sig, validate_block_tables,
                       tables, model=self.model, page_size=self.page_size,
                       pool_pages=self.alloc.n_pages, dtype=self._pool_dtype)
            self._table_sig = sig
        elif tables.min() < 0 or tables.max() >= self.alloc.n_pages:
            # geometry already verified: still range-check the concrete
            # mapping (the runtime mirror of assert_in_range)
            raise ValueError("block table maps outside the pool")
        with _Timed(self._host, "pack_us", "serve.pack"):
            tables = self._t(tables)
        return self.kv.gather(tables)

    # -- prefill -------------------------------------------------------------
    def _prefill_tick(self) -> Dict[str, int]:
        """Advance every un-prefilled sequence by one prompt chunk, all
        rows batched through a single call."""
        pend = [(i, s) for i, s in enumerate(self.rows)
                if s is not None and not s.prefilled]
        empty = {"prefill_tokens": 0, "preempted": 0, "finished": 0}
        if not pend:
            return empty
        C = self.prefill_chunk if self._chunk is not None else 1
        preempted = 0
        for i, s in pend:
            if self.rows[i] is not s:      # evicted by an earlier ensure
                continue
            n = min(C, len(s.ctx) - s.pos)
            preempted += self._preempt_for(s, s.pos + n)
        # a preemption may have evicted a sequence in `pend` — rebuild
        pend = [(i, s) for i, s in pend if self.rows[i] is s]
        if not pend:
            return dict(empty, preempted=preempted)
        lens = {i: min(C, len(s.ctx) - s.pos) for i, s in pend}
        gather_bytes = kernel_ticks = 0
        packed = (self._prefill_kernel(pend, lens)
                  if self.prefill_path == "kernel" else None)
        if packed is not None:
            row_logits, packed_kv_tokens = packed
            gather_bytes = packed_kv_tokens * self._token_bytes
            kernel_ticks = 1
        else:
            # dense decode_chunk path (default, and the fallback when
            # the packed geometry has no verified config)
            tokens = np.zeros((self.max_batch, C), np.int32)
            pos_vec = np.zeros((self.max_batch,), np.int32)
            for i, s in pend:
                tokens[i, :lens[i]] = s.ctx[s.pos:s.pos + lens[i]]
                pos_vec[i] = s.pos
            view = self._gather()
            fn = self._chunk or self.model.decode_step
            logits, view = fn(self.params, view, self._t(tokens),
                              self._t(pos_vec))
            self._scatter(view, {i: (s.pos, lens[i]) for i, s in pend})
            row_logits = {i: logits[i, lens[i] - 1] for i, s in pend}
            gather_bytes = self._view_bytes
        nxt_all = dict(zip(row_logits, _read_tokens(
            self._host, torch.stack(list(row_logits.values())))))
        now = time.perf_counter()
        total = 0
        finished = 0
        tick = self.metrics.counters["ticks"]
        for i, s in pend:
            s.pos += lens[i]
            total += lens[i]
            if s.pos == len(s.ctx):
                # prompt complete: first generated token comes from the
                # logits at the chunk's last real position
                nxt = nxt_all[i]
                s.req.output.append(nxt)
                s.prefilled = True
                lat = self._lat.get(s.req.rid)
                if lat is not None:
                    if "last" not in lat:
                        # first token ever for this request: TTFT
                        self.metrics.record_latency(
                            "ttft", tick - lat.get("submit", tick))
                        self.metrics.record_latency(
                            "ttft_us", _us_since(lat["submit_s"], now))
                        lat["last"], lat["last_s"] = tick, now
                    else:
                        # resumed prefill replays a decode tick: TPOT
                        _record_tpots(self.metrics, [lat], tick, now)
                # a *resumed* prefill replays a decode tick, so its token
                # gets the decode-tick exhaustion check
                if s.resumed and (
                        len(s.req.output) >= s.req.max_new_tokens
                        or nxt == self.eos_id
                        or s.pos >= self.max_len):
                    s.req.done = True
                    self.finished.append(s.req)
                    self._lat.pop(s.req.rid, None)
                    self.alloc.free_seq(self._seq_id(s))
                    self.rows[i] = None
                    finished += 1
        return {"prefill_tokens": total, "preempted": preempted,
                "finished": finished,
                "prefill_gather_bytes": gather_bytes,
                "kernel_prefill_ticks": kernel_ticks}

    def _prefill_kernel(self, pend, lens):
        """Kernel-path chunked prefill: pack the tick's prompt chunks
        ragged and attend them through the ragged-prefill kernel
        straight off the pool (token-granular packed-KV gather, no
        dense view).  Returns ``({row: last-real-token logits}, packed
        kv tokens)``, or None when the model cannot packed-prefill or
        the gate rejects the packed geometry — the tick then falls back to
        the dense ``decode_chunk`` path."""
        model = self.model
        if self._chunk is None \
                or not hasattr(model, "prefill_chunk_packed") \
                or getattr(model.cfg, "attn_type", None) == "mla":
            return None
        from repro_torch.kernels.ragged_prefill.ops import verified_config
        spans = [(i, s, s.pos, lens[i]) for i, s in pend]
        # pad both packed extents to 64-token granularity, as the JAX
        # engine does (64 is itself a valid block size, so every padded
        # extent tiles)
        pad = lambda t: -(-max(t, 1) // 64) * 64
        TQp = pad(sum(n for *_, n in spans))
        TKp = pad(sum(p + n for _, _, p, n in spans))
        mcfg = model.cfg
        key = (TQp, TKp, len(spans))
        if key not in self._prefill_cfgs:
            # ARGUS gate: verify the leakage invariants once per packed
            # geometry, config resolved from the dispatch table
            self._prefill_cfgs[key] = self._gate(
                "prefill", key, verified_config,
                TQp, TKp, len(spans), q_heads=mcfg.n_heads,
                kv_heads=mcfg.n_kv_heads,
                head_dim=mcfg.resolved_head_dim,
                dtype="bf16" if "bf" in str(mcfg.dtype) else "f32")
        kcfg = self._prefill_cfgs[key]
        if kcfg is None:
            return None
        with _Timed(self._host, "pack_us", "serve.pack"):
            inputs, q_last = self._pack_prefill(spans, TQp, TKp)
        t0 = time.perf_counter()
        logits, self.kv.storage = model.prefill_chunk_packed(
            self.params, self.kv.storage, *inputs, kernel_cfg=kcfg)
        self._host["prefill_model_us"] += _us_since(t0)
        return {i: logits[0, t] for i, t in q_last.items()}, TKp

    def _pack_prefill(self, spans, TQp: int, TKp: int):
        """The packed prefill call's nine inputs on the device, and
        ``{row: its last query's packed index}``."""
        PS = self.page_size
        tokens = np.zeros((1, TQp), np.int32)
        seg_q = np.full((TQp,), -1, np.int32)
        pos_q = np.zeros((TQp,), np.int32)
        seg_k = np.full((TKp,), -1, np.int32)
        pos_k = np.zeros((TKp,), np.int32)
        # padding queries address past the pool (not written); padding
        # KV reads the reserved null page (zeros, fully masked)
        wphys = np.full((TQp,), self.alloc.n_pages, np.int32)
        woffs = np.zeros((TQp,), np.int32)
        gphys = np.zeros((TKp,), np.int32)
        goffs = np.zeros((TKp,), np.int32)
        qt = kt = 0
        q_last = {}
        for j, (i, s, p, n) in enumerate(spans):
            table = self.alloc.table_row(self._seq_id(s),
                                         self.pages_per_seq)
            tokens[0, qt:qt + n] = s.ctx[p:p + n]
            seg_q[qt:qt + n] = j
            qpos = np.arange(p, p + n)
            pos_q[qt:qt + n] = qpos
            wphys[qt:qt + n] = table[qpos // PS]
            woffs[qt:qt + n] = qpos % PS
            seg_k[kt:kt + p + n] = j
            kpos = np.arange(p + n)
            pos_k[kt:kt + p + n] = kpos
            gphys[kt:kt + p + n] = table[kpos // PS]
            goffs[kt:kt + p + n] = kpos % PS
            q_last[i] = qt + n - 1
            qt += n
            kt += p + n
        return [self._t(a) for a in (tokens, seg_q, pos_q, seg_k, pos_k,
                                     wphys, woffs, gphys, goffs)], q_last

    # -- decode --------------------------------------------------------------
    def _kernel_config(self, tables: np.ndarray):
        """Resolve (from the installed dispatch table, else the default)
        and statically verify the kernel config for this batch geometry
        (memoized on it, like ``_gather``'s gate).  None when the gate
        rejects it or the cache cannot be paged-attended — the tick then
        falls back to the gather path."""
        sig = (tables.shape, self.alloc.n_pages)
        if sig != self._kernel_sig:
            from repro_torch.kernels.paged_attention.ops import (
                InvariantViolation, validate_block_tables)
            self._kernel_sig = sig
            self._decode_graph = (DecodeGraph() if self.device.type == "cuda"
                                  else None)
            if not hasattr(self.model, "decode_step_paged"):
                self._kernel_cfg = None
                return None
            try:
                self._kernel_cfg = self._gate(
                    "decode", sig, validate_block_tables,
                    tables, model=self.model, page_size=self.page_size,
                    pool_pages=self.alloc.n_pages, dtype=self._pool_dtype)
            except InvariantViolation:
                self._kernel_cfg = None
        return self._kernel_cfg

    def _decode_kernel(self, rows, tokens, pos_vec):
        """Kernel-path decode tick: no gather, no dense view.  The fresh
        K/V write happens inside ``decode_step_paged``; inactive rows
        carry null tables and length 0.  On a CUDA device the call
        replays the engine's :class:`DecodeGraph`, made anew for each
        batch geometry; its replays and captures are counted.  Returns
        logits, or None when no config exists for this geometry (gather
        fallback)."""
        with _Timed(self._host, "pack_us", "serve.pack"):
            tables = self._tables()
        cfg = self._kernel_config(tables)
        if cfg is None:
            return None
        from repro_torch.kernels.paged_attention.ops import \
            validate_block_tables
        with _Timed(self._host, "pack_us", "serve.pack"):
            # kernel tables: only decoding rows expose their pages — a
            # row mid-prefill holds pages for tokens not yet written,
            # which the mapped-length consistency check (rightly) rejects
            kt = np.zeros_like(tables)
            lengths = np.zeros((self.max_batch,), np.int32)
            for i, s in rows:
                kt[i] = tables[i]
                lengths[i] = s.pos + 1   # the token being written included
            # hot-path concrete gate: range + mapped-length consistency
            # (each row maps exactly ceil(length/page_size) pages, no
            # null holes)
            validate_block_tables(kt, page_size=self.page_size,
                                  pool_pages=self.alloc.n_pages,
                                  lengths=lengths)
            inputs = [self._t(a) for a in (kt, tokens, pos_vec, lengths)]
        graph = self._decode_graph
        counts = ((graph.replays, graph.captures) if graph is not None
                  else (0, 0))
        t0 = time.perf_counter()
        logits, self.kv.storage = self.model.decode_step_paged(
            self.params, self.kv.storage, *inputs, kernel_cfg=cfg,
            graph=graph)
        self._host["decode_model_us"] += _us_since(t0)
        if graph is not None:
            self._host["decode_graph_replays"] += graph.replays - counts[0]
            self._host["decode_graph_captures"] += graph.captures - counts[1]
        return logits

    def _decode_tick(self) -> Dict[str, int]:
        rows = [(i, s) for i, s in enumerate(self.rows)
                if s is not None and s.prefilled and not s.req.done]
        if not rows:
            return {"decode_tokens": 0, "finished": 0, "preempted": 0}
        preempted = 0
        for i, s in rows:
            if self.rows[i] is not s:      # evicted by an earlier ensure
                continue
            preempted += self._preempt_for(s, s.pos + 1)
        rows = [(i, s) for i, s in rows if self.rows[i] is s]
        if not rows:
            return {"decode_tokens": 0, "finished": 0,
                    "preempted": preempted}
        with _Timed(self._host, "pack_us", "serve.pack"):
            tokens = np.zeros((self.max_batch, 1), np.int32)
            pos_vec = np.zeros((self.max_batch,), np.int32)
            for i, s in rows:
                tokens[i, 0] = s.req.output[-1]
                pos_vec[i] = s.pos
        gather_bytes = kernel_ticks = 0
        logits = (self._decode_kernel(rows, tokens, pos_vec)
                  if self.decode_path == "kernel" else None)
        if logits is None:
            view = self._gather()
            logits, view = self.model.decode_step(
                self.params, view, self._t(tokens), self._t(pos_vec))
            self._scatter(view, {i: (s.pos, 1) for i, s in rows})
            gather_bytes = self._view_bytes
        else:
            kernel_ticks = 1
        nxt_all = _read_tokens(self._host, logits[:, -1])
        now = time.perf_counter()
        finished = 0
        tick = self.metrics.counters["ticks"]
        lats = []
        for i, s in rows:
            nxt = nxt_all[i]
            s.req.output.append(nxt)
            s.pos += 1
            s.ctx.append(int(tokens[i, 0]))
            lat = self._lat.get(s.req.rid)
            if lat is not None:
                lats.append(lat)
            exhausted = (len(s.req.output) >= s.req.max_new_tokens
                         or nxt == self.eos_id
                         or s.pos >= self.max_len)
            if exhausted:
                s.req.done = True
                self.finished.append(s.req)
                self._lat.pop(s.req.rid, None)
                self.alloc.free_seq(self._seq_id(s))
                self.rows[i] = None
                finished += 1
        _record_tpots(self.metrics, lats, tick, now)
        return {"decode_tokens": len(rows), "finished": finished,
                "preempted": preempted, "gather_bytes": gather_bytes,
                "kernel_decode_ticks": kernel_ticks}

    def _scatter(self, view: Dict, slabs: Dict[int, tuple]) -> None:
        """slabs: row -> (start position, n tokens written)."""
        rows, pos, phys, offs = [], [], [], []
        for i, (p0, n) in slabs.items():
            s = self.rows[i]
            table = self.alloc.tables[self._seq_id(s)]
            for p in range(p0, p0 + n):
                rows.append(i)
                pos.append(p)
                phys.append(table[p // self.page_size])
                offs.append(p % self.page_size)
        self.kv.scatter(view, np.asarray(rows, np.int32),
                        np.asarray(pos, np.int32),
                        np.asarray(phys, np.int32),
                        np.asarray(offs, np.int32))

    # -- tick ----------------------------------------------------------------
    def step(self) -> int:
        """One engine tick: admit by headroom, one prefill chunk per
        pending prompt, one decode step for the running batch, retire.
        Returns #active sequences."""
        t0 = self._clock()
        tick_sp = _obs.span("serve.tick")
        with tick_sp:
            with _obs.span("serve.admit"):
                adm = self._admit()
            with _obs.span("serve.prefill_chunk"):
                pre = self._prefill_tick()
            dec_sp = _obs.span("serve.decode_tick")
            with dec_sp:
                dec = self._decode_tick()
                if _obs.enabled():
                    dec_sp.set(
                        decode_tokens=dec["decode_tokens"],
                        trace_ids=[s.req.trace_name for s in self.active
                                   if s.prefilled])
            for s in self.active:
                self.alloc.touch(self._seq_id(s))
            n_active = len(self.active)
            if _obs.enabled():
                tick_sp.set(tick=self.metrics.counters["ticks"],
                            active=n_active)
            self.metrics.record_tick(
                queue_depth=len(self.queue), active=n_active,
                occupancy=self.alloc.used_pages,
                prefill_tokens=pre["prefill_tokens"],
                decode_tokens=dec["decode_tokens"],
                admitted=adm["admitted"],
                finished=pre["finished"] + dec["finished"],
                preempted=pre["preempted"] + dec["preempted"],
                gather_bytes=dec.get("gather_bytes", 0),
                kernel_decode_ticks=dec.get("kernel_decode_ticks", 0),
                kernel_prefill_ticks=pre.get("kernel_prefill_ticks", 0),
                prefill_gather_bytes=pre.get("prefill_gather_bytes", 0),
                step_time_us=int((self._clock() - t0) * 1e6), **self._host)
            self._host = dict.fromkeys(HOST_COUNTERS, 0)
        return n_active

    def run(self, max_ticks: int = 10_000) -> List[Request]:
        for _ in range(max_ticks):
            if not self.queue and not self.active:
                break
            self.step()
        return self.finished
