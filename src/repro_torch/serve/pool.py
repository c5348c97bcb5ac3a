"""Block-table KV page pool for the paged serving engine.

The port of the JAX package's ``serve/pool.py``.  Two layers, separately
testable:

:class:`PageAllocator` — pure bookkeeping, a copy of the JAX package's.
A pool of ``n_pages`` fixed-size physical pages; each sequence owns a
*block table* (logical page -> physical page).  Physical page 0 is the
reserved **null page**: it is never allocated, never written, and backs
every unallocated logical-table slot, so a gathered cache view is
all-zeros exactly where a dense cache slab would be.  Allocation pops
the lowest-numbered free page and frees re-insert in sorted order, so
the table layout is a deterministic function of the call sequence.
Eviction is LRU over ``touch`` stamps with an explicit ``protected``
set — the allocator can never be asked to reclaim a page out from
under a sequence the engine is currently running.

:class:`KVPool` — the torch storage behind the allocator: one pooled
tensor per model cache leaf, the dense leaf's batch axis replaced by
the physical-page axis and its kv_seq axis by ``page_size`` (for the
dense GQA family: ``(L, P, Hkv, PS, D)``).  ``gather`` materializes the
dense per-sequence cache view through the block tables; ``scatter``
writes freshly produced KV entries back to their (physical page,
offset) homes, in place.
"""
from __future__ import annotations

import bisect
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

NULL_PAGE = 0


class PoolExhausted(RuntimeError):
    """No free page and nothing evictable — callers preempt or reject."""


def pages_needed(tokens: int, page_size: int) -> int:
    return -(-tokens // page_size)


class PageAllocator:
    """Free-list page bookkeeping with per-sequence block tables."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("pool needs >= 2 pages (page 0 is the "
                             "reserved null page)")
        self.n_pages = n_pages
        self.page_size = page_size
        # page 0 reserved: all-zero backing for unallocated table slots
        self._free: List[int] = list(range(1, n_pages))
        self.tables: Dict[int, List[int]] = {}
        self._last_touch: Dict[int, int] = {}
        self._clock = 0

    # -- introspection ------------------------------------------------------
    @property
    def usable_pages(self) -> int:
        return self.n_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.usable_pages - len(self._free)

    def capacity(self, seq: int) -> int:
        """Tokens the sequence's allocated pages can hold."""
        return len(self.tables.get(seq, ())) * self.page_size

    def mapped_pages(self) -> Set[int]:
        return {p for t in self.tables.values() for p in t}

    # -- alloc / free -------------------------------------------------------
    def touch(self, seq: int) -> None:
        self._clock += 1
        self._last_touch[seq] = self._clock

    def alloc(self, seq: int, n: int = 1) -> List[int]:
        if n > len(self._free):
            raise PoolExhausted(
                f"seq {seq} needs {n} pages, {len(self._free)} free")
        got, self._free = self._free[:n], self._free[n:]
        self.tables.setdefault(seq, []).extend(got)
        self.touch(seq)
        return got

    def ensure(self, seq: int, n_tokens: int) -> List[int]:
        """Grow seq's table until it can hold ``n_tokens`` tokens."""
        need = pages_needed(n_tokens, self.page_size) - len(
            self.tables.get(seq, ()))
        return self.alloc(seq, need) if need > 0 else []

    def free_seq(self, seq: int) -> List[int]:
        pages = self.tables.pop(seq, [])
        self._last_touch.pop(seq, None)
        for p in pages:
            bisect.insort(self._free, p)
        return pages

    # -- eviction -----------------------------------------------------------
    def lru_victim(self, protected: FrozenSet[int] = frozenset()
                   ) -> Optional[int]:
        """Least-recently-touched mapped sequence outside ``protected``
        (admission-order tie-break) — or None if every mapped sequence
        is protected.  Never proposes a running sequence: the engine
        always passes the set it is actively stepping."""
        victims = [s for s in self.tables if s not in protected
                   and self.tables[s]]
        if not victims:
            return None
        return min(victims, key=lambda s: (self._last_touch.get(s, 0), s))

    def evict(self, protected: FrozenSet[int] = frozenset()
              ) -> Tuple[int, List[int]]:
        victim = self.lru_victim(protected)
        if victim is None:
            raise PoolExhausted("every mapped sequence is protected")
        return victim, self.free_seq(victim)

    # -- views --------------------------------------------------------------
    def table_row(self, seq: int, n_logical: int) -> np.ndarray:
        """(n_logical,) physical pages, null-padded past the allocation."""
        row = np.full((n_logical,), NULL_PAGE, np.int32)
        t = self.tables.get(seq, ())
        row[:len(t)] = t[:n_logical]
        return row

    def check(self) -> None:
        """Structural invariants (the hypothesis tests drive this):
        free ∪ mapped partitions pages 1..n-1; null page unmapped."""
        mapped = [p for t in self.tables.values() for p in t]
        assert len(mapped) == len(set(mapped)), "page mapped twice"
        assert NULL_PAGE not in mapped, "null page was allocated"
        assert not (set(mapped) & set(self._free)), "mapped page on free list"
        assert len(mapped) + len(self._free) == self.usable_pages, \
            "alloc/free did not conserve the page population"


class KVPool:
    """Paged physical storage for a model's KV cache leaves.

    Built from ``model.cache_shape``/``model.cache_axes``: every leaf
    must carry both a ``batch`` and a ``kv_seq`` axis (attention KV).
    Leaf layout keeps the dense axis order with batch->pages and
    kv_seq->page_size, so ``gather`` returns a view identical in shape
    and content to the dense engine's cache slab.
    """

    def __init__(self, model, n_pages: int, page_size: int,
                 device: DeviceLike = "cuda"):
        self.n_pages = n_pages
        self.page_size = page_size
        self.device = resolve_device(device)
        self.axes = model.cache_axes()
        shapes = model.cache_shape(1, page_size)
        self.storage: Dict = {}
        for group, leaves in self.axes.items():
            self.storage[group] = {}
            for name, ax in leaves.items():
                if "batch" not in ax or "kv_seq" not in ax:
                    raise ValueError(
                        f"cache leaf axes {ax} lack batch/kv_seq: this "
                        "model cannot be paged — use the dense "
                        "ServingEngine")
                sd = shapes[group][name]
                shp = list(sd.shape)
                shp[ax.index("batch")] = n_pages
                self.storage[group][name] = torch.zeros(
                    tuple(shp), dtype=sd.dtype, device=self.device)

    def _leaves(self):
        for group, leaves in self.axes.items():
            for name, ax in leaves.items():
                yield group, name, ax

    # -- accounting ---------------------------------------------------------
    @property
    def nbytes(self) -> int:
        return sum(self.storage[g][n].numel()
                   * self.storage[g][n].element_size()
                   for g, n, _ in self._leaves())

    @staticmethod
    def dense_reserved_bytes(model, n_slots: int, max_len: int) -> int:
        """Bytes the dense engine's per-slot ``max_len`` slabs reserve."""
        shapes = model.cache_shape(n_slots, max_len)
        return sum(int(np.prod(sd.shape)) * sd.dtype.itemsize
                   for leaves in shapes.values() for sd in leaves.values())

    # -- data movement ------------------------------------------------------
    def gather(self, tables: torch.Tensor) -> Dict:
        """tables (B, NP) int32 -> dense cache view, kv length NP·PS."""
        t = tables.to(self.device).long()
        out: Dict = {}
        for group, name, ax in self._leaves():
            b, s = ax.index("batch"), ax.index("kv_seq")
            pm = self.storage[group][name].movedim((b, s), (0, 1))
            v = pm[t]                                   # (B, NP, PS, *rest)
            B, NP, PS = v.shape[:3]
            v = v.reshape((B, NP * PS) + tuple(v.shape[3:]))
            out.setdefault(group, {})[name] = v.movedim((0, 1), (b, s))
        return out

    def scatter(self, view: Dict, rows: np.ndarray, pos: np.ndarray,
                phys: np.ndarray, offs: np.ndarray) -> None:
        """Write view entries (row, kv position) back to pool homes
        (physical page, in-page offset), in place.  All four index
        vectors are flat and same-length."""
        if len(rows) == 0:
            return
        idx = [torch.as_tensor(np.asarray(a, np.int64), device=self.device)
               for a in (rows, pos, phys, offs)]
        rows_t, pos_t, phys_t, offs_t = idx
        for group, name, ax in self._leaves():
            b, s = ax.index("batch"), ax.index("kv_seq")
            vals = view[group][name].movedim((b, s), (0, 1))[rows_t, pos_t]
            pm = self.storage[group][name].movedim((b, s), (0, 1))
            pm[phys_t, offs_t] = vals.to(pm.dtype)
