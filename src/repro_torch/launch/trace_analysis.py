"""Roofline terms from an eager trace — the counterpart of the JAX
package's ``launch/hlo_analysis.py``.  There is no compiled HLO to read:
:class:`TraceCounter`, a dispatch mode, watches every op a step runs and
counts per device, from the local shards DTensor computes on:

* **FLOPs** of the matmul-like ops (``torch.utils.flop_counter``'s
  formulas) on the local operands' shapes.  ``FlopCounterMode`` would
  count at the DTensor level, the global work; redundant work on
  replicated dimensions shows here as a smaller ``useful_flops_frac``.
  Elementwise work is not counted (XLA's count has it).
* **HBM bytes**: the bytes of every op's local inputs and outputs, views
  excluded.  No fusion is modelled, so this exceeds what a fused
  program moves (XLA's ``bytes accessed`` is of its fused program).
* **Collective bytes** by kind, where DTensor asks for a collective,
  with the JAX package's ring factors: the bytes of the collective's
  result, times 2 for an all-reduce.  A shard-to-shard redistribution
  is an all-to-all even where DTensor emulates it with an all-gather
  (its CPU meshes do).
* **Memory**: the bytes of the live local tensors (arguments included),
  and their peak over the trace.

Ops that DTensor's sharding propagation runs on fake tensors are not
counted.  The counter works the same on ``meta`` tensors (the dry-run)
and on a real step, so a dry-run's counts can be held to a real step's.

The rates are an NVIDIA H100 SXM's (data sheet, 700 W): bf16 tensor
cores 989 TFLOP/s and HBM3 3.35 TB/s from ``core/costs.py``, and one
NVLink 4 direction, 450 GB/s.  A mesh axis wider than the 8 GPUs of an
NVLink domain crosses the NIC, so there the collective term is a lower
bound.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.core.costs import HBM_BW, PEAK_FLOPS

PEAK_BF16 = PEAK_FLOPS["bf16"]   # bf16 dense FLOP/s per card (data sheet)
NVLINK_BW = 450e9                # NVLink 4, bytes/s one direction (data sheet)

# bytes of a collective's result that cross links (ring algorithms), as
# the JAX package's hlo_analysis counts them
_TRAFFIC_FACTOR = {
    "all-gather": 1.0,
    "all-reduce": 2.0,        # reduce-scatter + all-gather
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
    "broadcast": 1.0,
}
_C10D_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast",
}


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, float] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())

    def add(self, kind: str, result_bytes: float) -> None:
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) + \
            result_bytes * _TRAFFIC_FACTOR[kind]
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tensors_of(tree):
    """The tensors of a tree of tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from tensors_of(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from tensors_of(x)


class TraceCounter(TorchDispatchMode):
    """Counts the ops run under it (see the module docstring).  Use as a
    context manager; :meth:`track` registers tensors that are live
    before it starts (a step's arguments)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.coll = CollectiveStats()
        self.n_ops = 0
        self._live: Dict[int, tuple] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._in_alltoall = 0

    # -- memory --------------------------------------------------------------
    def track(self, tree) -> int:
        """Add the local storages of ``tree``'s tensors (DTensors by their
        local shard) to the live set; returns their bytes."""
        from torch.distributed.tensor import DTensor
        n = 0
        for t in tensors_of(tree):
            if isinstance(t, DTensor):
                t = t.to_local()
            n += self._add_storage(t)
        self._note_peak()
        return n

    def _add_storage(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        ref = StorageWeakRef(st)
        if ref.cdata in self._live:
            return 0
        nb = st.nbytes()
        self._live[ref.cdata] = (ref, nb)
        self.live_bytes += nb
        return nb

    def _note_peak(self) -> None:
        if self.live_bytes <= self.peak_bytes:
            return
        # a new peak candidate: drop the storages freed since, then look
        # again (the running total only overestimates)
        for k in [k for k, (ref, _) in self._live.items() if ref.expired()]:
            self.live_bytes -= self._live.pop(k)[1]
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    # -- all-to-all ----------------------------------------------------------
    @contextlib.contextmanager
    def _alltoall_patch(self):
        """DTensor's shard-to-shard redistribution
        (``placement_types.shard_dim_alltoall``) falls back to an
        all-gather on CPU meshes: count each call as one all-to-all of
        its input's bytes, and nothing inside it.  On ``meta`` tensors
        (the dry-run) the result is made directly, so the fallback's
        gathered tensor does not count as live memory."""
        import torch.distributed.tensor.placement_types as pt
        orig = getattr(pt, "shard_dim_alltoall", None)
        if orig is None:
            yield
            return

        def counted(input, gather_dim, shard_dim, mesh, mesh_dim):
            self.coll.add("all-to-all", _nbytes(input))
            if input.is_meta:
                n = mesh.size(mesh_dim)
                shape = list(input.shape)
                shape[gather_dim] *= n
                shape[shard_dim] = -(-shape[shard_dim] // n)  # rank 0's
                return input.new_empty(shape)
            self._in_alltoall += 1
            try:
                return orig(input, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                self._in_alltoall -= 1
        pt.shard_dim_alltoall = counted
        try:
            yield
        finally:
            pt.shard_dim_alltoall = orig

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(self._alltoall_patch())
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._stack.close()
        self._note_peak()
        return out

    # -- dispatch ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is not FakeTensor and issubclass(t, torch.Tensor)
               and t is not torch.Tensor for t in types):
            # a DTensor (or another wrapper): let it run its local ops,
            # which come back through this mode
            return NotImplemented
        out = func(*args, **kwargs)
        outs = list(tensors_of(out))
        ins = list(tensors_of((args, kwargs)))
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out              # DTensor's sharding propagation
        self.n_ops += 1
        packet = func._overloadpacket
        if func.namespace in ("_c10d_functional", "_dtensor", "c10d"):
            kind = _C10D_KIND.get(packet.__name__)
            if kind and not self._in_alltoall:
                self.coll.add(kind, sum(_nbytes(t) for t in outs))
            return out
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        if not func.is_view:
            seen = set()
            for t in ins + outs:
                if id(t) not in seen:
                    seen.add(id(t))
                    self.hbm_bytes += _nbytes(t)
        for t in outs:
            self._add_storage(t)
        self._note_peak()
        return out


@dataclass
class Roofline:
    """Per-device roofline terms, the fields of the JAX package's.  The
    eager layer loop runs every layer, so no count is scaled by
    ``trips``: it is recorded for parity with the JAX record (XLA counts
    a scan body once and scales by it)."""

    flops: float          # per device
    hbm_bytes: float
    coll_bytes: float
    n_chips: int
    model_flops: float = 0.0   # global 6·N_active·D
    trips: int = 1

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_BF16

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / (global counted FLOPs): how much of the computed
        work is useful (catches recomputation and redundant work)."""
        total = self.flops * self.n_chips
        return self.model_flops / total if total else 0.0

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "n_chips": self.n_chips,
            "trips": self.trips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "bound": self.bound,
            "model_flops": self.model_flops,
            "useful_flops_frac": self.useful_flops_frac,
        }


def analyze(counter: TraceCounter, *, n_chips: int, model_flops: float = 0.0,
            trips: int = 1) -> Roofline:
    """The roofline of what ``counter`` saw; ``trips`` is recorded only."""
    return Roofline(flops=counter.flops, hbm_bytes=counter.hbm_bytes,
                    coll_bytes=counter.coll.total_bytes, n_chips=n_chips,
                    model_flops=model_flops, trips=trips)
