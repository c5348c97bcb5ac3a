"""The paged decode call as one CUDA graph.

The JAX package jits its decode tick; the port's counterpart captures
:meth:`~repro_torch.models.transformer.TransformerLM.decode_step_paged`
(every layer's norms, projections, rotary, K/V writes, the paged-
attention kernel and the FFN or MoE, then the head) into a
``torch.cuda.CUDAGraph`` and replays it: one launch from the host in
place of some seventy a layer.

A :class:`DecodeGraph` holds one graph, for one decode geometry.  Its
key is the inputs' shapes and types, the address, shape and type of
every parameter and pool leaf (plain ints: the holder keeps no
reference to either, so dropping the engine frees the pool) and the
kernel config.  On a new key it runs the body once eagerly (the
warm-up: lazy initialisation and the kernels' first use happen outside
the capture; the body rewrites the same K/V, which is harmless),
captures it, and replays.  On a known key it copies the
call's inputs into the graph's own and replays.  Each call returns a
copy of the logits, so a later replay cannot change logits a caller
still holds.

The port's kernels count their launches on the host
(:attr:`repro_torch.kernels._build.CudaKernel.launches`).  A capture
launches nothing, so the launches counted while capturing are taken
back, and each replay adds the launches the graph holds: the counters
keep counting kernels that ran.  A capture that fails raises; nothing
falls back to the eager call.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from .params import leaf_paths


def _leaves_key(tree) -> Tuple:
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                 for _, t in leaf_paths(tree))


class DecodeGraph:
    """One captured paged decode call, replayed while its key holds.
    ``replays`` and ``captures`` count the calls that replayed (every
    call does, a capturing one too) and those that captured."""

    def __init__(self):
        self.replays = 0
        self.captures = 0
        self._key = None
        self._graph = None
        self._inputs: Tuple[torch.Tensor, ...] = ()
        self._logits = None
        self._launches: Tuple = ()     # (kernel, launches in one replay)

    def __call__(self, body: Callable, params, pool,
                 inputs: Sequence[torch.Tensor],
                 kernel_cfg) -> Tuple[torch.Tensor, str]:
        """``body(params, pool, *inputs, kernel_cfg=kernel_cfg)``'s
        logits by a replay, and "capture" or "replay"."""
        key = (_leaves_key(params), _leaves_key(pool),
               tuple((tuple(t.shape), t.dtype, t.device) for t in inputs),
               kernel_cfg)
        if key == self._key:
            mode = "replay"
            for dst, src in zip(self._inputs, inputs):
                dst.copy_(src)
        else:
            mode = "capture"
            self._capture(body, params, pool, inputs, kernel_cfg)
            self._key = key
        self._graph.replay()
        self.replays += 1
        for kernel, n in self._launches:
            kernel.launches += n
        return self._logits.clone(), mode

    def _capture(self, body, params, pool, inputs, kernel_cfg) -> None:
        from repro_torch.kernels import ALL_KERNELS
        # the old graph's memory goes back before the new one is taken
        self._key = self._graph = self._logits = None
        self._inputs = tuple(t.clone() for t in inputs)
        # the warm-up runs on the current stream: a new stream would
        # take a cuBLAS workspace of its own for the life of the process
        body(params, pool, *self._inputs, kernel_cfg=kernel_cfg)
        before = [k.launches for k in ALL_KERNELS]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            logits = body(params, pool, *self._inputs, kernel_cfg=kernel_cfg)
        self._launches = tuple((k, k.launches - n)
                               for k, n in zip(ALL_KERNELS, before)
                               if k.launches != n)
        for kernel, n in self._launches:
            kernel.launches -= n
        self._graph, self._logits = graph, logits
        self.captures += 1
