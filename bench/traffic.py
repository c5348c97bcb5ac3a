"""Seeded request traffic for the benchmark's cells.

A rewrite of ``repro_torch.serve.trace`` for the benchmark: a backlog
that never empties, not arrivals counted in engine ticks, and lengths
drawn from a mix file's distributions.  One general generator reads
every mix file (``bench/traffic/<mix>.json``):

``arrivals``
    ``"backlog"``, the only kind: every request is due at once, and the
    harness keeps the engine's queue topped up, so the batch is always
    full.
``prompt_tokens`` / ``output_tokens``
    ``{"dist": "log_uniform" | "uniform", "min": a, "max": b}``.
``block``
    Each run of ``block`` consecutive requests takes the lengths at the
    distribution's ``block`` evenly spaced quantiles, in an order drawn
    from the seed.  Every seed then serves the same sizes in another
    order, so seeds change which request comes when, not how much work
    a window holds.
``first_batch``
    ``"residual"``: the first ``engine.max_batch`` requests (the batch
    that set-up fills) get a share of their drawn output length, at
    evenly spaced fractions in a seeded order, as if they had been
    running for a while: completions and admissions are then already
    interleaved when the window opens.

Token ids are uniform over the vocabulary, drawn per request from
``(seed, request index)``, so a request's prompt does not depend on how
many requests were drawn before it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, List

import numpy as np


@dataclass(frozen=True)
class Arrival:
    rid: int
    prompt: List[int]
    max_new_tokens: int


def quantile_lengths(dist: Dict, n: int) -> List[int]:
    """The lengths at the ``n`` quantiles (i + 0.5) / n of ``dist``."""
    lo, hi = int(dist["min"]), int(dist["max"])
    if not 1 <= lo <= hi:
        raise ValueError(f"length range {lo}..{hi} is not 1 <= min <= max")
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "uniform":
        x = lo + u * (hi + 1 - lo)
    elif kind == "log_uniform":
        x = np.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo)))
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return [min(hi, int(v)) for v in x]


class Traffic:
    """The request stream of one mix under one seed."""

    def __init__(self, mix: Dict, seed: int, vocab: int):
        self.mix = mix
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.block = int(mix.get("block", 16))
        self.prompts = quantile_lengths(mix["prompt_tokens"], self.block)
        self.outputs = quantile_lengths(mix["output_tokens"], self.block)
        self.first_batch = (int(mix["engine"]["max_batch"])
                            if mix.get("first_batch") == "residual" else 0)
        arrivals = mix.get("arrivals", "backlog")
        if arrivals != "backlog":
            raise ValueError(f"unknown arrivals {arrivals!r}")

    def _rng(self, *key: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, *key])

    def sizes(self, rid: int):
        """(prompt tokens, output tokens) of request ``rid``."""
        b, i = divmod(rid, self.block)
        rng = self._rng(0, b)
        p = self.prompts[rng.permutation(self.block)[i]]
        o = self.outputs[rng.permutation(self.block)[i]]
        if rid < self.first_batch:
            n = self.first_batch
            frac = (self._rng(1).permutation(n)[rid] + 0.5) / n
            o = max(1, math.ceil(o * frac))
        return p, o

    def request(self, rid: int) -> Arrival:
        p, o = self.sizes(rid)
        toks = self._rng(2, rid).integers(0, self.vocab, size=p)
        return Arrival(rid, toks.tolist(), o)

    def stream(self) -> Iterator[Arrival]:
        """Requests in order, without end."""
        rid = 0
        while True:
            yield self.request(rid)
            rid += 1
