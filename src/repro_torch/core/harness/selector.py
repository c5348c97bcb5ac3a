"""Optimization selector (paper §6): stochastic choice over the planner's
ranked proposals — softmax sampling keeps exploration alive in a tightly
coupled space where the top-ranked local step may be a dead end (e.g.
pipelining before scheduling, Figure 2)."""
from __future__ import annotations

import math
import random
from typing import List, Optional

from .planner import Proposal


class Selector:
    def __init__(self, temperature: float = 0.3, seed: int = 0):
        self.temperature = temperature
        self.rng = random.Random(seed)

    def select(self, proposals: List[Proposal]) -> Optional[Proposal]:
        if not proposals:
            return None
        t = max(self.temperature, 1e-6)
        mx = max(p.score for p in proposals)
        ws = [math.exp((p.score - mx) / t) for p in proposals]
        total = sum(ws)
        r = self.rng.random() * total
        acc = 0.0
        for p, w in zip(proposals, ws):
            acc += w
            if r <= acc:
                return p
        return proposals[-1]
