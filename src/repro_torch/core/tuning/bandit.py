"""Speed-of-light tuning policy: the early-stop rule + the deterministic
UCB bandit that reallocates freed budget (the port of the JAX package's
``core/tuning/bandit.py``).

:class:`SolPolicy` is the knob bundle the fleet threads through the
schedulers: a job's promotion chain stops the moment its verified
cost-model estimate is within ``slack`` of the family's analytic
speed-of-light bound (``record["sol_frac"] >= 1 / (1 + slack)``, where
``sol_frac = sol_time_s / best_time_s`` is stamped on every journal
record by the item runner).  A stopped job keeps occupying the promotion
slots its frozen record's rank earns — so stopping job A never changes
which *other* jobs promote — but its slots' budgets are freed instead of
run.

:class:`GapBandit` spends ``realloc`` of the freed iterations on the
remaining (not-stopped, not-promoted) sweep buckets.  Arms are job ids;
the reward is per-iteration SoL-gap closed, observed from consecutive
*base-rung* records only (never from the extra side-branches the bandit
itself funds, which keeps sync, async-reconciled and killed-and-resumed
runs byte-identical); the exploration bonus is plain UCB1.  All
tie-breaks hash the journal fingerprint (``SolPolicy.seed``) with the
job id through :func:`repro_torch.core.tuning.jobs.stable_seed`, so the grant
sequence is a pure function of (jobs, records, fingerprint).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, Optional

from .jobs import stable_seed


@dataclass(frozen=True)
class SolPolicy:
    """Speed-of-light early-stop + reallocation knobs.

    ``slack``   — stop a job once best_time <= sol_time * (1 + slack);
    ``realloc`` — fraction of freed iterations the bandit re-spends;
    ``seed``    — journal fingerprint, the bandit's tie-break salt;
    ``ucb_c``   — UCB1 exploration constant.
    """

    slack: float = 0.1
    realloc: float = 0.25
    seed: str = ""
    ucb_c: float = 0.5

    def stops(self, record: dict) -> bool:
        """True when the record's verified estimate is within ``slack``
        of the analytic bound.  Records without a ``sol_frac`` (family
        has no ``sol_bound`` hook, or a pre-SoL journal) never stop."""
        frac = record.get("sol_frac")
        return frac is not None and frac * (1.0 + self.slack) >= 1.0


class GapBandit:
    """Deterministic UCB1 allocator over sweep-bucket arms.

    ``observe`` feeds one base-rung transition (how much of the SoL gap
    the rung's iterations closed); ``grant`` picks the arm with the
    highest mean-reward-plus-exploration score and counts the pull.
    Grants deliberately do *not* feed rewards back (extra side-branch
    results never influence scheduling), so repeated grants to one arm
    decay its score through the pull count alone and the budget rotates.
    """

    def __init__(self, policy: SolPolicy):
        self.policy = policy
        self._reward_sum: Dict[str, float] = {}
        self._obs: Dict[str, int] = {}
        self._pulls: Dict[str, int] = {}
        self._total_pulls = 0

    def observe(self, job_id: str, gap_closed: float,
                iterations: int) -> None:
        """One base-rung observation: ``gap_closed`` is the sol_frac
        increase the rung achieved, ``iterations`` its budget."""
        if iterations <= 0:
            return
        self._reward_sum[job_id] = self._reward_sum.get(job_id, 0.0) \
            + max(0.0, gap_closed) / iterations
        self._obs[job_id] = self._obs.get(job_id, 0) + 1

    def grant(self, candidates: Iterable[str]) -> Optional[str]:
        """The next arm to fund among ``candidates`` (job ids), or
        ``None`` when there are none.  Deterministic: scores tie-break
        through the fingerprint-salted hash, then the job id."""
        best = None
        for jid in sorted(candidates):
            score = (self._score(jid),
                     stable_seed(self.policy.seed, "bandit", jid), jid)
            if best is None or score > best[0]:
                best = (score, jid)
        if best is None:
            return None
        jid = best[1]
        self._pulls[jid] = self._pulls.get(jid, 0) + 1
        self._total_pulls += 1
        return jid

    def _score(self, jid: str) -> float:
        obs = self._obs.get(jid, 0)
        mean = self._reward_sum.get(jid, 0.0) / obs if obs else 0.0
        pulls = self._pulls.get(jid, 0)
        bonus = self.policy.ucb_c * math.sqrt(
            math.log(self._total_pulls + 1.0) / (pulls + 1.0))
        return mean + bonus
