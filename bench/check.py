"""Whether what the timed path served is right.

A sample, drawn from the seed, of the requests the window finished is
run through the plain reference of the configuration's family (its
module's ``Reference``, on the weights as its ``published`` gives them;
:mod:`bench.families.decoder`): each prompt with its served tokens,
once.  The engine's rows are split into ``requests`` equal groups, and
each group gives one request that last decoded in one of its rows (the
one with the longest sequence always among them, in its own group), so a
fault in any part of the batch reaches the sample; of each, its last
``tokens_per_request`` served tokens are compared, so that no one
request outweighs the others.  At each compared position the gap by which
the served token's logit lies below the reference's best is read: 0
where the reference ranks it first.  Rounding in the served precision
flips only near-ties; a wrong prefill, decode, expert or pool read
serves tokens the reference ranks anywhere.  The configuration file's
``check`` block gives the sample's size and names the numbers compared
and their limits: ``widest_logit_gap`` (the largest gap),
``mean_logit_gap`` (their mean), ``flipped_share`` (the share of
positions not ranked first).  PERF.md gives the readings each limit was
set from.

:func:`control_stats` reads the control: the reference itself in
float8 in the program's place; at each of the same positions the token
that it ranks first, and that token's gap in the float32 reference.
:func:`verdict` judges either side's numbers alike.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch


def sample(finished: Sequence, rows: Dict[int, int], max_batch: int,
           groups: int, seed: int) -> List:
    """One request finished without error from each of ``groups``
    equal groups of the engine's ``max_batch`` rows (by the row it last
    decoded in, ``rows``), drawn from the seed; the one with the longest
    sequence is its group's.  A group none of whose rows finished a
    request gives none."""
    ok = [r for r in finished
          if r.error is None and r.output and r.rid in rows]
    if not ok:
        return []
    longest = max(ok, key=lambda r: (len(r.prompt) + len(r.output), -r.rid))
    by_group: Dict[int, List] = {}
    for r in ok:
        by_group.setdefault(rows[r.rid] * groups // max_batch, []).append(r)
    rng = np.random.default_rng([int(seed), 7])
    out = []
    for g in sorted(by_group):
        reqs = by_group[g]
        out.append(longest if longest in reqs
                   else reqs[rng.integers(len(reqs))])
    return out


def _inputs(reqs, device, last: int):
    """Each request's prompt with its served tokens but the last (the
    sequence the reference runs), the positions that predicted its last
    ``last`` served tokens, and those tokens."""
    seqs, pos, served = [], [], []
    for r in reqs:
        full = list(r.prompt) + list(r.output)
        n = min(last, len(r.output))
        seqs.append(torch.tensor(full[:-1], device=device))
        pos.append(torch.arange(len(full) - 1 - n, len(full) - 1,
                                device=device))
        served.append(torch.tensor(r.output[-n:], device=device))
    return seqs, pos, served


def served_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor
                ) -> torch.Tensor:
    """How far each served token's logit lies below the reference's best
    at its position (0 where the reference ranks it first)."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(1, tokens.long()[:, None])[:, 0]
    return best - got


STATS = ("widest_logit_gap", "mean_logit_gap", "flipped_share")


def gap_stats(gaps: Sequence[torch.Tensor]) -> Dict[str, float]:
    g = torch.cat([x.reshape(-1) for x in gaps])
    if g.numel() == 0:
        return dict.fromkeys(STATS, math.nan)
    return {"widest_logit_gap": float(g.max()),
            "mean_logit_gap": float(g.mean()),
            "flipped_share": float((g > 0).float().mean())}


def _reference(cell, params: Dict, precision: str = "f32"):
    family, model = cell.family, cell.config["model"]
    return family.Reference(model, family.published(params, model),
                            precision)


def served_stats(cell, params: Dict, reqs, last: int) -> Dict[str, float]:
    """The numbers of the program's served tokens; ``params`` are the
    weights the program was handed."""
    device = params["embed"]["tok"].device
    seqs, pos, served = _inputs(reqs, device, last)
    with torch.no_grad():
        logits = _reference(cell, params).logits(seqs, pos)
    return gap_stats([served_gaps(l, t) for l, t in zip(logits, served)])


def control_stats(cell, params: Dict, reqs, last: int) -> Dict[str, float]:
    """The control's numbers on the same prompts and served tokens."""
    device = params["embed"]["tok"].device
    seqs, pos, _ = _inputs(reqs, device, last)
    with torch.no_grad():
        ref = _reference(cell, params).logits(seqs, pos)
        low = _reference(cell, params, "fp8").logits(seqs, pos)
    return gap_stats([served_gaps(r, l.argmax(dim=-1))
                      for r, l in zip(ref, low)])


def verdict(cell, stats: Dict[str, float], reqs, off_kernel_ticks: int
            ) -> Dict:
    """``correct`` and the numbers compared beside their limits, for
    the program's served tokens or the control's."""
    want = cell.config["check"]
    checks = {k: {"value": stats[k], "rule": "<=", "limit": float(want[k])}
              for k in STATS if k in want}
    checks.update({
        "ticks_off_kernel_path": {"value": off_kernel_ticks, "rule": "<=",
                                  "limit": 0},
        "row_groups_checked": {"value": len(reqs), "rule": ">=",
                               "limit": int(want["requests"])},
        "served_tokens_checked": {
            "value": sum(min(len(r.output), int(want["tokens_per_request"]))
                         for r in reqs), "rule": ">=", "limit": 1},
    })
    correct = all(c["value"] <= c["limit"] if c["rule"] == "<="
                  else c["value"] >= c["limit"] for c in checks.values())
    return dict(correct=bool(correct), checks=checks)


def judge(cell, *, params: Dict, finished: Sequence, rows: Dict[int, int],
          seed: int, off_kernel_ticks: int) -> Dict:
    """The program's verdict, and the requests attempted and failed in
    the window."""
    want = cell.config["check"]
    reqs = sample(finished, rows, int(cell.traffic["engine"]["max_batch"]),
                  int(want["requests"]), seed)
    stats = (served_stats(cell, params, reqs,
                          int(want["tokens_per_request"]))
             if reqs else dict.fromkeys(STATS, math.nan))
    out = verdict(cell, stats, reqs, off_kernel_ticks)
    out.update(stats=stats, attempted=len(finished),
               failed=sum(r.error is not None for r in finished),
               sample=reqs)
    return out
