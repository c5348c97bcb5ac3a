"""Mergeable log2-bucketed histograms for latency telemetry.

Bucket layout is *fixed* (no per-instance configuration): bucket ``i``
covers integer values in ``[2**(i-1), 2**i - 1]`` with bucket 0
reserved for values ``<= 0`` and the last bucket absorbing everything
above ``2**(N_BUCKETS-2) - 1``.  Because every histogram shares the
same buckets, ``merge`` is element-wise addition of counts — an
associative, commutative, order-free operation.

A copy of the JAX package's ``obs/hist.py`` (the port imports nothing
of that package), without ``merge_save_hist``: a locked shared-file
merge that no path of the JAX package calls (its fleet tuner, ported in
``repro_torch.core.tuning``, shares proofs and lessons, not
histograms).

Quantiles are nearest-rank over bucket counts and return the bucket's
inclusive upper bound, so the estimate errs by at most one bucket
width (a factor-of-2 band at the high end) — and *merging then asking*
equals *recording everything in one histogram then asking*, because
the merged counts are identical by construction.
"""
from typing import Dict, Iterable, List, Optional

N_BUCKETS = 64


def bucket_index(value: int) -> int:
    """The fixed bucket for an integer value (floats are truncated)."""
    v = int(value)
    if v <= 0:
        return 0
    return min(v.bit_length(), N_BUCKETS - 1)


def bucket_upper(i: int) -> int:
    """Inclusive upper bound of bucket ``i`` (0 for the zero bucket)."""
    if i <= 0:
        return 0
    return (1 << i) - 1


class LogHistogram:
    """Fixed-bucket log2 histogram; ``merge`` is element-wise add."""

    __slots__ = ("counts", "total")

    def __init__(self, counts: Optional[List[int]] = None, total: int = 0):
        self.counts = list(counts) if counts is not None else [0] * N_BUCKETS
        if len(self.counts) != N_BUCKETS:
            raise ValueError(f"expected {N_BUCKETS} buckets, "
                             f"got {len(self.counts)}")
        self.total = int(total)

    def record(self, value: int, n: int = 1) -> None:
        self.counts[bucket_index(value)] += n
        self.total += int(value) * n

    @property
    def count(self) -> int:
        return sum(self.counts)

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Pure merge: a new histogram with element-wise summed counts."""
        return LogHistogram(
            [a + b for a, b in zip(self.counts, other.counts)],
            self.total + other.total)

    def quantile(self, q: float) -> int:
        """Nearest-rank quantile, reported as the bucket upper bound.

        Empty histograms report 0.  The true value lives in the same
        bucket, so the error is bounded by that bucket's width.
        """
        n = self.count
        if n == 0:
            return 0
        rank = max(1, min(n, int(-(-q * n // 1))))  # ceil(q*n), clamped
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return bucket_upper(i)
        return bucket_upper(N_BUCKETS - 1)  # pragma: no cover

    def summary(self) -> Dict[str, int]:
        """The percentile block benchmarks embed in their reports."""
        return {"count": self.count, "sum": self.total,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    def to_dict(self) -> Dict[str, object]:
        """Sparse, JSON- and merge_save-friendly encoding."""
        return {"scheme": "log2",
                "counts": {str(i): c for i, c in enumerate(self.counts)
                           if c},
                "sum": self.total}

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "LogHistogram":
        if d.get("scheme") != "log2":
            raise ValueError(f"unknown histogram scheme {d.get('scheme')!r}")
        counts = [0] * N_BUCKETS
        for k, c in d["counts"].items():  # type: ignore[union-attr]
            counts[int(k)] = int(c)
        return cls(counts, int(d.get("sum", 0)))


def merge_dicts(a: Dict[str, object], b: Dict[str, object]):
    """Merge two :meth:`LogHistogram.to_dict` payloads (for
    ``fslock.merge_save`` merge functions)."""
    return LogHistogram.from_dict(a).merge(LogHistogram.from_dict(b)).to_dict()


def merged_summaries(hists: Dict[str, LogHistogram]) -> Dict[str, Dict[str, int]]:
    """Summaries for a dict of named histograms (helper for reports)."""
    return {k: h.summary() for k, h in hists.items()}


def quantiles_from_values(values: Iterable[int], q: float) -> int:
    """Reference nearest-rank quantile over raw values, reported in the
    same bucket-upper-bound terms — used by tests to bound the
    histogram's error."""
    vs = sorted(int(v) for v in values)
    if not vs:
        return 0
    rank = max(1, min(len(vs), int(-(-q * len(vs) // 1))))
    return bucket_upper(bucket_index(vs[rank - 1]))
