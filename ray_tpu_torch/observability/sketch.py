"""Deterministic fixed-boundary quantile sketches for serving SLOs.

The port's own copy of ``ray_tpu/observability/sketch.py``.  A
:class:`LatencySketch` is a histogram over a fixed, sorted boundary vector
whose quantile answers are a pure function of the observation multiset (no
randomized compaction), so a p99 reproduces exactly.  Two sketches over the
same boundaries merge by element-wise count addition (associative and
commutative), so per-engine sketches roll up in any order.  Quantiles and
the ``to_dict`` wire form equal the JAX package's for the same samples.

Boundaries are ms-scale between 0.5 ms and 30 s; a quantile answer is the
upper edge of the bucket holding the rank.  ``SERVING_LATENCY_BOUNDS``
matches the ``llm_ttft_seconds`` / ``llm_inter_token_seconds`` families in
``metric_defs.py``.
"""

from __future__ import annotations

import math
from bisect import bisect_left
from typing import Dict, Iterable, List, Sequence, Tuple

#: ms-scale serving boundaries (seconds): 0.5 ms .. 30 s.  Shared with the
#: serving histogram families in metric_defs.py so Prometheus buckets and
#: sketch quantiles are computed over the same grid.
SERVING_LATENCY_BOUNDS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


class LatencySketch:
    """Fixed-boundary quantile sketch: bounded memory, deterministic
    quantiles, associative merge.

    Not internally locked: single-writer per sketch is the intended shape
    (each engine owns its sketches and observes from its own loop thread);
    concurrent snapshot readers may see a mid-update view that skews one
    poll, never corrupts state.
    """

    __slots__ = ("boundaries", "counts", "total", "sum", "max")

    def __init__(self, boundaries: Sequence[float] = SERVING_LATENCY_BOUNDS):
        bounds = tuple(float(b) for b in boundaries)
        if not bounds or list(bounds) != sorted(bounds):
            raise ValueError("sketch boundaries must be non-empty and sorted")
        self.boundaries = bounds
        # one bucket per boundary (value <= boundary) + explicit overflow
        self.counts: List[int] = [0] * (len(bounds) + 1)
        self.total = 0
        self.sum = 0.0
        self.max = 0.0

    # ------------------------------------------------------------- write
    def observe(self, value: float) -> None:
        value = float(value)
        idx = bisect_left(self.boundaries, value)
        self.counts[idx if idx < len(self.boundaries) else -1] += 1
        self.total += 1
        self.sum += value
        if value > self.max:
            self.max = value

    def merge(self, other: "LatencySketch") -> "LatencySketch":
        """Fold ``other`` into this sketch in place (and return self)."""
        if other.boundaries != self.boundaries:
            raise ValueError(
                f"cannot merge sketches over different boundaries "
                f"({len(self.boundaries)} vs {len(other.boundaries)} edges)"
            )
        for i, n in enumerate(other.counts):
            self.counts[i] += n
        self.total += other.total
        self.sum += other.sum
        if other.max > self.max:
            self.max = other.max
        return self

    # -------------------------------------------------------------- read
    def quantile(self, q: float) -> float:
        """Upper edge of the bucket holding rank ``ceil(q * total)``.

        Deterministic and monotonic in ``q``; the overflow bucket answers
        with the exact max seen (the one scalar cheap enough to track).
        Returns 0.0 on an empty sketch.
        """
        if self.total <= 0:
            return 0.0
        q = min(1.0, max(0.0, float(q)))
        # epsilon guards the float product: 0.99 * 100 is 99.000…01 in
        # IEEE and a bare ceil would bump the rank a full position
        rank = max(1, math.ceil(q * self.total - 1e-9))
        seen = 0
        for i, n in enumerate(self.counts):
            seen += n
            if seen >= rank:
                if i < len(self.boundaries):
                    return self.boundaries[i]
                return self.max
        return self.max

    def percentiles(self) -> Dict[str, float]:
        """The SLO trio + count/mean, as /api payloads report them."""
        mean = self.sum / self.total if self.total else 0.0
        return {
            "count": self.total,
            "mean": mean,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "max": self.max,
        }

    # -------------------------------------------------- wire (merge RPC)
    def to_dict(self) -> dict:
        return {
            "boundaries": list(self.boundaries),
            "counts": list(self.counts),
            "total": self.total,
            "sum": self.sum,
            "max": self.max,
        }

    @classmethod
    def from_dict(cls, data: dict) -> "LatencySketch":
        sk = cls(data["boundaries"])
        counts = list(data["counts"])
        if len(counts) != len(sk.counts):
            raise ValueError("sketch counts do not match boundaries")
        sk.counts = [int(n) for n in counts]
        sk.total = int(data["total"])
        sk.sum = float(data["sum"])
        sk.max = float(data.get("max", 0.0))
        return sk


def merged(sketches: Iterable[LatencySketch],
           boundaries: Sequence[float] = SERVING_LATENCY_BOUNDS) -> LatencySketch:
    """Merge any number of same-boundary sketches into a fresh one."""
    out = LatencySketch(boundaries)
    for sk in sketches:
        out.merge(sk)
    return out
