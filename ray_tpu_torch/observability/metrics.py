"""Metric registry with Prometheus text exposition.

The port's own copy of ``ray_tpu/observability/metrics.py``: counters,
gauges and fixed-bucket histograms keyed by tag sets, one process-global
registry, and ``render_prometheus`` whose text is byte-equal to the JAX
package's after the same operations (float formatting by ``_fnum``, label
escaping by ``_escape``).
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

TagMap = Tuple[Tuple[str, str], ...]


def _tagkey(tags: Optional[Dict[str, str]]) -> TagMap:
    if not tags:
        return ()
    return tuple(sorted(tags.items()))


class Metric:
    """Base: a named family of time series, one per unique tag set."""

    kind = "untyped"

    def __init__(self, name: str, description: str = "", unit: str = ""):
        self.name = name
        self.description = description
        self.unit = unit
        self._lock = threading.Lock()
        self._series: Dict[TagMap, float] = {}

    def series(self) -> List[Tuple[TagMap, float]]:
        with self._lock:
            return list(self._series.items())


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None) -> None:
        key = _tagkey(tags)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def get(self, tags: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._series.get(_tagkey(tags), 0.0)


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._series[_tagkey(tags)] = float(value)

    def get(self, tags: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._series.get(_tagkey(tags), 0.0)


class Histogram(Metric):
    """Fixed-bucket histogram (Prometheus cumulative-bucket semantics).

    ``counts`` carries ``len(boundaries) + 1`` entries: one per finite
    boundary plus an explicit overflow bucket for values above the largest
    boundary, so ``sum(counts) == total`` always holds."""

    kind = "histogram"

    def __init__(self, name: str, description: str = "", unit: str = "", boundaries: Sequence[float] = ()):
        super().__init__(name, description, unit)
        self.boundaries = sorted(boundaries) or [0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 60]
        self._counts: Dict[TagMap, List[int]] = {}
        self._sums: Dict[TagMap, float] = {}
        self._totals: Dict[TagMap, int] = {}

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None) -> None:
        key = _tagkey(tags)
        # binary search, not a linear scan: this sits on the per-token
        # serving hot path (inter-token/TTFT families observe every token).
        # bisect_left is bucket-for-bucket identical to the old `value <= b`
        # scan: first boundary >= value, len(boundaries) = overflow.
        idx = bisect.bisect_left(self.boundaries, value)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * (len(self.boundaries) + 1))
            counts[idx if idx < len(self.boundaries) else -1] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def snapshot(self, tags: Optional[Dict[str, str]] = None):
        key = _tagkey(tags)
        with self._lock:
            return (
                list(self._counts.get(key, [])),
                self._sums.get(key, 0.0),
                self._totals.get(key, 0),
            )

    def histogram_series(self):
        with self._lock:
            return [
                (key, list(counts), self._sums.get(key, 0.0), self._totals.get(key, 0))
                for key, counts in self._counts.items()
            ]


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def counter(self, name: str, description: str = "", unit: str = "") -> Counter:
        return self._get_or_create(name, Counter, description, unit)

    def gauge(self, name: str, description: str = "", unit: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, description, unit)

    def histogram(self, name: str, description: str = "", unit: str = "", boundaries: Sequence[float] = ()) -> Histogram:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Histogram(name, description, unit, boundaries)
                self._metrics[name] = m
            if not isinstance(m, Histogram):
                raise TypeError(f"metric {name!r} already registered as {m.kind}")
            return m

    def _get_or_create(self, name, cls, description, unit):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, description, unit)
                self._metrics[name] = m
            if not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as {m.kind}")
            return m

    def all_metrics(self) -> List[Metric]:
        with self._lock:
            return list(self._metrics.values())

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    # ------------------------------------------------------------------
    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        for m in self.all_metrics():
            full = f"ray_tpu_{m.name}"
            if m.description:
                help_text = m.description.replace("\\", "\\\\").replace("\n", "\\n")
                lines.append(f"# HELP {full} {help_text}")
            lines.append(f"# TYPE {full} {m.kind}")
            if isinstance(m, Histogram):
                for key, counts, total_sum, total in m.histogram_series():
                    cum = 0
                    for b, c in zip(m.boundaries, counts):
                        cum += c
                        lines.append(f"{full}_bucket{_labels(key, ('le', _fnum(b)))} {cum}")
                    lines.append(f"{full}_bucket{_labels(key, ('le', '+Inf'))} {total}")
                    lines.append(f"{full}_sum{_labels(key)} {total_sum}")
                    lines.append(f"{full}_count{_labels(key)} {total}")
            else:
                for key, value in m.series():
                    lines.append(f"{full}{_labels(key)} {value}")
        return "\n".join(lines) + "\n"


def _fnum(x: float) -> str:
    return f"{x:g}"


def _escape(value: str) -> str:
    """Label-value escaping per the exposition spec: backslash, quote, newline."""
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels(key: TagMap, extra: Optional[Tuple[str, str]] = None) -> str:
    """Render a `{k="v",...}` label suffix ("" when empty) with escaping."""
    items = list(key) + ([extra] if extra else [])
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape(str(v))}"' for k, v in items) + "}"


_global = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    return _global


class timed:
    """Context manager observing wall time into a histogram."""

    def __init__(self, hist: Histogram, tags: Optional[Dict[str, str]] = None):
        self.hist = hist
        self.tags = tags

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.perf_counter() - self._t0, self.tags)
        return False
