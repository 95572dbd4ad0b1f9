"""User-facing metrics API (parity: ``ray.util.metrics`` — Counter/Gauge/
Histogram that application code defines and the runtime exports through the
same Prometheus endpoint as the system metrics; ``python/ray/util/metrics.py``
Metric.set_default_tags :104).

The port's copy of ``ray_tpu/util/metrics.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Thin wrappers over the shared registry: default tags set once merge under
per-record tags, exactly like the reference."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from ray_tpu_torch.observability.metrics import global_registry


class _UserMetric:
    def __init__(self, metric, tag_keys: Optional[Sequence[str]] = None):
        self._metric = metric
        self._tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}

    def set_default_tags(self, tags: Dict[str, str]):
        """Tags applied to every record unless overridden per call."""
        self._default_tags = dict(tags)
        return self

    def _merged(self, tags: Optional[Dict[str, str]]) -> Optional[Dict[str, str]]:
        merged = {**self._default_tags, **(tags or {})} or None
        if self._tag_keys and merged:
            unknown = set(merged) - set(self._tag_keys)
            if unknown:
                # declared tag_keys are a schema: a typo'd tag must error,
                # not export a stray series (reference Metric.record)
                raise ValueError(
                    f"unknown tag(s) {sorted(unknown)}; declared tag_keys "
                    f"are {list(self._tag_keys)}"
                )
        return merged

    @property
    def info(self) -> dict:
        return {
            "name": self._metric.name,
            "description": self._metric.description,
            "tag_keys": self._tag_keys,
            "default_tags": dict(self._default_tags),
        }


class Counter(_UserMetric):
    """Monotonic counter (parity: ray.util.metrics.Counter)."""

    def __init__(self, name: str, description: str = "", tag_keys: Optional[Sequence[str]] = None):
        super().__init__(global_registry().counter(name, description), tag_keys)

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None) -> None:
        if value <= 0:
            raise ValueError(f"Counter.inc requires value > 0, got {value}")
        self._metric.inc(value, tags=self._merged(tags))


class Gauge(_UserMetric):
    """Point-in-time value (parity: ray.util.metrics.Gauge)."""

    def __init__(self, name: str, description: str = "", tag_keys: Optional[Sequence[str]] = None):
        super().__init__(global_registry().gauge(name, description), tag_keys)

    def set(self, value: float, tags: Optional[Dict[str, str]] = None) -> None:
        self._metric.set(value, tags=self._merged(tags))


class Histogram(_UserMetric):
    """Distribution with bucket boundaries (parity: ray.util.metrics.Histogram)."""

    def __init__(
        self,
        name: str,
        description: str = "",
        boundaries: Optional[Sequence[float]] = None,
        tag_keys: Optional[Sequence[str]] = None,
    ):
        super().__init__(
            global_registry().histogram(name, description, boundaries=tuple(boundaries or ())),
            tag_keys,
        )

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None) -> None:
        self._metric.observe(value, tags=self._merged(tags))


__all__ = ["Counter", "Gauge", "Histogram"]
