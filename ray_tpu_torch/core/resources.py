"""Resource accounting with fixed-point arithmetic.

The port's copy of ``ray_tpu/core/resources.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Parity with the reference (``src/ray/common/scheduling/fixed_point.h`` and
``cluster_resource_data.h:36``): resource quantities are stored as integer
milli-units so fractional requests (e.g. ``num_cpus=0.5``) never accumulate
floating-point drift.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

SCALE = 1000  # milli-units


def to_fixed(value: float) -> int:
    return round(value * SCALE)


def from_fixed(value: int) -> float:
    return value / SCALE


class ResourceSet:
    """A bag of named resource quantities in fixed-point units."""

    __slots__ = ("_r",)

    def __init__(self, resources: Mapping[str, float] | None = None, *, _fixed: Dict[str, int] | None = None):
        if _fixed is not None:
            self._r = _fixed
        else:
            self._r = {k: to_fixed(v) for k, v in (resources or {}).items() if v != 0}

    @classmethod
    def from_fixed_dict(cls, fixed: Dict[str, int]) -> "ResourceSet":
        return cls(_fixed={k: v for k, v in fixed.items() if v != 0})

    def to_dict(self) -> Dict[str, float]:
        return {k: from_fixed(v) for k, v in self._r.items()}

    def fixed(self) -> Dict[str, int]:
        return dict(self._r)

    def get(self, name: str) -> float:
        return from_fixed(self._r.get(name, 0))

    def is_empty(self) -> bool:
        return not self._r

    def names(self) -> Iterable[str]:
        return self._r.keys()

    # -- arithmetic --------------------------------------------------------
    def fits(self, available: "ResourceSet") -> bool:
        return all(available._r.get(k, 0) >= v for k, v in self._r.items())

    def __add__(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._r)
        for k, v in other._r.items():
            out[k] = out.get(k, 0) + v
        return ResourceSet.from_fixed_dict(out)

    def __sub__(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._r)
        for k, v in other._r.items():
            out[k] = out.get(k, 0) - v
        return ResourceSet.from_fixed_dict(out)

    def __eq__(self, other):
        return isinstance(other, ResourceSet) and self._r == other._r

    def __repr__(self):
        return f"ResourceSet({self.to_dict()})"


class ResourcePool:
    """Total/available pair with acquire/release (LocalResourceManager parity,
    src/ray/raylet/scheduling/local_resource_manager.h:54).

    Internally locked: callers reach this pool from scheduler threads, task
    completion callbacks, and actor-creation retry threads concurrently.
    """

    def __init__(self, total: Mapping[str, float]):
        import threading

        self._lock = threading.Lock()
        self.total = ResourceSet(total)
        self._available = dict(self.total.fixed())

    @property
    def available(self) -> ResourceSet:
        with self._lock:
            return ResourceSet.from_fixed_dict(dict(self._available))

    def can_acquire(self, request: ResourceSet) -> bool:
        with self._lock:
            return all(self._available.get(k, 0) >= v for k, v in request.fixed().items())

    def acquire(self, request: ResourceSet) -> bool:
        req = request.fixed()
        with self._lock:
            if not all(self._available.get(k, 0) >= v for k, v in req.items()):
                return False
            for k, v in req.items():
                self._available[k] = self._available.get(k, 0) - v
            return True

    def release(self, request: ResourceSet) -> None:
        with self._lock:
            for k, v in request.fixed().items():
                total_k = self.total.fixed().get(k, 0)
                self._available[k] = min(self._available.get(k, 0) + v, total_k) if total_k else self._available.get(k, 0) + v

    def force_acquire(self, request: ResourceSet) -> None:
        """Deduct unconditionally (may go transiently negative).  Used when
        applying a head-authorized acquire on an agent's authoritative pool:
        the placement decision was already made against the head's view, so
        the agent must reflect it even mid-reconciliation."""
        with self._lock:
            for k, v in request.fixed().items():
                self._available[k] = self._available.get(k, 0) - v

    def add_capacity(self, extra: ResourceSet) -> None:
        """Grow the pool (used by placement-group bundle commit/return)."""
        with self._lock:
            self.total = self.total + extra
            for k, v in extra.fixed().items():
                self._available[k] = self._available.get(k, 0) + v

    def remove_capacity(self, extra: ResourceSet) -> None:
        with self._lock:
            self.total = self.total - extra
            for k, v in extra.fixed().items():
                self._available[k] = self._available.get(k, 0) - v

    def utilization(self) -> float:
        """Max utilization across dimensions (for the hybrid policy score)."""
        with self._lock:
            util = 0.0
            for k, total in self.total.fixed().items():
                if total <= 0:
                    continue
                used = total - self._available.get(k, 0)
                util = max(util, used / total)
            return util
