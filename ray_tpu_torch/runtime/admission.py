"""Admission control for the serving engine: typed sheds and fair queuing.

The port's own copy of the part of ``ray_tpu/runtime/admission.py`` that the
serving path uses (the port imports nothing of ``ray_tpu``):

  * :func:`shed` / :func:`record_shed` — the one way a layer rejects: build
    the typed :class:`OverloadedError`, count
    ``requests_shed_total{layer,reason}`` and the process totals, and
    flight-record the shed (throttled per layer and reason).  The JAX
    package also appends each shed to its cluster's overload log when a
    runtime is up; the port has no runtime, so there is no log to append to.
  * :func:`tenant_tags` / :func:`tenant_label` — bounded tenant metric
    labels (the first ``MAX_TENANT_LABELS`` ids, then ``"other"``).
  * :func:`register_admission_source` / :func:`sources_snapshot` — layers
    with live queues (LLM engines) register a snapshot callable.
  * :class:`WeightedFairQueue` — tenant-keyed weighted fair queuing (stride
    scheduling over per-tenant FIFOs; deterministic).
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.exceptions import OverloadedError
from ray_tpu_torch.observability import metric_defs

_stats_lock = threading.Lock()
_shed_totals: Dict[Tuple[str, str], int] = {}


def shed(
    layer: str,
    reason: str,
    *,
    retry_after_s: Optional[float] = None,
    message: Optional[str] = None,
) -> OverloadedError:
    """Build (and fully account) the typed shed error for ``layer``; the
    caller raises it."""
    if retry_after_s is None:
        retry_after_s = get_config().overload_retry_after_s
    record_shed(layer, reason)
    return OverloadedError(layer, reason, retry_after_s, message)


def record_shed(layer: str, reason: str) -> None:
    """Account a shed whose typed signal the caller raises itself (e.g. an
    expired-deadline shed that surfaces ``DeadlineExceededError``)."""
    metric_defs.REQUESTS_SHED.inc(tags={"layer": layer, "reason": reason})
    with _stats_lock:
        key = (layer, reason)
        _shed_totals[key] = _shed_totals.get(key, 0) + 1
    # flight-record the shed, throttled per (layer, reason) so a shed storm
    # costs one snapshot a second, not one per rejected request
    try:
        from ray_tpu_torch.observability import reqtrace

        if reqtrace.snapshot_due(f"shed:{layer}:{reason}"):
            reqtrace.flight_record(
                "request_shed",
                f"admission shed at {layer}: {reason}",
                severity="WARNING",
                state={"shed_totals": shed_totals()},
                layer=layer,
                reason=reason,
            )
    except Exception:  # noqa: BLE001 — observability must never fail a shed
        pass


def shed_totals() -> Dict[str, Dict[str, int]]:
    """{layer: {reason: count}} lifetime shed totals for this process."""
    out: Dict[str, Dict[str, int]] = {}
    with _stats_lock:
        for (layer, reason), n in _shed_totals.items():
            out.setdefault(layer, {})[reason] = n
    return out


# bounded tenant metric labels: tenant ids are client-supplied, and every
# distinct tag value mints a permanent metric series.  The first
# MAX_TENANT_LABELS distinct ids get their own series; the rest aggregate
# under "other" (per-tenant truth stays in the fair-queue snapshots).
MAX_TENANT_LABELS = 64
_tenant_labels_lock = threading.Lock()
_tenant_tags: Dict[str, Dict[str, str]] = {}
_DEFAULT_TENANT_TAGS = {"tenant": "default"}
_OTHER_TENANT_TAGS = {"tenant": "other"}


def tenant_tags(tenant: Optional[str]) -> Dict[str, str]:
    """Prebuilt (cached) metric tags dict for a tenant; the lock is taken
    only on the first sight of a new tenant."""
    if not tenant:
        return _DEFAULT_TENANT_TAGS
    tags = _tenant_tags.get(tenant)
    if tags is not None:
        return tags
    with _tenant_labels_lock:
        tags = _tenant_tags.get(tenant)
        if tags is None and len(_tenant_tags) < MAX_TENANT_LABELS:
            tags = _tenant_tags[tenant] = {"tenant": tenant}
    return tags if tags is not None else _OTHER_TENANT_TAGS


def tenant_label(tenant: Optional[str]) -> str:
    return tenant_tags(tenant)["tenant"]


# admission sources: layers with live queues register a snapshot callable
_sources_lock = threading.Lock()
_sources: "OrderedDict[int, Tuple[str, Callable[[], dict]]]" = OrderedDict()


def register_admission_source(name: str, snapshot_fn: Callable[[], dict]) -> int:
    """Register a snapshot callable; returns its token.  Tokens are the
    smallest free integer, not a counter: they label metric series (one
    gauge series per live engine), so a process replacing engines reuses
    labels and the series stay bounded by the engines alive at once."""
    with _sources_lock:
        token = 1
        while token in _sources:
            token += 1
        _sources[token] = (name, snapshot_fn)
        return token


def unregister_admission_source(token: int) -> None:
    with _sources_lock:
        _sources.pop(token, None)


def sources_snapshot() -> List[dict]:
    with _sources_lock:
        items = list(_sources.values())
    out = []
    for name, fn in items:
        try:
            snap = fn()
        except Exception as exc:  # noqa: BLE001 — a dying source must not fail the snapshot
            snap = {"error": f"{type(exc).__name__}: {exc}"}
        out.append({"source": name, **snap})
    return out


class WeightedFairQueue:
    """Per-tenant FIFOs popped by stride scheduling.

    Each tenant accrues virtual time ``1/weight`` per pop; the next pop
    serves the non-empty tenant with the smallest virtual time (FIFO within
    a tenant).  Deterministic — same push/pop sequence, same order.  A
    tenant joining late starts at the current minimum virtual time (it
    cannot replay the past to monopolize the queue).  Not thread-safe:
    callers hold their own admission lock around every operation."""

    DEFAULT = "default"

    def __init__(self, weights: Optional[Dict[str, float]] = None):
        self._weights = {k: float(v) for k, v in (weights or {}).items() if v > 0}
        self._queues: "OrderedDict[str, deque]" = OrderedDict()
        self._vtime: Dict[str, float] = {}
        # global virtual clock: the vtime of the last served item.  Every
        # push onto an EMPTY queue floors that tenant's vtime here, so a
        # late joiner cannot replay the past, and a tenant returning from
        # idle is not punished for its old activity.
        self._vclock = 0.0
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def _weight(self, tenant: str) -> float:
        return self._weights.get(tenant, 1.0)

    def push(self, item: Any, tenant: Optional[str] = None) -> None:
        tenant = tenant or self.DEFAULT
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = deque()
        if not q:
            self._vtime[tenant] = max(self._vtime.get(tenant, 0.0), self._vclock)
        q.append(item)
        self._len += 1

    def pop(self) -> Optional[Any]:
        """Next item in weighted fair order; None when empty."""
        best = None
        for tenant, q in self._queues.items():
            if not q:
                continue
            vt = self._vtime.get(tenant, 0.0)
            if best is None or vt < best[0]:
                best = (vt, tenant)
        if best is None:
            return None
        vt, tenant = best
        q = self._queues[tenant]
        item = q.popleft()
        self._vclock = max(self._vclock, vt)
        self._vtime[tenant] = self._vtime.get(tenant, 0.0) + 1.0 / self._weight(tenant)
        self._len -= 1
        if not q and tenant not in self._weights:
            # prune drained ad-hoc tenants: tenant ids are client-supplied,
            # so the queue must not grow with distinct ids.  Configured-
            # weight tenants keep their vtime (a bounded set).
            del self._queues[tenant]
            self._vtime.pop(tenant, None)
        return item

    def remove(self, item: Any) -> bool:
        for tenant, q in list(self._queues.items()):
            try:
                q.remove(item)
            except ValueError:
                continue
            self._len -= 1
            if not q and tenant not in self._weights:
                del self._queues[tenant]
                self._vtime.pop(tenant, None)
            return True
        return False

    def drain(self) -> List[Any]:
        """Pop everything (FIFO per tenant, tenants interleaved fairly)."""
        out = []
        while True:
            item = self.pop()
            if item is None:
                return out
            out.append(item)

    def items(self) -> List[Any]:
        """Non-destructive snapshot (per-tenant FIFO order)."""
        return [item for q in self._queues.values() for item in q]

    def depth_by_tenant(self) -> Dict[str, int]:
        return {t: len(q) for t, q in self._queues.items() if q}
