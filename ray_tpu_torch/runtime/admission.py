"""Admission control + load shedding: the overload-survival spine (ISSUE 9).

The port's copy of ``ray_tpu/runtime/admission.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Every waiting list between the HTTP proxy and the object store is bounded:
the serve router (``max_queued_requests``), the replica
(``max_ongoing_requests``), the LLM engine's waiting queue (count + prefill
token budget), core task submission (per-caller in-flight cap), the
scheduler's parked demand queue, and the object store's spill tier.  Load
beyond a bound **sheds** with a typed :class:`OverloadedError` carrying a
machine-readable ``retry_after_s`` — mapped to HTTP 429 + ``Retry-After``
(gRPC: RESOURCE_EXHAUSTED) at the proxies — instead of growing a queue
until something OOMs.  Reference parity: Serve's
``max_ongoing_requests``/``max_queued_requests`` rejection path
(``pow_2_scheduler.py:49``) and Data's backpressure policies
(``streaming_executor_state.py:503``).

This module holds the shared machinery:

  * :func:`shed` — the one way a layer rejects: builds the typed error,
    counts ``requests_shed_total{layer,reason}``, and audits the event on
    the cluster's bounded overload log (chaos invariant 11 reads it).
  * :class:`WeightedFairQueue` — tenant-keyed weighted fair queuing
    (stride scheduling over per-tenant FIFOs; deterministic, so seeded
    chaos runs stay byte-reproducible).  One hot tenant cannot starve the
    rest: pops interleave proportionally to configured weights.
  * :class:`AdmissionGate` — the per-caller in-flight task cap with
    block-or-shed policy (``max_inflight_tasks_per_caller``).
  * :func:`http_status_for` / :func:`grpc_code_for` — the one
    error→status mapping both proxies share, so it cannot drift.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    DeadlineExceededError,
    GetTimeoutError,
    OverloadedError,
    RayActorError,
    RayTaskError,
    StoreFullError,
    WorkerCrashedError,
)
from ray_tpu_torch.observability import metric_defs

# --------------------------------------------------------------------------
# shed accounting: process-global totals (served by /api/overload even when
# the shedding layer has no cluster attached) + the cluster audit log the
# chaos invariant sweep reads.
# --------------------------------------------------------------------------
_stats_lock = threading.Lock()
_shed_totals: Dict[Tuple[str, str], int] = {}


def shed(
    layer: str,
    reason: str,
    *,
    retry_after_s: Optional[float] = None,
    task_id: Optional[str] = None,
    message: Optional[str] = None,
) -> OverloadedError:
    """Build (and fully account) the typed shed error for ``layer``.

    Returns the error for the caller to raise — every rejection in the
    stack goes through here so the metric, the audit entry, and the typed
    signal can never diverge (invariant 11: every shed request got the
    typed signal)."""
    if retry_after_s is None:
        retry_after_s = get_config().overload_retry_after_s
    record_shed(layer, reason, task_id)
    return OverloadedError(layer, reason, retry_after_s, message)


def record_shed(layer: str, reason: str, task_id: Optional[str] = None) -> None:
    """Account a shed whose typed signal is raised by the caller itself
    (e.g. an expired-deadline shed that surfaces DeadlineExceededError)."""
    tags = {"layer": layer, "reason": reason}
    metric_defs.REQUESTS_SHED.inc(tags=tags)
    with _stats_lock:
        key = (layer, reason)
        _shed_totals[key] = _shed_totals.get(key, 0) + 1
    _audit({"layer": layer, "reason": reason, "task": task_id, "typed": True})
    # flight-record the shed into the structured event ring, throttled per
    # (layer, reason) so a shed storm costs one snapshot a second, not one
    # per rejected request
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


def _audit(event: dict) -> None:
    try:
        from ray_tpu_torch.api import get_cluster, is_initialized

        if is_initialized():
            get_cluster().record_overload_event(event)
    except Exception:  # noqa: BLE001 — auditing must never fail a shed
        pass


def shed_totals() -> Dict[str, Dict[str, int]]:
    """{layer: {reason: count}} lifetime shed totals for this process."""
    out: Dict[str, Dict[str, int]] = {}
    with _stats_lock:
        for (layer, reason), n in _shed_totals.items():
            out.setdefault(layer, {})[reason] = n
    return out


# --------------------------------------------------------------------------
# bounded tenant metric labels: tenant ids are CLIENT-supplied (the
# X-Tenant-Id header), and every distinct tag value mints a permanent metric
# series — the overload-protection layer must not itself grow unboundedly.
# The first MAX_TENANT_LABELS distinct ids get their own series; the rest
# aggregate under "other" (per-tenant truth stays in the WFQ snapshots).
# --------------------------------------------------------------------------
MAX_TENANT_LABELS = 64
_tenant_labels_lock = threading.Lock()
_tenant_tags: Dict[str, Dict[str, str]] = {}
_DEFAULT_TENANT_TAGS = {"tenant": "default"}
_OTHER_TENANT_TAGS = {"tenant": "other"}


def tenant_tags(tenant: Optional[str]) -> Dict[str, str]:
    """Prebuilt (cached) metric tags dict for a tenant — the routed-request
    hot path takes the lock only on FIRST sight of a new tenant (the cache
    is append-only and GIL-safe to read)."""
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


# --------------------------------------------------------------------------
# admission sources: layers with live queues (LLM engines, routers) register
# a snapshot callable so GET /api/overload can show per-layer depth/bounds
# without the dashboard knowing every subsystem.
# --------------------------------------------------------------------------
_sources_lock = threading.Lock()
_sources: "OrderedDict[int, Tuple[str, Callable[[], dict]]]" = OrderedDict()


def register_admission_source(name: str, snapshot_fn: Callable[[], dict]) -> int:
    with _sources_lock:
        # smallest FREE token, not a monotonic counter: tokens label metric
        # series (one gauge series per live engine), and a long-lived serve
        # process replacing replicas must reuse labels — cardinality stays
        # bounded by the max CONCURRENT sources, not total ever created
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
        except Exception as exc:  # noqa: BLE001 — a dying source must not 500 the API
            snap = {"error": f"{type(exc).__name__}: {exc}"}
        out.append({"source": name, **snap})
    return out


# --------------------------------------------------------------------------
# weighted fair queuing (tenant-keyed)
# --------------------------------------------------------------------------
class WeightedFairQueue:
    """Per-tenant FIFOs popped by stride scheduling.

    Each tenant accrues virtual time ``1/weight`` per pop; the next pop
    serves the non-empty tenant with the smallest virtual time (FIFO within
    a tenant).  Deterministic — same push/pop sequence, same order — so
    seeded chaos schedules stay byte-reproducible.  A tenant joining late
    starts at the current minimum virtual time (it cannot replay the past
    to monopolize the queue).  Not thread-safe: callers hold their own
    admission lock around every operation (the LLM engine already
    serializes queue access under its lock)."""

    DEFAULT = "default"

    def __init__(self, weights: Optional[Dict[str, float]] = None):
        self._weights = {k: float(v) for k, v in (weights or {}).items() if v > 0}
        self._queues: "OrderedDict[str, deque]" = OrderedDict()
        self._vtime: Dict[str, float] = {}
        # global virtual clock: the vtime of the last served item.  Every
        # push onto an EMPTY queue floors that tenant's vtime here, so (a)
        # a late joiner cannot replay the past, and (b) a tenant that
        # drained and went idle is not punished for its old activity when
        # it returns (its stale high vtime would otherwise starve it
        # against a fresh tenant starting at 0).
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
            # prune drained ad-hoc tenants: tenant ids are CLIENT-supplied
            # (the X-Tenant-Id header), and the overload-protection layer
            # must not itself grow unboundedly with distinct ids.  A
            # re-push rejoins at the live vtime floor (the late-joiner
            # rule), so cycling a tenant buys at most one stride.
            # Configured-weight tenants keep their vtime (bounded set).
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
                # same ad-hoc-tenant pruning as pop(): abandoned streams
                # removing queued entries must not leak client-supplied ids
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


# --------------------------------------------------------------------------
# per-caller in-flight task cap (core submission layer)
# --------------------------------------------------------------------------
class AdmissionGate:
    """Bounds in-flight (submitted, not yet terminal) normal tasks per
    caller.  ``max_inflight_tasks_per_caller = 0`` disables (the fast path
    is one config read).  Release is keyed by task id and idempotent — a
    hedged clone committing for its primary, or a racing double commit,
    can never double-release."""

    def __init__(self):
        self._cv = threading.Condition()
        self._counts: Dict[Any, int] = {}
        self._outstanding: Dict[bytes, Any] = {}  # task_id binary -> caller key
        self.sheds = 0
        self.blocks = 0

    def admit(self, caller_key: Any, task_id_bin: bytes, deadline_budget: Optional[float]) -> None:
        """Admit one submission or raise :class:`OverloadedError`.

        ``deadline_budget``: the caller's remaining deadline seconds (the
        block wait never outlives the task's own budget)."""
        cfg = get_config()
        cap = cfg.max_inflight_tasks_per_caller
        if cap <= 0:
            return
        with self._cv:
            if self._counts.get(caller_key, 0) < cap:
                self._admit_locked(caller_key, task_id_bin)
                return
            if cfg.task_submit_overload_policy == "shed":
                self.sheds += 1
                raise shed(
                    "submission", "inflight_cap", task_id=task_id_bin.hex(),
                    message=(
                        f"caller has {cap} tasks in flight "
                        "(max_inflight_tasks_per_caller)"
                    ),
                )
            # block policy: wait for a slot, bounded by the block timeout
            # AND the caller's remaining deadline budget
            timeout = cfg.task_submit_block_timeout_s
            if deadline_budget is not None:
                timeout = min(timeout, max(0.0, deadline_budget))
            deadline = time.monotonic() + timeout
            self.blocks += 1
            while self._counts.get(caller_key, 0) >= cap:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self.sheds += 1
                    raise shed(
                        "submission", "block_timeout", task_id=task_id_bin.hex(),
                        message=(
                            f"blocked {timeout:.2f}s at the per-caller "
                            f"in-flight cap ({cap}) without a slot freeing"
                        ),
                    )
                self._cv.wait(remaining)
            self._admit_locked(caller_key, task_id_bin)

    def _admit_locked(self, caller_key: Any, task_id_bin: bytes) -> None:
        self._counts[caller_key] = self._counts.get(caller_key, 0) + 1
        self._outstanding[task_id_bin] = caller_key
        # aggregate across callers — a per-caller value would be clobbered
        # by whichever caller touched the gauge last
        metric_defs.ADMISSION_QUEUE_DEPTH.set(
            len(self._outstanding), _SUBMISSION_TAGS
        )

    def release(self, task_id_bin: bytes) -> None:
        with self._cv:
            caller_key = self._outstanding.pop(task_id_bin, None)
            if caller_key is None:
                return  # never gated, or already released (hedge twin)
            n = self._counts.get(caller_key, 0) - 1
            if n > 0:
                self._counts[caller_key] = n
            else:
                self._counts.pop(caller_key, None)
            metric_defs.ADMISSION_QUEUE_DEPTH.set(
                len(self._outstanding), _SUBMISSION_TAGS
            )
            self._cv.notify_all()

    def snapshot(self) -> dict:
        cfg = get_config()
        with self._cv:
            return {
                "cap": cfg.max_inflight_tasks_per_caller,
                "policy": cfg.task_submit_overload_policy,
                "callers": len(self._counts),
                "inflight": sum(self._counts.values()),
                "max_caller_inflight": max(self._counts.values(), default=0),
                "blocks": self.blocks,
                "sheds": self.sheds,
            }


_SUBMISSION_TAGS = {"layer": "submission"}


# --------------------------------------------------------------------------
# error -> status mapping (shared by the HTTP and gRPC proxies)
# --------------------------------------------------------------------------
def unwrap(exc: BaseException) -> BaseException:
    """A typed error raised inside a replica crosses the actor boundary
    wrapped in RayTaskError; the status mapping keys on the cause."""
    cause = getattr(exc, "cause", None)
    if isinstance(exc, RayTaskError) and isinstance(cause, BaseException):
        return cause
    return exc


def http_status_for(exc: BaseException) -> Tuple[int, Optional[float]]:
    """(status code, retry_after_s hint or None) for one request failure.

    The contract (regression-tested in tests/test_overload.py):
      OverloadedError / StoreFullError -> 429 / 503 with Retry-After,
      DeadlineExceededError / timeout  -> 504,
      actor or worker death (after the retry budget) -> 503,
      anything else -> 500.
    """
    exc = unwrap(exc)
    if isinstance(exc, OverloadedError):
        return 429, exc.retry_after_s
    if isinstance(exc, StoreFullError):
        return 503, get_config().overload_retry_after_s
    if isinstance(exc, (DeadlineExceededError, GetTimeoutError)):
        return 504, None
    if isinstance(exc, (RayActorError, ActorDiedError, WorkerCrashedError)):
        return 503, None
    return 500, None


def grpc_code_for(exc: BaseException) -> Tuple[str, Optional[float]]:
    """(grpc.StatusCode attribute name, retry_after_s hint) — name-based so
    this module never imports grpc."""
    exc = unwrap(exc)
    if isinstance(exc, OverloadedError):
        return "RESOURCE_EXHAUSTED", exc.retry_after_s
    if isinstance(exc, StoreFullError):
        return "RESOURCE_EXHAUSTED", get_config().overload_retry_after_s
    if isinstance(exc, (DeadlineExceededError, GetTimeoutError)):
        return "DEADLINE_EXCEEDED", None
    if isinstance(exc, (RayActorError, ActorDiedError, WorkerCrashedError)):
        return "UNAVAILABLE", None
    return "INTERNAL", None
