"""Exception hierarchy.

The port's copy of ``ray_tpu/exceptions.py`` (same classes, constructors,
messages and pickling), plus :class:`NotPortedError`, which the port raises
where it reaches a feature of the JAX package it has not taken yet.

Parity with the reference's ``python/ray/exceptions.py``: errors raised inside a
task are captured, stored as the task's result object, and re-raised at
``get()`` time wrapped in :class:`RayTaskError` so the full remote traceback is
visible at the caller.
"""

from __future__ import annotations

import traceback


class RayTpuError(Exception):
    """Base class for all framework errors."""


class RayTaskError(RayTpuError):
    """A task raised an exception; re-raised at the caller on get().

    Mirrors ``python/ray/exceptions.py:RayTaskError`` — carries the remote
    traceback text and the original cause.
    """

    def __init__(self, function_name: str, traceback_str: str, cause: BaseException | None = None):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(f"Task {function_name} failed:\n{traceback_str}")

    @classmethod
    def from_exception(cls, function_name: str, exc: BaseException) -> "RayTaskError":
        tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
        return cls(function_name, tb, exc)

    def __reduce__(self):
        # The cause may not be picklable (it crossed a process boundary as
        # text); the traceback string carries the information.
        return (_rebuild_task_error, (self.function_name, self.traceback_str, _maybe_picklable(self.cause)))


def _rebuild_task_error(function_name, traceback_str, cause):
    return RayTaskError(function_name, traceback_str, cause)


def _maybe_picklable(obj):
    import pickle

    if obj is None:
        return None
    try:
        pickle.dumps(obj)
        return obj
    except Exception:
        return None


class RayActorError(RayTpuError):
    """The actor died (creation failure, crash, or intentional kill)."""

    def __init__(self, actor_id=None, message: str = "The actor died unexpectedly."):
        self.actor_id = actor_id
        super().__init__(message)

    def __reduce__(self):
        # default Exception pickling replays __init__ with args=(message,),
        # which would land the message in actor_id; rebuild with both
        return (type(self), (self.actor_id, str(self)))


class ActorDiedError(RayActorError):
    pass


class ActorUnavailableError(RayActorError):
    """Actor is temporarily unreachable (restarting)."""


class ObjectLostError(RayTpuError):
    """Object could not be found or reconstructed."""

    def __init__(self, object_id, message: str | None = None):
        self.object_id = object_id
        super().__init__(message or f"Object {object_id} was lost and could not be reconstructed.")

    def __reduce__(self):
        return (type(self), (self.object_id, str(self)))


class ObjectReconstructionFailedError(ObjectLostError):
    pass


class OwnerDiedError(ObjectLostError):
    def __init__(self, object_id):
        super().__init__(object_id, f"The owner of object {object_id} has died.")

    def __reduce__(self):
        # narrower __init__ than the base: the message is derived, so only
        # object_id crosses the wire (the base reduce would TypeError)
        return (OwnerDiedError, (self.object_id,))


class GetTimeoutError(RayTpuError, TimeoutError):
    """ray_tpu_torch.get() timed out."""


class TaskCancelledError(RayTpuError):
    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__(f"Task {task_id} was cancelled.")

    def __reduce__(self):
        return (TaskCancelledError, (self.task_id,))


class DeadlineExceededError(RayTpuError):
    """An end-to-end task deadline (``.options(deadline_s=...)``) expired.

    ``stage`` names the lifecycle stage the task was in when the deadline
    fired — ``parked`` (demand queue), ``queued`` (node-local queue),
    ``pulling`` (dependency transfer), or ``executing``.  Deadline failures
    are terminal by design: a task that is already too late must never
    retry (retrying cannot un-miss the deadline), so this error bypasses
    every retry path including ``retry_exceptions``."""

    def __init__(self, task_name: str = "?", stage: str = "?", deadline_s: float | None = None):
        self.task_name = task_name
        self.stage = stage
        self.deadline_s = deadline_s
        budget = f"{deadline_s:.3f}s" if deadline_s is not None else "?"
        super().__init__(
            f"Task {task_name} exceeded its {budget} deadline while {stage}."
        )

    def __reduce__(self):
        return (DeadlineExceededError, (self.task_name, self.stage, self.deadline_s))


class FencedError(RayTpuError):
    """This agent's incarnation was fenced by the head: a newer incarnation
    of its node id registered (or the head declared this node dead while it
    was partitioned).  The agent must self-fence — kill workers, drop its
    store, clear lease pins — and rejoin as a fresh node; none of its
    in-flight commits will be accepted."""

    def __init__(self, node_id=None, incarnation: int | None = None):
        self.node_id = node_id
        self.incarnation = incarnation
        super().__init__(
            f"node incarnation {incarnation} is fenced; re-register as a fresh node"
        )

    def __reduce__(self):
        return (FencedError, (self.node_id, self.incarnation))


class OverloadedError(RayTpuError):
    """Admission control shed this request: a bounded queue at ``layer`` was
    full (or a per-caller cap was hit) and the request was rejected instead
    of growing the queue.  Machine-readable ``retry_after_s`` tells the
    caller when capacity is likely to exist again; the serve proxies map
    this to HTTP 429 with a ``Retry-After`` header (gRPC:
    RESOURCE_EXHAUSTED).  Shedding happens BEFORE any side effect — a shed
    request never executed and is always safe to retry after the hint."""

    def __init__(
        self,
        layer: str = "?",
        reason: str = "queue_full",
        retry_after_s: float = 1.0,
        message: str | None = None,
    ):
        self.layer = layer
        self.reason = reason
        self.retry_after_s = float(retry_after_s)
        super().__init__(
            message
            or f"overloaded at {layer} ({reason}); retry after {retry_after_s:.3g}s"
        )

    def __reduce__(self):
        # str(self) rides along so layer detail (which replica/queue) is
        # not lost crossing process/actor boundaries
        return (
            OverloadedError,
            (self.layer, self.reason, self.retry_after_s, str(self)),
        )


class StoreFullError(RayTpuError):
    """Every tier of the object store — host budget plus the bounded
    disk/spill tier — is full, and the put's backpressure deadline expired
    before deletions freed room.  The put committed NOTHING; the caller can
    free references and retry, or treat it as an overload signal."""

    def __init__(self, waited_s: float = 0.0, needed: int = 0, message: str | None = None):
        self.waited_s = float(waited_s)
        self.needed = int(needed)
        super().__init__(
            message
            or (
                f"object store full (spill tier at capacity); waited "
                f"{waited_s:.2f}s for {needed} bytes of room"
            )
        )

    def __reduce__(self):
        return (StoreFullError, (self.waited_s, self.needed, str(self)))


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died."""


class RuntimeEnvSetupError(RayTpuError):
    """Failed to set up the runtime environment for a task/actor."""


class PendingCallsLimitExceeded(RayTpuError):
    """Actor's pending-call queue is full (max_pending_calls)."""


class OutOfMemoryError(RayTpuError):
    """Object store / HBM capacity exhausted."""


class CollectiveGroupDeadError(RayTpuError):
    """A rank of an open collective group died: surviving ranks' waits fail
    immediately instead of running out the full rendezvous timeout
    (reference: pending actor calls fail atomically with the death notice,
    ``src/ray/core_worker/transport/direct_actor_task_submitter.h:120``)."""

    def __init__(self, group_name: str, reason: str = ""):
        self.group_name = group_name
        self.reason = reason
        super().__init__(
            f"collective group {group_name!r} lost a participant: {reason or 'rank died'}"
        )

    def __reduce__(self):
        return (CollectiveGroupDeadError, (self.group_name, self.reason))


class NotPortedError(RayTpuError, NotImplementedError):
    """The port reached a feature of the JAX package it does not have yet.
    ``feature`` names it and ``reference`` the JAX package's code for it;
    ROADMAP.md lists every such feature."""

    def __init__(self, feature: str, reference: str):
        self.feature = feature
        self.reference = reference
        super().__init__(
            f"{feature} is not ported to ray_tpu_torch yet "
            f"(JAX package: {reference}; see ROADMAP.md)"
        )

    def __reduce__(self):
        return (NotPortedError, (self.feature, self.reference))


def raised_copy(exc: BaseException) -> BaseException:
    """A fresh copy of a STORED exception, for raising at a caller.

    Error objects live in the object store (error tombstones, failed-task
    returns) and are served to every getter.  Raising the stored object
    itself attaches each caller's traceback to it — the store entry then
    pins those frames (and every local they reference: ref lists, values)
    for as long as the object lives.  Found by the chaos invariant sweep as
    a refcount "leak" after fault runs; the reference avoids it by
    reconstructing exceptions from their serialized form on every get.
    Falls back to the original object if the copy fails (uncopyable custom
    exception) — correctness over hygiene.
    """
    import copy

    try:
        fresh = copy.copy(exc)
        # copy re-invokes __init__ with args=(message,), which re-formats
        # classes that build their message from a non-message first arg —
        # restore the original args so str(copy) == str(original)
        fresh.args = exc.args
        fresh.__traceback__ = None
        # keep the cause chain visible without sharing OUR traceback back
        # into the stored object
        fresh.__cause__ = exc.__cause__
        return fresh
    except Exception:  # noqa: BLE001
        return exc
