"""Per-thread execution context: which task/node is currently executing.

The port's copy of ``ray_tpu/runtime/context.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Parity with the reference's ``python/ray/runtime_context.py`` plus the
worker's current-task tracking — used so nested submissions and ``put``s are
attributed to the running task (ObjectIDs embed the creating TaskID).
"""

from __future__ import annotations

import contextvars
from typing import Optional, Tuple

from ray_tpu_torch.core.ids import JobID, NodeID, TaskID

# contextvars, not threading.local: per-thread for sync execution (same
# semantics as before), but ALSO copied into every asyncio Task — so async
# actor methods interleaving on one event-loop thread each see their own
# task context instead of whichever one pushed last.
_stack: "contextvars.ContextVar[tuple]" = contextvars.ContextVar("rt_task_stack", default=())


class _TaskContext:
    def push(self, task_id: TaskID, node_id: NodeID):
        return _stack.set(_stack.get() + ((task_id, node_id),))

    def pop(self, token) -> None:
        try:
            _stack.reset(token)
        except ValueError:
            # token from another Context copy (async hand-off): nothing to
            # unwind here — that copy dies with its Task
            pass

    def current(self) -> Optional[Tuple[TaskID, NodeID]]:
        stack = _stack.get()
        return stack[-1] if stack else None


task_context = _TaskContext()


# --------------------------------------------------------------------------
# end-to-end deadline propagation (.options(deadline_s=...)): the executing
# task's absolute deadline rides a contextvar so nested submissions inherit
# the REMAINING budget (min'd with their own) and deadline-bearing blocking
# calls can pass it instead of flat defaults.  Crosses process boundaries by
# riding the worker payload (worker_main re-installs it around execution).
# --------------------------------------------------------------------------
_deadline_ts: "contextvars.ContextVar[Optional[float]]" = contextvars.ContextVar(
    "rt_deadline_ts", default=None
)


def push_deadline(deadline_ts: Optional[float]):
    """Install the executing task's absolute deadline (wall-clock seconds);
    returns a token for :func:`pop_deadline`.  None is a no-op install so
    callers need no branching."""
    return _deadline_ts.set(deadline_ts)


def pop_deadline(token) -> None:
    try:
        _deadline_ts.reset(token)
    except ValueError:
        pass  # token from another Context copy (async hand-off)


def current_deadline_ts() -> Optional[float]:
    return _deadline_ts.get()


def remaining_budget(default: Optional[float] = None) -> Optional[float]:
    """Seconds left on the executing task's deadline, or ``default`` when
    no deadline is in scope.  Never negative (an expired budget returns 0
    so blocking calls fail fast instead of hanging a full default)."""
    import time as _time

    ts = _deadline_ts.get()
    if ts is None:
        return default
    return max(0.0, ts - _time.time())


# --------------------------------------------------------------------------
# tenant propagation (overload survival, ISSUE 9): the serving ingress tags
# each request with a tenant id (HTTP header / gRPC metadata); it rides this
# contextvar through the serve handle and replica into every admission
# decision (weighted fair queuing at the LLM engine, per-tenant admission
# counters) so one hot tenant cannot starve the rest.
# --------------------------------------------------------------------------
_tenant_id: "contextvars.ContextVar[Optional[str]]" = contextvars.ContextVar(
    "rt_tenant_id", default=None
)


def push_tenant(tenant: Optional[str]):
    """Install the requesting tenant id; returns a token for
    :func:`pop_tenant`.  None is a no-op install so callers need no
    branching."""
    return _tenant_id.set(tenant)


def pop_tenant(token) -> None:
    try:
        _tenant_id.reset(token)
    except ValueError:
        pass  # token from another Context copy (async hand-off)


def current_tenant(default: Optional[str] = None) -> Optional[str]:
    tenant = _tenant_id.get()
    return tenant if tenant is not None else default


# --------------------------------------------------------------------------
# request-trace propagation (request-scope observability, ISSUE 16): the
# proxy births a RequestTrace (observability/reqtrace.py) and it rides this
# contextvar alongside the tenant id so each layer can stamp its phase
# timestamps without new plumbing.  Like the tenant, it does NOT survive
# the router -> replica actor-call boundary (replicas run requests on pool
# threads) — the router passes it as an explicit argument and the replica
# re-installs it here around the callable invocation.
# --------------------------------------------------------------------------
_request_trace: "contextvars.ContextVar[Optional[object]]" = contextvars.ContextVar(
    "rt_request_trace", default=None
)


def push_request_trace(trace):
    """Install the in-flight request's trace record; returns a token for
    :func:`pop_request_trace`.  None is a no-op install so callers need no
    branching."""
    return _request_trace.set(trace)


def pop_request_trace(token) -> None:
    try:
        _request_trace.reset(token)
    except ValueError:
        pass  # token from another Context copy (async hand-off)


def current_request_trace():
    return _request_trace.get()


class RuntimeContext:
    """User-facing runtime context (ray.get_runtime_context() parity)."""

    def __init__(self, worker):
        self._worker = worker

    def get_job_id(self) -> str:
        return self._worker.job_id.hex()

    def get_node_id(self) -> str:
        current = task_context.current()
        if current is not None:
            return current[1].hex()
        return self._worker.head_node.node_id.hex()

    def get_task_id(self) -> Optional[str]:
        current = task_context.current()
        return current[0].hex() if current else None

    def get_actor_id(self) -> Optional[str]:
        current = task_context.current()
        if current is None:
            return None
        actor = current[0].actor_id()
        return None if actor.is_nil() else actor.hex()
