"""Request context: the deadline, tenant and request trace in scope.

The port's own copy of the contextvar half of ``ray_tpu/runtime/context.py``
(the task context and ``RuntimeContext`` need the runtime, which the port
does not have).  A serving ingress installs these around a request; the LLM
engine reads them at submit when the caller passes no explicit value.
Contextvars, not thread-locals: each asyncio task sees its own copy.
"""

from __future__ import annotations

import contextvars
import time
from typing import Optional

_deadline_ts: "contextvars.ContextVar[Optional[float]]" = contextvars.ContextVar(
    "rt_deadline_ts", default=None
)


def push_deadline(deadline_ts: Optional[float]):
    """Install the absolute deadline (wall-clock seconds) in scope; returns a
    token for :func:`pop_deadline`.  None is a no-op install."""
    return _deadline_ts.set(deadline_ts)


def pop_deadline(token) -> None:
    try:
        _deadline_ts.reset(token)
    except ValueError:
        pass  # token from another Context copy (async hand-off)


def current_deadline_ts() -> Optional[float]:
    return _deadline_ts.get()


def remaining_budget(default: Optional[float] = None) -> Optional[float]:
    """Seconds left on the deadline in scope, or ``default`` when there is
    none.  Never negative: an expired budget returns 0."""
    ts = _deadline_ts.get()
    if ts is None:
        return default
    return max(0.0, ts - time.time())


_tenant_id: "contextvars.ContextVar[Optional[str]]" = contextvars.ContextVar(
    "rt_tenant_id", default=None
)


def push_tenant(tenant: Optional[str]):
    """Install the requesting tenant id; returns a token for
    :func:`pop_tenant`.  None is a no-op install."""
    return _tenant_id.set(tenant)


def pop_tenant(token) -> None:
    try:
        _tenant_id.reset(token)
    except ValueError:
        pass  # token from another Context copy (async hand-off)


def current_tenant(default: Optional[str] = None) -> Optional[str]:
    tenant = _tenant_id.get()
    return tenant if tenant is not None else default


_request_trace: "contextvars.ContextVar[Optional[object]]" = contextvars.ContextVar(
    "rt_request_trace", default=None
)


def push_request_trace(trace):
    """Install the in-flight request's trace (``observability.reqtrace``);
    returns a token for :func:`pop_request_trace`.  None is a no-op install."""
    return _request_trace.set(trace)


def pop_request_trace(token) -> None:
    try:
        _request_trace.reset(token)
    except ValueError:
        pass  # token from another Context copy (async hand-off)


def current_request_trace():
    return _request_trace.get()
