"""Replica actor: hosts one copy of a deployment's callable.

The port's copy of ``ray_tpu/serve/replica.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Parity: ``python/ray/serve/_private/replica.py`` — wraps the user
function/class, counts ongoing requests (the router's pow-2 signal),
applies ``reconfigure`` (user_config), and reports health.
"""

from __future__ import annotations

import contextvars
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import ray_tpu_torch


@dataclass(frozen=True)
class ReplicaContext:
    """What a replica knows about itself (parity: serve.context
    ReplicaContext / serve.get_replica_context)."""

    deployment: str
    replica_tag: str
    app_name: str = "default"
    servable_object: Any = field(default=None, compare=False)


_replica_context: contextvars.ContextVar = contextvars.ContextVar(
    "rt_serve_replica_context", default=None
)


def get_replica_context() -> ReplicaContext:
    """Inside a replica (constructor or request), the replica's identity.
    Contextvar-scoped: replicas can share a process (inproc execution) and
    requests run on pool threads, so a module global would cross-talk."""
    ctx = _replica_context.get()
    if ctx is None:
        raise RuntimeError(
            "get_replica_context() may only be called from within a Serve "
            "replica (a deployment's constructor or request handler)"
        )
    return ctx


@ray_tpu_torch.remote
class ReplicaActor:
    def __init__(self, func_or_class, init_args, init_kwargs, user_config, is_function: bool,
                 deployment: str = "", replica_tag: str = "",
                 max_ongoing_requests: int = 0):
        self.is_function = is_function
        # replica-level admission backstop (0 = unlimited): the router's
        # queue bound is the primary gate, but a replica must defend itself
        # against stale routers too (parity: Serve replicas re-reject past
        # max_ongoing_requests)
        self._max_ongoing = int(max_ongoing_requests)
        self._context = ReplicaContext(deployment=deployment, replica_tag=replica_tag)
        token = _replica_context.set(self._context)
        try:
            if is_function:
                self.callable = func_or_class
            else:
                self.callable = func_or_class(*init_args, **init_kwargs)
                if user_config is not None and hasattr(self.callable, "reconfigure"):
                    self.callable.reconfigure(user_config)
        finally:
            _replica_context.reset(token)
        if not is_function:
            object.__setattr__(self._context, "servable_object", self.callable)
        self._ongoing = 0
        self._lock = threading.Lock()
        self._total = 0

    def handle_request(self, method: str, args: tuple, kwargs: dict,
                       tenant: str = None, trace=None) -> Any:
        from ray_tpu_torch.runtime.context import (
            pop_request_trace,
            pop_tenant,
            push_request_trace,
            push_tenant,
        )

        with self._lock:
            if self._max_ongoing > 0 and self._ongoing >= self._max_ongoing:
                from ray_tpu_torch.runtime import admission

                raise admission.shed(
                    "replica", "queue_full",
                    message=(
                        f"replica {self._context.replica_tag!r} at its "
                        f"max_ongoing_requests bound ({self._max_ongoing})"
                    ),
                )
            self._ongoing += 1
            self._total += 1
        token = _replica_context.set(self._context)
        # the requesting tenant rides proxy header -> handle -> HERE so
        # anything the deployment submits (e.g. LLMEngine admission) sees it
        tenant_token = push_tenant(tenant)
        # the request trace rode the router's explicit argument across the
        # actor boundary; re-install it so the engine stamps its phases
        if trace is not None:
            trace.mark("replica_in")
        trace_token = push_request_trace(trace)
        try:
            if self.is_function:
                return self.callable(*args, **kwargs)
            target = self.callable if method == "__call__" else getattr(self.callable, method)
            if method == "__call__" and not callable(target):
                raise TypeError(f"deployment class {type(self.callable)} is not callable")
            return target(*args, **kwargs) if method != "__call__" else self.callable(*args, **kwargs)
        finally:
            pop_request_trace(trace_token)
            pop_tenant(tenant_token)
            _replica_context.reset(token)
            with self._lock:
                self._ongoing -= 1

    def reconfigure(self, user_config) -> None:
        if not self.is_function and hasattr(self.callable, "reconfigure"):
            self.callable.reconfigure(user_config)

    # rt-lint: disable=lock-discipline -- autoscaler metric snapshot: a
    # torn counter read skews one poll, never request accounting
    def get_num_ongoing_requests(self) -> int:
        return self._ongoing

    # rt-lint: disable=lock-discipline -- same: observability snapshot
    def get_metrics(self) -> Dict[str, Any]:
        return {"ongoing": self._ongoing, "total": self._total}

    def check_health(self) -> str:
        if not self.is_function and hasattr(self.callable, "check_health"):
            self.callable.check_health()
        return "ok"
