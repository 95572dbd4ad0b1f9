"""Workflow events: durable external triggers.

The port's copy of ``ray_tpu/workflow/events.py``.

Parity: ``python/ray/workflow/event_listener.py`` (``EventListener`` with
``poll_for_event``) and ``api.wait_for_event`` — a workflow step that
blocks on an external event; the received payload is checkpointed like any
step result, so a resumed workflow replays the event value instead of
waiting again. ``HTTPEventProvider``'s role (push triggers) is covered by
:class:`QueueEventListener` + :func:`deliver_event`, which the dashboard's
job/REST surface can call into.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Optional


class EventListener:
    """Subclass and implement ``poll_for_event`` (may block)."""

    def poll_for_event(self, *args, **kwargs) -> Any:
        raise NotImplementedError

    def event_checkpointed(self, event: Any) -> None:
        """Ack hook: called after the event payload is durably stored."""


class TimerListener(EventListener):
    """Fires after ``seconds`` (parity: workflow TimerListener example)."""

    def poll_for_event(self, seconds: float) -> float:
        time.sleep(seconds)
        return time.time()


_event_queues: Dict[str, "queue.Queue[Any]"] = {}
_event_waiters: Dict[str, int] = {}
_event_lock = threading.Lock()


def _queue_for(name: str) -> "queue.Queue[Any]":
    with _event_lock:
        q = _event_queues.get(name)
        if q is None:
            q = _event_queues[name] = queue.Queue()
        return q


def has_waiters(name: str) -> bool:
    """True when at least one workflow is blocked on the channel (lets the
    HTTP trigger reject events nobody will consume instead of queueing
    them forever)."""
    with _event_lock:
        return _event_waiters.get(name, 0) > 0


def deliver_event(name: str, payload: Any) -> None:
    """Push an event to ONE workflow blocked on ``name`` (HTTP-trigger
    style: an external system calls this — e.g. via the dashboard REST).
    Each delivered payload resumes a single waiter."""
    _queue_for(name).put(payload)


class QueueEventListener(EventListener):
    """Listens on a named in-process event channel fed by
    :func:`deliver_event`."""

    def poll_for_event(self, name: str, timeout: Optional[float] = None) -> Any:
        with _event_lock:
            _event_waiters[name] = _event_waiters.get(name, 0) + 1
        try:
            return _queue_for(name).get(timeout=timeout)
        finally:
            with _event_lock:
                _event_waiters[name] = max(0, _event_waiters.get(name, 1) - 1)
                if _event_waiters[name] == 0 and _event_queues.get(name) is not None:
                    if _event_queues[name].empty():
                        del _event_queues[name]
                    _event_waiters.pop(name, None)


def wait_for_event(listener_or_cls, *args, **kwargs):
    """Build a workflow step that blocks on an event (parity:
    ``workflow.wait_for_event``). Returns a bound DAG node usable inside
    ``workflow.run`` graphs; the event payload checkpoints durably."""
    import ray_tpu_torch

    if isinstance(listener_or_cls, type):
        listener = listener_or_cls()
    else:
        listener = listener_or_cls

    def _await_event(*a, **kw):
        event = listener.poll_for_event(*a, **kw)
        listener.event_checkpointed(event)
        return event

    _await_event.__name__ = f"wait_for_{type(listener).__name__}"
    # execution="thread": the listener blocks on driver-process state (the
    # in-process event channels); a process worker would poll its own empty
    # registry. Blocking is fine — the inproc executor grows on demand.
    return ray_tpu_torch.remote(_await_event).options(execution="thread").bind(*args, **kwargs)
