"""Distributed task tracing: spans, trace-context propagation, export.

The port's copy of ``ray_tpu/observability/tracing.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Parity with the reference's tracing hooks (``python/ray/util/tracing/``
``tracing_helper.py`` — OpenTelemetry spans injected around ``.remote()``
submission and worker-side execution, with the trace context carried inside
the task spec) rebuilt without an OpenTelemetry dependency:

  * :class:`Span` — id/parent/trace ids plus wall-clock start/end.
  * a contextvar stack of the *current* span, so nested ``with span(...)``
    blocks and nested task submissions chain parent ids naturally (and async
    actor methods each see their own context, same rationale as
    ``runtime/context.py``).
  * **propagation**: ``task_trace_context()`` stamps a ``TaskSpec`` at
    ``.remote()`` time with ``(trace_id, task_span_id, parent_span_id)``;
    the tuple rides the spec to the scheduler and — for process workers —
    rides the exec/actor_call payload across the process boundary, where
    :class:`task_span` adopts it as the parent of the worker-side execute
    span.  Worker-side finished spans travel back in the result payload and
    land in the driver's span store.
  * export: finished spans become event dicts (``type == "span"``) that
    ``ray_tpu_torch.timeline()`` merges with task events and
    ``observability.timeline.chrome_trace`` renders as nested slices, one
    track group per trace.

The driver installs the control service's span store as the sink at
``init()`` (``api.init`` → :func:`set_span_sink`); processes without a sink
(pool workers) buffer locally and are drained into result payloads.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

#: event-dict marker distinguishing span records from task-state records in
#: the merged timeline stream
SPAN_EVENT_TYPE = "span"


def _new_id() -> str:
    return os.urandom(8).hex()


class TraceContext:
    """The minimal propagated unit: which trace, and which span is current."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id


# contextvars (not threading.local) for the same reason as runtime/context:
# per-thread for sync code, copied into asyncio Tasks for async actors.
_stack: "contextvars.ContextVar[tuple]" = contextvars.ContextVar("rt_trace_stack", default=())


def current_context() -> Optional[TraceContext]:
    stack = _stack.get()
    return stack[-1] if stack else None


def enabled() -> bool:
    from ray_tpu_torch.core.config import get_config

    return get_config().tracing_enabled


# --------------------------------------------------------------------------
# collection: sink on the driver, bounded local buffer everywhere else
# --------------------------------------------------------------------------
class _Collector:
    def __init__(self, maxlen: int = 100_000):
        self._lock = threading.Lock()
        self._sink: Optional[Callable[[dict], None]] = None
        self._buffer: deque = deque(maxlen=maxlen)

    def set_sink(self, sink: Optional[Callable[[dict], None]]) -> None:
        with self._lock:
            self._sink = sink
            # drop anything buffered: in sink-ful processes (drivers) the
            # buffer only ever holds strays from a PREVIOUS session (late
            # worker results after shutdown) — flushing them would leak
            # one session's spans into the next cluster's store
            self._buffer.clear()

    def record(self, event: dict) -> None:
        with self._lock:
            sink = self._sink
            if sink is None:
                self._buffer.append(event)
                return
        sink(event)

    def drain(self) -> List[dict]:
        with self._lock:
            out, self._buffer = list(self._buffer), deque(maxlen=self._buffer.maxlen)
        return out


_collector = _Collector()


def set_span_sink(sink: Optional[Callable[[dict], None]]) -> None:
    """Install (or clear, with None) the destination for finished spans —
    the driver points this at its control service's span store."""
    _collector.set_sink(sink)


def record_span_event(event: dict) -> None:
    _collector.record(event)


def record_span_events(events) -> None:
    for ev in events or ():
        _collector.record(ev)


def drain_span_events() -> List[dict]:
    """Take everything buffered locally (sink-less processes: pool workers
    hand these back in result payloads)."""
    return _collector.drain()


# --------------------------------------------------------------------------
# spans
# --------------------------------------------------------------------------
class Span:
    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start", "end", "attrs")

    def __init__(
        self,
        name: str,
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        start: Optional[float] = None,
        attrs: Optional[Dict[str, str]] = None,
    ):
        self.name = name
        self.trace_id = trace_id or _new_id()
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.start = time.time() if start is None else start
        self.end: Optional[float] = None
        self.attrs = attrs

    def context(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def set_attr(self, key: str, value) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = str(value)

    def to_event(self) -> dict:
        ev = {
            "type": SPAN_EVENT_TYPE,
            "state": "SPAN",  # timeline consumers index ev["state"] directly
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_ts": self.start,
            "ts": self.end if self.end is not None else time.time(),
            "pid": os.getpid(),
        }
        if self.attrs:
            ev["attrs"] = dict(self.attrs)
        return ev

    def finish(self, end: Optional[float] = None) -> dict:
        self.end = time.time() if end is None else end
        ev = self.to_event()
        record_span_event(ev)
        return ev


class span:
    """``with span("name"):`` — a child of the current context (or a fresh
    trace root), pushed as current for the body."""

    def __init__(self, name: str, attrs: Optional[Dict[str, str]] = None,
                 context: Optional[TraceContext] = None):
        self._name = name
        self._attrs = attrs
        self._parent = context
        self._span: Optional[Span] = None
        self._token = None

    def __enter__(self) -> Span:
        parent = self._parent or current_context()
        self._span = Span(
            self._name,
            trace_id=parent.trace_id if parent else None,
            parent_id=parent.span_id if parent else None,
            attrs=self._attrs,
        )
        self._token = _stack.set(_stack.get() + (self._span.context(),))
        return self._span

    def __exit__(self, *exc):
        try:
            _stack.reset(self._token)
        except ValueError:
            pass  # crossed an async context copy; that copy dies with its Task
        self._span.finish()
        return False


class task_span:
    """Execution-side span adopting a propagated ``TaskSpec.trace_ctx``
    tuple ``(trace_id, task_span_id, parent_span_id)``; the task span is the
    parent, so nested submissions from inside the body chain under it.
    No-op (yields None) when ``ctx`` is None — tracing off or an untraced
    caller."""

    def __init__(self, name: str, ctx: Optional[Tuple]):
        self._name = name
        self._ctx = ctx
        self._span: Optional[Span] = None
        self._token = None

    def __enter__(self) -> Optional[Span]:
        if self._ctx is None:
            return None
        self._span = Span(self._name, trace_id=self._ctx[0], parent_id=self._ctx[1])
        self._token = _stack.set(_stack.get() + (self._span.context(),))
        return self._span

    def __exit__(self, *exc):
        if self._span is None:
            return False
        try:
            _stack.reset(self._token)
        except ValueError:
            pass
        self._span.finish()
        return False


# --------------------------------------------------------------------------
# task propagation helpers (used by CoreWorker / Node / workers)
# --------------------------------------------------------------------------
def task_trace_context() -> Optional[Tuple[str, str, Optional[str]]]:
    """Mint the context stamped on a TaskSpec at submit time:
    ``(trace_id, task_span_id, parent_span_id)``.  The task span itself is
    synthesized owner-side at the terminal commit (its end isn't known
    yet); this just reserves its id so both sides of the process boundary
    can parent to it.  None when tracing is disabled."""
    if not enabled():
        return None
    cur = current_context()
    if cur is None:
        return (_new_id(), _new_id(), None)
    return (cur.trace_id, _new_id(), cur.span_id)


def emit_span(
    name: str,
    trace_id: str,
    parent_id: Optional[str],
    start: float,
    end: float,
    span_id: Optional[str] = None,
    attrs: Optional[Dict[str, str]] = None,
) -> None:
    """Synthesize an already-timed span (phases whose boundaries the runtime
    records as plain timestamps: submit→start queueing, return commits)."""
    ev = {
        "type": SPAN_EVENT_TYPE,
        "state": "SPAN",
        "name": name,
        "trace_id": trace_id,
        "span_id": span_id or _new_id(),
        "parent_id": parent_id,
        "start_ts": start,
        "ts": end,
        "pid": os.getpid(),
    }
    if attrs:
        ev["attrs"] = dict(attrs)
    record_span_event(ev)
