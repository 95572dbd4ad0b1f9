"""Chrome-tracing timeline from the control service's task-event store.

The port's copy of ``ray_tpu/observability/timeline.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Parity with ``ray timeline``: the reference buffers per-task events in each
worker (``src/ray/core_worker/task_event_buffer.h:206``), ships them to
``GcsTaskManager`` and dumps Chrome tracing JSON from
``python/ray/_private/state.py:434``.  Here the control service's
``TaskEventStore`` already holds finished-task records with submit/start/end
timestamps; this module converts them into the ``chrome://tracing`` /
Perfetto "X" (complete) event format.

Span records from the tracing layer (``observability/tracing.py``; event
dicts with ``type == "span"``) render as their own slices, grouped per
trace (``pid = trace:<id>``) with one row per OS process — the
submit→schedule→execute→commit phases of one task nest inside its task
span, across process boundaries.
"""

from __future__ import annotations

import json
from typing import List, Optional


def _span_trace_event(ev: dict) -> Optional[dict]:
    start = ev.get("start_ts")
    end = ev.get("ts")
    if start is None or end is None:
        return None
    args = {
        "trace_id": ev.get("trace_id", ""),
        "span_id": ev.get("span_id", ""),
        "parent_id": ev.get("parent_id") or "",
    }
    if ev.get("attrs"):
        args.update(ev["attrs"])
    return {
        "name": ev.get("name", "span"),
        "cat": "span",
        "ph": "X",
        "ts": start * 1e6,
        "dur": max(0.0, (end - start) * 1e6),
        # one track group per trace, one row per OS process: phases of one
        # task nest by time containment within their process's row
        "pid": f"trace:{ev.get('trace_id', '')[:8]}",
        "tid": f"pid:{ev.get('pid', '?')}",
        "args": args,
    }


def chrome_trace(events: List[dict]) -> List[dict]:
    """Convert task-event and span dicts into chrome trace 'X' events.

    Each finished/failed task record carries ``ts`` (end, seconds), and
    optionally ``submit_ts``/``start_ts``; spans prefer start→end
    (execution) and fall back to submit→end (includes queueing).
    """
    out: List[dict] = []
    for ev in events:
        if ev.get("type") == "span":
            slice_ = _span_trace_event(ev)
            if slice_ is not None:
                out.append(slice_)
            continue
        end = ev.get("ts")
        if end is None:
            continue
        # explicit None checks: start_ts == 0.0 is a legitimate epoch
        # timestamp and must not fall through to submit time
        start = ev.get("start_ts")
        if start is None:
            start = ev.get("submit_ts")
        if start is None:
            start = end
        node = ev.get("node", "node")
        state = ev.get("state", "FINISHED")
        out.append(
            {
                "name": ev.get("name", "task"),
                "cat": "task",
                "ph": "X",
                "ts": start * 1e6,
                "dur": max(0.0, (end - start) * 1e6),
                "pid": f"node:{node}",
                "tid": ev.get("worker", "worker"),
                "cname": "thread_state_running" if state == "FINISHED" else "terrible",
                "args": {"task_id": ev.get("task_id", ""), "state": state, "attempt": ev.get("attempt", 0)},
            }
        )
    return out


def dump_timeline(path: str, events: Optional[List[dict]] = None) -> str:
    """Write a chrome-trace JSON file; returns the path (``ray timeline``
    parity).  Without an explicit event list, dumps the running cluster's
    task events merged with its finished tracing spans."""
    if events is None:
        from ray_tpu_torch.api import get_cluster

        control = get_cluster().control
        events = control.task_events.list_events(limit=100_000)
        events = events + control.spans.list_events(limit=100_000)
    with open(path, "w") as f:
        json.dump(chrome_trace(events), f)
    return path
