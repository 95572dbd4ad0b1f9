"""Structured event framework.

The port's copy of ``ray_tpu/observability/events.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Parity with the reference's event system (``src/ray/util/event.h:130``
``EventManager``, wire schema ``src/ray/protobuf/event.proto:79``): typed,
severity-tagged events emitted by runtime components, buffered in a bounded
ring and optionally appended as JSON lines to the session log directory, from
which the dashboard's event module reads.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from enum import Enum
from typing import Dict, List, Optional


class EventSeverity(Enum):
    DEBUG = "DEBUG"
    INFO = "INFO"
    WARNING = "WARNING"
    ERROR = "ERROR"
    FATAL = "FATAL"


class Event:
    __slots__ = ("timestamp", "severity", "source_type", "label", "message", "custom_fields")

    def __init__(
        self,
        severity: EventSeverity,
        source_type: str,
        label: str,
        message: str,
        custom_fields: Optional[Dict[str, str]] = None,
    ):
        self.timestamp = time.time()
        self.severity = severity
        self.source_type = source_type
        self.label = label
        self.message = message
        self.custom_fields = custom_fields or {}

    def to_dict(self) -> dict:
        return {
            "timestamp": self.timestamp,
            "severity": self.severity.value,
            "source_type": self.source_type,
            "label": self.label,
            "message": self.message,
            "custom_fields": self.custom_fields,
        }


class EventManager:
    def __init__(self, max_events: int = 10_000, log_dir: Optional[str] = None):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max_events)
        self._log_path: Optional[str] = None
        if log_dir:
            self.set_log_dir(log_dir)

    def set_log_dir(self, log_dir: str) -> None:
        os.makedirs(log_dir, exist_ok=True)
        with self._lock:
            self._log_path = os.path.join(log_dir, "events.jsonl")

    def emit(
        self,
        severity: EventSeverity,
        source_type: str,
        label: str,
        message: str,
        **custom_fields: str,
    ) -> Event:
        ev = Event(severity, source_type, label, message, {k: str(v) for k, v in custom_fields.items()})
        with self._lock:
            self._events.append(ev)
            path = self._log_path
        if path:
            try:
                with open(path, "a") as f:
                    f.write(json.dumps(ev.to_dict()) + "\n")
            except OSError:
                pass
        return ev

    def info(self, source_type: str, label: str, message: str, **fields) -> Event:
        return self.emit(EventSeverity.INFO, source_type, label, message, **fields)

    def warning(self, source_type: str, label: str, message: str, **fields) -> Event:
        return self.emit(EventSeverity.WARNING, source_type, label, message, **fields)

    def error(self, source_type: str, label: str, message: str, **fields) -> Event:
        return self.emit(EventSeverity.ERROR, source_type, label, message, **fields)

    def list_events(
        self,
        severity: Optional[EventSeverity] = None,
        source_type: Optional[str] = None,
        limit: int = 1000,
    ) -> List[Event]:
        with self._lock:
            items = list(self._events)
        if severity is not None:
            items = [e for e in items if e.severity == severity]
        if source_type is not None:
            items = [e for e in items if e.source_type == source_type]
        return items[-limit:]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


_global = EventManager()


def global_event_manager() -> EventManager:
    return _global
