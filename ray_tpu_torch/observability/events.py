"""Structured events in a bounded ring.

The port's own copy of the ring of ``ray_tpu/observability/events.py``:
typed, severity-tagged events buffered in a bounded ring (the JAX package's
JSON-lines log file and its emit helpers are left out: nothing here writes
them).  The flight recorder of ``observability/reqtrace.py`` writes its
postmortems here.
"""

from __future__ import annotations

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


class EventManager:
    def __init__(self, max_events: int = 10_000):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max_events)

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
        return ev

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


_global = EventManager()


def global_event_manager() -> EventManager:
    return _global
