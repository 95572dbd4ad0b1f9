"""Small concurrency helpers shared by the runtime.

The port's copy of ``ray_tpu/core/sync.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, TypeVar

T = TypeVar("T")


def when_all(
    items: Iterable[T],
    start: Callable[[T, Callable[[], None]], None],
    then: Callable[[], None],
) -> None:
    """Countdown barrier: ``start(item, done)`` is called for each item and
    must eventually invoke ``done``; ``then`` fires exactly once after all
    items complete.  With no items, ``then`` fires immediately."""
    items = list(items)
    if not items:
        then()
        return
    remaining = len(items)
    lock = threading.Lock()

    def done(*_ignored) -> None:
        nonlocal remaining
        with lock:
            remaining -= 1
            last = remaining == 0
        if last:
            then()

    for item in items:
        start(item, done)
