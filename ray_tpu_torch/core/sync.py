"""Small concurrency helpers shared by the runtime.

The port's copy of ``ray_tpu/core/sync.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``, plus ``join_threads``, the bounded join of the runtime's
teardown paths.
"""

from __future__ import annotations

import threading
import time
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


#: how long one teardown waits, in all, for the threads it has signalled to end
SHUTDOWN_JOIN_S = 5.0


def join_threads(threads: Iterable[threading.Thread]) -> None:
    """Join every thread (except the caller's own) within one shared
    ``SHUTDOWN_JOIN_S`` budget. Teardown paths call this after signalling
    their threads to stop: a thread still unwinding holds its frame, and
    with it whatever its target is bound to, past the return of
    ``shutdown``."""
    deadline = time.monotonic() + SHUTDOWN_JOIN_S
    me = threading.current_thread()
    for t in list(threads):
        if t is me or t.ident is None:
            continue
        t.join(max(0.0, deadline - time.monotonic()))
