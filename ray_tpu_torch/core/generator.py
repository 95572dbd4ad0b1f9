"""Streaming generator tasks: ObjectRefGenerator.

The port's copy of ``ray_tpu/core/generator.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Parity: the reference's streaming-generator machinery
(``src/ray/core_worker/core_worker.h:389`` ``TryReadObjectRefStream``,
``python/ray/_raylet.pyx:273`` ``ObjectRefGenerator``; used by Data's
streaming executor and Serve's response streaming). A task whose function
is a generator and whose ``num_returns="streaming"`` returns ONE
``ObjectRefGenerator``; each yielded item commits to the object store as
its own return object the moment it is produced, and the caller iterates
ObjectRefs without waiting for the task to finish.

Error semantics (reference parity): an exception inside the generator
commits as the NEXT item (an errored ref — ``rt.get`` raises), then the
stream ends.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from ray_tpu_torch.core.object_ref import ObjectRef


class ObjectRefGenerator:
    """Iterator over a streaming task's return refs, in yield order.

    Thread-safe: the executing node pushes refs as items commit; the
    consuming thread blocks in ``__next__`` until an item arrives or the
    stream finishes."""

    def __init__(self, task_id):
        self._task_id = task_id
        self._cond = threading.Condition()
        self._items: List[ObjectRef] = []
        self._read = 0
        self._done = False

    # -- producer side (runtime-internal) -----------------------------------
    def _push(self, ref: ObjectRef) -> None:
        with self._cond:
            self._items.append(ref)
            self._cond.notify_all()

    def _finish(self) -> None:
        with self._cond:
            self._done = True
            self._cond.notify_all()

    # -- consumer side ------------------------------------------------------
    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self) -> ObjectRef:
        with self._cond:
            while self._read >= len(self._items) and not self._done:
                self._cond.wait()
            if self._read < len(self._items):
                ref = self._items[self._read]
                self._read += 1
                return ref
            raise StopIteration

    def next_ready(self, timeout: Optional[float] = None) -> Optional[ObjectRef]:
        """Like ``next()`` but returns None on timeout instead of blocking
        forever; raises StopIteration when the stream is exhausted."""
        with self._cond:
            if self._read >= len(self._items) and not self._done:
                self._cond.wait(timeout)
            if self._read < len(self._items):
                ref = self._items[self._read]
                self._read += 1
                return ref
            if self._done:
                raise StopIteration
            return None

    @property
    def task_id(self):
        return self._task_id

    def num_ready(self) -> int:
        """Items produced but not yet consumed."""
        with self._cond:
            return len(self._items) - self._read

    def is_finished(self) -> bool:
        with self._cond:
            return self._done and self._read >= len(self._items)

    def __repr__(self) -> str:
        with self._cond:
            state = "done" if self._done else "open"
            return f"ObjectRefGenerator({self._task_id.hex()[:8]}, {len(self._items)} items, {state})"
