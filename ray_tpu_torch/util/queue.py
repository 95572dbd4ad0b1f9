"""Distributed Queue backed by a named actor
(parity: python/ray/util/queue.py).

The port's copy of ``ray_tpu/util/queue.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``. A CUDA tensor put here stays on the card: the queue's
actor runs in process and holds the item as given.
"""

from __future__ import annotations

import queue as _stdlib_queue
import time
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


@ray_tpu_torch.remote
class _QueueActor:
    def __init__(self, maxsize: int):
        self.q = _stdlib_queue.Queue(maxsize=maxsize)

    def put_nowait(self, item) -> bool:
        try:
            self.q.put_nowait(item)
            return True
        except _stdlib_queue.Full:
            return False

    def get_nowait(self):
        try:
            return (True, self.q.get_nowait())
        except _stdlib_queue.Empty:
            return (False, None)

    def qsize(self) -> int:
        return self.q.qsize()

    def empty(self) -> bool:
        return self.q.empty()

    def full(self) -> bool:
        return self.q.full()


class Queue:
    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        opts = dict(actor_options or {})
        opts.setdefault("execution", "inproc")
        opts.setdefault("max_concurrency", 8)
        self.actor = _QueueActor.options(**opts).remote(maxsize)

    def put(self, item: Any, block: bool = True, timeout: Optional[float] = None) -> None:
        if not block:
            if not ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                raise Full()
            return
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok = ray_tpu_torch.get(self.actor.put_nowait.remote(item))
            if ok:
                return
            if deadline is not None and time.monotonic() >= deadline:
                raise Full()
            time.sleep(0.005)

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        if not block:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
            if not ok:
                raise Empty()
            return item
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
            if ok:
                return item
            if deadline is not None and time.monotonic() >= deadline:
                raise Empty()
            time.sleep(0.005)

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote())

    def shutdown(self) -> None:
        ray_tpu_torch.kill(self.actor)
