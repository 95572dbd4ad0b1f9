"""ActorPool (parity: python/ray/util/actor_pool.py).

The port's copy of ``ray_tpu/util/actor_pool.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Schedules a stream of tasks over a fixed set of actors, returning results
in submission order (``map``) or completion order (``map_unordered``).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, Tuple

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: List[Any]):
        self._idle = list(actors)
        self._future_to_actor = {}
        self._index_to_future = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending_submits: List[Tuple[Callable, Any]] = []

    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        """fn(actor, value) -> ObjectRef; queues if all actors busy."""
        if self._idle:
            actor = self._idle.pop()
            future = fn(actor, value)
            self._future_to_actor[future] = actor
            self._index_to_future[self._next_task_index] = future
            self._next_task_index += 1
        else:
            self._pending_submits.append((fn, value))

    def _return_actor(self, actor) -> None:
        self._idle.append(actor)
        if self._pending_submits:
            self.submit(*self._pending_submits.pop(0))

    def has_next(self) -> bool:
        return bool(self._index_to_future)

    def get_next(self, timeout: float = None) -> Any:
        if not self.has_next():
            raise StopIteration("no more results")
        future = self._index_to_future[self._next_return_index]
        if timeout is not None:
            ready, _ = ray_tpu_torch.wait([future], num_returns=1, timeout=timeout)
            if not ready:
                # leave all state intact so the caller can retry
                raise TimeoutError("timed out waiting for result")
        # settle bookkeeping BEFORE get: a raising task must still return its
        # actor to the pool and advance the return cursor (the reference pops
        # the future first for the same reason)
        del self._index_to_future[self._next_return_index]
        self._next_return_index += 1
        self._return_actor(self._future_to_actor.pop(future))
        return ray_tpu_torch.get(future)

    def get_next_unordered(self, timeout: float = None) -> Any:
        if not self.has_next():
            raise StopIteration("no more results")
        ready, _ = ray_tpu_torch.wait(list(self._future_to_actor), num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("timed out waiting for result")
        future = ready[0]
        for idx, fut in list(self._index_to_future.items()):
            if fut is future:
                del self._index_to_future[idx]
                break
        self._return_actor(self._future_to_actor.pop(future))
        return ray_tpu_torch.get(future)

    def map(self, fn: Callable, values: Iterable[Any]) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[Any]) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def has_free(self) -> bool:
        return bool(self._idle)

    def pop_idle(self):
        return self._idle.pop() if self._idle else None

    def push(self, actor) -> None:
        self._return_actor(actor)
