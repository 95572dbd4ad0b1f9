"""ParallelIterator: sharded lazy iteration over actors.

The port's copy of ``ray_tpu/util/iter.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Parity: ``python/ray/util/iter.py`` (1.3k LoC) — the pre-Ray-Data parallel
iterator API.  Each shard is an actor pulling from its own item source;
transforms (``for_each``/``filter``/``batch``/``flat_map``) compose lazily
per shard; ``gather_sync``/``gather_async`` merge shards on the driver.
Kept compact here because ``ray_tpu_torch.data`` is the modern path (the
reference deprecated this module in favor of Datasets too) — but the API
works, it is not a stub.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, Iterator, List

import ray_tpu_torch


@ray_tpu_torch.remote(num_cpus=0)
class _ShardActor:
    """Owns one shard's item source and applies its transform chain."""

    def __init__(self, make_source):
        self._make_source = make_source
        self._it: Iterator = iter(make_source())

    def next_batch(self, ops: List[tuple], n: int = 64) -> tuple:
        """Up to n transformed items + done flag (one RPC per wave, not per
        item — the per-item actor-call tax is what killed the original)."""
        out: List[Any] = []
        done = False
        while len(out) < n:
            try:
                item = next(self._it)
            except StopIteration:
                done = True
                break
            items = [item]
            for kind, fn in ops:
                if kind == "for_each":
                    items = [fn(x) for x in items]
                elif kind == "filter":
                    items = [x for x in items if fn(x)]
                elif kind == "flat_map":
                    items = [y for x in items for y in fn(x)]
            out.extend(items)
        return out, done

    def reset(self) -> None:
        self._it = iter(self._make_source())


class LocalIterator:
    """Driver-side iterator over gathered shard output
    (parity: util.iter.LocalIterator)."""

    def __init__(self, gen_factory: Callable[[], Iterator]):
        self._factory = gen_factory

    def __iter__(self):
        return self._factory()

    def for_each(self, fn: Callable) -> "LocalIterator":
        factory = self._factory
        return LocalIterator(lambda: (fn(x) for x in factory()))

    def filter(self, fn: Callable) -> "LocalIterator":
        factory = self._factory
        return LocalIterator(lambda: (x for x in factory() if fn(x)))

    def batch(self, n: int) -> "LocalIterator":
        factory = self._factory

        def gen():
            it = factory()
            while True:
                block = list(itertools.islice(it, n))
                if not block:
                    return
                yield block

        return LocalIterator(gen)

    def take(self, n: int) -> List[Any]:
        return list(itertools.islice(iter(self), n))


class ParallelIterator:
    """A sharded iterator over actors (parity: util.iter.ParallelIterator)."""

    _batch_n = None  # set by batch(): gather re-chunks to this size

    def __init__(self, sources: List[Callable[[], Iterable]], ops: List[tuple] = ()):  # noqa: B006
        self._sources = sources
        self._ops = list(ops)
        self._actors: List[Any] = []

    # ----------------------------------------------------------- lazy ops
    def for_each(self, fn: Callable) -> "ParallelIterator":
        return ParallelIterator(self._sources, self._ops + [("for_each", fn)])

    def filter(self, fn: Callable) -> "ParallelIterator":
        return ParallelIterator(self._sources, self._ops + [("filter", fn)])

    def flat_map(self, fn: Callable) -> "ParallelIterator":
        return ParallelIterator(self._sources, self._ops + [("flat_map", fn)])

    def batch(self, n: int) -> "ParallelIterator":
        # batching happens driver-side on gather (shard waves re-chunk)
        out = ParallelIterator(self._sources, self._ops)
        out._batch_n = n
        return out

    def union(self, other: "ParallelIterator") -> "ParallelIterator":
        if self._ops or other._ops:
            raise ValueError("union() must be applied before transforms")
        return ParallelIterator(self._sources + other._sources)

    def num_shards(self) -> int:
        return len(self._sources)

    # ------------------------------------------------------------- gather
    def _ensure_actors(self) -> List[Any]:
        if not self._actors:
            self._actors = [_ShardActor.remote(src) for src in self._sources]
        return self._actors

    def gather_sync(self) -> LocalIterator:
        """Round-robin over shards, in order (parity: gather_sync)."""
        outer = self

        def gen():
            actors = outer._ensure_actors()
            for a in actors:
                ray_tpu_torch.get(a.reset.remote())
            live = {i: a for i, a in enumerate(actors)}
            batch_n = getattr(outer, "_batch_n", None)
            while live:
                for i, a in list(live.items()):
                    items, done = ray_tpu_torch.get(a.next_batch.remote(outer._ops))
                    if batch_n:
                        for j in range(0, len(items), batch_n):
                            yield items[j : j + batch_n]
                    else:
                        yield from items
                    if done:
                        del live[i]

        return LocalIterator(gen)

    def gather_async(self) -> LocalIterator:
        """Merge shards by completion order (parity: gather_async)."""
        outer = self

        def gen():
            actors = outer._ensure_actors()
            for a in actors:
                ray_tpu_torch.get(a.reset.remote())
            pending = {a.next_batch.remote(outer._ops): a for a in actors}
            batch_n = getattr(outer, "_batch_n", None)
            while pending:
                ready, _ = ray_tpu_torch.wait(list(pending), num_returns=1)
                ref = ready[0]
                actor = pending.pop(ref)
                items, done = ray_tpu_torch.get(ref)
                if not done:
                    pending[actor.next_batch.remote(outer._ops)] = actor
                if batch_n:
                    for j in range(0, len(items), batch_n):
                        yield items[j : j + batch_n]
                else:
                    yield from items

        return LocalIterator(gen)

    def take(self, n: int) -> List[Any]:
        return self.gather_sync().take(n)

    def show(self, n: int = 20) -> None:
        for item in self.take(n):
            print(item)

    def __repr__(self) -> str:
        return f"ParallelIterator(shards={len(self._sources)}, ops={len(self._ops)})"


# ----------------------------------------------------------- constructors
def from_items(items: List[Any], num_shards: int = 2) -> ParallelIterator:
    shards = [list(items[i::num_shards]) for i in range(num_shards)]
    return ParallelIterator([(lambda s=s: s) for s in shards if s or True])


def from_range(n: int, num_shards: int = 2) -> ParallelIterator:
    def make(i):
        return lambda: range(i, n, num_shards)

    return ParallelIterator([make(i) for i in range(num_shards)])


def from_iterators(generators: List[Callable[[], Iterable]]) -> ParallelIterator:
    return ParallelIterator(list(generators))
