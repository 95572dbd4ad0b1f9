"""@serve.batch: dynamic request batching.

The port's copy of ``ray_tpu/serve/batching.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``; the queue thread drops each finished batch before it
waits for the next, so a retired replica is collected and its thread ends.

Parity: ``python/ray/serve/batching.py`` — queues individual calls and
invokes the wrapped method once per batch (max_batch_size or
batch_wait_timeout_s, whichever first): a batched replica turns N
concurrent single requests into one batch for the model on the card.
"""

from __future__ import annotations

import functools
import queue
import threading
import weakref
from concurrent.futures import Future
from typing import Any, Callable, List, Optional


def _register_cleanup(instance, key, bq, bq_holder, bq_lock) -> None:
    """Stop the batch thread and drop the holder entry when the replica
    instance is gc'd. Guarded by identity: id() reuse after gc must not
    evict a NEW instance's queue."""

    def cleanup():
        with bq_lock:
            if bq_holder.get(key) is bq:
                del bq_holder[key]
        bq.stop()

    try:
        weakref.finalize(instance, cleanup)
    except TypeError:
        pass  # non-weakref-able instance: entry lives for the process


_STOP = object()


class _BatchQueue:
    def __init__(self, fn: Callable, max_batch_size: int, timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout_s = timeout_s
        self.queue: "queue.Queue" = queue.Queue()
        self.thread = threading.Thread(target=self._loop, daemon=True, name="serve-batch")
        self.thread.start()

    def submit(self, instance, item) -> Future:
        fut: Future = Future()
        self.queue.put((instance, item, fut))
        return fut

    def stop(self) -> None:
        """Terminate the loop thread (called when the owning replica is
        gc'd — without it every retired replica leaks a thread)."""
        self.queue.put(_STOP)

    def _loop(self) -> None:
        while True:
            got = self.queue.get()
            if got is _STOP:
                return
            instance, item, fut = got
            batch_items = [item]
            futures = [fut]
            deadline = None
            import time

            deadline = time.monotonic() + self.timeout_s
            while len(batch_items) < self.max_batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self.queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    self.queue.put(_STOP)  # re-deliver after this batch
                    break
                batch_items.append(nxt[1])
                futures.append(nxt[2])
            try:
                if instance is not None:
                    results = self.fn(instance, batch_items)
                else:
                    results = self.fn(batch_items)
                if results is None or len(results) != len(batch_items):
                    raise ValueError(
                        f"@serve.batch function must return one result per input "
                        f"(got {None if results is None else len(results)} for {len(batch_items)})"
                    )
                for f, r in zip(futures, results):
                    f.set_result(r)
            except BaseException as exc:  # noqa: BLE001
                for f in futures:
                    if not f.done():
                        f.set_exception(exc)
            # the idle wait must not hold the last batch: its instance would
            # never be collected, so its finalizer would never stop this thread
            got = instance = item = fut = batch_items = futures = results = None


def batch(
    _fn: Optional[Callable] = None,
    *,
    max_batch_size: int = 8,
    batch_wait_timeout_s: float = 0.01,
):
    """Decorator (parity: serve.batch).  The wrapped fn receives a LIST of
    requests and must return a list of equal length."""

    def wrap(fn):
        bq_holder: dict = {}
        bq_lock = threading.Lock()

        @functools.wraps(fn)
        def method_wrapper(*args, **kwargs):
            if kwargs:
                raise TypeError(
                    "@serve.batch functions take exactly one positional request "
                    f"argument; got keyword arguments {sorted(kwargs)}"
                )
            # Distinguish bound-method vs free-function by arg count.
            if len(args) == 2:
                instance, item = args
            elif len(args) == 1:
                instance, item = None, args[0]
            else:
                raise TypeError("@serve.batch functions take exactly one request argument")
            key = id(instance)
            with bq_lock:
                # Concurrent first calls race here; without the lock each
                # request gets a private queue and batching never happens.
                bq = bq_holder.get(key)
                if bq is None:
                    bq = bq_holder[key] = _BatchQueue(fn, max_batch_size, batch_wait_timeout_s)
                    if instance is not None:
                        _register_cleanup(instance, key, bq, bq_holder, bq_lock)
            return bq.submit(instance, item).result()

        method_wrapper._is_serve_batch = True
        return method_wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
