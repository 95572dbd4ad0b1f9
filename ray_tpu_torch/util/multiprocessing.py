"""multiprocessing.Pool API over remote tasks.

The port's copy of ``ray_tpu/util/multiprocessing.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Parity: ``python/ray/util/multiprocessing/`` — a drop-in ``Pool`` whose
``apply/map/starmap/imap`` fan work out as tasks instead of forked
processes, so the same code scales past one host.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, List, Optional


class AsyncResult:
    def __init__(self, refs, single: bool):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None):
        import ray_tpu_torch as rt

        out = rt.get(self._refs, timeout=timeout)
        return out[0] if self._single else out

    def wait(self, timeout: Optional[float] = None) -> None:
        import ray_tpu_torch as rt

        rt.wait(self._refs, num_returns=len(self._refs), timeout=timeout)

    def ready(self) -> bool:
        import ray_tpu_torch as rt

        ready, _ = rt.wait(self._refs, num_returns=len(self._refs), timeout=0)
        return len(ready) == len(self._refs)

    def successful(self) -> bool:
        try:
            self.get(timeout=0)
            return True
        except Exception:
            return False


class Pool:
    """Task-backed process pool (``ray.util.multiprocessing.Pool`` parity).

    ``processes`` bounds in-flight chunks (the runtime's scheduler does the
    real placement); ``chunksize`` groups items per task like stdlib's Pool.
    """

    def __init__(self, processes: Optional[int] = None, initializer=None, initargs=()):
        import ray_tpu_torch as rt

        if not rt.is_initialized():
            rt.init()
        self._rt = rt
        self._processes = processes or 8
        self._initializer = initializer
        self._initargs = initargs
        self._closed = False

    # ------------------------------------------------------------------
    def _chunk_runner(self, func):
        init, initargs = self._initializer, self._initargs

        def run_chunk(chunk):
            if init is not None:
                init(*initargs)
            return [func(*args) for args in chunk]

        return run_chunk

    def apply(self, func: Callable, args=(), kwds=None):
        return self.apply_async(func, args, kwds).get()

    def apply_async(self, func: Callable, args=(), kwds=None) -> AsyncResult:
        self._check_open()
        kwds = kwds or {}
        remote_fn = self._rt.remote(lambda: func(*args, **kwds))
        return AsyncResult([remote_fn.remote()], single=True)

    def map(self, func: Callable, iterable: Iterable, chunksize: Optional[int] = None) -> List[Any]:
        return self.starmap(func, ((x,) for x in iterable), chunksize)

    def map_async(self, func, iterable, chunksize: Optional[int] = None) -> AsyncResult:
        return self.starmap_async(func, ((x,) for x in iterable), chunksize)

    def starmap(self, func: Callable, iterable: Iterable, chunksize: Optional[int] = None) -> List[Any]:
        return self.starmap_async(func, iterable, chunksize).get()

    def starmap_async(self, func, iterable, chunksize: Optional[int] = None) -> AsyncResult:
        self._check_open()
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, len(items) // (self._processes * 4) or 1)
        runner = self._rt.remote(self._chunk_runner(func))
        refs = [
            runner.remote(items[i : i + chunksize]) for i in range(0, len(items), chunksize)
        ]
        return _ChunkedAsyncResult(refs)

    def imap(self, func: Callable, iterable: Iterable, chunksize: int = 1):
        self._check_open()
        runner = self._rt.remote(self._chunk_runner(func))
        items = list(iterable)
        refs = [
            runner.remote([(x,) for x in items[i : i + chunksize]])
            for i in range(0, len(items), chunksize)
        ]
        for ref in refs:  # ordered
            yield from self._rt.get(ref)

    def imap_unordered(self, func: Callable, iterable: Iterable, chunksize: int = 1):
        self._check_open()
        runner = self._rt.remote(self._chunk_runner(func))
        items = list(iterable)
        refs = [
            runner.remote([(x,) for x in items[i : i + chunksize]])
            for i in range(0, len(items), chunksize)
        ]
        pending = list(refs)
        while pending:
            ready, pending = self._rt.wait(pending, num_returns=1)
            yield from self._rt.get(ready[0])

    # ------------------------------------------------------------------
    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True

    def join(self) -> None:
        pass

    def _check_open(self) -> None:
        if self._closed:
            raise ValueError("Pool is closed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _ChunkedAsyncResult(AsyncResult):
    def __init__(self, refs):
        super().__init__(refs, single=False)

    def get(self, timeout: Optional[float] = None):
        import ray_tpu_torch as rt

        chunks = rt.get(self._refs, timeout=timeout)
        return list(itertools.chain.from_iterable(chunks))
