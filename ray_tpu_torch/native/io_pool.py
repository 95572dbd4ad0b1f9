"""ctypes bindings for the native parallel file I/O pool (libtpuio.so).

The port's copy of ``ray_tpu/native/io_pool.py``, over its own build of
``src/io_pool.cpp`` (:mod:`ray_tpu_torch.native._build`).

The reference's data plane reads files in native code (Arrow C++ under
``python/ray/data``'s datasources). Here a C++ pthread pool does
pread/pwrite into caller-owned buffers; ctypes calls release the GIL, so N
files stream concurrently while Python decodes the previous batch. Used by
the data datasources for batched reads and by checkpoint writers.

Falls back cleanly: callers should catch ``OSError`` from construction and
use plain Python IO when the toolchain is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence

from ray_tpu_torch.native import _build

_lib = None
_lib_lock = threading.Lock()


def _load_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build.library_path("io_pool"))
        lib.tio_pool_create.restype = ctypes.c_void_p
        lib.tio_pool_create.argtypes = [ctypes.c_int]
        lib.tio_pool_destroy.argtypes = [ctypes.c_void_p]
        lib.tio_file_size.restype = ctypes.c_int64
        lib.tio_file_size.argtypes = [ctypes.c_char_p]
        lib.tio_submit_read.restype = ctypes.c_uint64
        lib.tio_submit_read.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p,
        ]
        lib.tio_submit_write.restype = ctypes.c_uint64
        lib.tio_submit_write.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_void_p, ctypes.c_int,
        ]
        lib.tio_wait.restype = ctypes.c_int64
        lib.tio_wait.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        _lib = lib
        return lib


def file_size(path: str) -> int:
    r = _load_lib().tio_file_size(os.fspath(path).encode())
    if r < 0:
        raise OSError(-r, os.strerror(-r), path)
    return r


class IOPool:
    """A fixed pool of native reader/writer threads.

    Buffers handed to submit_* MUST stay alive until the matching wait().
    The high-level helpers (read_files / write_file) own that lifetime.
    """

    def __init__(self, num_threads: Optional[int] = None):
        self._lib = _load_lib()
        n = num_threads or min(16, (os.cpu_count() or 4))
        self._handle = self._lib.tio_pool_create(n)
        if not self._handle:
            raise OSError("failed to create native IO pool")
        self.num_threads = n
        self._closed = False
        self._pending_bufs: dict = {}

    # -- low-level ----------------------------------------------------------
    def _check_open(self) -> None:
        # use-after-close would hand the freed native pool handle to the C
        # library — a crash, not an exception; fail in Python instead
        if self._closed:
            raise RuntimeError("IOPool is closed")

    def submit_read(self, path: str, buf, offset: int = 0, length: Optional[int] = None) -> int:
        """Read [offset, offset+length) of path into buf (writable buffer)."""
        self._check_open()
        addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
        n = length if length is not None else len(buf)
        return self._lib.tio_submit_read(
            self._handle, os.fspath(path).encode(), offset, n, addr
        )

    def submit_write(self, path: str, data, offset: int = 0, trunc: bool = True) -> int:
        self._check_open()
        # copy into a ctypes buffer so arbitrary (possibly readonly) bytes
        # stay alive until the worker thread finishes
        buf = (ctypes.c_char * len(data)).from_buffer_copy(data)
        jid = self._lib.tio_submit_write(
            self._handle, os.fspath(path).encode(), offset, len(data),
            ctypes.addressof(buf), 1 if trunc else 0,
        )
        # keep the copy alive until waited
        self._pending_bufs[jid] = buf
        return jid

    def wait(self, job_id: int) -> int:
        self._check_open()
        r = self._lib.tio_wait(self._handle, job_id)
        self._pending_bufs.pop(job_id, None)
        if r < 0:
            raise OSError(-r, os.strerror(-r))
        return r

    # -- high-level ---------------------------------------------------------
    def _drain(self, jobs) -> None:
        """Wait out in-flight jobs whose results we no longer want. MUST run
        before their buffers are freed — a native thread may still be
        writing into them (use-after-free otherwise)."""
        for jid in jobs:
            try:
                self._lib.tio_wait(self._handle, jid)
            except Exception:
                pass

    def iter_reads(self, ranges: Sequence[tuple], *, window: Optional[int] = None):
        """Generator over [(path, offset, length), ...]: keeps up to
        ``window`` reads in flight (default: pool threads + a small
        lookahead) and yields each payload in order as it completes — IO
        for later files overlaps the caller's processing of earlier ones,
        and peak memory is bounded by the window, not the whole batch.

        Exception-safe: on any error (or early generator close) every
        outstanding job is drained before its buffer can be freed."""
        ranges = list(ranges)
        w = window or (self.num_threads + 4)
        inflight: List = []  # [(buf, job_id or None)]
        idx = 0
        try:
            while idx < len(ranges) or inflight:
                while idx < len(ranges) and len(inflight) < w:
                    path, off, ln = ranges[idx]
                    idx += 1
                    if ln == 0:
                        # ctypes can't take the address of an empty buffer;
                        # an empty file is just an empty payload
                        inflight.append((bytearray(0), None))
                        continue
                    buf = bytearray(ln)
                    inflight.append((buf, self.submit_read(path, buf, offset=off, length=ln)))
                buf, jid = inflight.pop(0)
                if jid is not None:
                    n = self.wait(jid)
                    if n != len(buf):
                        del buf[n:]  # short read at EOF / file shrank
                yield buf
        finally:
            self._drain(j for _, j in inflight if j is not None)

    def read_files(self, paths: Sequence[str]) -> List[bytearray]:
        """Read whole files concurrently; returns payloads (bytes-like) in
        input order. Buffers are returned as-is — no trailing copy."""
        ranges = [(p, 0, file_size(p)) for p in paths]
        return list(self.iter_reads(ranges))

    def read_ranges(self, ranges: Sequence[tuple]) -> List[bytearray]:
        """ranges: [(path, offset, length), ...] read concurrently."""
        return list(self.iter_reads(ranges))

    def write_file(self, path: str, data) -> int:
        return self.wait(self.submit_write(path, data))

    def write_files(self, items: Sequence[tuple]) -> List[int]:
        """items: [(path, data), ...] written concurrently. On any failure
        (a bad submit OR a failed write) every in-flight job is still
        reaped — no leaked buffers or native job slots."""
        jobs: List[int] = []
        out, done = [], 0
        try:
            for p, d in items:
                jobs.append(self.submit_write(p, d))
            for jid in jobs:
                done += 1
                out.append(self.wait(jid))
        finally:
            rest = jobs[done:]
            self._drain(rest)
            for jid in rest:
                self._pending_bufs.pop(jid, None)
        return out

    # -- teardown -----------------------------------------------------------
    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._lib.tio_pool_destroy(self._handle)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


_default_pool = None  # None = untried, False = build failed (don't retry), else IOPool
_default_lock = threading.Lock()


def default_pool() -> Optional[IOPool]:
    """Process-wide shared pool, or None when the native lib can't build.
    A failed build is cached — without the sentinel every grouped read task
    would re-fork a doomed ``make`` before falling back to Python IO."""
    global _default_pool
    if _default_pool is None:
        with _default_lock:
            if _default_pool is None:
                try:
                    _default_pool = IOPool()
                except Exception:
                    _default_pool = False
    return _default_pool or None
