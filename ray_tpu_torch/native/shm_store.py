"""ctypes bindings for the native shared-memory object store (libtpustore.so).

The port's copy of ``ray_tpu/native/shm_store.py``, over its own build of
``src/shm_store.cpp`` (:mod:`ray_tpu_torch.native._build`). The Python side
maps the same POSIX shm segment with ``mmap`` for zero-copy reads/writes; the
C++ library owns allocation, the object index, refcounts and LRU eviction
(parity: plasma client ``src/ray/object_manager/plasma/client.h`` — but
in-process via a shared mutex instead of a unix-socket protocol).

The runtime names its segments with :data:`SEGMENT_PREFIX`, which differs
from the JAX package's ``/rt_``, so a process that holds both packages'
clusters never opens one segment twice.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import threading

from ray_tpu_torch.native import _build

#: prefix of the runtime's segment names (the JAX package's is ``/rt_``)
SEGMENT_PREFIX = "/rttorch_"

_lib = None
_lib_lock = threading.Lock()


def _load_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build.library_path("shm_store"))
        lib.tstore_open.restype = ctypes.c_void_p
        lib.tstore_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int]
        lib.tstore_close.argtypes = [ctypes.c_void_p]
        lib.tstore_unlink.argtypes = [ctypes.c_char_p]
        lib.tstore_create.restype = ctypes.c_int64
        lib.tstore_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
        lib.tstore_seal.restype = ctypes.c_int
        lib.tstore_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.tstore_get.restype = ctypes.c_int64
        lib.tstore_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.tstore_release.restype = ctypes.c_int
        lib.tstore_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.tstore_delete.restype = ctypes.c_int
        lib.tstore_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.tstore_contains.restype = ctypes.c_int
        lib.tstore_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.tstore_pin_range.restype = ctypes.c_int
        lib.tstore_pin_range.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.tstore_prefault.restype = ctypes.c_int
        lib.tstore_prefault.argtypes = [ctypes.c_void_p]
        lib.tstore_used.restype = ctypes.c_uint64
        lib.tstore_used.argtypes = [ctypes.c_void_p]
        lib.tstore_capacity.restype = ctypes.c_uint64
        lib.tstore_capacity.argtypes = [ctypes.c_void_p]
        lib.tstore_num_objects.restype = ctypes.c_uint64
        lib.tstore_num_objects.argtypes = [ctypes.c_void_p]
        lib.tstore_evict.restype = ctypes.c_uint64
        lib.tstore_evict.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        _lib = lib
        return lib


class ShmObjectStore:
    """A named, process-shared arena of sealed immutable objects."""

    def __init__(self, name: str, capacity: int = 1 << 30, create: bool = True):
        self._lib = _load_lib()
        self.name = name
        self._handle = self._lib.tstore_open(name.encode(), capacity, 1 if create else 0)
        if not self._handle:
            raise OSError(f"failed to open shm store {name!r}")
        # Map the same segment for zero-copy python-side access.
        fd = os.open(f"/dev/shm{name}" if name.startswith("/") else f"/dev/shm/{name}", os.O_RDWR)
        try:
            size = os.fstat(fd).st_size
            self._map = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self._view = memoryview(self._map)
        self._closed = False
        # base address of the mapping, for buffer-containment checks
        self._base_addr = ctypes.addressof(ctypes.c_char.from_buffer(self._map))
        self._size = len(self._map)
        # Populate THIS mapping's page tables off the hot path: the first
        # bulk memcpy through an unpopulated VMA pays a write-fault per 4K
        # page (~1.6-2.8 GB/s measured) vs ~8 GB/s once populated.  PTEs are
        # per-mapping, so every opener — creator and workers alike — warms
        # its own.  MADV_POPULATE_WRITE allocates the tmpfs pages without
        # altering contents; unsupported kernels just skip the warmup.
        import threading

        threading.Thread(
            target=self._prefault, name="shm-prefault", daemon=True
        ).start()

    _MADV_POPULATE_WRITE = 23  # Linux 5.14+

    def _prefault(self) -> None:
        # Populating commits the segment's FULL capacity in tmpfs up front.
        # Gate on free memory (skip when the arena would eat >25% of
        # MemAvailable) so small hosts keep lazy per-object allocation;
        # RAY_TPU_SHM_PREFAULT=0/1 forces either way.
        forced = os.environ.get("RAY_TPU_SHM_PREFAULT")
        if forced == "0":
            return
        if forced != "1":
            try:
                with open("/proc/meminfo") as f:
                    for line in f:
                        if line.startswith("MemAvailable:"):
                            avail_kb = int(line.split()[1])
                            if self._size > avail_kb * 1024 // 4:
                                return
                            break
            except (OSError, ValueError):
                return
        try:
            self._map.madvise(self._MADV_POPULATE_WRITE)
        except (OSError, ValueError):
            pass

    # -- plasma-style lifecycle -------------------------------------------
    def create(self, object_id: bytes, size: int, meta_size: int = 0) -> memoryview:
        """Allocate and return a writable view; call seal() when filled."""
        off = self._lib.tstore_create(self._handle, object_id, size, meta_size)
        if off == -2:
            raise FileExistsError(f"object {object_id.hex()} already exists")
        if off < 0:
            raise MemoryError(f"shm store full (need {size} bytes)")
        return self._view[off : off + size]

    def seal(self, object_id: bytes) -> None:
        if self._lib.tstore_seal(self._handle, object_id) != 0:
            raise KeyError(f"cannot seal {object_id.hex()}")

    def put(self, object_id: bytes, data, meta_size: int = 0, pin: bool = False) -> None:
        """Store and seal. With pin=True the object holds a reference and is
        exempt from LRU eviction until unpin() — used by the spill tier,
        where the shm copy is the only copy."""
        buf = self.create(object_id, len(data), meta_size)
        buf[:] = data
        self.seal(object_id)
        if pin:
            size = ctypes.c_uint64()
            meta = ctypes.c_uint64()
            self._lib.tstore_get(self._handle, object_id, ctypes.byref(size), ctypes.byref(meta))

    def unpin(self, object_id: bytes) -> None:
        self.release(object_id)

    def get(self, object_id: bytes) -> tuple[memoryview, int] | None:
        """Returns (payload_view, meta_size) pinned against eviction, or None."""
        size = ctypes.c_uint64()
        meta = ctypes.c_uint64()
        off = self._lib.tstore_get(self._handle, object_id, ctypes.byref(size), ctypes.byref(meta))
        if off < 0:
            return None
        return self._view[off : off + size.value], meta.value

    def release(self, object_id: bytes) -> None:
        self._lib.tstore_release(self._handle, object_id)

    def delete(self, object_id: bytes) -> bool:
        return self._lib.tstore_delete(self._handle, object_id) == 0

    def contains(self, object_id: bytes) -> bool:
        return bool(self._lib.tstore_contains(self._handle, object_id))

    def pin_buffer(self, addr: int, nbytes: int):
        """If [addr, addr+nbytes) lies inside one SEALED entry's payload,
        pin that entry and return ``(entry_id, offset_within_payload)``;
        else None.  Pairs with release(entry_id).  This is the zero-copy
        passthrough: a buffer already living in the arena is served by
        reference, never re-staged."""
        if not (self._base_addr <= addr and addr + nbytes <= self._base_addr + self._size):
            return None
        seg_off = addr - self._base_addr
        id_out = ctypes.create_string_buffer(28)
        pay_off = ctypes.c_uint64()
        pay_size = ctypes.c_uint64()
        rc = self._lib.tstore_pin_range(
            self._handle, seg_off, id_out, ctypes.byref(pay_off), ctypes.byref(pay_size)
        )
        if rc != 0:
            return None
        rel = seg_off - pay_off.value
        if rel + nbytes > pay_size.value:  # straddles entries: not servable
            self.release(id_out.raw)
            return None
        return id_out.raw, rel

    def evict(self, num_bytes: int) -> int:
        return self._lib.tstore_evict(self._handle, num_bytes)

    # -- stats -------------------------------------------------------------
    @property
    def used_bytes(self) -> int:
        return self._lib.tstore_used(self._handle)

    @property
    def capacity(self) -> int:
        return self._lib.tstore_capacity(self._handle)

    @property
    def num_objects(self) -> int:
        return self._lib.tstore_num_objects(self._handle)

    # -- teardown ----------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._view.release()
            self._map.close()
        except BufferError:
            # Zero-copy views handed out by get() are still alive; the mapping
            # is reclaimed at process exit instead.
            pass
        else:
            self._lib.tstore_close(self._handle)

    def unlink(self) -> None:
        self._lib.tstore_unlink(self.name.encode())

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
