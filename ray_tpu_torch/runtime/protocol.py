"""Framed pickle protocol shared by the worker pool and worker processes.

The port's copy of ``ray_tpu/runtime/protocol.py``, on the port's own
native frame codec (``ray_tpu_torch/native/src/hotpath.c``).

A frame is a 4-byte little-endian length followed by a pickle-5 payload of
``(msg_type: str, payload: dict)``.  Large array values never ride this pipe —
they go through the native shm store (``ShmRef`` markers), giving workers
zero-copy reads (parity: plasma client reads over mmap while the unix socket
carries only control messages — ``src/ray/object_manager/plasma/protocol.h``).
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import sys
from typing import Any, Optional, Tuple

_LEN = struct.Struct("<I")

# Native frame codec (ray_tpu_torch/native/src/hotpath.c): C-buffered reads
# pull many frames per recv syscall and sends skip the header+payload concat.
# Same wire format either way — a native peer and a pure-Python peer
# interoperate frame-for-frame (and the JAX package's codec with this one).
_native = None
if os.environ.get("RAY_TPU_PURE_PY_FRAMES") != "1":
    try:
        from ray_tpu_torch.native import hotpath as _native
    except Exception:  # noqa: BLE001 — no compiler: pure-Python framing
        _native = None

# Frames up to this size go out in one send (header and payload joined);
# larger ones in two, sparing a copy of the payload.
_SEND_CONCAT_MAX = 1 << 20

# Arrays above this many bytes move via shm, not the socket.
SHM_THRESHOLD = 256 * 1024

# Hard ceiling on one frame, mirrored by the native codec (hotpath.c reads
# the same env at module init).  Caps what a corrupted 4-byte length header
# can demand on the receive side, and makes an over-limit send fail FAST on
# the sender instead of wedging the peer's decoder.  Bulk payloads ride the
# shm arena / chunked data plane, never one control frame.
MAX_FRAME_BYTES = 1 << 30
_env_max = os.environ.get("RAY_TPU_MAX_FRAME_BYTES")
if _env_max:
    try:
        _v = int(_env_max)
        if 0 < _v <= 0xFFFFFFFF:
            MAX_FRAME_BYTES = _v
    except ValueError:
        pass


class ShmRef:
    """Marker for a value stored out-of-band in the native shm store."""

    __slots__ = ("object_id",)

    def __init__(self, object_id: bytes):
        self.object_id = object_id


def send_msg(sock: socket.socket, msg_type: str, payload: dict) -> None:
    data = pickle.dumps((msg_type, payload), protocol=5)
    if len(data) > MAX_FRAME_BYTES:
        raise OverflowError(
            f"frame length {len(data)} exceeds max {MAX_FRAME_BYTES} "
            "(move bulk data through put()/the object store, or raise "
            "RAY_TPU_MAX_FRAME_BYTES on every process)"
        )
    if _native is not None:
        fd = sock.fileno()
        if fd < 0:
            raise ConnectionError("socket closed")
        _native.send_frame(fd, data)
    elif len(data) > _SEND_CONCAT_MAX:
        sock.sendall(_LEN.pack(len(data)))  # no header + payload copy
        sock.sendall(data)
    else:
        sock.sendall(_LEN.pack(len(data)) + data)


def recv_msg(sock: socket.socket) -> Tuple[str, dict]:
    header = _recv_exact(sock, _LEN.size)
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME_BYTES:
        raise ValueError(
            f"frame length {length} exceeds max {MAX_FRAME_BYTES} (corrupt header?)"
        )
    data = _recv_exact(sock, length)
    return pickle.loads(data)


class FrameReader:
    """Per-connection buffered frame reader for a dedicated reader thread.

    With the native codec, one recv syscall drains every frame the kernel
    has buffered (a burst of coalesced results parses with no further
    syscalls); without it, behaves exactly like ``recv_msg``.  Not
    thread-safe — each socket's single reader loop owns one instance.
    """

    __slots__ = ("_sock", "_dec")

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._dec = _native.FrameDecoder() if _native is not None else None

    def recv(self) -> Tuple[str, dict]:
        if self._dec is None:
            return recv_msg(self._sock)
        # fileno() re-read per call: after close() it returns -1, so a
        # reader racing a teardown can't recv on a recycled fd number
        fd = self._sock.fileno()
        if fd < 0:
            raise ConnectionError("socket closed")
        return pickle.loads(self._dec.read_frame(fd))


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    # into one buffer: ``sock.recv(n - got)`` would allocate n - got bytes
    # for every chunk the socket hands over (a 256 MiB frame arrives in
    # thousands of them)
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("socket closed")
        got += k
    return buf


def _shm_tensor(v, shm_store, id_factory) -> Any:
    """A ``torch.Tensor`` of at least SHM_THRESHOLD bytes, written straight
    into the arena: one copy from its storage (the card's or the host's)
    into the entry, which a worker decodes into the CPU tensor the in-band
    path gives (``serialization._rebuild_tensor``: the same dtype, bf16 and
    float8 as their integer bits, the grad flag). The JAX package sends the
    host copy of a device array as this ndarray would go; here the bytes go
    once, with no host copy in between. Returns ``v`` when the arena is full."""
    from ray_tpu_torch.core.serialization import _BIT_VIEWS

    t = v.detach()
    dtype = str(t.dtype).removeprefix("torch.")
    bits = t.view(getattr(sys.modules["torch"], _BIT_VIEWS[dtype])) if dtype in _BIT_VIEWS else t
    np_dtype = str(bits.new_empty(0, device="cpu").numpy().dtype.str)
    header = pickle.dumps((np_dtype, tuple(t.shape), dtype, v.requires_grad))
    nbytes = t.numel() * t.element_size()
    oid = id_factory()
    try:
        view = shm_store.create(oid, len(header) + nbytes, meta_size=len(header))
    except (MemoryError, FileExistsError):
        return v
    view[: len(header)] = header
    torch = sys.modules["torch"]
    dst = torch.frombuffer(view[len(header):], dtype=torch.uint8)
    dst.copy_(t.contiguous().reshape(-1).view(torch.uint8))
    shm_store.seal(oid)
    return ShmRef(oid)


def _is_tensor(v) -> bool:
    torch = sys.modules.get("torch")  # never imported here: a tensor brings it
    return torch is not None and isinstance(v, torch.Tensor)


def encode_value(value: Any, shm_store, id_factory) -> Any:
    """Replace large ndarrays and tensors with ShmRef markers (recursive
    over tuple/list/dict one level deep — deep graphs just get pickled)."""
    import numpy as np

    def enc(v):
        if (shm_store is not None and _is_tensor(v)
                and v.numel() * v.element_size() >= SHM_THRESHOLD):
            return _shm_tensor(v, shm_store, id_factory)
        if isinstance(v, np.ndarray) and v.dtype != object and v.nbytes >= SHM_THRESHOLD and shm_store is not None:
            oid = id_factory()
            header = pickle.dumps((v.dtype.str, v.shape))
            try:
                if hasattr(shm_store, "create"):
                    # write STRAIGHT into the arena: one memcpy, no
                    # header+bytes concat staging copy
                    view = shm_store.create(oid, len(header) + v.nbytes, meta_size=len(header))
                    view[: len(header)] = header
                    src = v if v.flags.c_contiguous else np.ascontiguousarray(v)
                    view[len(header):] = memoryview(src).cast("B")
                    shm_store.seal(oid)
                else:
                    shm_store.put(
                        oid, header + np.ascontiguousarray(v).tobytes(), meta_size=len(header)
                    )
                return ShmRef(oid)
            except (MemoryError, FileExistsError):
                return v
        return v

    if isinstance(value, tuple):
        return tuple(enc(v) for v in value)
    if isinstance(value, list):
        return [enc(v) for v in value]
    if isinstance(value, dict):
        return {k: enc(v) for k, v in value.items()}
    return enc(value)


def decode_put_frame(blob: bytes, shm_store):
    """Resolve ShmRef markers inside a worker-api ``put`` frame at the FIRST
    hop that shares the worker's shm arena.  Worker ``rt.put`` of a bulk
    ndarray moves one shm memcpy + a tiny pickled marker over the pool
    socket instead of in-band pickled gigabytes (same policy as task
    args/results; reference: plasma puts from workers never ride the GCS).
    Returns the DECODED ``(op, kw)`` tuple — never a re-pickled blob; the
    round trip through pickle would copy the bulk value twice."""
    op, kw = pickle.loads(blob)
    value = kw.get("value")

    def has_ref(v) -> bool:
        if isinstance(v, ShmRef):
            return True
        if isinstance(v, (tuple, list)):
            return any(isinstance(x, ShmRef) for x in v)
        if isinstance(v, dict):
            return any(isinstance(x, ShmRef) for x in v.values())
        return False

    if shm_store is not None and has_ref(value):
        kw["value"] = decode_value(value, shm_store)
    return op, kw


def nd_owner(arr):
    """The data-owning ndarray at the bottom of a view chain.  NumPy
    collapses ``.base`` through views, so a slice of a reshaped frombuffer
    array keeps only the BOTTOM array alive — a finalizer must ride there,
    or a surviving sub-view outlives the pin and reads reused memory."""
    import numpy as np

    a = arr
    while isinstance(a.base, np.ndarray):
        a = a.base
    return a


def _release_entry(shm_store, oid: bytes, delete: bool) -> None:
    """Finalizer for zero-copy views: drop the pin (and the entry, when we
    were its consumer-of-record) once the array is garbage-collected."""
    if getattr(shm_store, "_closed", False):
        return
    try:
        shm_store.release(oid)
        if delete:
            shm_store.delete(oid)  # refuses (-2) if someone else still pins
    except Exception:  # noqa: BLE001 — arena torn down mid-exit
        pass


def _as_tensor(arr, tensor_meta):
    """The CPU tensor an entry written by :func:`_shm_tensor` holds (it
    shares ``arr``'s memory, as the in-band rebuild shares its buffer)."""
    from ray_tpu_torch.core.serialization import _rebuild_tensor

    dtype, requires_grad = tensor_meta
    return _rebuild_tensor(arr, dtype, requires_grad)


def decode_value(value: Any, shm_store, release: bool = True,
                 zero_copy: Optional[bool] = None) -> Any:
    """Resolve ShmRef markers back into ndarrays.

    ``zero_copy=True`` (the default, via config) returns READ-ONLY arrays
    that view the arena directly — the plasma semantic: no copy-out, the
    entry stays pinned until the array is garbage-collected (plasma client
    Get maps the object read-only for exactly this reason,
    ``plasma/client.h:62``).  ``zero_copy=False`` restores owned, writable
    copies."""
    import numpy as np

    if zero_copy is None:
        from ray_tpu_torch.core.config import get_config

        zero_copy = get_config().zero_copy_shm_values

    def dec(v):
        if isinstance(v, ShmRef):
            got = shm_store.get(v.object_id)
            if got is None:
                raise KeyError(f"shm object {v.object_id.hex()} missing")
            view, meta_size = got
            if zero_copy:
                import weakref

                try:
                    # (dtype, shape) of an ndarray; a tensor's entry adds
                    # its torch dtype and grad flag (_shm_tensor)
                    dtype_str, shape, *tensor = pickle.loads(view[:meta_size])
                    flat = np.frombuffer(
                        view[meta_size:].toreadonly(), dtype=np.dtype(dtype_str)
                    )
                    arr = flat.reshape(shape)
                except BaseException:
                    shm_store.release(v.object_id)
                    raise
                # finalize the data OWNER (flat), not the reshaped view:
                # sub-views collapse .base to the owner, so only it is
                # guaranteed to outlive every surviving slice
                weakref.finalize(nd_owner(arr), _release_entry, shm_store, v.object_id, release)
                return _as_tensor(arr, tensor) if tensor else arr
            try:
                dtype_str, shape, *tensor = pickle.loads(view[:meta_size])
                arr = np.frombuffer(view[meta_size:], dtype=np.dtype(dtype_str)).reshape(shape)
                arr = arr.copy()  # detach from the pinned segment
            finally:
                shm_store.release(v.object_id)
            if release:
                shm_store.delete(v.object_id)
            return _as_tensor(arr, tensor) if tensor else arr
        return v

    if isinstance(value, tuple):
        return tuple(dec(v) for v in value)
    if isinstance(value, list):
        return [dec(v) for v in value]
    if isinstance(value, dict):
        return {k: dec(v) for k, v in value.items()}
    return dec(value)
