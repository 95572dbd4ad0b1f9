"""Device-to-device movement of staged tensors between processes of one host.

The port's counterpart of the transfer-server half of
``ray_tpu/runtime/device_plane.py``.  Where the JAX package stages a device
array on a ``jax.experimental.transfer`` server and the consumer pulls it
over ICI/DCN, here a producer stages a CUDA tensor on a
:class:`CudaIpcTransferServer` and a consumer process on the same host pulls
it over CUDA IPC: the server answers a uuid with the staged tensor, pickled
by ``torch.multiprocessing``'s reducer (which sends a CUDA IPC handle, not
the bytes), and the consumer copies the block into memory of its own, then
drops the handle.  No byte leaves the card.

The surface is the reference's: :func:`install_transfer_server`,
:func:`transfer_server`, :func:`transfer_address`, :func:`offer_device_pull`,
:func:`device_pull` and ``stats``.  :func:`transfer_server` starts the CUDA
IPC server when the process has a CUDA device and returns None on the CPU;
tests install the host-memory fake (``runtime/fake_transfer.py``) with
``install_transfer_server``.  The port reads no environment switch for it.

CUDA IPC's conditions, and how this module meets them:

  * a consumer in another process opens the handle: child processes are
    started with ``spawn`` (never ``fork`` after CUDA is initialised), and
    a process never pulls its own offer (the in-process registry rung of
    ``serve/disagg.py`` serves those first);
  * the producer synchronises its stream before it offers a tensor, so the
    consumer never reads a half-written block;
  * the producer keeps the staged tensor alive until the consumer has
    copied it out (the server holds it until the consumer's ack, the engine
    until ``release_migration``), and ``torch.cuda.ipc_collect()`` on
    release frees what the consumers have let go;
  * connections authenticate with the process's ``multiprocessing`` authkey,
    which spawned children inherit, so only processes of one tree pull.

A consumer keeps its connections to a peer open between pulls (an idle pool
per peer address), so the blocks of a migration ride one connection. Every
read on a connection, the authentication handshake included, is bounded by
the caller's ``timeout_s``: a stalled producer fails the pull (None), it
does not hang the decode caller.

The object-store envelope (``DevicePickler``, the first half of this
module) is the counterpart of the reference's: a tensor inside a value the
data plane frames reduces to its shape, dtype, device kind and an
out-of-band ``PickleBuffer`` of its host bytes, so its bytes never enter
the pickle stream, and the receiver rebuilds a real tensor: on its own
current CUDA device when the sender's was on one and the receiver has one,
else on the CPU.  The envelope takes every concrete tensor, CPU ones
included (:func:`is_device_array`), as the reference's takes every
``jax.Array`` on the CPU backend; the object store's device tier
(``core/object_store._is_device_array``) takes CUDA tensors only.  The
reducer comes before ``torch.multiprocessing``'s: a CUDA tensor framed by
the envelope never travels as a CUDA IPC handle.
"""

from __future__ import annotations

import io
import os
import pickle
import socket
import struct
import sys
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

_FIELDS = ("arrays_packed", "arrays_restored", "bytes_moved", "ici_pulls",
           "connects", "connect_s", "open_s", "copy_s")


class DeviceStats:
    """Tensors through the envelope, pulls through the transfer server,
    their bytes, and where a pull's time goes."""

    def __init__(self):
        self._lock = threading.Lock()
        self.arrays_packed = 0     # tensors serialized via the envelope
        self.arrays_restored = 0   # tensors rebuilt from it
        self.bytes_moved = 0
        self.ici_pulls = 0         # transfers that rode the transfer server
        self.connects = 0          # connections opened to a peer's server
        self.connect_s = 0.0       # opening them, authentication included
        self.open_s = 0.0          # uuid sent -> the peer's block in hand (IPC handle opened)
        self.copy_s = 0.0          # copying the blocks out, synchronised

    def add(self, field: str, n: float = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def snapshot(self) -> dict:
        with self._lock:
            return {f: getattr(self, f) for f in _FIELDS}


stats = DeviceStats()


# --------------------------------------------------------------------------
# the object-store envelope
# --------------------------------------------------------------------------
def is_device_array(value: Any) -> bool:
    """A concrete tensor the envelope frames: any ``torch.Tensor`` with
    storage (on the CPU too), not one on the meta device and not a fake or
    functional tensor of a trace."""
    torch = sys.modules.get("torch")
    if torch is None or not isinstance(value, torch.Tensor):
        return False
    if value.device.type == "meta":
        return False
    # subclasses made while tracing (FakeTensor, FunctionalTensor) hold no data
    return type(value) in (torch.Tensor, torch.nn.Parameter)


def _rebuild_device_array(shape, dtype_str, buf, on_cuda=False):
    """Unpickle hook: raw host bytes -> a tensor, on this process's current
    CUDA device when the sender's tensor was on one and this process has
    one, else on the CPU."""
    import torch

    view = memoryview(buf).cast("B")
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given buffer is not writable")
        raw = torch.frombuffer(view, dtype=torch.uint8) if view.nbytes else torch.empty(
            0, dtype=torch.uint8)
    out = raw.view(getattr(torch, dtype_str)).reshape(tuple(shape))
    if on_cuda and torch.cuda.is_available():
        out = out.to(torch.device("cuda", torch.cuda.current_device()))
    elif view.readonly:
        out = out.clone()  # never a tensor that aliases read-only bytes
    stats.add("arrays_restored")
    stats.add("bytes_moved", view.nbytes)
    return out


class _DeviceReducerMixin:
    """reducer_override shared by the pickle and cloudpickle paths."""

    def reducer_override(self, obj):
        if is_device_array(obj):
            import torch

            host = obj.detach()
            on_cuda = host.is_cuda
            if on_cuda:
                host = host.cpu()  # device to host: a sync point
            host = host.contiguous()
            stats.add("arrays_packed")
            # uint8 view: bfloat16 and the float8 types have no numpy
            # dtype; the raw bytes stream identically either way
            raw = host.reshape(-1).view(torch.uint8).numpy()
            return (
                _rebuild_device_array,
                (tuple(host.shape), str(host.dtype).removeprefix("torch."),
                 pickle.PickleBuffer(raw), on_cuda),
            )
        return NotImplemented


class DevicePickler(_DeviceReducerMixin, pickle.Pickler):
    pass


def dumps_with_device_envelope(value: Any, buffer_callback) -> bytes:
    """pickle-5 dump routing concrete tensors through the device envelope
    (buffers out-of-band).  The cloudpickle fallback keeps the same reducer
    via its own pickler subclass.  Buffers reach the caller only from the
    attempt that SUCCEEDS (a half-failed pass must not leak)."""
    collected: list = []
    out = io.BytesIO()
    try:
        DevicePickler(out, protocol=5, buffer_callback=collected.append).dump(value)
    except (AttributeError, TypeError, pickle.PicklingError):
        import cloudpickle

        class _DeviceCloudPickler(_DeviceReducerMixin, cloudpickle.CloudPickler):
            def reducer_override(self, obj):
                r = _DeviceReducerMixin.reducer_override(self, obj)
                if r is not NotImplemented:
                    return r
                return super().reducer_override(obj)

        collected.clear()
        out = io.BytesIO()
        _DeviceCloudPickler(out, protocol=5, buffer_callback=collected.append).dump(value)
    for b in collected:
        buffer_callback(b)
    return out.getvalue()


def uuid_for_object(oid_bytes: bytes) -> int:
    """Stable transfer-uuid for an ObjectID (both ends derive it)."""
    return int.from_bytes(oid_bytes[:8], "little") or 1


class _Ticket:
    """``await_pull``'s return: completes when the staged entry is pulled
    (the device plane releases its staging-admission slot then)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._done = False
        self._callbacks = []

    def add_done_callback(self, fn) -> None:
        with self._lock:
            if not self._done:
                self._callbacks.append(fn)
                return
        fn(self)

    def _fire(self) -> None:
        with self._lock:
            if self._done:
                return
            self._done = True
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 — a callback must not kill the server
                pass


class CudaIpcTransferServer:
    """Same-host transfer server over CUDA IPC: a thread accepting on a
    ``multiprocessing.connection.Listener`` on localhost.  Each connection
    sends uuids; the server answers with the staged CUDA tensor (an IPC
    handle, by ``torch.multiprocessing``'s reducer) or None, and waits for
    the consumer's ack that it has copied the block out before it lets go
    of the tensor.  One staging per pull: a pull consumes its entry."""

    def __init__(self, host: str = "127.0.0.1"):
        import multiprocessing
        from multiprocessing.connection import Listener

        import torch.multiprocessing  # noqa: F401 — registers the CUDA tensor reducers

        self._authkey = bytes(multiprocessing.current_process().authkey)
        self._listener = Listener((host, 0), authkey=self._authkey)
        self._host, self._port = self._listener.address
        self._staged: Dict[int, Tuple[Any, _Ticket]] = {}
        self._lock = threading.Lock()
        self._closed = False
        self.pulls_served = 0
        threading.Thread(target=self._accept_loop, name="cuda-ipc-xfer", daemon=True).start()

    # -- surface consumed by the device plane ------------------------------
    def address(self) -> str:
        return f"{self._host}:{self._port}"

    def await_pull(self, uuid: int, tensor) -> _Ticket:
        import torch

        if tensor.device.type != "cuda":
            raise ValueError(f"CUDA IPC stages CUDA tensors, got one on {tensor.device}")
        # the consumer reads through the handle on its own stream: every
        # write to the block must have landed before it is offered
        torch.cuda.current_stream(tensor.device).synchronize()
        ticket = _Ticket()
        with self._lock:
            self._staged[uuid] = (tensor, ticket)
        return ticket

    def withdraw(self, uuid: int) -> None:
        """Drop an unpulled offer (the producer released its staging)."""
        with self._lock:
            entry = self._staged.pop(uuid, None)
        if entry is not None:
            entry[1]._fire()

    def connect(self, addr: str, timeout_s: Optional[float] = None) -> "_IpcConnection":
        return _IpcConnection(addr, self._authkey, timeout_s)

    def staged_count(self) -> int:
        with self._lock:
            return len(self._staged)

    def close(self) -> None:
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass

    # -- server side -------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn = self._listener.accept()
            except (OSError, EOFError):
                if self._closed:
                    return
                continue  # a peer that failed authentication
            threading.Thread(
                target=self._serve, args=(conn,), name="cuda-ipc-xfer-serve", daemon=True
            ).start()

    def _serve(self, conn) -> None:
        try:
            while not self._closed:
                uuid = conn.recv()
                with self._lock:
                    entry = self._staged.pop(uuid, None)
                if entry is None:
                    conn.send(None)
                    continue
                tensor, ticket = entry
                conn.send(tensor)
                conn.recv()  # the consumer's ack: it has copied the block out
                del tensor
                self.pulls_served += 1
                ticket._fire()
        except (EOFError, OSError):
            pass
        finally:
            conn.close()


def _bound_reads(fd: int, timeout_s: Optional[float]) -> None:
    """Make every read and write on socket ``fd`` fail (an ``OSError``)
    after ``timeout_s`` seconds instead of blocking; None leaves it
    unbounded. The socket stays blocking, as ``Connection`` needs."""
    if timeout_s is None:
        return
    usec = max(1, round(timeout_s * 1e6))  # a zero timeval would mean no bound
    tv = struct.pack("ll", usec // 1_000_000, usec % 1_000_000)
    sock = socket.socket(fileno=os.dup(fd))
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVTIMEO, tv)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO, tv)
    finally:
        sock.close()


class _IpcConnection:
    def __init__(self, addr: str, authkey: bytes, timeout_s: Optional[float] = None):
        from multiprocessing.connection import Client, answer_challenge, deliver_challenge

        import torch.multiprocessing  # noqa: F401 — registers the CUDA tensor rebuilders

        host, _, port = addr.rpartition(":")
        # authenticate by hand, as ``Client(authkey=)`` would, once the
        # socket's reads are bounded: a stalled peer must not hang it
        self._conn = Client((host or "127.0.0.1", int(port)))
        try:
            _bound_reads(self._conn.fileno(), timeout_s)
            answer_challenge(self._conn, authkey)
            deliver_challenge(self._conn, authkey)
        except BaseException:
            self._conn.close()
            raise
        self._lock = threading.Lock()

    def pull(self, uuid: int, template) -> Any:
        """A copy, on this process's current CUDA device, of the tensor
        staged under ``uuid``; ``template`` gives its shape and dtype."""
        import torch

        with self._lock:
            t0 = time.perf_counter()
            self._conn.send(uuid)
            shared = self._conn.recv()
            if shared is None:
                raise KeyError(f"uuid {uuid} not staged on peer")
            try:
                if tuple(shared.shape) != tuple(template.shape) or shared.dtype != template.dtype:
                    raise ValueError(
                        f"staged block is {tuple(shared.shape)} {shared.dtype}, the ticket "
                        f"says {tuple(template.shape)} {template.dtype}"
                    )
                t1 = time.perf_counter()
                out = torch.empty_like(shared, device=torch.cuda.current_device())
                out.copy_(shared)
                torch.cuda.current_stream().synchronize()  # copied before the handle goes
                t2 = time.perf_counter()
            finally:
                del shared
                self._conn.send(True)
        stats.add("open_s", t1 - t0)
        stats.add("copy_s", t2 - t1)
        return out

    def close(self) -> None:
        self._conn.close()


# --------------------------------------------------------------------------
# the process's transfer server
# --------------------------------------------------------------------------
_xfer_lock = threading.Lock()
_xfer_server = None
_xfer_probed = False


def install_transfer_server(server: Optional[Any]) -> None:
    """Inject a transfer server (tests, the fake): later ``transfer_server()``
    calls return it without probing.  None resets to the unprobed state."""
    global _xfer_server, _xfer_probed, _staged_outstanding
    with _xfer_lock:
        _xfer_server = server
        _xfer_probed = server is not None
    # staged entries belong to the outgoing server; the admission count
    # resets with it, and the pooled connections it opened go
    with _staged_lock:
        _staged_outstanding = 0
    with _pool_lock:
        idle = [c for conns in _idle.values() for c in conns]
        _idle.clear()
    for conn in idle:
        conn.close()


def transfer_server() -> Optional[Any]:
    """This process's transfer server: a :class:`CudaIpcTransferServer`,
    started on first use when the process has a CUDA device, else None."""
    global _xfer_server, _xfer_probed
    with _xfer_lock:
        if _xfer_probed:
            return _xfer_server
        _xfer_probed = True
        import torch

        _xfer_server = CudaIpcTransferServer() if torch.cuda.is_available() else None
        return _xfer_server


def transfer_address() -> Optional[str]:
    server = transfer_server()
    return None if server is None else server.address()


_staged_lock = threading.Lock()
_staged_outstanding = 0
_STAGED_CAP = 256


def offer_device_pull(uuid: int, array) -> bool:
    """Producer side: stage a tensor for one pull.  False when there is no
    transfer server, the staging cap is reached or the server refuses (the
    ticket then advertises no device rung)."""
    global _staged_outstanding
    server = transfer_server()
    if server is None:
        return False
    with _staged_lock:
        if _staged_outstanding >= _STAGED_CAP:
            return False
    try:
        res = server.await_pull(uuid, array)
    except (ValueError, RuntimeError):
        return False
    with _staged_lock:
        _staged_outstanding += 1

    def _release(_ticket):
        global _staged_outstanding
        with _staged_lock:
            _staged_outstanding = max(0, _staged_outstanding - 1)

    res.add_done_callback(_release)
    return True


def withdraw_device_pull(uuid: int) -> None:
    """Producer side: drop an offer that will not be pulled (its staging was
    released), so the server stops holding the tensor."""
    server = transfer_server()
    if server is not None:
        server.withdraw(uuid)


_pool_lock = threading.Lock()
# (peer address, timeout_s) -> idle connections to it, newest last
_idle: Dict[Tuple[str, Optional[float]], List[Any]] = {}
_IDLE_CAP = 8  # a peer's idle connections kept; concurrent pulls open more


def device_pull(addr: str, uuid: int, template,
                timeout_s: Optional[float] = None) -> Optional[Any]:
    """Consumer side: pull a staged tensor from the transfer server at
    ``addr``, over an idle connection to it if there is one.  ``template``
    (any tensor, e.g. on the meta device) gives the shape and dtype;
    ``timeout_s`` bounds each read (None: unbounded).  None when this
    process has no transfer server or the pull fails."""
    from multiprocessing import AuthenticationError

    server = transfer_server()
    if server is None:
        return None
    key = (addr, timeout_s)
    with _pool_lock:
        idle = _idle.get(key)
        conn = idle.pop() if idle else None
    try:
        if conn is None:
            t0 = time.perf_counter()
            conn = server.connect(addr, timeout_s)
            stats.add("connects")
            stats.add("connect_s", time.perf_counter() - t0)
        out = conn.pull(uuid, template)
    except (OSError, EOFError, KeyError, ValueError, RuntimeError, AuthenticationError):
        if conn is not None:
            conn.close()  # its protocol state is unknown: never pooled again
        return None
    with _pool_lock:
        idle = _idle.setdefault(key, [])
        if len(idle) < _IDLE_CAP:
            idle.append(conn)
            conn = None
    if conn is not None:
        conn.close()
    stats.add("ici_pulls")
    stats.add("bytes_moved", out.numel() * out.element_size())
    return out
