"""Thin client: the user-side API over a client-server connection.

Parity with ``python/ray/util/client/`` (``ClientObjectRef`` in
``common.py``, the ``ray.util.connect`` entry): ``connect("host:port")``
returns a :class:`ClientContext` exposing remote/get/put/wait/kill with the
same call shapes as the in-process API, but every operation executes in the
server's runtime. A background reader thread multiplexes responses to
concurrent callers by request id.

The port's copy of ``ray_tpu/util/client/worker.py``.  The session opens
with a ``hello`` naming ``common.CLIENT_PROTOCOL``: a server of the JAX
package (or anything else) answers otherwise, and :func:`connect` raises
:class:`~ray_tpu_torch.util.client.common.ClientProtocolError`.  Functions
and classes go to the server pickled by value through cloudpickle where it
is installed, else by reference (``core/serialization.dumps_by_value``): a
client without cloudpickle sends module-level definitions the server can
import, and refuses a closure at ``remote()``.

What a client gets back for a ref that holds a tensor: the value crosses
the same pickle path that carries the JAX package's device arrays to its
clients, so a CUDA tensor on the server reaches the client as a CPU tensor
of the same dtype, shape and values (its host bytes), and a CPU tensor as
itself; the client never needs a card.
"""

from __future__ import annotations

import hashlib
import socket
import threading
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch.core.serialization import dumps_by_value
from ray_tpu_torch.util.client.common import (
    CLIENT_PROTOCOL,
    ActorMarker,
    ClientProtocolError,
    RefMarker,
    recv_msg,
    send_msg,
)


class ClientObjectRef:
    __slots__ = ("_id", "_ctx", "__weakref__")

    def __init__(self, ref_id: bytes, ctx: "ClientContext"):
        self._id = ref_id
        self._ctx = ctx

    def id(self) -> bytes:
        return self._id

    def hex(self) -> str:
        return self._id.hex()

    def __repr__(self):
        return f"ClientObjectRef({self._id.hex()[:16]})"

    def __reduce__(self):  # only markers cross the wire
        raise TypeError("ClientObjectRef cannot be pickled; pass it in task args instead")

    def __del__(self):
        ctx = self._ctx
        if ctx is not None and not ctx._closed:
            ctx._release(self._id)


class ClientRemoteFunction:
    def __init__(self, ctx: "ClientContext", fn, options: Optional[dict] = None):
        self._ctx = ctx
        self._fn = fn
        self._fn_bytes = dumps_by_value(fn)
        self._fn_hash = hashlib.sha1(self._fn_bytes).digest()
        self._options = options or {}

    def options(self, **new_options) -> "ClientRemoteFunction":
        return ClientRemoteFunction(self._ctx, self._fn, {**self._options, **new_options})

    def remote(self, *args, **kwargs):
        out = self._ctx._call(
            op="task",
            fn=self._fn_bytes,
            fn_hash=self._fn_hash,
            args=self._ctx._encode(args),
            kwargs=self._ctx._encode(kwargs),
            options=self._options,
        )
        if isinstance(out, list):
            return [ClientObjectRef(i, self._ctx) for i in out]
        return ClientObjectRef(out, self._ctx)


class ClientActorMethod:
    def __init__(self, handle: "ClientActorHandle", name: str):
        self._handle = handle
        self._name = name

    def remote(self, *args, **kwargs) -> ClientObjectRef:
        ctx = self._handle._ctx
        ref_id = ctx._call(
            op="actor_call",
            actor_id=self._handle._id,
            method=self._name,
            args=ctx._encode(args),
            kwargs=ctx._encode(kwargs),
        )
        return ClientObjectRef(ref_id, ctx)


class ClientActorHandle:
    def __init__(self, ctx: "ClientContext", actor_id: bytes, methods: List[str]):
        self._ctx = ctx
        self._id = actor_id
        self._methods = set(methods)

    def __getattr__(self, name: str) -> ClientActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ClientActorMethod(self, name)


class ClientActorClass:
    def __init__(self, ctx: "ClientContext", cls, options: Optional[dict] = None):
        self._ctx = ctx
        self._cls = cls
        self._cls_bytes = dumps_by_value(cls)
        self._fn_hash = hashlib.sha1(self._cls_bytes).digest()
        self._options = options or {}

    def options(self, **new_options) -> "ClientActorClass":
        return ClientActorClass(self._ctx, self._cls, {**self._options, **new_options})

    def remote(self, *args, **kwargs) -> ClientActorHandle:
        out = self._ctx._call(
            op="create_actor",
            cls=self._cls_bytes,
            fn_hash=self._fn_hash,
            args=self._ctx._encode(args),
            kwargs=self._ctx._encode(kwargs),
            options=self._options,
        )
        return ClientActorHandle(self._ctx, out["actor_id"], out["methods"])


class ClientContext:
    """The connected session (``ray.util.client.RayAPIStub`` parity)."""

    def __init__(self, address: str, connect_timeout: float = 10.0):
        host, _, port = address.rpartition(":")
        self._sock = socket.create_connection((host or "127.0.0.1", int(port)), timeout=connect_timeout)
        self._sock.settimeout(None)
        self._send_lock = threading.Lock()
        self._pending: Dict[int, Future] = {}
        self._pending_lock = threading.Lock()
        self._rid = 0
        self._closed = False
        self._released: List[bytes] = []
        self._reader = threading.Thread(target=self._read_loop, name="rt-client-reader", daemon=True)
        self._reader.start()
        try:
            reply = self._call(op="hello", protocol=CLIENT_PROTOCOL)
        except ConnectionError as exc:
            self.disconnect()
            raise ClientProtocolError(
                f"{address} closed the session at its hello: not a ray_tpu_torch "
                f"client server ({exc})") from None
        except Exception as exc:  # noqa: BLE001 — the server's refusal, typed here
            self.disconnect()
            raise ClientProtocolError(
                f"{address} is not a ray_tpu_torch client server (it answered the "
                f"{CLIENT_PROTOCOL} hello with {type(exc).__name__}: {exc})") from None
        if not isinstance(reply, dict) or reply.get("protocol") != CLIENT_PROTOCOL:
            self.disconnect()
            raise ClientProtocolError(f"{address} answered the hello with {reply!r}")

    # ------------------------------------------------------------------
    def _read_loop(self) -> None:
        try:
            while not self._closed:
                reply = recv_msg(self._sock)
                with self._pending_lock:
                    fut = self._pending.pop(reply["rid"], None)
                if fut is None:
                    continue
                if reply["ok"]:
                    fut.set_result(reply["result"])
                else:
                    fut.set_exception(reply["error"])
        except (ConnectionError, OSError) as exc:
            with self._pending_lock:
                pending, self._pending = self._pending, {}
            for fut in pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError(f"client connection lost: {exc}"))

    def _call(self, **msg) -> Any:
        if self._closed:
            raise ConnectionError("client context is disconnected")
        fut: Future = Future()
        with self._pending_lock:
            self._rid += 1
            rid = self._rid
            self._pending[rid] = fut
        msg["rid"] = rid
        with self._send_lock:
            send_msg(self._sock, msg)
        return fut.result()

    def _release(self, ref_id: bytes) -> None:
        # batched, fire-and-forget distributed GC
        self._released.append(ref_id)
        if len(self._released) >= 32:
            batch, self._released = self._released, []
            try:
                with self._pending_lock:
                    self._rid += 1
                    rid = self._rid
                    self._pending[rid] = Future()  # reply discarded by reader
                with self._send_lock:
                    send_msg(self._sock, {"rid": rid, "op": "release", "ref_ids": batch})
            except (ConnectionError, OSError):
                pass

    def _encode(self, obj):
        """Swap ClientObjectRef/ClientActorHandle for wire markers."""
        if isinstance(obj, ClientObjectRef):
            return RefMarker(obj._id)
        if isinstance(obj, ClientActorHandle):
            return ActorMarker(obj._id)
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._encode(x) for x in obj)
        if isinstance(obj, dict):
            return {k: self._encode(v) for k, v in obj.items()}
        return obj

    # ------------------------------------------------------------------ API
    def remote(self, fn_or_class=None, **options):
        if fn_or_class is None:
            return lambda f: self.remote(f, **options)
        if isinstance(fn_or_class, type):
            return ClientActorClass(self, fn_or_class, options or None)
        return ClientRemoteFunction(self, fn_or_class, options or None)

    def put(self, value: Any) -> ClientObjectRef:
        return ClientObjectRef(self._call(op="put", value=value), self)

    def get(self, refs: Union[ClientObjectRef, Sequence[ClientObjectRef]], *, timeout: Optional[float] = None):
        single = isinstance(refs, ClientObjectRef)
        ref_list = [refs] if single else list(refs)
        values = self._call(op="get", ref_ids=[r._id for r in ref_list], timeout=timeout)
        return values[0] if single else values

    def wait(self, refs: Sequence[ClientObjectRef], *, num_returns: int = 1, timeout: Optional[float] = None):
        by_id = {r._id: r for r in refs}
        ready_ids, not_ready_ids = self._call(
            op="wait", ref_ids=[r._id for r in refs], num_returns=num_returns, timeout=timeout
        )
        return [by_id[i] for i in ready_ids], [by_id[i] for i in not_ready_ids]

    def kill(self, actor: ClientActorHandle, *, no_restart: bool = True) -> None:
        self._call(op="kill_actor", actor_id=actor._id, no_restart=no_restart)

    def cluster_resources(self) -> dict:
        return self._call(op="cluster_info")["cluster_resources"]

    def available_resources(self) -> dict:
        return self._call(op="cluster_info")["available_resources"]

    def nodes(self) -> list:
        return self._call(op="cluster_info")["nodes"]

    def disconnect(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.disconnect()


def connect(address: str, **kw) -> ClientContext:
    """Connect to a :class:`~ray_tpu_torch.util.client.server.ClientServer`
    (``ray.util.connect`` parity; address form ``"host:port"`` or
    ``"ray://host:port"``)."""
    if address.startswith("ray://"):
        address = address[len("ray://"):]
    ctx = ClientContext(address, **kw)
    connect._last_context = ctx  # ray.util.disconnect() closes the latest
    return ctx
