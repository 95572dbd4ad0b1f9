"""TCP control-plane transport: the wire between the head and node agents.

This is the transport layer the rest of the runtime rides when a node is a
separate OS process on (possibly) a separate machine.  Role parity with the
reference's gRPC plumbing (``src/ray/rpc/grpc_server.h``,
``src/ray/rpc/client_call.h``) and the raylet<->GCS session it carries
(``src/ray/protobuf/node_manager.proto:371-433``,
``src/ray/gcs/gcs_server/gcs_server.h:78``) — re-designed small: one duplex
TCP connection per node carries requests in BOTH directions (the head pushes
dispatch; the agent pushes results, pulls, resource reports), instead of the
reference's 2N unary channels.

Framing reuses the worker-pool protocol (``runtime/protocol.py``): 4-byte
length + pickle-5 ``(msg_type, payload)``.  Three message shapes:

  * one-way:      ``send(type, payload)`` — no reply expected,
  * request:      ``request(type, payload)`` — payload carries ``_rid``; the
                  peer replies with ``("__reply__", {"_rid": rid, ...})``,
  * deferred:     a handler returns :data:`DEFER` and later calls
                  ``conn.send_reply(rid, payload)`` (used by object pulls,
                  which resolve asynchronously through the object directory).

The port's copy of ``ray_tpu/runtime/rpc.py``.  Deltas: values and task
arguments pickle through ``core/serialization.py`` (a tensor crosses as its
host bytes and arrives as a CPU tensor, never through torch's own pickling),
and the handshake names the port's own protocol (:data:`PROTOCOL_NAME`,
:data:`PROTOCOL_VERSION`): a JAX-package agent and a port head, or the other
way round, refuse each other at ``register_node_config`` with
:class:`ProtocolMismatchError` instead of registering and failing later on a
frame neither side can read.

Ordering: inbound messages dispatch on ONE thread per connection, in arrival
order — per-actor call ordering and stream-item ordering therefore hold
end-to-end without sequence numbers (the reference needs them because its
calls fan out over concurrent gRPC streams).  Replies are matched and run on
the reader thread so a blocked dispatch thread can still receive its answer.
"""

from __future__ import annotations

import itertools
import pickle
import queue
import socket
import threading
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

from ray_tpu_torch.runtime import failpoints
from ray_tpu_torch.runtime.protocol import FrameReader, send_msg as _send_msg

#: Wire-protocol version: bumped on any incompatible change to message
#: shapes (the reference versions its protobuf schemas; pickle frames
#: assume same-version-everywhere, so the version is checked EXPLICITLY at
#: node registration instead of silently corrupting).  The port numbers its
#: own protocol apart from the JAX package's (which is at 6): the message
#: shapes match, but the values inside the frames do not (tensors, not
#: ``jax.Array``s), so the two packages must never join one cluster.
#: v1001: the JAX package's v6 message set, spoken by the port.
#: v1002: the plan-install frames (``install_plan``, ``uninstall_plan``,
#: ``plan_broken``) and the thin client's ops, its ``hello`` included.
PROTOCOL_VERSION = 1002

#: The protocol family a port head names in its ``register_node_config``
#: reply; an agent of the port refuses a head that names another (a JAX
#: head names none).
PROTOCOL_NAME = "ray_tpu_torch"

#: Sentinel a handler returns to take ownership of replying later.
DEFER = object()


class RpcError(ConnectionError):
    """Transport-level failure (peer died, handler raised)."""


class RemoteHandlerError(RpcError):
    """The peer's handler raised; carries the remote traceback."""


class ControlPlaneTimeout(RpcError, TimeoutError):
    """A control-plane request ran out its time budget without a reply.

    Typed so callers can distinguish "the peer is slow
    or partitioned" from "the connection died" (:class:`RpcError` base) and
    apply backoff-retry (:func:`retry_with_backoff`) or surface the
    remaining deadline budget — a generic RpcError forced every caller to
    string-match."""

    def __init__(self, msg_type: str, timeout: Optional[float]):
        self.msg_type = msg_type
        self.timeout = timeout
        super().__init__(
            f"control-plane rpc {msg_type!r} timed out after {timeout}s"
        )

    def __reduce__(self):
        # args holds the formatted message; replaying __init__ with it
        # would TypeError (two required params) — rebuild from the fields
        return (ControlPlaneTimeout, (self.msg_type, self.timeout))


class FunctionNotCached(KeyError):
    """decode_spec: the spec's fn_id is absent from this agent's fn cache
    (the blob rode another channel whose frame hasn't landed yet)."""


class ProtocolMismatchError(RpcError):
    """Peer speaks a different wire-protocol version — permanent, never
    retried (reconnect loops fail fast with the diagnostic)."""


class RpcConnection:
    """One duplex framed-pickle connection; thread-safe sends."""

    def __init__(
        self,
        sock: socket.socket,
        handlers: Dict[str, Callable],
        on_disconnect: Optional[Callable[["RpcConnection"], None]] = None,
        name: str = "rpc",
        defer_dispatch: bool = False,
    ):
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._handlers = handlers
        self._on_disconnect = on_disconnect
        self._name = name
        self._send_lock = threading.Lock()
        self._rid = itertools.count(1)
        self._pending: Dict[int, Callable] = {}  # rid -> callback(payload, error)
        self._pending_lock = threading.Lock()
        self._inbox: "queue.SimpleQueue" = queue.SimpleQueue()
        self._closed = threading.Event()
        self.peer: Any = None  # slot for the owner to hang state on
        self._reader = threading.Thread(target=self._read_loop, name=f"{name}-reader", daemon=True)
        self._dispatcher = threading.Thread(target=self._dispatch_loop, name=f"{name}-dispatch", daemon=True)
        self._reader.start()
        if not defer_dispatch:
            self._dispatcher.start()

    def start_dispatch(self) -> None:
        """Start inbound dispatch after the owner finished installing
        handlers (messages received meanwhile queue in arrival order)."""
        self._dispatcher.start()

    # ------------------------------------------------------------------
    # sending
    # ------------------------------------------------------------------
    def _send_frame(self, msg_type: str, payload: dict) -> None:
        if failpoints.ARMED:
            # chaos: drop/partition make the frame vanish on the "wire"
            # (one-ways are simply lost; requests hit their timeouts — a
            # network partition as the caller experiences it); raise tears
            # the connection down like a peer death (reconnect machinery)
            try:
                action = failpoints.fp("rpc.call")
            except failpoints.FailpointInjected as exc:
                raise OSError(str(exc)) from None
            if action is not None:
                return
        with self._send_lock:
            _send_msg(self._sock, msg_type, payload)

    def send(self, msg_type: str, payload: dict) -> None:
        """One-way notification."""
        try:
            self._send_frame(msg_type, payload)
        except OverflowError as exc:
            # nothing reached the wire — the connection stays usable
            raise RpcError(f"message too large: {exc}") from exc
        except OSError as exc:
            self._teardown()
            raise RpcError(f"connection lost during send: {exc}") from exc

    def request(self, msg_type: str, payload: dict, timeout: Optional[float] = 30.0) -> dict:
        """Blocking request/response."""
        result: list = [None, None]
        done = threading.Event()

        def cb(reply, error):
            result[0], result[1] = reply, error
            done.set()

        rid_box: list = [None]
        self.request_async(msg_type, payload, cb, _rid_box=rid_box)
        if not done.wait(timeout):
            # Drop the pending entry so the map can't grow unboundedly and a
            # late reply can't fire a stale callback.
            with self._pending_lock:
                self._pending.pop(rid_box[0], None)
            raise ControlPlaneTimeout(msg_type, timeout)
        if result[1] is not None:
            raise result[1]
        return result[0]

    def request_async(
        self, msg_type: str, payload: dict, callback: Callable, _rid_box: Optional[list] = None
    ) -> None:
        """Fire a request; ``callback(reply, error)`` runs on the reader
        thread when the response lands (or on teardown with an RpcError)."""
        rid = next(self._rid)
        if _rid_box is not None:
            _rid_box[0] = rid
        with self._pending_lock:
            if self._closed.is_set():
                callback(None, RpcError("connection closed"))
                return
            self._pending[rid] = callback
        payload = dict(payload)
        payload["_rid"] = rid
        try:
            self._send_frame(msg_type, payload)
        except OverflowError as exc:
            # Frame over the codec cap: nothing reached the wire, so the
            # connection stays healthy — fail just this request.
            with self._pending_lock:
                self._pending.pop(rid, None)
            callback(None, RpcError(f"request too large: {exc}"))
        except OSError as exc:
            with self._pending_lock:
                self._pending.pop(rid, None)
            self._teardown()
            callback(None, RpcError(f"connection lost: {exc}"))

    def send_reply(self, rid: int, payload: dict) -> None:
        payload = dict(payload)
        payload["_rid"] = rid
        try:
            self._send_frame("__reply__", payload)
        except OSError:
            self._teardown()

    # ------------------------------------------------------------------
    # receiving
    # ------------------------------------------------------------------
    def _read_loop(self) -> None:
        reader = FrameReader(self._sock)
        try:
            while not self._closed.is_set():
                msg_type, payload = reader.recv()
                if msg_type == "__reply__":
                    rid = payload.pop("_rid", None)
                    with self._pending_lock:
                        cb = self._pending.pop(rid, None)
                    if cb is not None:
                        exc_text = payload.get("_exc")
                        if exc_text is not None:
                            cb(None, RemoteHandlerError(exc_text))
                        else:
                            cb(payload, None)
                else:
                    self._inbox.put((msg_type, payload))
        except (ConnectionError, OSError, EOFError, ValueError, pickle.UnpicklingError):
            # ValueError = corrupt frame header; stream unrecoverable
            pass
        finally:
            self._teardown()

    def _dispatch_loop(self) -> None:
        while True:
            item = self._inbox.get()
            if item is None:
                return
            msg_type, payload = item
            rid = payload.pop("_rid", None)
            handler = self._handlers.get(msg_type)
            try:
                if handler is None:
                    raise KeyError(f"no handler for rpc message {msg_type!r}")
                result = handler(self, payload) if rid is None else handler(self, payload, rid)
                if rid is not None and result is not DEFER:
                    self.send_reply(rid, result if isinstance(result, dict) else {})
            except Exception:  # noqa: BLE001 — a bad message must not kill the link
                if rid is not None:
                    self.send_reply(rid, {"_exc": traceback.format_exc()})
                else:
                    import sys

                    print(
                        f"[{self._name}] handler for {msg_type!r} failed:\n{traceback.format_exc()}",
                        file=sys.stderr,
                    )

    # ------------------------------------------------------------------
    def _teardown(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._inbox.put(None)
        with self._pending_lock:
            pending = list(self._pending.items())
            self._pending.clear()
        for _rid, cb in pending:
            try:
                cb(None, RpcError("connection closed"))
            except Exception:  # noqa: BLE001
                pass
        cb = self._on_disconnect
        self._on_disconnect = None
        if cb is not None:
            try:
                cb(self)
            except Exception:  # noqa: BLE001
                pass

    def close(self) -> None:
        self._teardown()

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    @property
    def local_ip(self) -> str:
        """The local interface IP this connection rides — the address the
        PEER can reach this process at (used to advertise data-plane
        endpoints on multi-host clusters, where 127.0.0.1 is meaningless)."""
        try:
            return self._sock.getsockname()[0]
        except OSError:
            return "127.0.0.1"

    @property
    def peer_ip(self) -> str:
        try:
            return self._sock.getpeername()[0]
        except OSError:
            return "127.0.0.1"


class RpcServer:
    """Accept loop creating an :class:`RpcConnection` per client.

    ``handler_factory(conn)`` returns the handler dict for that connection
    (letting the owner bind per-connection state before any message lands).
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        handler_factory: Callable[[RpcConnection], Dict[str, Callable]] = None,
        on_disconnect: Optional[Callable[[RpcConnection], None]] = None,
        name: str = "rpc-server",
    ):
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.host, self.port = self._listener.getsockname()
        self._factory = handler_factory
        self._on_disconnect = on_disconnect
        self._name = name
        self._conns: list = []
        self._lock = threading.Lock()
        self._closed = False
        threading.Thread(target=self._accept_loop, name=f"{name}-accept", daemon=True).start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return
            handlers: Dict[str, Callable] = {}
            conn = RpcConnection(
                sock, handlers, on_disconnect=self._on_disconnect,
                name=self._name, defer_dispatch=True,
            )
            handlers.update(self._factory(conn))
            conn.start_dispatch()
            with self._lock:
                self._conns.append(conn)

    def connections(self) -> list:
        with self._lock:
            return [c for c in self._conns if not c.closed]

    def close(self) -> None:
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            conn.close()


def _jitter_factor(salt: str, attempt: int) -> float:
    """Deterministic jitter in [0.5, 1.0): a pure hash of (salt, attempt),
    NOT a shared PRNG — retry timing stays reproducible under seeded chaos
    (the same contract failpoint decisions follow)."""
    import hashlib

    h = hashlib.blake2b(f"{salt}:{attempt}".encode(), digest_size=8).digest()
    return 0.5 + (int.from_bytes(h, "little") / 2.0**64) * 0.5


def retry_with_backoff(
    fn: Callable[[], Any],
    attempts: Optional[int] = None,
    base_backoff_s: Optional[float] = None,
    max_backoff_s: Optional[float] = None,
    retry_on: tuple = (ControlPlaneTimeout,),
    deadline_ts: Optional[float] = None,
    salt: str = "rpc",
) -> Any:
    """The ONE control-plane retry idiom: call ``fn`` up to ``attempts``
    times, sleeping an exponentially-growing, deterministically-jittered
    delay between tries.  Only exception types in ``retry_on`` retry —
    the default retries timeouts but NOT connection death (a dead
    connection needs the reconnect machinery, not a hot loop).
    ``deadline_ts`` (absolute wall clock) bounds the whole dance: once the
    budget cannot fit another attempt the last failure re-raises."""
    from ray_tpu_torch.core.config import get_config

    cfg = get_config()
    attempts = attempts if attempts is not None else max(1, cfg.rpc_retry_max_attempts)
    base = base_backoff_s if base_backoff_s is not None else cfg.rpc_retry_base_backoff_s
    cap = max_backoff_s if max_backoff_s is not None else cfg.rpc_retry_max_backoff_s
    import time as _time

    last: Optional[BaseException] = None
    for i in range(attempts):
        try:
            return fn()
        except retry_on as exc:  # noqa: PERF203 — retries are the point
            last = exc
            if i == attempts - 1:
                raise
            delay = min(cap, base * (2 ** i)) * _jitter_factor(salt, i)
            if deadline_ts is not None and _time.time() + delay >= deadline_ts:
                raise
            _time.sleep(delay)
    raise last  # unreachable; keeps type checkers honest


def request_with_budget(
    conn: "RpcConnection", msg_type: str, payload: dict, default_timeout: float = 30.0
) -> dict:
    """Deadline-aware blocking request: a call made on behalf of a
    deadline-bearing task passes the task's REMAINING budget as the rpc
    timeout instead of the flat default, so a doomed call fails within the
    caller's deadline rather than 30 s later."""
    from ray_tpu_torch.runtime.context import remaining_budget

    budget = remaining_budget(default=None)
    timeout = default_timeout if budget is None else max(0.05, min(default_timeout, budget))
    return conn.request(msg_type, payload, timeout=timeout)


def connect(
    address: str,
    handlers: Dict[str, Callable],
    on_disconnect: Optional[Callable] = None,
    timeout: float = 10.0,
    name: str = "rpc-client",
) -> RpcConnection:
    host, _, port = address.rpartition(":")
    sock = socket.create_connection((host or "127.0.0.1", int(port)), timeout=timeout)
    sock.settimeout(None)
    return RpcConnection(sock, handlers, on_disconnect=on_disconnect, name=name)


# ==========================================================================
# TaskSpec wire codec
# ==========================================================================
# The reference serializes TaskSpecs as protobuf (src/ray/protobuf/common.proto:408
# ``TaskSpec``); here the spec's control fields ride as a plain dict and the
# function/args ride as pickle-5 blobs.  Function bodies are content-addressed
# (blake2b of the cloudpickle blob) and sent at most once per connection —
# FunctionManager-over-GCS-KV parity (python/ray/_private/function_manager.py)
# without the extra KV round trip.

def encode_spec(spec, fn_blob_fn, sent_fns: set) -> dict:
    """Encode a TaskSpec for the wire.  ``fn_blob_fn(func) -> (fn_id, blob)``
    is Node._function_blob-compatible; ``sent_fns`` tracks fn_ids this
    connection has already shipped."""
    args_blob = dumps_value((spec.args, spec.kwargs))
    d = {
        "task_id": spec.task_id.binary(),
        "name": spec.name,
        "args_blob": args_blob,
        "deps": [dep.binary() for dep in spec.dependencies],
        "num_returns": spec.num_returns,
        "return_ids": [oid.binary() for oid in spec.return_ids],
        "resources": spec.resources.fixed(),
        "max_retries": spec.max_retries,
        "retries_left": spec.retries_left,
        "execution": spec.execution,
        "attempt": spec.attempt,
        "actor_id": spec.actor_id.binary() if spec.actor_id is not None else None,
        "actor_method": spec.actor_method,
        "is_actor_creation": spec.is_actor_creation,
        "runtime_env": spec.runtime_env,
        # propagated trace context (tracing.py) — the agent's execute span
        # must parent to the task span minted on the submitting host
        "trace_ctx": spec.trace_ctx,
        # end-to-end deadline rides the spec so the agent installs it
        # around execution (nested submissions inherit remaining budget)
        "deadline_ts": spec.deadline_ts,
        "deadline_s": spec.deadline_s,
    }
    if spec.func is not None:
        fn_id, blob = fn_blob_fn(spec.func)
        d["fn_id"] = fn_id
        if fn_id not in sent_fns:
            d["fn_blob"] = blob
            sent_fns.add(fn_id)
    return d


def decode_spec(d: dict, fn_cache: Dict[bytes, Any]):
    """Rebuild a TaskSpec on the agent.  ``fn_cache`` maps fn_id -> callable
    and is fed by the ``fn_blob`` field when present."""
    from ray_tpu_torch.core.ids import ActorID, ObjectID, TaskID
    from ray_tpu_torch.core.resources import ResourceSet
    from ray_tpu_torch.runtime.scheduler import TaskSpec

    func = None
    fn_id = d.get("fn_id")
    if fn_id is not None:
        blob = d.get("fn_blob")
        if blob is not None and fn_id not in fn_cache:
            fn_cache[fn_id] = pickle.loads(blob)
        try:
            func = fn_cache[fn_id]
        except KeyError:
            # distinct from a KeyError raised by user args unpickling below:
            # only THIS miss means "resend with the blob inline"
            raise FunctionNotCached(fn_id) from None
    args, kwargs = pickle.loads(d["args_blob"])
    spec = TaskSpec(
        task_id=TaskID(d["task_id"]),
        name=d["name"],
        func=func,
        args=args,
        kwargs=kwargs,
        dependencies=[ObjectID(b) for b in d["deps"]],
        num_returns=d["num_returns"],
        return_ids=[ObjectID(b) for b in d["return_ids"]],
        resources=ResourceSet.from_fixed_dict(d["resources"]),
        max_retries=d["max_retries"],
        execution=d["execution"],
        actor_id=ActorID(d["actor_id"]) if d["actor_id"] is not None else None,
        actor_method=d["actor_method"],
        is_actor_creation=d["is_actor_creation"],
        runtime_env=d["runtime_env"],
    )
    spec.retries_left = d["retries_left"]
    spec.attempt = d["attempt"]
    spec.trace_ctx = d.get("trace_ctx")
    spec.deadline_ts = d.get("deadline_ts")
    spec.deadline_s = d.get("deadline_s")
    return spec


def dumps_value(value: Any) -> bytes:
    """The CONTROL-plane value-serialization policy (in-band pickle-5 with
    tensors as host bytes, then by value through cloudpickle where it is
    installed, else by reference).  The bulk data plane shares the same
    policy plus out-of-band buffers and the tensor envelope —
    ``device_plane.dumps_with_device_envelope`` (this function stays the
    small-value fast path)."""
    from ray_tpu_torch.core import serialization

    try:
        return serialization.dumps(value)
    except (AttributeError, TypeError, pickle.PicklingError):
        return serialization.dumps_by_value(value)


def encode_value(value: Any, is_error: bool = False) -> dict:
    """Encode a task result / object value for the wire."""
    return {"value_blob": dumps_value(value), "is_error": is_error}


def decode_value(d: dict) -> Tuple[Any, bool]:
    return pickle.loads(d["value_blob"]), d.get("is_error", False)
