"""Thin-client server: hosts real driver state for remote clients.

Parity with ``python/ray/util/client/server/server.py:96``
(``RayletServicer``): the server owns real ``ObjectRef``s / actor handles on
behalf of each connected client session and executes the client's
put/get/task/actor RPCs against the in-process runtime. Each connection is a
session; its refs are released on disconnect (the reference ties object
lifetime to client_id the same way).

The port's copy of ``ray_tpu/util/client/server.py``: a session starts
with the client's ``hello`` naming ``common.CLIENT_PROTOCOL``; any other
first frame (a JAX-package client opens with ``ping``) is answered with a
``ConnectionRefusedError`` and the connection closed, as is a native client
opening with the JAX package's binary magic.  Functions and classes arrive
pickled by value (cloudpickle on the client's side) or by reference.

Run standalone::

    python -m ray_tpu_torch.util.client.server --port 10001 --num-cpus 8
"""

from __future__ import annotations

import logging
import pickle
import socket
import threading
import uuid
from typing import Any, Dict

from ray_tpu_torch.util.client.binary import (
    BINARY_MAGIC,
    JAX_BINARY_MAGIC,
    recv_exact as _recv_exact_raw,
    refuse_binary,
    serve_binary,
)
from ray_tpu_torch.util.client.common import (
    CLIENT_PROTOCOL,
    ActorMarker,
    RefMarker,
    recv_msg,
    send_msg,
    translate,
)

logger = logging.getLogger(__name__)


class _Session:
    def __init__(self):
        self.refs: Dict[bytes, Any] = {}        # ref_id -> ObjectRef
        self.actors: Dict[bytes, Any] = {}      # actor_id -> ActorHandle
        self.fn_cache: Dict[bytes, Any] = {}    # fn hash -> deserialized callable
        self.lock = threading.Lock()


class ClientServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 10001):
        import ray_tpu_torch as rt

        if not rt.is_initialized():
            raise RuntimeError("ray_tpu_torch must be initialized before serving clients")
        self._rt = rt
        self._sock = socket.create_server((host, port))
        self.host, self.port = self._sock.getsockname()[:2]
        self.address = f"{self.host}:{self.port}"
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, name="rt-client-server", daemon=True)

    def start(self) -> "ClientServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    # ------------------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(conn, addr), daemon=True,
                name=f"rt-client-{addr[1]}",
            ).start()

    def _serve_conn(self, conn: socket.socket, addr) -> None:
        session = _Session()
        send_lock = threading.Lock()
        try:
            # Mode sniff: C++/native clients open with the 8-byte magic
            # "RTCPBIN1" (cross-language frontend, reference cpp/ parity);
            # Python clients open with a frame-length header (first byte 0
            # for any sane frame size).
            first8 = _recv_exact_raw(conn, 8)
            if first8 == BINARY_MAGIC:
                self._serve_binary(conn, session)
                return
            if first8 == JAX_BINARY_MAGIC:
                refuse_binary(conn)
                return
            if not self._hello(conn, first8):
                return
            while not self._stop.is_set():
                msg = recv_msg(conn)
                # each request handled on its own thread so a blocking get
                # doesn't starve concurrent calls (gRPC-stream parity)
                threading.Thread(
                    target=self._handle, args=(conn, send_lock, session, msg), daemon=True
                ).start()
        except (ConnectionError, OSError):
            pass
        finally:
            with session.lock:
                session.refs.clear()
                session.actors.clear()
            try:
                conn.close()
            except OSError:
                pass

    def _hello(self, conn: socket.socket, header: bytes) -> bool:
        """The session's first frame: this package's hello, answered with
        the protocol name; anything else (a client of the JAX package opens
        with ``ping``) is refused with a ``ConnectionRefusedError`` reply."""
        try:
            msg = recv_msg(conn, preread_header=header)
        except (pickle.UnpicklingError, ImportError, AttributeError, EOFError, ValueError):
            msg = None
        if not isinstance(msg, dict):
            msg = {}
        op = msg.get("op")
        ok = op == "hello" and msg.get("protocol") == CLIENT_PROTOCOL
        rid = msg.get("rid")
        if ok:
            reply = {"rid": rid, "ok": True, "result": {"protocol": CLIENT_PROTOCOL}}
        else:
            reply = {"rid": rid, "ok": False, "error": ConnectionRefusedError(
                f"this server speaks the ray_tpu_torch client protocol ({CLIENT_PROTOCOL}); "
                "the client did not open with its hello (a client of the JAX package?)")}
        send_msg(conn, reply)
        return ok

    def _serve_binary(self, conn: socket.socket, session: _Session) -> None:
        serve_binary(self._rt, session, conn, stop_event=self._stop)

    def _handle(self, conn, send_lock, session: _Session, msg: dict) -> None:
        rid = msg.get("rid")
        try:
            result = self._dispatch(session, msg)
            reply = {"rid": rid, "ok": True, "result": result}
        except BaseException as exc:  # noqa: BLE001 — errors cross the wire
            reply = {"rid": rid, "ok": False, "error": exc}
        try:
            with send_lock:
                send_msg(conn, reply)
        except (ConnectionError, OSError):
            pass

    # ------------------------------------------------------------------
    def _resolve(self, session: _Session, obj):
        def ref_fn(marker: RefMarker):
            with session.lock:
                return session.refs[marker.id]

        def actor_fn(marker: ActorMarker):
            with session.lock:
                return session.actors[marker.id]

        return translate(obj, ref_fn, actor_fn)

    def _register_ref(self, session: _Session, ref) -> bytes:
        ref_id = uuid.uuid4().bytes
        with session.lock:
            session.refs[ref_id] = ref
        return ref_id

    def _dispatch(self, session: _Session, msg: dict):
        rt = self._rt
        op = msg["op"]
        if op == "put":
            return self._register_ref(session, rt.put(msg["value"]))
        if op == "get":
            with session.lock:
                refs = [session.refs[i] for i in msg["ref_ids"]]
            values = rt.get(refs, timeout=msg.get("timeout"))
            return values
        if op == "task":
            fn = session.fn_cache.get(msg["fn_hash"])
            if fn is None:
                fn = pickle.loads(msg["fn"])
                session.fn_cache[msg["fn_hash"]] = fn
            args = self._resolve(session, msg["args"])
            kwargs = self._resolve(session, msg["kwargs"])
            remote_fn = rt.remote(fn) if not msg.get("options") else rt.remote(fn).options(**msg["options"])
            out = remote_fn.remote(*args, **kwargs)
            if isinstance(out, list):
                return [self._register_ref(session, r) for r in out]
            return self._register_ref(session, out)
        if op == "create_actor":
            cls = session.fn_cache.get(msg["fn_hash"])
            if cls is None:
                cls = pickle.loads(msg["cls"])
                session.fn_cache[msg["fn_hash"]] = cls
            args = self._resolve(session, msg["args"])
            kwargs = self._resolve(session, msg["kwargs"])
            actor_cls = rt.remote(cls) if not msg.get("options") else rt.remote(cls).options(**msg["options"])
            handle = actor_cls.remote(*args, **kwargs)
            actor_id = uuid.uuid4().bytes
            with session.lock:
                session.actors[actor_id] = handle
            return {"actor_id": actor_id, "methods": [m for m in dir(handle) if not m.startswith("_")]}
        if op == "actor_call":
            with session.lock:
                handle = session.actors[msg["actor_id"]]
            args = self._resolve(session, msg["args"])
            kwargs = self._resolve(session, msg["kwargs"])
            method = getattr(handle, msg["method"])
            return self._register_ref(session, method.remote(*args, **kwargs))
        if op == "wait":
            with session.lock:
                refs = [session.refs[i] for i in msg["ref_ids"]]
            by_ref = {id(r): i for r, i in zip(refs, msg["ref_ids"])}
            ready, not_ready = rt.wait(
                refs, num_returns=msg["num_returns"], timeout=msg.get("timeout")
            )
            return ([by_ref[id(r)] for r in ready], [by_ref[id(r)] for r in not_ready])
        if op == "kill_actor":
            with session.lock:
                handle = session.actors.get(msg["actor_id"])
            if handle is not None:
                rt.kill(handle, no_restart=msg.get("no_restart", True))
            return None
        if op == "release":
            with session.lock:
                for i in msg["ref_ids"]:
                    session.refs.pop(i, None)
            return None
        if op == "cluster_info":
            return {
                "cluster_resources": rt.cluster_resources(),
                "available_resources": rt.available_resources(),
                "nodes": rt.nodes(),
            }
        if op == "ping":
            return "pong"
        raise ValueError(f"unknown client op: {op!r}")


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="ray_tpu_torch thin-client server")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=10001)
    parser.add_argument("--num-cpus", type=int, default=None)
    args = parser.parse_args(argv)

    import ray_tpu_torch as rt

    rt.init(num_cpus=args.num_cpus)
    server = ClientServer(args.host, args.port).start()
    print(f"ray_tpu_torch client server listening on {server.address}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        rt.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
