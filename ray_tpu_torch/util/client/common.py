"""Wire protocol for thin-client mode.

Parity with the reference Ray Client protocol
(``src/ray/protobuf/ray_client.proto``, design in
``python/ray/util/client/ARCHITECTURE.md:1``): the reference rides gRPC
streams; here the same request/response shapes ride length-prefixed pickle
frames over TCP, with request-id multiplexing so many client threads can
have calls in flight on one connection.

The port's copy of ``ray_tpu/util/client/common.py``.  Frames are pickled
by ``core/serialization.dumps_by_value``: functions and classes by value
through cloudpickle where it is installed, else by reference (module-level
definitions only); tensors cross as their host bytes and arrive as CPU
tensors.  A session opens with a ``hello`` naming :data:`CLIENT_PROTOCOL`;
a server of the JAX package answers it with an unknown-op error, and the
port's server refuses a first frame that is not its hello, so the two
packages' clients and servers refuse each other (:class:`ClientProtocolError`
here, ``ConnectionRefusedError`` on the JAX package's side).
"""

from __future__ import annotations

import pickle
import socket
import struct
from typing import Any

from ray_tpu_torch.core import serialization

_HEADER = struct.Struct(">Q")
MAX_FRAME = 1 << 34  # 16 GiB sanity bound

#: the protocol a port client names in its hello (the JAX package's has none)
CLIENT_PROTOCOL = "ray_tpu_torch-client/1"


class ClientProtocolError(ConnectionRefusedError):
    """The peer does not speak this package's client protocol (a server or
    client of the other package, or another service): permanent."""


def send_msg(sock: socket.socket, msg: Any) -> None:
    payload = serialization.dumps_by_value(msg)
    sock.sendall(_HEADER.pack(len(payload)) + payload)


def recv_msg(sock: socket.socket, preread_header: bytes | None = None) -> Any:
    header = preread_header if preread_header is not None else _recv_exact(sock, _HEADER.size)
    (length,) = _HEADER.unpack(header)
    if length > MAX_FRAME:
        raise ConnectionError(f"frame too large: {length}")
    return pickle.loads(_recv_exact(sock, length))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("connection closed")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


class RefMarker:
    """Placeholder for a client-held ObjectRef inside pickled args; the
    server swaps it for the real ref (reference: ClientObjectRef ids in
    ray_client.proto Args)."""

    __slots__ = ("id",)

    def __init__(self, ref_id: bytes):
        self.id = ref_id


class ActorMarker:
    """Placeholder for a client-held actor handle inside pickled args."""

    __slots__ = ("id",)

    def __init__(self, actor_id: bytes):
        self.id = actor_id


def translate(obj: Any, ref_fn, actor_fn) -> Any:
    """Shallow-walk containers swapping client refs/handles via the given
    translators (the reference also only walks top-level containers)."""
    if isinstance(obj, RefMarker):
        return ref_fn(obj)
    if isinstance(obj, ActorMarker):
        return actor_fn(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(translate(x, ref_fn, actor_fn) for x in obj)
    if isinstance(obj, dict):
        return {k: translate(v, ref_fn, actor_fn) for k, v in obj.items()}
    return obj
