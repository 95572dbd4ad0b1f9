"""Binary client protocol: the cross-language (C++) frontend wire format.

Parity: the reference's C++ user API (``cpp/include/ray/api/``) and
cross-language calls (``python/ray/cross_language.py``) — a native client
puts/gets byte objects and invokes Python functions by importable name.
The counterpart C++ library lives in ``ray_tpu_torch/native/src/client.cpp``
(``ray_tpu_torch/native/include/ray_tpu_client.h``).

The port's copy of ``ray_tpu/util/client/binary.py``: the same wire format
under the port's own magic, ``RTTCBIN1`` (:data:`BINARY_MAGIC`).  A native
client of the JAX package (magic ``RTCPBIN1``, :data:`JAX_BINARY_MAGIC`) is
answered with one error reply (:func:`refuse_binary`) and disconnected.

Wire format (little-endian), after the 8-byte magic ``RTTCBIN1``:

    request:  u32 payload_len | u8 op | u64 rid | payload
    reply:    u32 payload_len | u8 status (0 ok, 1 error) | u64 rid | payload

Ops:
    1 PING                                  -> b"pong"
    2 PUT      raw bytes                    -> 16-byte ref id
    3 GET      16B ref id                   -> value bytes (see encoding)
    4 CALL     u16 name_len | name utf8 ("module:function")
               u8 nargs | per-arg: u8 kind | u32 len | data
                                            -> 16-byte ref id
    5 RELEASE  16B ref id                   -> empty

Arg kinds: 0 raw bytes, 1 ref id (resolves to the object), 2 utf-8 str,
3 f64, 4 i64. GET value encoding: bytes pass through; str utf-8; int/float
rendered as their decimal utf-8 text (native callers parse); other types
are an error — cross-language results should be bytes.
"""

from __future__ import annotations

import importlib
import struct
import threading
import uuid
from typing import Any, Dict

from ray_tpu_torch.util.client.common import _recv_exact as recv_exact

BINARY_MAGIC = b"RTTCBIN1"
#: the JAX package's magic: refused here
JAX_BINARY_MAGIC = b"RTCPBIN1"

_REQ_HEAD = struct.Struct("<IBQ")   # payload_len, op, rid
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_F64 = struct.Struct("<d")
_I64 = struct.Struct("<q")

OP_PING = 1
OP_PUT = 2
OP_GET = 3
OP_CALL = 4
OP_RELEASE = 5

_fn_cache: Dict[str, Any] = {}
_fn_lock = threading.Lock()


def _resolve_function(name: str):
    with _fn_lock:
        fn = _fn_cache.get(name)
    if fn is not None:
        return fn
    if ":" not in name:
        raise ValueError(f"cross-language function name must be 'module:attr', got {name!r}")
    module_name, attr = name.split(":", 1)
    target = importlib.import_module(module_name)
    for part in attr.split("."):
        target = getattr(target, part)
    if not callable(target):
        raise TypeError(f"{name!r} is not callable")
    with _fn_lock:
        _fn_cache[name] = target
    return target


def _decode_args(session, payload: bytes, offset: int):
    (nargs,) = struct.unpack_from("<B", payload, offset)
    offset += 1
    args = []
    for _ in range(nargs):
        (kind,) = struct.unpack_from("<B", payload, offset)
        (length,) = _U32.unpack_from(payload, offset + 1)
        data = payload[offset + 5 : offset + 5 + length]
        offset += 5 + length
        if kind == 0:
            args.append(bytes(data))
        elif kind == 1:
            with session.lock:
                args.append(session.refs[bytes(data)])
        elif kind == 2:
            args.append(data.decode("utf-8"))
        elif kind == 3:
            args.append(_F64.unpack(data)[0])
        elif kind == 4:
            args.append(_I64.unpack(data)[0])
        else:
            raise ValueError(f"unknown arg kind {kind}")
    if offset != len(payload):
        # a truncated/overlong request must fail loudly, not silently run
        # with the wrong argument list
        raise ValueError(
            f"malformed CALL payload: {len(payload) - offset} trailing bytes"
        )
    return args


def _encode_value(value: Any) -> bytes:
    if isinstance(value, (bytes, bytearray, memoryview)):
        return bytes(value)
    if isinstance(value, str):
        return value.encode("utf-8")
    if isinstance(value, bool):
        return b"1" if value else b"0"   # before int: bool IS int in Python
    if isinstance(value, (int, float)):
        return repr(value).encode("utf-8")
    raise TypeError(
        f"cross-language GET needs bytes/str/int/float, got {type(value).__name__}"
    )


def refuse_binary(conn) -> None:
    """Answer a native client of the JAX package with one error reply (its
    first request reads it: status 1, the reason as its error text)."""
    out = (b"ConnectionRefusedError: this server speaks the ray_tpu_torch binary "
           b"client protocol (magic RTTCBIN1), not the JAX package's (RTCPBIN1)")
    conn.sendall(_REQ_HEAD.pack(len(out), 1, 0) + out)


def serve_binary(rt, session, conn, stop_event=None) -> None:
    """Request loop for one binary-mode connection (requests handled
    serially — native clients multiplex by opening more connections)."""
    while stop_event is None or not stop_event.is_set():
        head = recv_exact(conn, _REQ_HEAD.size)
        payload_len, op, rid = _REQ_HEAD.unpack(head)
        payload = recv_exact(conn, payload_len) if payload_len else b""
        try:
            out = _dispatch(rt, session, op, payload)
            status = 0
        except BaseException as exc:  # noqa: BLE001 — errors cross the wire
            out = repr(exc).encode("utf-8")
            status = 1
        conn.sendall(_REQ_HEAD.pack(len(out), status, rid) + out)


def _dispatch(rt, session, op: int, payload: bytes) -> bytes:
    if op == OP_PING:
        return b"pong"
    if op == OP_PUT:
        ref = rt.put(bytes(payload))
        ref_id = uuid.uuid4().bytes
        with session.lock:
            session.refs[ref_id] = ref
        return ref_id
    if op == OP_GET:
        ref_id = bytes(payload[:16])
        timeout = _F64.unpack_from(payload, 16)[0] if len(payload) >= 24 else None
        if timeout is not None and timeout < 0:
            timeout = None
        with session.lock:
            ref = session.refs[ref_id]
        return _encode_value(rt.get(ref, timeout=timeout))
    if op == OP_CALL:
        (name_len,) = _U16.unpack_from(payload, 0)
        name = payload[2 : 2 + name_len].decode("utf-8")
        args = _decode_args(session, payload, 2 + name_len)
        fn = _resolve_function(name)
        ref = rt.remote(fn).remote(*args)
        ref_id = uuid.uuid4().bytes
        with session.lock:
            session.refs[ref_id] = ref
        return ref_id
    if op == OP_RELEASE:
        with session.lock:
            session.refs.pop(bytes(payload[:16]), None)
        return b""
    raise ValueError(f"unknown binary op {op}")
