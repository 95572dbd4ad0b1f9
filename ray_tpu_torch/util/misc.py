"""Small ray.util parity helpers: node IP, named-actor listing, custom
serializers, and the log-once/periodic-logging switches.

The port's copy of ``ray_tpu/util/misc.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Parity anchors: python/ray/_private/services.py (get_node_ip_address),
python/ray/util/__init__.py (list_named_actors),
python/ray/util/serialization.py (register/deregister_serializer),
python/ray/util/debug.py (log_once / disable_log_once_globally /
enable_periodic_logging).
"""

from __future__ import annotations

import copyreg
import socket
import time
from typing import Any, Callable, Dict, List


def reserve_port(host: str = "127.0.0.1") -> socket.socket:
    """Bind an ephemeral port and return the OPEN socket.

    The caller closes it when whatever service will actually own the port
    is ready to bind — holding the socket open prevents the kernel handing
    the same port to a concurrent caller (the flaw in probe-and-close
    helpers: two gang ranks on one host can otherwise collide)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, 0))
    return s


def free_port(host: str = "127.0.0.1") -> int:
    """Probe-and-close ephemeral port lookup.  Only for single-caller uses
    (e.g. one driver picking a master port); concurrent callers should hold
    ``reserve_port`` sockets through their rendezvous instead."""
    s = reserve_port(host)
    try:
        return s.getsockname()[1]
    finally:
        s.close()


def get_node_ip_address() -> str:
    """This host's primary outbound IP: the address of the interface that
    holds the default route, or ``127.0.0.1`` when there is none. The
    reference asks the kernel to route a UDP socket to a public address;
    this copy reads the routing table instead and addresses no host."""
    import fcntl
    import struct

    try:
        with open("/proc/net/route") as f:
            rows = [line.split() for line in f.readlines()[1:]]
    except OSError:
        return "127.0.0.1"
    for row in rows:
        if len(row) > 1 and row[1] == "00000000":  # destination 0.0.0.0: the default route
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                req = struct.pack("256s", row[0][:15].encode())
                return socket.inet_ntoa(fcntl.ioctl(s.fileno(), 0x8915, req)[20:24])  # SIOCGIFADDR
            except OSError:
                continue
            finally:
                s.close()
    return "127.0.0.1"


def list_named_actors(all_namespaces: bool = False) -> List[Any]:
    """Names of all live named actors (parity: util.list_named_actors)."""
    from ray_tpu_torch.api import get_cluster

    cluster = get_cluster()
    out = []
    for info in cluster.control.actors.list_actors():
        if info.name and info.state.name not in ("DEAD",):
            if all_namespaces:
                out.append({"name": info.name, "namespace": getattr(info, "namespace", "default")})
            else:
                out.append(info.name)
    return out


# ------------------------------------------------------------- serializers
_custom_serializers: Dict[type, tuple] = {}


def register_serializer(cls: type, *, serializer: Callable, deserializer: Callable) -> None:
    """Install a custom (de)serializer for ``cls`` on every pickle path
    (parity: util.register_serializer).  Implemented via copyreg, so it
    applies to the control plane, the data plane, and worker IPC alike —
    workers registered the same way decode symmetrically."""

    def reduce_fn(obj):
        return (_deserialize_custom, (cls.__module__, cls.__qualname__, serializer(obj)))

    _custom_serializers[cls] = (serializer, deserializer)
    copyreg.pickle(cls, reduce_fn)


def deregister_serializer(cls: type) -> None:
    _custom_serializers.pop(cls, None)
    copyreg.dispatch_table.pop(cls, None)


def _deserialize_custom(module: str, qualname: str, payload):
    import importlib

    cls = importlib.import_module(module)
    for part in qualname.split("."):
        cls = getattr(cls, part)
    entry = _custom_serializers.get(cls)
    if entry is None:
        raise TypeError(
            f"no serializer registered for {module}.{qualname} in this "
            f"process — call util.register_serializer here too (the "
            f"registration is per-process, like the reference's)"
        )
    return entry[1](payload)


# ------------------------------------------------------------ log controls
_log_once_seen: set = set()
_log_once_disabled = False
_periodic_s = 0.0
_last_logged: Dict[str, float] = {}


def log_once(key: str) -> bool:
    """True the first time ``key`` is seen (or once per period when
    periodic logging is enabled); the caller does the actual logging
    (parity: util.debug.log_once)."""
    if _log_once_disabled:
        return False
    now = time.monotonic()
    if _periodic_s > 0:
        if now - _last_logged.get(key, -1e18) >= _periodic_s:
            _last_logged[key] = now
            return True
        return False
    if key in _log_once_seen:
        return False
    _log_once_seen.add(key)
    _last_logged[key] = now
    return True


def disable_log_once_globally() -> None:
    global _log_once_disabled
    _log_once_disabled = True


def enable_periodic_logging(period_s: float = 60.0) -> None:
    """log_once keys re-fire every ``period_s`` instead of never again."""
    global _periodic_s
    _periodic_s = period_s
