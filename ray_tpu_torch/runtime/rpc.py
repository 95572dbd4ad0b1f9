"""Control-plane RPC errors.

The port's copy of the error types of ``ray_tpu/runtime/rpc.py``: a worker
process's nested API call raises :class:`ControlPlaneTimeout` when its
deadline runs out.  The TCP transport of that module (multi-host) is not
ported yet.
"""

from __future__ import annotations

from typing import Optional


class RpcError(ConnectionError):
    """Transport-level failure (peer died, handler raised)."""


class RemoteHandlerError(RpcError):
    """The peer's handler raised; carries the remote traceback."""


class ControlPlaneTimeout(RpcError, TimeoutError):
    """A control-plane request ran out its time budget without a reply.

    Typed so callers can distinguish "the peer is slow or partitioned" from
    "the connection died" (:class:`RpcError` base) and apply backoff-retry
    or surface the remaining deadline budget."""

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
