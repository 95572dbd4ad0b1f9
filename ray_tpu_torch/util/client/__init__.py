"""Thin-client mode (``ray://``): a lightweight client driving a remote
runtime over a socket, parity with ``python/ray/util/client/``.

The port's copy of ``ray_tpu/util/client/``: the same names and calls over
the port's own protocol (``common.CLIENT_PROTOCOL``, the binary magic
``binary.BINARY_MAGIC``), so a client of one package and a server of the
other refuse each other with a typed error."""

from ray_tpu_torch.util.client.common import ClientProtocolError
from ray_tpu_torch.util.client.server import ClientServer
from ray_tpu_torch.util.client.worker import (
    ClientActorHandle,
    ClientContext,
    ClientObjectRef,
    connect,
)

__all__ = [
    "ClientServer",
    "ClientContext",
    "ClientObjectRef",
    "ClientActorHandle",
    "ClientProtocolError",
    "connect",
]
