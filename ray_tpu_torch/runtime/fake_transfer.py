"""Host-memory stand-in for the CUDA IPC transfer server, for tests.

The port's own copy of ``ray_tpu/runtime/fake_transfer.py``.  It implements
the surface the device plane consumes —

    server.address() -> str
    server.await_pull(uuid, tensor) -> ticket (add_done_callback)
    server.withdraw(uuid)
    server.connect(addr, timeout_s) -> connection
    connection.pull(uuid, template) -> tensor

— over a plain TCP socket on localhost with the staged tensor's host bytes
as payload, so the offer → ticket → pull → release protocol runs end to end
without a GPU.  Install it with ``device_plane.install_transfer_server``.
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
from typing import Dict, Optional, Tuple

from ray_tpu_torch.runtime.device_plane import _Ticket

_LEN = struct.Struct("<Q")


def _send_frame(sock: socket.socket, data: bytes) -> None:
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks, got = [], 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise ConnectionError("fake transfer socket closed")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _recv_frame(sock: socket.socket) -> bytes:
    (length,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return _recv_exact(sock, length)


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


class FakeTransferServer:
    def __init__(self, host: str = "127.0.0.1", refuse_pulls: bool = False):
        # uuid -> (host_bytes, shape, dtype name, ticket)
        self._staged: Dict[int, Tuple[bytes, tuple, str, _Ticket]] = {}
        self._lock = threading.Lock()
        self.refuse_pulls = refuse_pulls
        self.pulls_served = 0
        self.connections_accepted = 0
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, 0))
        self._listener.listen(16)
        self._host, self._port = self._listener.getsockname()
        self._closed = False
        threading.Thread(target=self._accept_loop, name="fake-xfer", daemon=True).start()

    # -- surface consumed by device_plane ---------------------------------
    def address(self) -> str:
        return f"{self._host}:{self._port}"

    def await_pull(self, uuid: int, tensor) -> _Ticket:
        import torch

        host = tensor.detach().to("cpu").contiguous()
        ticket = _Ticket()
        with self._lock:
            self._staged[uuid] = (
                host.reshape(-1).view(torch.uint8).numpy().tobytes(),
                tuple(host.shape),
                _dtype_name(host.dtype),
                ticket,
            )
        return ticket

    def withdraw(self, uuid: int) -> None:
        with self._lock:
            entry = self._staged.pop(uuid, None)
        if entry is not None:
            entry[3]._fire()

    def connect(self, addr: str, timeout_s: Optional[float] = None) -> "_FakeConnection":
        if self.refuse_pulls:
            raise ConnectionError("fake transfer server configured to refuse pulls")
        return _FakeConnection(addr, timeout_s)

    def close(self) -> None:
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass

    # -- server side -------------------------------------------------------
    def staged_count(self) -> int:
        with self._lock:
            return len(self._staged)

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            self.connections_accepted += 1
            threading.Thread(
                target=self._serve, args=(sock,), name="fake-xfer-serve", daemon=True
            ).start()

    def _serve(self, sock: socket.socket) -> None:
        try:
            while not self._closed:
                req = pickle.loads(_recv_frame(sock))
                uuid = req["uuid"]
                with self._lock:
                    # one staging per pull: the entry is CONSUMED by its pull
                    entry = self._staged.pop(uuid, None)
                if entry is None:
                    _send_frame(sock, pickle.dumps({"found": False}))
                    continue
                payload, shape, dtype, ticket = entry
                _send_frame(
                    sock,
                    pickle.dumps({"found": True, "shape": shape, "dtype": dtype,
                                  "size": len(payload)}),
                )
                sock.sendall(payload)
                self.pulls_served += 1
                ticket._fire()
        except (ConnectionError, OSError, EOFError, pickle.UnpicklingError):
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass


class _FakeConnection:
    def __init__(self, addr: str, timeout_s: Optional[float] = None):
        host, _, port = addr.rpartition(":")
        self._sock = socket.create_connection((host or "127.0.0.1", int(port)),
                                              timeout=timeout_s)
        self._lock = threading.Lock()

    def pull(self, uuid: int, template):
        import torch

        with self._lock:
            _send_frame(self._sock, pickle.dumps({"uuid": uuid}, protocol=5))
            header = pickle.loads(_recv_frame(self._sock))
            if not header.get("found"):
                raise KeyError(f"uuid {uuid} not staged on peer")
            raw = _recv_exact(self._sock, header["size"])
        return (
            torch.frombuffer(bytearray(raw), dtype=torch.uint8)
            .view(getattr(torch, header["dtype"]))
            .reshape(header["shape"])
        )

    def close(self) -> None:
        self._sock.close()
