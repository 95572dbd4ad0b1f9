"""Bulk object data plane: peer-to-peer chunked transfer sockets.

The port's copy of ``ray_tpu/runtime/data_plane.py``, its single-process
part: the framing, ``DataServer`` with the ``pull``, ``push``, shm
hand-off, ``chan_push`` and ``kv_pull`` ops, ``DataClient``,
``ChannelStream`` and ``store_server``, and the registry of KV-block
migration sources.  What serves node agents waits for the multi-node
runtime and raises ``NotPortedError`` where it is reached: the relay tree
(``build_relay_tree``, ``DataClient.relay``; a server answers the ``relay``
op with an error) and leased direct dispatch (``DataClient.push_task``; the
``push_task`` op likewise).  Tensors in a framed value ride the device
envelope (``runtime/device_plane.py``): their bytes stream out of band and
the receiver rebuilds tensors.

Separate from the control transport (``runtime/rpc.py``) by design: a
multi-GB object frame must never head-of-line-block heartbeats, task
dispatch or health pings, and object bytes must move node-to-node without
relaying through the head (the reference's object manager is node-to-node
``Push``/``Pull`` gRPC with 5 MiB chunks and admission-controlled pulls —
``src/ray/object_manager/object_manager.h:117``, ``pull_manager.h:52``,
``push_manager.h:30``, chunk size ``ray_config_def.h:352``).

Every process that serves objects runs one :class:`DataServer`.

Wire protocol per data connection (header frames are length-prefixed
pickles; chunk frames are length-prefixed raw bytes):

  pull:  -> {"op": "pull", "oid", "timeout", "device_capable"?, "shm_token"?}
         <- {"found": bool, "is_error", "meta_size", "buffer_sizes"}
            | {"found": True, "device_xfer": ticket}
            | {"found": True, "is_error", "shm": offer}
         <- meta + chunk stream             # the first form only
  push:  -> {"op": "push", "oid", "is_error", "meta_size", "buffer_sizes"}
         -> meta + chunk stream
         <- {"ok": True}
  chan_push (compiled-plan channel stream; runtime/channel_manager.py):
         -> {"op": "chan_push", "plan", "chan", "seq", "is_error",
             "meta_size", "buffer_sizes", "device"?}
         -> meta + chunk stream
         <- {"ok": bool, "error": str}      # ack withheld until the
                                            # consumer slot accepted the
                                            # frame: end-to-end backpressure
  kv_pull (a staged KV block of a disaggregated migration):
         -> {"op": "kv_pull", "mig", "idx"}
         <- {"found": bool, "shape", "dtype", "size"}
         <- the block's raw bytes
  relay, push_task: answered with {"ok": False, "error"} and the connection
         closed (the reference's broadcast relay and leased dispatch).

Blocking is fine HERE (unlike on the control connection): each data
connection has a dedicated server thread and carries nothing but bulk
bytes, so a pull that waits for a not-yet-materialized object parks only
its own transfer.
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.runtime import failpoints

_LEN = struct.Struct("<Q")


def _observe_latency(op: str, t_start: float) -> None:
    from ray_tpu_torch.observability import metric_defs

    metric_defs.DATA_PLANE_LATENCY.observe(time.perf_counter() - t_start, tags={"op": op})


class DataPlaneError(ConnectionError):
    pass


# --------------------------------------------------------------------------
# incarnation fencing on the data plane (gray failures): channel
# frames stamp their source (node hex, incarnation); once the head fences a
# node it broadcasts ``peer_fenced`` and every data server rejects frames
# from that node id.  Fenced node ids never serve again (a healed agent
# rejoins under a FRESH id), so a plain set suffices.
# --------------------------------------------------------------------------
_fence_lock = threading.Lock()
_fenced_sources: set = set()            # node hex strings
_local_source: Optional[tuple] = None   # (node_hex, incarnation) of THIS process


def set_local_source(node_hex: str, incarnation: int) -> None:
    global _local_source
    with _fence_lock:
        _local_source = (node_hex, int(incarnation))


def local_source() -> Optional[tuple]:
    with _fence_lock:
        return _local_source


def fence_source(node_hex: str) -> None:
    with _fence_lock:
        _fenced_sources.add(node_hex)


def source_fenced(src) -> bool:
    if not src:
        return False
    with _fence_lock:
        return src[0] in _fenced_sources


def reset_fencing() -> None:
    """Test/shutdown hook: forget fenced sources and the local stamp."""
    global _local_source
    with _fence_lock:
        _fenced_sources.clear()
        _local_source = None


class ObjectNotFound(DataPlaneError):
    pass


def to_frames(value: Any) -> Tuple[bytes, List[memoryview]]:
    """Pickle-5 OUT-OF-BAND serialization: the pickle stream carries only
    metadata (fast, tiny GIL hold); big buffers (ndarray and tensor payloads) stay as
    zero-copy memoryviews streamed raw by the socket layer (sendall and
    recv_into release the GIL).  A 1 GB array costs no GIL-held gigabyte
    memcpy — without this, serializing bulk objects starves the agent's
    heartbeat threads and the head's health checker false-kills the node
    (the failure mode this avoids)."""
    from ray_tpu_torch.runtime.device_plane import dumps_with_device_envelope

    buffers: List[pickle.PickleBuffer] = []
    meta = dumps_with_device_envelope(value, buffer_callback=buffers.append)
    return meta, [b.raw() for b in buffers]


def from_frames(meta: bytes, buffers: List[Any]) -> Any:
    return pickle.loads(meta, buffers=buffers)


def _check_send_failpoint() -> None:
    if failpoints.ARMED:
        # chaos: every fault shape surfaces as ConnectionError — the exact
        # failure the transfer paths already recover from (client: discard
        # socket + DataPlaneError -> relay/retry; server: connection reaped)
        try:
            action = failpoints.fp("data_plane.send_frame")
        except failpoints.FailpointInjected as exc:
            raise ConnectionError(str(exc)) from None
        if action is not None:
            raise ConnectionError(f"failpoint data_plane.send_frame: {action}")


def _send_frame(sock: socket.socket, data: bytes) -> None:
    _check_send_failpoint()
    sock.sendall(_LEN.pack(len(data)) + data)


def _send_header(sock: socket.socket, header: dict) -> None:
    _send_frame(sock, pickle.dumps(header, protocol=5))


def _recv_exact(sock: socket.socket, n: int):
    """Read exactly ``n`` bytes.  Large reads (>= 1 MiB: bulk meta frames,
    big pickle headers) go straight into one preallocated buffer via
    recv_into — no per-chunk bytes objects and no final join() copy; every
    consumer (pickle.loads, len, from_frames) takes the bytearray as-is."""
    if n == 0:
        return b""
    if n >= (1 << 20):
        return _recv_into_buffer(sock, n)
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            raise ConnectionError("data socket closed")
        chunks.append(chunk)
        got += len(chunk)
    return chunks[0] if len(chunks) == 1 else b"".join(chunks)


def _recv_into_buffer(sock: socket.socket, size: int) -> bytearray:
    """Receive ``size`` raw bytes straight into one allocation (recv_into
    releases the GIL; no join() copy of bulk payloads)."""
    buf = bytearray(size)
    view = memoryview(buf)
    got = 0
    while got < size:
        n = sock.recv_into(view[got:], min(size - got, 1 << 20))
        if n == 0:
            raise ConnectionError("data socket closed")
        got += n
    return buf


def _send_buffers(sock: socket.socket, buffers, chunk_bytes: int) -> int:
    """Stream raw buffers in bounded chunks (sendall releases the GIL)."""
    total = 0
    for buf in buffers:
        view = memoryview(buf).cast("B")
        total += view.nbytes
        for start in range(0, view.nbytes, chunk_bytes):
            sock.sendall(view[start:start + chunk_bytes])
    return total


def build_relay_tree(addrs: List[str], fanout: int) -> List[dict]:
    """The broadcast relay tree over node agents' data servers: not ported
    (the multi-node runtime)."""
    from ray_tpu_torch.exceptions import NotPortedError

    raise NotPortedError("the broadcast relay tree", "ray_tpu/runtime/data_plane.py")


# --------------------------------------------------------------------------
# Same-host shm handoff (plasma zero-copy local sharing role: store.h:55)
# --------------------------------------------------------------------------
# Two processes can hand an object through the native shm arena instead of
# loopback TCP iff they share /dev/shm.  The proof is a shared random token
# file: same namespace <=> both read the same bytes.  (Hostname comparison
# would lie across containers; this cannot.)
_HOST_TOKEN_PATH = "/dev/shm/rttorch_host_token"
_host_token_cache: Optional[bytes] = None


def host_token() -> Optional[bytes]:
    global _host_token_cache
    if _host_token_cache is not None:
        return _host_token_cache or None  # b"" caches "unavailable"

    def _fail() -> None:
        global _host_token_cache
        _host_token_cache = b""  # never re-pay the probe on this process

    import os

    try:
        for attempt in range(2):
            try:
                fd = os.open(_HOST_TOKEN_PATH, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
            except FileExistsError:
                fd = -1
            if fd >= 0:
                try:
                    # rt-lint: disable=chaos-determinism -- one-time host
                    # identity token (same-host transport detection); not a
                    # frame payload and never part of a chaos decision
                    os.write(fd, os.urandom(16).hex().encode())
                finally:
                    os.close(fd)
            # read back (covers the creator and the raced loser; a reader
            # racing the creator's write may see a short file — retry
            # briefly)
            for _ in range(50):
                try:
                    with open(_HOST_TOKEN_PATH, "rb") as f:
                        tok = f.read()
                except FileNotFoundError:
                    break  # repaired/unlinked under us: recreate
                if len(tok) >= 32:
                    _host_token_cache = tok
                    return tok
                time.sleep(0.01)
            if attempt == 0:
                # a creator SIGKILLed between open and write leaves a
                # permanent zero-byte file: unlink the carcass and retry
                # once as the new creator
                try:
                    os.unlink(_HOST_TOKEN_PATH)
                except OSError:
                    pass
        _fail()
        return None
    except OSError:
        _fail()
        return None


# Staged-entry payload layout (self-contained; the arena entry's own
# meta_size field is unused):
#   u32 n_buffers | u64 meta_off | u64 meta_len | n * (u64 off, u64 len)
#   ... meta bytes ... | 64B-aligned buffer payloads ...
_STAGE_HDR = struct.Struct("<IQQ")
_STAGE_BUF = struct.Struct("<QQ")
_STAGE_ALIGN = 64


def _staging_id(oid: bytes) -> bytes:
    import hashlib

    return hashlib.sha224(b"xfer:" + oid).digest()[:28]


def stage_frames(shm, sid: bytes, meta: bytes, buffers: List[Any]) -> None:
    """Write pickle-5 frames as ONE sealed arena entry under ``sid``.
    Raises FileExistsError if another stager won, MemoryError if the arena
    cannot fit it even after eviction."""
    views = [memoryview(b).cast("B") for b in buffers]
    table_len = _STAGE_HDR.size + _STAGE_BUF.size * len(views)
    meta_off = table_len
    cursor = meta_off + len(meta)
    offsets = []
    for v in views:
        cursor = (cursor + _STAGE_ALIGN - 1) // _STAGE_ALIGN * _STAGE_ALIGN
        offsets.append(cursor)
        cursor += v.nbytes
    dest = shm.create(sid, cursor)
    try:
        _STAGE_HDR.pack_into(dest, 0, len(views), meta_off, len(meta))
        pos = _STAGE_HDR.size
        for off, v in zip(offsets, views):
            _STAGE_BUF.pack_into(dest, pos, off, v.nbytes)
            pos += _STAGE_BUF.size
        dest[meta_off : meta_off + len(meta)] = meta
        for off, v in zip(offsets, views):
            dest[off : off + v.nbytes] = v
    finally:
        dest.release()
    shm.seal(sid)


def _release_pins(store, pins) -> None:
    if getattr(store, "_closed", False):
        return
    for eid in pins:
        try:
            store.release(eid)
        except Exception:  # noqa: BLE001 — arena torn down mid-exit
            pass


def read_staged(view: memoryview) -> Tuple[memoryview, List[memoryview]]:
    """Parse a staged entry into (meta, buffer views) — zero-copy slices of
    the pinned arena view."""
    n, meta_off, meta_len = _STAGE_HDR.unpack_from(view, 0)
    meta = view[meta_off : meta_off + meta_len]
    bufs = []
    pos = _STAGE_HDR.size
    for _ in range(n):
        off, size = _STAGE_BUF.unpack_from(view, pos)
        pos += _STAGE_BUF.size
        bufs.append(view[off : off + size])
    return meta, bufs


def _recv_frame(sock: socket.socket) -> bytes:
    (length,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return _recv_exact(sock, length)


def _recv_header(sock: socket.socket) -> dict:
    return pickle.loads(_recv_frame(sock))


class TransferStats:
    """Byte/count accounting, surfaced in tests and the dashboard.  Every
    ``add`` also feeds the matching global metric family, so per-instance
    snapshots and the Prometheus scrape can't drift."""

    #: field -> (metric attr on metric_defs, tag dict); resolved lazily so
    #: importing this module in bare worker processes stays cheap
    _FIELD_METRICS = {
        "bytes_sent": ("DATA_PLANE_BYTES", {"direction": "sent"}),
        "bytes_received": ("DATA_PLANE_BYTES", {"direction": "received"}),
        "pulls_served": ("DATA_PLANE_TRANSFERS", {"op": "pull_served"}),
        "pulls_issued": ("DATA_PLANE_TRANSFERS", {"op": "pull"}),
        "pushes_sent": ("DATA_PLANE_TRANSFERS", {"op": "push"}),
        "pushes_received": ("DATA_PLANE_TRANSFERS", {"op": "push_received"}),
        "shm_handoffs": ("DATA_PLANE_TRANSFERS", {"op": "shm_handoff"}),
        "relays": ("DATA_PLANE_TRANSFERS", {"op": "relay"}),
        "kv_blocks_served": ("DATA_PLANE_TRANSFERS", {"op": "kv_pull_served"}),
    }

    def __init__(self):
        self._lock = threading.Lock()
        self.bytes_sent = 0
        self.bytes_received = 0
        self.pulls_served = 0
        self.pulls_issued = 0
        self.pushes_sent = 0
        self.pushes_received = 0
        self.shm_handoffs = 0
        self.relays = 0
        self.kv_blocks_served = 0
        self.frame_cache_hits = 0
        self.frame_cache_misses = 0

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "bytes_sent": self.bytes_sent,
                "bytes_received": self.bytes_received,
                "pulls_served": self.pulls_served,
                "pulls_issued": self.pulls_issued,
                "pushes_sent": self.pushes_sent,
                "pushes_received": self.pushes_received,
                "shm_handoffs": self.shm_handoffs,
                "relays": self.relays,
                "kv_blocks_served": self.kv_blocks_served,
                "frame_cache_hits": self.frame_cache_hits,
                "frame_cache_misses": self.frame_cache_misses,
            }

    def add(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)
        metric = self._FIELD_METRICS.get(field)
        if metric is not None:
            from ray_tpu_torch.observability import metric_defs

            getattr(metric_defs, metric[0]).inc(n, tags=metric[1])


# --------------------------------------------------------------------------
# KV-block migration sources (disaggregated serving, serve/disagg.py).
# A prefill engine registers its staged block set here under the derived
# migration id; the decode side's host-fallback `kv_pull` op resolves
# through this registry, so the runtime layer never imports serve code.
# Process-global: in-proc replicas on one node share one data server.
# --------------------------------------------------------------------------
_kv_sources_lock = threading.Lock()
_kv_sources: Dict[str, Callable[[int], Any]] = {}


def register_kv_block_source(mig_id: str, fetch: Callable[[int], Any]) -> None:
    """``fetch(block_idx) -> tensor`` for one staged migration."""
    with _kv_sources_lock:
        _kv_sources[mig_id] = fetch


def unregister_kv_block_source(mig_id: str) -> None:
    with _kv_sources_lock:
        _kv_sources.pop(mig_id, None)


def kv_block_source(mig_id: str) -> Optional[Callable[[int], Any]]:
    with _kv_sources_lock:
        return _kv_sources.get(mig_id)


def pull_kv_block(addr: str, mig_id: str, idx: int,
                  timeout: float = 30.0) -> Optional[Any]:
    """Pull one staged KV block over the ``kv_pull`` wire op (host-staged
    fallback rung).  Returns the block as a CPU tensor, or ``None`` when
    the peer has no such staging (released, unknown, or refused)."""
    from ray_tpu_torch.parallel.collective import _rendezvous_device_frame

    host, port = addr.rsplit(":", 1)
    try:
        sock = socket.create_connection((host, int(port)), timeout=timeout)
    except OSError:
        return None
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(timeout)
        _send_header(sock, {"op": "kv_pull", "mig": mig_id, "idx": int(idx)})
        header = _recv_header(sock)
        if not header.get("found"):
            return None
        raw = _recv_into_buffer(sock, int(header["size"]))
        return _rendezvous_device_frame(header["shape"], header["dtype"], raw, device="cpu")
    except (ConnectionError, OSError, EOFError, pickle.UnpicklingError, KeyError):
        return None
    finally:
        try:
            sock.close()
        except OSError:
            pass


class DataServer:
    """Per-process bulk-transfer endpoint.

    ``get_frames(oid_bytes, timeout) -> (meta, buffers, is_error)`` resolves
    a local object as pickle-5 out-of-band frames (blocking until
    materialized or raising ``KeyError``/timeout);
    ``put_frames(oid_bytes, meta, buffers, is_error)`` lands an inbound
    push.  A semaphore admission-controls concurrent streams (PullManager
    role, ``pull_manager.h:52``)."""

    def __init__(
        self,
        get_frames: Callable[[bytes, float], Tuple[bytes, List[Any], bool]],
        put_frames: Callable[[bytes, bytes, List[Any], bool], None],
        host: str = "127.0.0.1",
        port: int = 0,
        chunk_bytes: int = 8 * 1024 * 1024,
        max_concurrent: int = 4,
        get_device_offer: Optional[Callable[[bytes], Optional[dict]]] = None,
        shm_store=None,
    ):
        self._get_frames = get_frames
        self._put_frames = put_frames
        self._get_device_offer = get_device_offer
        self._shm_store = shm_store
        self._stage_lock = threading.Lock()
        self.chunk_bytes = chunk_bytes
        self.stats = TransferStats()
        self._admission = threading.BoundedSemaphore(max(1, max_concurrent))
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.host, self.port = self._listener.getsockname()
        self._closed = False
        threading.Thread(target=self._accept_loop, name="data-accept", daemon=True).start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def close(self) -> None:
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass

    # ------------------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(
                target=self._serve_conn, args=(sock,), name="data-serve", daemon=True
            ).start()

    def _serve_conn(self, sock: socket.socket) -> None:
        try:
            while not self._closed:
                req = _recv_header(sock)
                op = req.get("op")
                if op == "pull":
                    self._serve_pull(sock, req)
                elif op == "push":
                    self._serve_push(sock, req)
                elif op == "chan_push":
                    self._serve_chan_push(sock, req)
                elif op == "kv_pull":
                    self._serve_kv_pull(sock, req)
                elif op in ("relay", "push_task"):
                    # their payload follows the header: answer, then drop the
                    # connection, whose byte stream is no longer framed
                    _send_header(sock, {"ok": False, "error": f"{op} is not ported"})
                    return
                else:
                    _send_header(sock, {"error": f"unknown op {op!r}"})
        except (ConnectionError, OSError, EOFError, pickle.UnpicklingError):
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _serve_pull(self, sock: socket.socket, req: dict) -> None:
        oid = req["oid"]
        timeout = float(req.get("timeout", 30.0))
        if req.get("device_capable") and self._get_device_offer is not None:
            # both endpoints run transfer servers (CUDA IPC): hand the
            # consumer a device-to-device pull ticket; the host envelope
            # (and its device->host export) is skipped entirely
            offer = self._get_device_offer(oid)
            if offer is not None:
                _send_header(sock, {"found": True, "device_xfer": offer})
                self.stats.add("pulls_served")
                return
        try:
            meta, buffers, is_error = self._get_frames(oid, timeout)
        except Exception:  # noqa: BLE001 — not found / timed out
            _send_header(sock, {"found": False})
            return
        # Same-host requester: hand off through the shm arena — one memcpy
        # into the segment, zero object bytes on this socket.
        tok = req.get("shm_token")
        if (
            tok is not None
            and self._shm_store is not None
            and tok == host_token()
        ):
            offer = self._stage_offer(oid, meta, buffers)
            if offer is not None:
                _send_header(
                    sock,
                    {"found": True, "is_error": is_error, "shm": offer},
                )
                self.stats.add("pulls_served")
                self.stats.add("shm_handoffs")
                return
        sizes = [memoryview(b).cast("B").nbytes for b in buffers]
        with self._admission:
            _send_header(
                sock,
                {"found": True, "is_error": is_error,
                 "meta_size": len(meta), "buffer_sizes": sizes},
            )
            sock.sendall(meta)
            sent = _send_buffers(sock, buffers, self.chunk_bytes)
        self.stats.add("pulls_served")
        self.stats.add("bytes_sent", len(meta) + sent)

    def _serve_kv_pull(self, sock: socket.socket, req: dict) -> None:
        """Host-staged rung of the KV-block migration ladder
        (serve/disagg.py): serve one staged block of a registered
        migration as raw bytes.  The device-to-device ticket path never
        touches this op — it exists for refused/absent transfer servers,
        mirroring the chan_push host fallback."""
        fetch = kv_block_source(req.get("mig", ""))
        if fetch is None:
            _send_header(sock, {"found": False})
            return
        try:
            import torch

            block = fetch(int(req.get("idx", 0)))
            host = block.detach().to("cpu").contiguous()
            payload = memoryview(host.reshape(-1).view(torch.uint8).numpy()).cast("B")
        except Exception:  # noqa: BLE001 — released mid-pull / bad index
            _send_header(sock, {"found": False})
            return
        with self._admission:
            _send_header(
                sock,
                {"found": True, "shape": tuple(host.shape),
                 "dtype": str(host.dtype).removeprefix("torch."), "size": payload.nbytes},
            )
            sent = _send_buffers(sock, [payload], self.chunk_bytes)
        self.stats.add("kv_blocks_served")
        self.stats.add("bytes_sent", sent)

    def _stage_offer(self, oid: bytes, meta: bytes, buffers: List[Any]) -> Optional[dict]:
        """Build a same-host handoff offer.

        Passthrough first: when every buffer ALREADY lives inside the arena
        (a worker-produced result decoded zero-copy), pin those entries and
        reference them — no bytes move at all.  Otherwise stage one copy
        into the arena under a derived id; staged entries are LRU-reclaimed
        once the consumer releases its pin, so repeat pulls of one object
        reuse a single staging."""
        shm = self._shm_store
        try:
            entries = self._passthrough_entries(shm, buffers)
            if entries is not None:
                return {
                    "segment": shm.name, "kind": "entries",
                    "meta": bytes(meta), "bufs": entries,
                }
            sid = _staging_id(oid)
            with self._stage_lock:
                if not shm.contains(sid):
                    try:
                        stage_frames(shm, sid, meta, buffers)
                    except FileExistsError:
                        # created-but-unsealed by a crashed/other path; let
                        # the socket path carry this pull
                        return None
            return {"segment": shm.name, "kind": "staged", "sid": sid}
        except MemoryError:
            return None
        except Exception:  # noqa: BLE001 — arena closed mid-shutdown etc.
            return None

    @staticmethod
    def _passthrough_entries(shm, buffers: List[Any]) -> Optional[list]:
        """Resolve each buffer to its containing arena entry; returns
        [(entry_id, rel_off, nbytes), ...] or None if any buffer lives
        off-arena.  No pin is retained here: the entries are kept alive by
        the store's own zero-copy value (which pins them for its lifetime);
        if the object is dropped before the consumer pins, its get fails
        and the pull falls back to the socket path."""
        if not buffers or not hasattr(shm, "pin_buffer"):
            return None
        import numpy as np

        out = []
        for b in buffers:
            view = memoryview(b).cast("B")
            if view.nbytes == 0:
                return None
            addr = np.frombuffer(view, dtype=np.uint8).__array_interface__["data"][0]
            hit = shm.pin_buffer(addr, view.nbytes)
            if hit is None:
                return None
            shm.release(hit[0])  # lookup only — the store value holds the pin
            out.append((hit[0], hit[1], view.nbytes))
        return out

    def _serve_chan_push(self, sock: socket.socket, req: dict) -> None:
        """Compiled-plan channel frame: land it in this process's channel
        manager and ack only once the single consumer slot ACCEPTED it —
        the blocking deliver IS the stream's backpressure, so this op
        deliberately skips the admission semaphore (a full slot must not
        pin a transfer slot other ops need; the per-edge one-frame-in-
        flight bound is its own admission control)."""
        meta = _recv_exact(sock, req["meta_size"])
        buffers = [_recv_into_buffer(sock, size) for size in req["buffer_sizes"]]
        nbytes = req["meta_size"] + sum(req["buffer_sizes"])
        if source_fenced(req.get("src")):
            # stale incarnation pushing channel frames (a partitioned agent
            # whose plan streams stayed connected peer-to-peer): the frame
            # bytes were drained above to keep the stream parseable, but
            # the value must never reach a consumer slot
            from ray_tpu_torch.observability import metric_defs

            metric_defs.FENCED_FRAMES.inc(tags={"kind": "chan_push"})
            _send_header(
                sock, {"ok": False, "fenced": True, "error": "fenced: stale incarnation"}
            )
            return
        dev = req.get("device")
        if dev is not None:
            # DEVICE-kind frame: the header IS the metadata (dtype/shape/
            # transfer ticket); the payload never saw pickle.  Materialize
            # straight to a tensor: a failed device-to-device pull
            # nacks with a fallback flag so the producer resends host-staged.
            from ray_tpu_torch.observability import metric_defs
            from ray_tpu_torch.runtime import channel_manager

            value, err = _materialize_device_frame(dev, buffers)
            if value is None:
                _send_header(sock, {"ok": False, "fallback": True, "error": err})
                return
            metric_defs.COMPILED_DEVICE_CHANNEL_BYTES.inc(
                int(value.nbytes), tags={"direction": "received"}
            )
            ok, err = channel_manager.deliver(
                req["plan"], req["chan"], req["seq"], value, False
            )
            _send_header(sock, {"ok": ok, "error": err})
            return
        try:
            value = from_frames(meta, buffers)
        except Exception as exc:  # noqa: BLE001 — poisoned frame: nack, keep the stream
            _send_header(sock, {"ok": False, "error": f"decode failed: {exc!r}"})
            return
        from ray_tpu_torch.observability import metric_defs
        from ray_tpu_torch.runtime import channel_manager

        metric_defs.COMPILED_CHANNEL_BYTES.inc(nbytes, tags={"direction": "received"})
        ok, err = channel_manager.deliver(
            req["plan"], req["chan"], req["seq"], value, req.get("is_error", False)
        )
        _send_header(sock, {"ok": ok, "error": err})

    def _serve_push(self, sock: socket.socket, req: dict) -> None:
        # same admission gate as pulls: inbound bulk buffering is bounded too
        with self._admission:
            meta = _recv_exact(sock, req["meta_size"])
            buffers = [_recv_into_buffer(sock, size) for size in req["buffer_sizes"]]
        self._put_frames(req["oid"], meta, buffers, req.get("is_error", False))
        _send_header(sock, {"ok": True})
        self.stats.add("pushes_received")
        self.stats.add("bytes_received", len(meta) + sum(req["buffer_sizes"]))


class DataClient:
    """Pooled client side: one connection per concurrent transfer per peer,
    reused across transfers.  Client-side admission bounds total concurrent
    transfers issued by this process."""

    def __init__(self, chunk_bytes: int = 8 * 1024 * 1024, max_concurrent: int = 4):
        self.chunk_bytes = chunk_bytes
        self.stats = TransferStats()
        self._admission = threading.BoundedSemaphore(max(1, max_concurrent))
        self._idle: Dict[str, List[socket.socket]] = {}
        self._lock = threading.Lock()
        # same-host handoff: cached read-side opens of peers' arenas
        self._peer_segments: Dict[str, Any] = {}
        self._seg_lock = threading.Lock()

    # -- same-host shm handoff ------------------------------------------
    def _peer_segment(self, name: str):
        with self._seg_lock:
            store = self._peer_segments.get(name)
        if store is not None:
            return store
        from ray_tpu_torch.native.shm_store import ShmObjectStore

        store = ShmObjectStore(name, create=False)
        with self._seg_lock:
            return self._peer_segments.setdefault(name, store)

    def _consume_shm_offer(self, offer: dict, is_error: bool) -> Tuple[Any, bool]:
        """Reconstruct the value from a peer's arena.

        ``entries`` offers reference the producer's ORIGINAL entries (zero
        server-side copy); ``staged`` offers reference one freshly staged
        entry.  Either way: zero-copy when the value can carry a finalizer
        (ndarray — the dominant bulk case), buffers viewing the mapped
        segment pinned until the value is garbage-collected; otherwise the
        buffers are copied out (one memcpy at arena rates) and the pins
        drop immediately."""
        import weakref

        store = self._peer_segment(offer["segment"])
        if offer.get("kind") == "entries":
            meta = offer["meta"]
            pins: List[bytes] = []
            bufs = []
            try:
                for eid, rel, nbytes in offer["bufs"]:
                    got = store.get(eid)
                    if got is None:
                        raise DataPlaneError(f"entry {eid.hex()} vanished")
                    pins.append(eid)
                    view, _ = got
                    bufs.append(view[rel : rel + nbytes].toreadonly())
            except BaseException:
                for eid in pins:
                    store.release(eid)
                raise
        else:
            sid = offer["sid"]
            got = store.get(sid)
            if got is None:
                raise DataPlaneError(f"staged entry {sid.hex()} vanished")
            view, _meta = got
            pins = [sid]
            meta, bufs = read_staged(view)
            # read-only views: a consumer mutating its array must not
            # corrupt the shared bytes other pullers may map (plasma
            # returns read-only buffers for the same reason)
            bufs = [b.toreadonly() for b in bufs]
        pinned = True
        try:
            value = from_frames(meta, bufs)
            import numpy as np

            if isinstance(value, np.ndarray):
                # zero-copy: finalize the data OWNER — sub-views collapse
                # .base to the bottom array, so only it is guaranteed to
                # outlive every surviving slice (else: use-after-free)
                from ray_tpu_torch.runtime.protocol import nd_owner

                weakref.finalize(nd_owner(value), _release_pins, store, tuple(pins))
                pinned = False  # finalizer owns the releases now
            else:
                # containers/custom objects: an inner array a caller
                # extracts could outlive any finalizer anchor we can see —
                # re-load with copies so nothing references the arena once
                # we release (one memcpy at arena rates)
                copied = [bytes(b) for b in bufs]
                value = from_frames(bytes(meta), copied)
            return value, is_error
        finally:
            if pinned:
                for eid in pins:
                    store.release(eid)

    # -- connection pool -------------------------------------------------
    def _checkout(self, addr: str) -> socket.socket:
        with self._lock:
            pool = self._idle.get(addr)
            if pool:
                return pool.pop()
        host, _, port = addr.rpartition(":")
        sock = socket.create_connection((host or "127.0.0.1", int(port)), timeout=10.0)
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _checkin(self, addr: str, sock: socket.socket) -> None:
        with self._lock:
            self._idle.setdefault(addr, []).append(sock)

    def _discard(self, sock: socket.socket) -> None:
        try:
            sock.close()
        except OSError:
            pass

    def close(self) -> None:
        with self._lock:
            pools, self._idle = self._idle, {}
        for socks in pools.values():
            for s in socks:
                self._discard(s)

    # -- operations ------------------------------------------------------
    def pull(self, addr: str, oid: bytes, timeout: float = 30.0) -> Tuple[Any, bool]:
        """Fetch an object from a peer; returns ``(value, is_error)``.
        Raises :class:`ObjectNotFound` if the peer doesn't materialize it
        within ``timeout``."""
        t_start = time.perf_counter()
        try:
            return self._pull(addr, oid, timeout)
        finally:
            _observe_latency("pull", t_start)

    def _pull(self, addr: str, oid: bytes, timeout: float = 30.0) -> Tuple[Any, bool]:
        from ray_tpu_torch.core.config import get_config
        from ray_tpu_torch.runtime import device_plane

        device_capable = device_plane.transfer_address() is not None
        tok = host_token() if get_config().same_host_shm_transfer else None
        with self._admission:
            sock = self._checkout(addr)
            try:
                sock.settimeout(timeout + 30.0)
                _send_header(
                    sock,
                    {"op": "pull", "oid": oid, "timeout": timeout,
                     "device_capable": device_capable, "shm_token": tok},
                )
                header = _recv_header(sock)
                if not header.get("found"):
                    self._checkin(addr, sock)
                    raise ObjectNotFound(f"peer {addr} does not hold the object")
                if "device_xfer" not in header and "shm" not in header:
                    meta = _recv_exact(sock, header["meta_size"])
                    buffers = [
                        _recv_into_buffer(sock, size) for size in header["buffer_sizes"]
                    ]
                sock.settimeout(None)
            except ObjectNotFound:
                raise  # connection already checked back in above
            except (OSError, EOFError, pickle.UnpicklingError) as exc:
                self._discard(sock)
                raise DataPlaneError(f"pull from {addr} failed: {exc}") from exc
            else:
                self._checkin(addr, sock)
        shm_offer = header.get("shm")
        if shm_offer is not None:
            try:
                value, is_error = self._consume_shm_offer(
                    shm_offer, header.get("is_error", False)
                )
                self.stats.add("pulls_issued")
                self.stats.add("shm_handoffs")
                return value, is_error
            except Exception:  # noqa: BLE001 — segment gone/arena churned:
                return self.pull_host(addr, oid, timeout)  # stream instead
        offer = header.get("device_xfer")
        if offer is not None:
            # device-to-device through the transfer server
            from ray_tpu_torch.parallel.collective import pull_device_value

            arr = pull_device_value(offer, offer["shape"], offer["dtype"])
            if arr is not None:
                self.stats.add("pulls_issued")
                return arr, False
            # local backend refused mid-flight: retry as a host-envelope pull
            return self.pull_host(addr, oid, timeout)
        self.stats.add("pulls_issued")
        self.stats.add("bytes_received", len(meta) + sum(header["buffer_sizes"]))
        return from_frames(meta, buffers), header.get("is_error", False)

    def pull_host(self, addr: str, oid: bytes, timeout: float = 30.0) -> Tuple[Any, bool]:
        """Envelope-only pull (no device-transfer negotiation)."""
        with self._admission:
            sock = self._checkout(addr)
            try:
                sock.settimeout(timeout + 30.0)
                _send_header(sock, {"op": "pull", "oid": oid, "timeout": timeout})
                header = _recv_header(sock)
                if not header.get("found"):
                    self._checkin(addr, sock)
                    raise ObjectNotFound(f"peer {addr} does not hold the object")
                meta = _recv_exact(sock, header["meta_size"])
                buffers = [_recv_into_buffer(sock, size) for size in header["buffer_sizes"]]
                sock.settimeout(None)
            except ObjectNotFound:
                raise
            except (OSError, EOFError, pickle.UnpicklingError) as exc:
                self._discard(sock)
                raise DataPlaneError(f"pull from {addr} failed: {exc}") from exc
            else:
                self._checkin(addr, sock)
        self.stats.add("pulls_issued")
        self.stats.add("bytes_received", len(meta) + sum(header["buffer_sizes"]))
        return from_frames(meta, buffers), header.get("is_error", False)

    def relay(self, oid: bytes, value: Any, tree: List[dict],
              is_error: bool = False, timeout: float = 120.0) -> List[str]:
        """Broadcast through a relay tree of node agents: not ported."""
        from ray_tpu_torch.exceptions import NotPortedError

        raise NotPortedError("the broadcast relay", "ray_tpu/runtime/data_plane.py")

    def push_task(self, addr: str, spec_blob: bytes, timeout: float = 300.0,
                  result_timeout: float = 24 * 3600.0 + 300.0):
        """Leased direct dispatch to a node agent: not ported."""
        from ray_tpu_torch.exceptions import NotPortedError

        raise NotPortedError("leased direct dispatch (push_task)",
                             "ray_tpu/runtime/data_plane.py")

    def push(self, addr: str, oid: bytes, value: Any, is_error: bool = False) -> None:
        t_start = time.perf_counter()
        try:
            self._push(addr, oid, value, is_error)
        finally:
            _observe_latency("push", t_start)

    def _push(self, addr: str, oid: bytes, value: Any, is_error: bool = False) -> None:
        meta, buffers = to_frames(value)
        sizes = [memoryview(b).cast("B").nbytes for b in buffers]
        with self._admission:
            sock = self._checkout(addr)
            try:
                sock.settimeout(120.0)
                _send_header(
                    sock,
                    {"op": "push", "oid": oid, "is_error": is_error,
                     "meta_size": len(meta), "buffer_sizes": sizes},
                )
                sock.sendall(meta)
                _send_buffers(sock, buffers, self.chunk_bytes)
                reply = _recv_header(sock)
                sock.settimeout(None)
            except (OSError, EOFError, pickle.UnpicklingError) as exc:
                self._discard(sock)
                raise DataPlaneError(f"push to {addr} failed: {exc}") from exc
            else:
                self._checkin(addr, sock)
            if not reply.get("ok"):
                raise DataPlaneError(f"push to {addr} rejected: {reply}")
        self.stats.add("pushes_sent")
        self.stats.add("bytes_sent", len(meta) + sum(sizes))


def _materialize_device_frame(dev: dict, buffers: List[Any]):
    """Rebuild a device-channel frame's payload WITHOUT pickle: either a
    device-to-device pull of the producer-staged tensor (``dev["xfer"]``
    ticket) or, the CPU and no-transfer-server fallback, the host-staged
    raw bytes assembled by ``collective._rendezvous_device_frame``.
    Returns ``(tensor, "")`` or ``(None, reason)``."""
    from ray_tpu_torch.parallel import collective

    try:
        xfer = dev.get("xfer")
        if xfer is not None:
            arr = collective.pull_device_value(xfer, dev["shape"], dev["dtype"])
            if arr is None:
                return None, "device pull unavailable"
            return arr, ""
        if not buffers:
            return None, "device frame carried no payload"
        return (
            collective._rendezvous_device_frame(dev["shape"], dev["dtype"], buffers[0]),
            "",
        )
    except Exception as exc:  # noqa: BLE001 — backend mismatch, expired entry
        return None, f"device frame materialize failed: {exc!r}"


class ChannelStream:
    """Persistent data-plane connection carrying ONE compiled-plan channel.

    Opened once at plan install, reused for every iteration (the 'install
    once, execute many' contract): each :meth:`push` streams one
    seq-numbered frame through the chunk pipeline and blocks on the
    receiver's ack — which the peer withholds until its consumer slot
    accepted the value, so the stream self-limits to one frame in flight
    plus one in the slot.  A nack means the peer released/closed the
    channel (teardown or a broken plan): surfaced as
    :class:`~ray_tpu.dag.channel.ChannelClosed`."""

    def __init__(self, addr: str, plan_id: str, chan: str,
                 chunk_bytes: int = 8 * 1024 * 1024, timeout: float = 300.0,
                 kind: str = "pickle"):
        self.addr = addr
        self.plan_id = plan_id
        self.chan = chan
        self.chunk_bytes = chunk_bytes
        self.timeout = timeout
        #: "device": tensor payloads ride control-only headers (see
        #: _push_device) — everything else falls back to the pickle frames
        self.kind = kind
        self._stager = None
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._closed = False

    def _connect(self) -> socket.socket:
        host, _, port = self.addr.rpartition(":")
        sock = socket.create_connection((host or "127.0.0.1", int(port)), timeout=10.0)
        sock.settimeout(self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def push(self, seq: int, value: Any, is_error: bool = False) -> None:
        from ray_tpu_torch.dag.channel import ChannelClosed
        from ray_tpu_torch.observability import metric_defs

        if self.kind == "device" and not is_error:
            from ray_tpu_torch.runtime import device_plane

            if device_plane.is_device_array(value):
                return self._push_device(seq, value)

        t_start = time.perf_counter()
        meta, buffers = to_frames(value)
        sizes = [memoryview(b).cast("B").nbytes for b in buffers]
        with self._lock:
            if self._closed:
                raise ChannelClosed(f"channel stream {self.chan!r} closed")
            if self._sock is None:
                self._sock = self._connect()
            sock = self._sock
            try:
                _send_header(
                    sock,
                    {"op": "chan_push", "plan": self.plan_id, "chan": self.chan,
                     "seq": seq, "is_error": is_error, "src": local_source(),
                     "meta_size": len(meta), "buffer_sizes": sizes},
                )
                sock.sendall(meta)
                _send_buffers(sock, buffers, self.chunk_bytes)
                reply = _recv_header(sock)
            except (OSError, EOFError, pickle.UnpicklingError) as exc:
                self._drop_sock_locked()
                raise DataPlaneError(
                    f"channel push to {self.addr} failed: {exc}"
                ) from exc
        if not reply.get("ok"):
            raise ChannelClosed(
                f"channel {self.chan!r} rejected by {self.addr}: {reply.get('error')}"
            )
        nbytes = len(meta) + sum(sizes)
        metric_defs.COMPILED_CHANNEL_BYTES.inc(nbytes, tags={"direction": "sent"})
        from ray_tpu_torch.observability import tracing

        if tracing.enabled():
            now = time.time()
            tracing.emit_span(
                f"chan::{self.chan}", f"plan-{self.plan_id[:12]}", None,
                now - (time.perf_counter() - t_start), now,
                attrs={"seq": str(seq), "bytes": str(nbytes)},
            )

    def _device_stager(self):
        if self._stager is None:
            from ray_tpu_torch.core.config import get_config
            from ray_tpu_torch.parallel import collective

            self._stager = collective.DeviceChannelStager(
                f"{self.plan_id}:{self.chan}",
                double_buffer=get_config().device_channel_double_buffer,
            )
        return self._stager

    def _push_device(self, seq: int, arr, force_host: bool = False) -> None:
        """Device-kind frame: the chan_push header is demoted to control
        only (dtype/shape + optional pull descriptor) and the tensor payload
        bypasses pickle entirely: either ZERO payload bytes on this stream
        (the consumer pulls the producer-staged tensor device-to-device) or
        the raw host bytes when no transfer server is running.  Exactly one ``_send_header`` per push, same as the
        pickle path, so the failpoint decision stream (and same-seed chaos
        fault logs) stays byte-identical."""
        import torch

        from ray_tpu_torch.dag.channel import ChannelClosed
        from ray_tpu_torch.observability import metric_defs

        t_start = time.perf_counter()
        shape = tuple(int(d) for d in arr.shape)
        dtype = str(arr.dtype).removeprefix("torch.")
        logical = int(arr.nbytes)
        desc = None if force_host else self._device_stager().offer(seq, arr)
        if desc is not None:
            buffers: List[Any] = []
            sizes: List[int] = []
        else:
            host = arr.detach().to("cpu").contiguous()
            buffers = [host.reshape(-1).view(torch.uint8).numpy()]
            sizes = [logical]
        with self._lock:
            if self._closed:
                raise ChannelClosed(f"channel stream {self.chan!r} closed")
            if self._sock is None:
                self._sock = self._connect()
            sock = self._sock
            try:
                _send_header(
                    sock,
                    {"op": "chan_push", "plan": self.plan_id, "chan": self.chan,
                     "seq": seq, "is_error": False, "src": local_source(),
                     "meta_size": 0, "buffer_sizes": sizes,
                     "device": {"shape": shape, "dtype": dtype, "shards": 1,
                                "xfer": desc}},
                )
                if buffers:
                    _send_buffers(sock, buffers, self.chunk_bytes)
                reply = _recv_header(sock)
            except (OSError, EOFError, pickle.UnpicklingError) as exc:
                self._drop_sock_locked()
                raise DataPlaneError(
                    f"channel push to {self.addr} failed: {exc}"
                ) from exc
        if not reply.get("ok"):
            if desc is not None and reply.get("fallback"):
                # the peer could not serve the device-to-device pull (no
                # backend, staged entry expired): resend this seq host-staged
                return self._push_device(seq, arr, force_host=True)
            raise ChannelClosed(
                f"channel {self.chan!r} rejected by {self.addr}: {reply.get('error')}"
            )
        metric_defs.COMPILED_DEVICE_CHANNEL_BYTES.inc(logical, tags={"direction": "sent"})
        from ray_tpu_torch.observability import tracing

        if tracing.enabled():
            now = time.time()
            tracing.emit_span(
                f"chan::{self.chan}", f"plan-{self.plan_id[:12]}", None,
                now - (time.perf_counter() - t_start), now,
                attrs={"seq": str(seq), "bytes": str(logical), "kind": "device"},
            )

    def _drop_sock_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._drop_sock_locked()


def store_server(store, host: str = "127.0.0.1", port: int = 0,
                 chunk_bytes: Optional[int] = None,
                 max_concurrent: Optional[int] = None,
                 shm_store=None) -> DataServer:
    """A :class:`DataServer` backed by one local ObjectStore."""
    from collections import OrderedDict

    from ray_tpu_torch.core.config import get_config
    from ray_tpu_torch.core.ids import ObjectID

    cfg = get_config()
    # Small serve-side frame cache: N consumers of one bulk object (shuffle
    # fan-in, broadcast) cost one serialization, not N.  Objects are
    # immutable so entries can never go stale.  Frames are (meta, buffer
    # views of the live value) — near-zero marginal memory.  Entry count is
    # a config knob (data_server_frame_cache_entries, 0 disables); hit/miss
    # counters surface in the server's TransferStats and `rt pulls`.
    cache_cap = max(0, cfg.data_server_frame_cache_entries)
    frame_cache: "OrderedDict[bytes, Tuple[bytes, List[Any], bool]]" = OrderedDict()
    cache_lock = threading.Lock()
    server_box: List[DataServer] = []

    def _cache_count(field: str) -> None:
        if server_box:
            server_box[0].stats.add(field)

    def get_frames(oid_bytes: bytes, timeout: float):
        with cache_lock:
            hit = frame_cache.get(oid_bytes)
            if hit is not None:
                frame_cache.move_to_end(oid_bytes)
        if hit is not None:
            _cache_count("frame_cache_hits")
            return hit
        _cache_count("frame_cache_misses")
        oid = ObjectID(oid_bytes)
        value = store.get(oid, timeout=timeout)
        info = store.entry_info(oid)
        meta, buffers = to_frames(value)
        out = (meta, buffers, bool(info and info["is_error"]))
        if cache_cap > 0:
            with cache_lock:
                frame_cache[oid_bytes] = out
                while len(frame_cache) > cache_cap:
                    frame_cache.popitem(last=False)
        return out

    def put_frames(oid_bytes: bytes, meta: bytes, buffers, is_error: bool) -> None:
        store.put(ObjectID(oid_bytes), from_frames(meta, buffers), is_error=is_error)

    def get_device_offer(oid_bytes: bytes):
        from ray_tpu_torch.runtime import device_plane

        try:
            addr = device_plane.transfer_address()
            if addr is None:
                return None
            oid = ObjectID(oid_bytes)
            if not store.contains(oid):
                return None
            value = store.get(oid, timeout=0.01)
            if not device_plane.is_device_array(value):
                return None
            uuid = device_plane.uuid_for_object(oid_bytes)
            if not device_plane.offer_device_pull(uuid, value):
                return None
            return {
                "addr": addr, "uuid": uuid,
                "shape": tuple(value.shape), "dtype": str(value.dtype),
            }
        except Exception:  # noqa: BLE001 — eviction race etc.: no offer,
            return None    # the pull falls through to the host envelope

    server = DataServer(
        get_frames, put_frames, host=host, port=port,
        chunk_bytes=chunk_bytes or cfg.object_transfer_chunk_bytes,
        max_concurrent=max_concurrent or cfg.max_concurrent_object_transfers,
        get_device_offer=get_device_offer,
        shm_store=shm_store,
    )
    server_box.append(server)
    return server
