"""Process-level peer-to-peer collective endpoint.

The port's copy of ``ray_tpu/runtime/p2p.py``, its single-host part. Every
process that joins a cross-process collective group (the driver, a spawned
pool worker) registers ONE endpoint here: a local object store, served by
its own data-plane ``DataServer`` (``runtime/data_plane.py``), a
``DataClient`` for outbound pushes, and the address peers reach it at.
Collective point-to-point messages and cross-process rendezvous then move
as direct store-to-store pushes; the control KV carries only tiny
rank→address registrations, never message payloads.

In the JAX package the driver's endpoint comes with the head service and
agents register theirs at startup; the port has neither yet (ROADMAP item
10), so the driver builds a private endpoint on first use, as a worker
does, bound to the loopback interface (one host).

Role parity with the reference's NCCL/Gloo transport binding in
``python/ray/util/collective/collective_group/``.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict, Optional, Tuple

from ray_tpu_torch.core.ids import ObjectID


class Endpoint:
    """This process's collective identity on the data plane."""

    def __init__(self, store, data_client, address: str, on_consume=None, server=None):
        self.store = store
        self.data_client = data_client
        self.address = address
        # the DataServer this module built for the endpoint (closed with it)
        self.server = server
        # optional hook run after a mailbox slot is consumed (the driver
        # uses it to drop the object-directory entry the head data server
        # records for every inbound blob — mailbox oids must not accumulate)
        self.on_consume = on_consume


_lock = threading.Lock()
_endpoint: Optional[Endpoint] = None
# (group, rank) -> (address, registered_at). Entries expire so a re-created
# group with different placement self-heals instead of deadlocking on a
# stale address forever.
_ADDR_TTL_S = 5.0
_addr_cache: Dict[Tuple[str, int], Tuple[str, float]] = {}
# this process's hosting node (hex), published beside each rank address so
# the head can map a dead node to the groups it strands
_local_node_hex: str = ""
# group -> failure reason; open take_group waits are woken with an error
# the moment a death notice lands
_group_failures: Dict[str, str] = {}
# group -> oids currently blocked in take_group (to be error-posted)
_group_waits: Dict[str, set] = {}


def set_local_node(node_hex: str) -> None:
    global _local_node_hex
    with _lock:
        _local_node_hex = node_hex


def register_endpoint(store, data_client, address: str, on_consume=None, server=None) -> None:
    global _endpoint
    with _lock:
        _endpoint = Endpoint(store, data_client, address, on_consume=on_consume, server=server)


def clear_endpoint() -> None:
    """Called at shutdown — endpoints must not leak across init cycles (a
    server and client this module built close with it)."""
    global _endpoint
    with _lock:
        ep, _endpoint = _endpoint, None
        _addr_cache.clear()
        _group_failures.clear()
        _group_waits.clear()
    if ep is not None and ep.server is not None:
        ep.server.close()
        ep.data_client.close()


def get_endpoint() -> Optional[Endpoint]:
    with _lock:
        return _endpoint


_build_lock = threading.Lock()


def ensure_endpoint() -> Optional[Endpoint]:
    """The process's endpoint, building one if this process can host one.

    Every execution mode owns a transport (reference: every core worker
    owns one, ``src/ray/core_worker/core_worker.h:292``): a spawned pool
    worker and the driver (``api.is_initialized()``) each build a private
    store + data server on first use.  Returns None only where no fabric
    exists (bare library use)."""
    ep = get_endpoint()
    if ep is not None:
        return ep
    from ray_tpu_torch.runtime.kv_client import worker_api_client

    if worker_api_client() is not None:
        return _build_endpoint()
    try:
        from ray_tpu_torch import api

        # driver proper (worker processes never pass api.is_initialized —
        # their global worker is the WorkerApiClient caught above)
        if api.is_initialized():
            return _build_endpoint()
    except Exception:  # noqa: BLE001 — no cluster in this process
        pass
    return get_endpoint()


def _build_endpoint() -> Optional[Endpoint]:
    """This process's transport: a private in-memory store served by its
    own DataServer on the loopback interface, plus a DataClient for
    outbound pushes.  A worker publishes its hosting node (``RT_NODE_ID``,
    set by the spawning pool) beside each rank address."""
    import os

    with _build_lock:
        ep = get_endpoint()
        if ep is not None:
            return ep
        from ray_tpu_torch.core.config import get_config
        from ray_tpu_torch.core.object_store import ObjectStore
        from ray_tpu_torch.runtime import data_plane

        cfg = get_config()
        store = ObjectStore()
        server = data_plane.store_server(store, host="127.0.0.1")
        client = data_plane.DataClient(
            chunk_bytes=cfg.object_transfer_chunk_bytes,
            max_concurrent=cfg.max_concurrent_object_transfers,
        )
        register_endpoint(store, client, server.address, server=server)
        node_hex = os.environ.get("RT_NODE_ID", "").strip()
        if node_hex:
            set_local_node(node_hex)
        return get_endpoint()


def mailbox_oid(*parts) -> ObjectID:
    """Deterministic ObjectID for a p2p mailbox slot — both ends derive the
    same id from (group, channel, src, dst, seq) without coordination."""
    key = "/".join(str(p) for p in parts).encode()
    return ObjectID(hashlib.blake2b(key, digest_size=ObjectID.SIZE).digest())


# --------------------------------------------------------------------------
# rank -> data-plane address registry (tiny metadata through the head KV)
# --------------------------------------------------------------------------
def addr_key(group: str, rank: int) -> bytes:
    """THE rank-address KV key format — every reader/writer uses this."""
    return f"rt_coll_addr/{group}/{rank}".encode()


def node_key(group: str, rank: int) -> bytes:
    """Rank -> hosting-node registration (death-notice routing)."""
    return f"rt_coll_node/{group}/{rank}".encode()


def register_rank(group: str, rank: int, address: Optional[str] = None) -> None:
    """Publish where this rank's process can be reached on the data plane.
    Idempotent and cheap: the KV put is skipped while a fresh cache entry
    already carries this address (no head RPC per collective op)."""
    from ray_tpu_torch.runtime.kv_client import get_kv

    ep = get_endpoint()
    addr = address or (ep.address if ep is not None else None)
    if addr is None:
        return
    now = time.monotonic()
    with _lock:
        hit = _addr_cache.get((group, rank))
        if hit is not None and hit[0] == addr and now - hit[1] < _ADDR_TTL_S:
            return
        _addr_cache[(group, rank)] = (addr, now)
        node_hex = _local_node_hex
    kv = get_kv()
    if kv is not None:
        kv.put(addr_key(group, rank), addr.encode())
        if node_hex and address is None:
            # only when registering OURSELVES: a third party re-publishing
            # another rank's address must not claim it for its own node
            kv.put(node_key(group, rank), node_hex.encode())


def resolve_rank(group: str, rank: int, timeout: float = 30.0) -> str:
    """Find a rank's data-plane address (cached with a TTL).  Bounded
    metadata poll: once per (group, rank) per TTL window per process, not
    per message — payloads never poll."""
    now = time.monotonic()
    with _lock:
        hit = _addr_cache.get((group, rank))
    if hit is not None and now - hit[1] < _ADDR_TTL_S:
        return hit[0]
    from ray_tpu_torch.runtime.kv_client import get_kv

    kv = get_kv()
    if kv is None:
        raise ConnectionError("no cluster KV available to resolve collective ranks")
    deadline = time.monotonic() + timeout
    while True:
        raw = kv.get(addr_key(group, rank))
        if raw:
            addr = raw.decode()
            with _lock:
                _addr_cache[(group, rank)] = (addr, time.monotonic())
            return addr
        if time.monotonic() > deadline:
            raise TimeoutError(f"rank {rank} of group {group!r} never registered an address")
        time.sleep(0.01)


def invalidate_rank(group: str, rank: int) -> None:
    """Drop a cached address after a failed post so the next attempt
    re-resolves from the KV."""
    with _lock:
        _addr_cache.pop((group, rank), None)


def forget_group(group: str) -> None:
    with _lock:
        for key in [k for k in _addr_cache if k[0] == group]:
            _addr_cache.pop(key, None)
        # a re-created group starts clean: old incarnation's death notice
        # must not poison it
        _group_failures.pop(group, None)


# --------------------------------------------------------------------------
# store-to-store message primitives (the p2p data path)
# --------------------------------------------------------------------------
def post(dst_addr: str, oid: ObjectID, value) -> None:
    """Deliver a value into the destination process's store (local put when
    the destination is this process; chunked data-plane push otherwise)."""
    ep = get_endpoint()
    if ep is None:
        raise ConnectionError("p2p endpoint not registered in this process")
    if dst_addr == ep.address:
        ep.store.put(oid, value)
        return
    ep.data_client.push(dst_addr, oid.binary(), value)


def post_to_rank(group: str, rank: int, oid: ObjectID, value, timeout: float = 30.0) -> None:
    """Resolve a rank's address and deliver; one stale-address retry (the
    cached address is invalidated and re-read from the KV on failure)."""
    addr = resolve_rank(group, rank, timeout=timeout)
    try:
        post(addr, oid, value)
    except (ConnectionError, OSError):
        invalidate_rank(group, rank)
        post(resolve_rank(group, rank, timeout=timeout), oid, value)


def take(oid: ObjectID, timeout: float):
    """Blocking consume from this process's store (waits on the local
    condition variable — no polling; the inbound push wakes it)."""
    ep = get_endpoint()
    if ep is None:
        raise ConnectionError("p2p endpoint not registered in this process")
    value = ep.store.get(oid, timeout=timeout)
    ep.store.delete(oid)
    if ep.on_consume is not None:
        try:
            ep.on_consume(oid)
        except Exception:  # noqa: BLE001 — cleanup must not fail a recv
            pass
    return value


class _GroupFailure:
    """Sentinel posted into a waiting mailbox by a death notice."""

    def __init__(self, reason: str):
        self.reason = reason


def take_group(group: str, oid: ObjectID, timeout: float):
    """:func:`take`, but registered under a collective group: a death
    notice for the group (``fail_group``) wakes the wait IMMEDIATELY with
    :class:`~ray_tpu_torch.exceptions.CollectiveGroupDeadError` instead of letting
    it run out the full rendezvous timeout."""
    from ray_tpu_torch.exceptions import CollectiveGroupDeadError

    with _lock:
        reason = _group_failures.get(group)
        if reason is None:
            _group_waits.setdefault(group, set()).add(oid)
    if reason is not None:
        raise CollectiveGroupDeadError(group, reason)
    try:
        value = take(oid, timeout)
    finally:
        with _lock:
            waits = _group_waits.get(group)
            if waits is not None:
                waits.discard(oid)
                if not waits:
                    _group_waits.pop(group, None)
    if isinstance(value, _GroupFailure):
        raise CollectiveGroupDeadError(group, value.reason)
    return value


def fail_group(group: str, reason: str) -> None:
    """Deliver a death notice locally: mark the group failed (future waits
    raise at entry) and error-post every currently-open wait's mailbox so
    blocked ranks wake NOW."""
    ep = get_endpoint()
    with _lock:
        _group_failures[group] = reason
        waiting = list(_group_waits.get(group, ()))
    if ep is not None:
        for oid in waiting:
            try:
                ep.store.put(oid, _GroupFailure(reason))
            except Exception:  # noqa: BLE001 — store torn down: wait times out
                pass
