"""Process-local handle to the cluster's internal KV store.

The port's copy of ``ray_tpu/runtime/kv_client.py``, its single-host part.
The control service owns one InternalKV (``runtime/control.py``; reference:
``GcsInternalKVManager``, ``src/ray/gcs/gcs_server/gcs_kv_manager.h``).  This
module answers "how do I reach it from THIS process":

  * driver process — direct in-process access to ``cluster.control.kv``;
  * spawned pool worker — ``kv_put``/``kv_get``/``kv_del`` frames over the
    pool socket (``runtime/worker_api.py``).

A node agent reaches the KV over its head connection in the JAX package
(``_RpcKV``, ``register_agent_kv``); the port has no agent yet, so both
raise ``NotPortedError``.

Gang rendezvous (the process-group coordinator exchange) and the
cross-process collective rendezvous ride this; the reference uses a named
NCCL-unique-id store actor for the same role
(``python/ray/util/collective/collective.py`` rendezvous).
"""

from __future__ import annotations

from typing import Optional


class KVClient:
    def put(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def delete(self, key: bytes) -> None:
        raise NotImplementedError


class _ControlKV(KVClient):
    """Driver-side: the control service lives in this process."""

    def __init__(self, kv):
        self._kv = kv

    def put(self, key: bytes, value: bytes) -> None:
        self._kv.put(key, value)

    def get(self, key: bytes) -> Optional[bytes]:
        return self._kv.get(key)

    def delete(self, key: bytes) -> None:
        self._kv.delete(key)


class _RpcKV(KVClient):
    """Agent-side KV over the head connection: waits for the multi-node
    runtime."""

    def __init__(self, conn):
        from ray_tpu_torch.exceptions import NotPortedError

        raise NotPortedError("the agent's KV client (_RpcKV)", "ray_tpu/runtime/kv_client.py:47")


class _WorkerKV(KVClient):
    """Worker-process side: KV ops as worker-api frames over the pool
    socket (worker -> node -> driver's control KV).  Metadata only — the
    collective rank-address book, never payloads."""

    def __init__(self, api_client):
        self._api = api_client

    def put(self, key: bytes, value: bytes) -> None:
        self._api.kv_put(key, value)

    def get(self, key: bytes) -> Optional[bytes]:
        return self._api.kv_get(key)

    def delete(self, key: bytes) -> None:
        self._api.kv_del(key)


def worker_api_client():
    """The WorkerApiClient when THIS process is a spawned pool worker,
    else None (shared by get_kv / is_multiprocess / p2p.ensure_endpoint)."""
    try:
        from ray_tpu_torch.runtime import worker as _worker_mod
        from ray_tpu_torch.runtime.worker_api import WorkerApiClient

        w = getattr(_worker_mod, "_global_worker", None)
        return w if isinstance(w, WorkerApiClient) else None
    except Exception:  # noqa: BLE001
        return None


def register_agent_kv(conn) -> None:
    """The node agent's KV registration: waits for the multi-node runtime."""
    from ray_tpu_torch.exceptions import NotPortedError

    raise NotPortedError("register_agent_kv (node agents)", "ray_tpu/runtime/kv_client.py:110")


def get_kv() -> Optional[KVClient]:
    w = worker_api_client()
    if w is not None:
        return _WorkerKV(w)
    try:
        from ray_tpu_torch import api

        if api.is_initialized():
            return _ControlKV(api.get_cluster().control.kv)
    except Exception:  # noqa: BLE001
        pass
    return None


def head_peer_ip() -> Optional[str]:
    """The head's IP as seen from this process: only agents have one, and
    the port has none, so always None."""
    return None


def is_multiprocess() -> bool:
    """True when collective/rendezvous state must go through the shared KV
    (this process is a spawned pool worker, or the driver hosts
    process-actor participants) rather than process-local memory."""
    if worker_api_client() is not None:
        return True
    try:
        from ray_tpu_torch import api

        if api.is_initialized():
            cluster = api.get_cluster()
            for n in cluster.nodes.values():
                # process-execution actors/tasks on a local node live in
                # spawned worker processes — a collective group touching
                # them must ride the transport
                pool = getattr(n, "worker_pool", None)
                if pool is not None and pool.has_process_participants():
                    return True
    except Exception:  # noqa: BLE001
        pass
    return False
