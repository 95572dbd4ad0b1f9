"""Head-side half of the multi-host fabric.

A node agent (``ray_tpu_torch.runtime.agent``) connecting over the transport
(``runtime/rpc.py``) materializes here as a :class:`RemoteNodeHandle` — an
object implementing the same surface as :class:`ray_tpu_torch.runtime.node.Node`,
so the cluster fabric (scheduler, actor FSM, object directory, chaos hooks)
treats in-process and remote nodes identically.

Role parity with the reference's head-side view of a raylet: the GCS node
table + the ``NodeManagerService`` client stubs
(``src/ray/gcs/gcs_server/gcs_server.h:78``,
``src/ray/protobuf/node_manager.proto:371-433``) and the ray_syncer resource
view (``src/ray/common/ray_syncer/ray_syncer.h:88``) — here one duplex
connection carries leases (task dispatch), actor lifecycle, object movement
and resource reports.

Resource accounting: the head schedules against a :class:`MirrorPool` — the
head's view of the agent's real pool.  Every head-initiated acquire/release
(actor placement, placement-group 2PC) is applied locally AND echoed to the
agent, so the agent's authoritative pool sees the same deltas its own local
scheduler does; periodic ``resource_report`` messages reconcile any drift
(the ray_syncer role).

The port's copy of ``ray_tpu/runtime/remote_node.py``: the same messages,
handlers, fencing and health loop; values cross through the port's codecs
(``rpc.dumps_value``, the data plane's tensor envelope), and the handshake
reply names the port's protocol (``rpc.PROTOCOL_NAME``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from ray_tpu_torch.core.ids import ActorID, NodeID, ObjectID
from ray_tpu_torch.core.object_store import ObjectStore
from ray_tpu_torch.core.resources import ResourcePool, ResourceSet
from ray_tpu_torch.observability import metric_defs
from ray_tpu_torch.runtime import rpc
from ray_tpu_torch.runtime.scheduler import TaskSpec

# prebuilt tag dict for the leased remote-push hot path
_DATA_PLANE_PUSH_TAGS = {"transport": "data_plane"}

#: concurrent leased pushes per remote node before new leased submissions
#: overflow onto the control-plane path (each push holds a thread for the
#: task's whole round trip — long tasks must not wedge the push pool)
_MAX_PUSH_INFLIGHT = 16


class MirrorPool(ResourcePool):
    """Head-side mirror of a remote node's resource pool.

    Head-initiated mutations forward to the agent (one-way; the agent
    force-applies them), keeping the remote authoritative pool consistent
    with placement decisions made here."""

    def __init__(self, total, send: Callable[[str, dict], None]):
        super().__init__(total)
        self._send = send

    def _forward(self, op: str, rset: ResourceSet) -> None:
        try:
            self._send("pool_update", {"op": op, "resources": rset.fixed()})
        except rpc.RpcError:
            pass  # node death is handled by the disconnect path

    def acquire(self, request: ResourceSet) -> bool:
        ok = super().acquire(request)
        if ok:
            self._forward("acquire", request)
        return ok

    def release(self, request: ResourceSet) -> None:
        super().release(request)
        self._forward("release", request)

    def add_capacity(self, extra: ResourceSet) -> None:
        super().add_capacity(extra)
        self._forward("add_capacity", extra)

    def remove_capacity(self, extra: ResourceSet) -> None:
        super().remove_capacity(extra)
        self._forward("remove_capacity", extra)

    # -- reconciliation (resource_report) ---------------------------------
    def reconcile(self, total_fixed: Dict[str, int], available_fixed: Dict[str, int]) -> None:
        with self._lock:
            self.total = ResourceSet.from_fixed_dict(total_fixed)
            self._available = dict(available_fixed)


def _probe_nbytes(value: Any, depth: int = 0) -> Tuple[int, bool]:
    """(known_bytes, fully_known): sums nbytes over arrays/bytes including
    ones nested in common containers — no serialization, no device->host
    export (a tensor's nbytes is metadata)."""
    nb = getattr(value, "nbytes", None)
    if nb is not None:
        return int(nb), True
    if isinstance(value, (bytes, bytearray)):
        return len(value), True
    if value is None or isinstance(value, (bool, int, float, str)):
        return 64, True
    if depth < 4:
        if isinstance(value, dict):
            items = value.values()
        elif isinstance(value, (list, tuple)):
            items = value
        else:
            return 0, False
        total, known = 0, True
        for item in items:
            n, k = _probe_nbytes(item, depth + 1)
            total += n
            known = known and k
        return total, known
    return 0, False


def _bulk_size(value: Any) -> int:
    """Size probe for inline-vs-bulk routing WITHOUT a GIL-held in-band
    pickle and WITHOUT device->host exports: arrays (incl. nested in
    containers) are summed via nbytes metadata; only odd types fall back to
    pickle-5 framing (whose reducer exports device buffers)."""
    from ray_tpu_torch.runtime import data_plane

    known, fully = _probe_nbytes(value)
    if fully:
        return known
    from ray_tpu_torch.core.config import get_config

    if known > get_config().data_plane_inline_bytes:
        return known  # already over the line; no need to serialize to prove it
    try:
        meta, buffers = data_plane.to_frames(value)
    except Exception:  # noqa: BLE001 — unpicklable probes as "small"
        return 0
    return len(meta) + sum(memoryview(b).cast("B").nbytes for b in buffers)


class RemoteStore(ObjectStore):
    """The head's cache of a remote node's objects.

    ``put`` pushes the value to the agent as well (object-manager ``Push``
    parity) so dependencies staged here before an actor/task dispatch are
    readable by the remote executor; values that ORIGINATED on the agent
    (task results it already stored locally) are marked via
    :meth:`skip_push_once` so they don't echo back across the wire.
    ``get`` falls back to fetching from the agent when the head cache
    doesn't hold the bytes (``Pull`` parity).

    Bulk routing: values above ``data_plane_inline_bytes`` move on the
    peer-to-peer chunked data plane (``runtime/data_plane.py``), never on
    the control connection — control frames (heartbeats, dispatch, health
    pings) must not queue behind multi-second transfers."""

    def __init__(self, handle: "RemoteNodeHandle"):
        super().__init__(shm_store=None)
        self._handle = handle
        self._skip_push: set = set()
        self._skip_lock = threading.Lock()

    def skip_push_once(self, oid: ObjectID) -> None:
        with self._skip_lock:
            self._skip_push.add(oid)

    def put(self, object_id: ObjectID, value: Any, is_error: bool = False) -> None:
        super().put(object_id, value, is_error=is_error)
        with self._skip_lock:
            if object_id in self._skip_push:
                self._skip_push.discard(object_id)
                return
        handle = self._handle
        if handle.dead:
            return
        from ray_tpu_torch.core.config import get_config

        threshold = get_config().data_plane_inline_bytes
        bulk_capable = handle.data_address and handle.data_client is not None
        if bulk_capable and _bulk_size(value) > threshold:
            handle.push_value_async(object_id, value, is_error)
            return
        blob = rpc.dumps_value(value)
        if bulk_capable and len(blob) > threshold:
            handle.push_value_async(object_id, value, is_error)
            return
        try:
            handle.conn.send(
                "push_object",
                {"oid": object_id.binary(), "value_blob": blob, "is_error": is_error},
            )
        except rpc.RpcError:
            pass

    def get(self, object_id: ObjectID, timeout: Optional[float] = None) -> Any:
        if self.contains(object_id):
            return super().get(object_id, timeout=timeout)
        handle = self._handle
        if handle.dead:
            return super().get(object_id, timeout=timeout)
        # fetch from the agent (its local store is a valid location):
        # bulk path first, control-frame fallback
        if handle.data_address and handle.data_client is not None:
            from ray_tpu_torch.runtime import data_plane

            try:
                value, is_error = handle.data_client.pull(
                    handle.data_address, object_id.binary(), timeout=timeout or 30.0
                )
                self.skip_push_once(object_id)
                super().put(object_id, value, is_error=is_error)
                return value
            except data_plane.DataPlaneError:
                pass  # fall through to the control-plane fetch
        reply = handle.conn.request(
            "fetch_object", {"oid": object_id.binary()}, timeout=timeout or 30.0
        )
        value, is_error = rpc.decode_value(reply)
        self.skip_push_once(object_id)
        super().put(object_id, value, is_error=is_error)
        return value

    def delete(self, object_id: ObjectID) -> None:
        super().delete(object_id)
        if not self._handle.dead:
            try:
                self._handle.conn.send("delete_object", {"oid": object_id.binary()})
            except rpc.RpcError:
                pass


class _RemoteSchedulerView:
    """queue_len/stats view fed by resource reports."""

    def __init__(self):
        self._queue_len = 0
        self._stats: dict = {}

    def queue_len(self) -> int:
        return self._queue_len

    def stats(self) -> dict:
        return dict(self._stats)


class _NullWorkerPool:
    """Head-side stub: direct-slot handoff / inflight inspection are local
    optimizations that don't exist across the wire."""

    def register_direct_waiter(self, task_bin: bytes):
        return None

    def cancel_direct_waiter(self, task_bin: bytes, slot) -> None:
        pass

    def inflight_tasks(self):
        return []

    def unpin_lease(self, lease_key: bytes) -> None:
        pass  # the agent's own pool sweeps its lease pins (stale-pin path)


class RemoteNodeHandle:
    """Node-surface proxy for an agent process (see module docstring)."""

    def __init__(self, cluster, conn: rpc.RpcConnection, node_id: NodeID,
                 resources: Dict[str, float], labels: Optional[dict], address: str,
                 data_address: Optional[str] = None,
                 data_client=None, transfer_pool=None, incarnation: int = 0):
        self.cluster = cluster
        self.conn = conn
        self.node_id = node_id
        # the incarnation granted to THIS registration: frames arriving on
        # this connection with a different stamp — or after a newer
        # incarnation of the same node id registered — are fenced
        self.incarnation = incarnation
        self.labels = labels or {}
        self.address = address
        self.data_address = data_address  # agent's bulk-transfer endpoint
        self.data_client = data_client    # shared per-HeadService DataClient
        self.transfer_pool = transfer_pool
        self.dead = False
        self.pool = MirrorPool(resources, self._send)
        self.store = RemoteStore(self)
        self.scheduler = _RemoteSchedulerView()
        self.worker_pool = _NullWorkerPool()
        self._inflight: Dict[bytes, TaskSpec] = {}   # task_id -> head-side spec
        self._inflight_lock = threading.Lock()
        self._sent_fns: set = set()
        # function blobs shipped over the PUSH channel — separate from
        # _sent_fns: control and data frames have no cross-channel ordering,
        # so a blob "already sent" on one channel may not have landed when
        # the other channel's frame arrives
        self._pushed_fns: set = set()
        self.push_pool = None  # dedicated leased-push executor (HeadService)
        self.push_gate = None  # shared in-flight cap (one per HeadService)
        self.last_report = time.monotonic()

    def push_value_async(self, oid: ObjectID, value, is_error: bool) -> None:
        """Ship a value to the agent on the data plane, off-thread: callers
        (directory callbacks, dispatch paths) must not block on bulk bytes.
        Consumers that race ahead of the push self-heal — the agent's pull
        path waits on its local store for in-flight pushes."""

        def run():
            try:
                self.data_client.push(self.data_address, oid.binary(), value, is_error)
            except Exception:  # noqa: BLE001 — transient data-plane failure
                # Control-plane fallback: the consuming task was already
                # dispatched assuming the dependency would land; silently
                # dropping the push would hang its arg resolution forever.
                try:
                    self.conn.send(
                        "push_object",
                        {"oid": oid.binary(), "value_blob": rpc.dumps_value(value),
                         "is_error": is_error},
                    )
                except rpc.RpcError:
                    pass  # connection death runs the node-failure path

        if self.transfer_pool is not None:
            self.transfer_pool.submit(run)
        else:
            threading.Thread(target=run, name="head-push", daemon=True).start()

    # ------------------------------------------------------------------
    def _send(self, msg_type: str, payload: dict) -> None:
        self.conn.send(msg_type, payload)

    def _encode(self, spec: TaskSpec) -> dict:
        return rpc.encode_spec(spec, self._function_blob, self._sent_fns)

    def _function_blob(self, func):  # reuse Node's cached function-blob path
        from ray_tpu_torch.runtime.node import Node

        return Node._function_blob(self, func)

    def _track(self, spec: TaskSpec) -> None:
        with self._inflight_lock:
            self._inflight[spec.task_id.binary()] = spec

    def _untrack(self, task_bin: bytes) -> Optional[TaskSpec]:
        with self._inflight_lock:
            return self._inflight.pop(task_bin, None)

    def _lookup(self, task_bin: bytes) -> Optional[TaskSpec]:
        with self._inflight_lock:
            return self._inflight.get(task_bin)

    # ------------------------------------------------------------------
    # Node surface (what the cluster fabric calls)
    # ------------------------------------------------------------------
    def submit(self, spec: TaskSpec) -> None:
        spec.owner_node = self.node_id
        self._track(spec)
        try:
            self._send("submit_task", {"spec": self._encode(spec)})
        except rpc.RpcError:
            self._untrack(spec.task_id.binary())
            raise

    def submit_leased(self, spec: TaskSpec) -> None:
        """Leased direct dispatch to this agent: the encoded spec (inline
        args included) rides a peer-to-peer ``push_task`` frame on the data
        plane, and the result frames come back on the same connection to
        the OWNER — the head control channel sees neither the dispatch nor
        the completion.  Falls back to the control-plane submit when the
        data plane is absent or the push pool is saturated (long tasks)."""
        if self.dead:
            raise ConnectionError("leased node is dead")
        pool = self.push_pool
        gate = self.push_gate
        if (
            pool is None or gate is None
            or self.data_address is None or self.data_client is None
        ):
            self.submit(spec)
            return
        # The gate is SHARED across all handles (it mirrors the push pool's
        # thread count): counting per-handle would accept N_handles x cap
        # pushes that then queue unsent inside the executor behind long
        # tasks instead of overflowing to the control path.
        if not gate.acquire(blocking=False):
            self.submit(spec)
            return
        spec.owner_node = self.node_id
        self._track(spec)
        metric_defs.DIRECT_PUSHES.inc(tags=_DATA_PLANE_PUSH_TAGS)
        pool.submit(self._push_task_run, spec)

    def _push_task_run(self, spec: TaskSpec) -> None:
        import pickle

        from ray_tpu_torch.runtime import data_plane

        try:
            try:
                blob = pickle.dumps(
                    rpc.encode_spec(spec, self._function_blob, self._pushed_fns),
                    protocol=5,
                )
                header, value = self.data_client.push_task(self.data_address, blob)
                if header.get("need_fn"):
                    # cross-channel race: the agent's fn cache is cold —
                    # resend with the blob inline
                    blob = pickle.dumps(
                        rpc.encode_spec(spec, self._function_blob, set()),
                        protocol=5,
                    )
                    header, value = self.data_client.push_task(self.data_address, blob)
                if not header.get("ok"):
                    if header.get("task_error"):
                        # the agent could not decode/dispatch the spec (e.g.
                        # unpicklable user args): a control resubmit would
                        # fail identically — fail the task instead
                        if self._untrack(spec.task_id.binary()) is not None:
                            self.cluster.on_task_finished(
                                self, spec, None,
                                RuntimeError(header.get("error") or "push_task failed"),
                            )
                        return
                    raise data_plane.DataPlaneError(
                        header.get("error") or "push_task rejected"
                    )
            except data_plane.PushDeliveredError:
                # the agent ACKed delivery before the socket died: the task
                # may be executing there — a control resubmit would double-
                # execute it.  The spec stays tracked: the agent re-routes
                # its completion over the control channel when the data
                # reply goes unconfirmed, and node death hands the spec to
                # the kill sweep.
                return
            except data_plane.DataPlaneError:
                # data plane can't serve (agent mid-restart, transient
                # socket death BEFORE the spec was accepted): the control-
                # plane submit path still can.  The spec stays tracked — the
                # completion comes back as a normal task_finished message.
                # (If the delivery ack was sent but lost, the agent's
                # pushed_duplicate guard drops this resubmit.)
                if self.dead:
                    return  # node death sweep owns the pending spec
                try:
                    self._send("submit_task", {"spec": self._encode(spec)})
                except rpc.RpcError:
                    pass  # connection gone: kill_node's sweep resubmits
                return
            self._on_push_reply(spec, header, value)
        finally:
            self.push_gate.release()

    def _record_push_fence(self, spec: TaskSpec, inc, current) -> None:
        metric_defs.FENCED_FRAMES.inc(tags={"kind": "push_result"})
        self.cluster.record_fence_event(
            {
                "kind": "push_result",
                "node": self.node_id.hex()[:8],
                "incarnation": inc,
                "current": current,
                "task": spec.task_id.hex(),
                "attempt": spec.attempt,
            }
        )

    def _on_push_reply(self, spec: TaskSpec, header: dict, value) -> None:
        """Owner-side completion of a pushed task — the mirror of
        on_task_finished_msg, fed by data-plane frames instead of a head
        control RPC."""
        src = header.get("src")
        current = self.cluster.control.nodes.incarnation_of(self.node_id)
        if src is not None and src[1] != current:
            # push result stamped by a FENCED incarnation: the death sweep
            # already owns this task (resubmission) — committing the stale
            # result would be the exact split-brain fencing exists to stop.
            self._record_push_fence(spec, src[1], current)
            return
        owner: "RemoteNodeHandle" = self
        if self.dead:
            live = self.cluster.nodes.get(self.node_id)
            if src is None or live is None or live.dead:
                # node genuinely dead: the sweep resolved / will resolve
                # the pending spec; this straggler result is fenced
                self._record_push_fence(spec, src[1] if src else None, current)
                return
            # rejoin-race migration: THIS handle was superseded mid-push,
            # but the reply carries the CURRENT epoch's stamp — the result
            # is live and the spec was migrated to the adopting handle.
            # Commit through it; dropping here would strand the rt.get
            # (no death sweep ever runs for a still-alive node id).
            owner = live
        spans = header.get("spans")
        if spans:
            from ray_tpu_torch.observability import tracing

            tracing.record_span_events(spans)
        if owner._untrack(spec.task_id.binary()) is None:
            return  # already resolved (node-death resubmission raced)
        if header.get("error") is not None:
            error, _ = rpc.decode_value(header["error"])
            self.cluster.on_task_finished(owner, spec, None, error)
            return
        if header.get("lazy"):
            device_returns = list(header.get("device_returns", ()))
            sizes = list(header.get("return_sizes", ()))
            for i, oid in enumerate(spec.return_ids):
                on_device = bool(device_returns[i]) if i < len(device_returns) else False
                if on_device:
                    self.cluster.directory.mark_device(oid)
                if i < len(sizes) and sizes[i]:
                    self.cluster.directory.record_meta(
                        oid, sizes[i], "device" if on_device else "host"
                    )
            self.cluster.on_task_finished(owner, spec, None, None, lazy=True)
            return
        # the agent stored the returns locally before replying: mark them
        # so the owner-side cache put doesn't echo the bytes back
        for oid in spec.return_ids:
            owner.store.skip_push_once(oid)
        self.cluster.on_task_finished(owner, spec, value, None)

    def create_actor(self, spec: TaskSpec, mode: str, max_concurrency: int = 1) -> None:
        self._track(spec)
        try:
            self._send(
                "create_actor",
                {"spec": self._encode(spec), "mode": mode, "max_concurrency": max_concurrency},
            )
        except rpc.RpcError:
            self._untrack(spec.task_id.binary())
            raise

    def submit_actor_task(self, spec: TaskSpec) -> None:
        spec.owner_node = self.node_id
        self._track(spec)
        try:
            self._send("submit_actor_task", {"spec": self._encode(spec)})
        except rpc.RpcError:
            self._untrack(spec.task_id.binary())
            raise

    def submit_actor_task_batch(self, specs) -> None:
        """k queued calls in ONE control frame (atomic: the frame either
        sends whole or not at all — a ConnectionError means none reached
        the agent and the caller requeues everything)."""
        for spec in specs:
            spec.owner_node = self.node_id
            self._track(spec)
        try:
            self._send(
                "submit_actor_task_batch",
                {"specs": [self._encode(spec) for spec in specs]},
            )
        except rpc.RpcError:
            for spec in specs:
                self._untrack(spec.task_id.binary())
            raise

    def kill_actor(self, actor_id: ActorID, restart: bool = False) -> None:
        if self.dead:
            return
        try:
            self._send("kill_actor", {"actor_id": actor_id.binary()})
        except rpc.RpcError:
            pass

    def steal_task(self, task_bin: bytes) -> bool:
        return False  # inline stealing is a same-process optimization

    def kill_candidates(self):
        return []  # the agent runs its own memory monitor

    def cancel_task(self, spec: TaskSpec, force: bool = False) -> None:
        if self.dead:
            return
        try:
            self._send("cancel_task", {"task_id": spec.task_id.binary(), "force": force})
        except rpc.RpcError:
            pass

    def shutdown(self) -> None:
        self.dead = True
        try:
            self.conn.send("shutdown", {})
        except rpc.RpcError:
            pass
        self.conn.close()

    # ------------------------------------------------------------------
    # agent -> head message handling (called by HeadService)
    # ------------------------------------------------------------------
    def on_task_finished_msg(self, payload: dict) -> None:
        spans = payload.get("spans")
        if spans:
            # agent-side execute/user spans ride the completion notice; the
            # head's sink lands them in the control service's span store
            from ray_tpu_torch.observability import tracing

            tracing.record_span_events(spans)
        spec = self._untrack(payload["task_id"])
        if spec is None:
            return  # already resolved (e.g. node-death resubmission raced)
        error = None
        result = None
        if payload.get("error") is not None:
            error, _ = rpc.decode_value(payload["error"])
        elif payload.get("lazy"):
            # bulk result: bytes stayed on the agent; commit location-only
            # and let consumers pull peer-to-peer on demand.  HBM-resident
            # returns are flagged in the directory (SURVEY §5.8); sizes
            # ride the notice so locality scoring and pull admission know
            # the payload weight without the payload.
            device_returns = list(payload.get("device_returns", ()))
            sizes = list(payload.get("return_sizes", ()))
            for i, oid in enumerate(spec.return_ids):
                on_device = bool(device_returns[i]) if i < len(device_returns) else False
                if on_device:
                    self.cluster.directory.mark_device(oid)
                if i < len(sizes) and sizes[i]:
                    self.cluster.directory.record_meta(
                        oid, sizes[i], "device" if on_device else "host"
                    )
            self.cluster.on_task_finished(self, spec, None, None, lazy=True)
            return
        else:
            result, _ = rpc.decode_value(payload["value"])
            # the agent stored the returns locally before reporting: mark
            # them so the head-cache put doesn't echo the bytes back
            for oid in spec.return_ids:
                self.store.skip_push_once(oid)
        self.cluster.on_task_finished(self, spec, result, error)

    def on_stream_item_msg(self, payload: dict) -> None:
        from ray_tpu_torch.core.ids import TaskID

        spec = self._lookup(payload["task_id"])
        if spec is None:
            if payload.get("lazy"):
                # the task already resolved head-side: the agent staged the
                # bulk item for nothing — free it or it pins store memory
                # for the agent's lifetime
                oid = ObjectID.for_task_return(
                    TaskID(payload["task_id"]), payload["index"] + 1
                )
                try:
                    self._send("delete_object", {"oid": oid.binary()})
                except rpc.RpcError:
                    pass
            return
        if payload.get("lazy"):
            # bulk item stayed on the agent: location-only commit
            item_oid = ObjectID.for_task_return(
                TaskID(payload["task_id"]), payload["index"] + 1
            )
            if payload.get("device"):
                self.cluster.directory.mark_device(item_oid)
            if payload.get("size"):
                self.cluster.directory.record_meta(
                    item_oid, payload["size"],
                    "device" if payload.get("device") else "host",
                )
            committed = self.cluster.on_stream_item(
                self, spec, payload["index"], None, lazy=True
            )
            if committed is False:
                # force-closed stream dropped the commit: free the staged copy
                oid = ObjectID.for_task_return(
                    TaskID(payload["task_id"]), payload["index"] + 1
                )
                try:
                    self._send("delete_object", {"oid": oid.binary()})
                except rpc.RpcError:
                    pass
            return
        value, is_error = rpc.decode_value(payload["value"])
        self.cluster.on_stream_item(self, spec, payload["index"], value, is_error=is_error)

    def on_stream_done_msg(self, payload: dict) -> None:
        spec = self._untrack(payload["task_id"])
        if spec is None:
            return
        error = None
        if payload.get("error") is not None:
            error, _ = rpc.decode_value(payload["error"])
        self.cluster.on_stream_done(self, spec, payload["index"], error)

    def on_actor_created_msg(self, payload: dict) -> None:
        spec = self._untrack(payload["task_id"])
        if spec is not None:
            self.cluster.on_actor_created(self, spec)

    def on_actor_creation_failed_msg(self, payload: dict) -> None:
        spec = self._untrack(payload["task_id"])
        if spec is None:
            return
        error, _ = rpc.decode_value(payload["error"])
        self.cluster.on_actor_creation_failed(spec, error)

    def on_actor_died_msg(self, payload: dict) -> None:
        self.cluster.on_actor_process_died(self, ActorID(payload["actor_id"]))

    def on_resource_report(self, payload: dict) -> None:
        self.pool.reconcile(payload["total"], payload["available"])
        self.scheduler._queue_len = payload.get("queue_len", 0)
        self.scheduler._stats = payload.get("stats", {})
        self.cluster.metrics_history.add(self.node_id.hex(), payload.get("metrics"))
        if "transfers" in payload:
            self.transfer_stats = payload["transfers"]
        if "arena" in payload:
            self.arena_stats = payload["arena"]
        if "chaos_faults" in payload:
            # incremental tail of the agent's deterministic fault log
            # (failpoints.raw_log cursor), accumulated here so multihost
            # chaos runs are auditable head-side; sort by (fp, hit) to
            # recover the canonical fault_log order
            if not hasattr(self, "chaos_faults"):
                self.chaos_faults = []
            self.chaos_faults.extend(payload["chaos_faults"])
        self.last_report = time.monotonic()
        self.cluster.control.nodes.heartbeat(
            self.node_id,
            ResourceSet.from_fixed_dict(payload["available"]).to_dict(),
        )


class HeadService:
    """The head's TCP control-plane service: accepts node agents, binds each
    to a :class:`RemoteNodeHandle`, and serves the cluster-side APIs they
    need (object pulls, the internal KV for gang rendezvous).

    Role parity: the GCS server process (``gcs_server.h:78``) plus the head
    raylet's object-manager endpoints."""

    def __init__(self, cluster, host: str = "127.0.0.1", port: int = 0):
        from concurrent.futures import ThreadPoolExecutor

        from ray_tpu_torch.core.config import get_config
        from ray_tpu_torch.runtime import data_plane

        cfg = get_config()
        self.cluster = cluster
        self.server = rpc.RpcServer(
            host=host, port=port,
            handler_factory=self._handlers_for,
            on_disconnect=self._on_disconnect,
            name="head",
        )
        # Bulk endpoint for objects living in THIS process (head node + the
        # head-side caches); agents learn its address at config fetch.
        self.data_server = data_plane.DataServer(
            self._head_get_frames, self._head_put_frames, host=host,
            chunk_bytes=cfg.object_transfer_chunk_bytes,
            max_concurrent=cfg.max_concurrent_object_transfers,
            shm_store=getattr(cluster, "shm_store", None),
        )
        self.data_client = data_plane.DataClient(
            chunk_bytes=cfg.object_transfer_chunk_bytes,
            max_concurrent=cfg.max_concurrent_object_transfers,
        )
        self._transfer_pool = ThreadPoolExecutor(
            max_workers=max(1, cfg.max_concurrent_object_transfers),
            thread_name_prefix="head-transfer",
        )
        # Leased direct dispatch gets its OWN executor: a push holds its
        # thread for the task's full round trip, and a slow leased task
        # must never starve object pushes/pulls out of the transfer pool.
        self._push_pool = ThreadPoolExecutor(
            max_workers=_MAX_PUSH_INFLIGHT, thread_name_prefix="head-push-task"
        )
        # one in-flight cap for the whole pool, shared by every handle
        self._push_gate = threading.BoundedSemaphore(_MAX_PUSH_INFLIGHT)
        self._stop = threading.Event()
        # Active failure detector (GcsHealthCheckManager parity,
        # gcs_health_check_manager.h:39,97): socket death catches clean
        # exits and kill -9 on one host; PINGS catch half-open connections
        # (network partition, frozen peer) that TCP alone won't surface for
        # minutes. A node whose resource reports go stale past the failure
        # threshold gets one ping; no answer => node failure path.
        self._health_thread = threading.Thread(
            target=self._health_loop, name="head-health", daemon=True
        )
        self._health_thread.start()

    @property
    def address(self) -> str:
        return self.server.address

    def close(self) -> None:
        self._stop.set()
        self.server.close()
        self.data_server.close()
        self.data_client.close()
        self._transfer_pool.shutdown(wait=False)
        self._push_pool.shutdown(wait=False)

    # -- data-plane store resolvers ------------------------------------
    def _head_get_frames(self, oid_bytes: bytes, timeout: float):
        """Serve a pull against this process's stores: the head node's own
        store first, then the head-side caches of every node (a value staged
        for / reported by any node is a valid copy)."""
        from ray_tpu_torch.runtime import data_plane

        oid = ObjectID(oid_bytes)
        cluster = self.cluster
        candidates = [cluster.head_node] + [
            n for n in list(cluster.nodes.values()) if n is not cluster.head_node
        ]
        for node in candidates:
            store = getattr(node, "store", None)
            if store is not None and store.contains(oid):
                value = ObjectStore.get(store, oid, timeout=1.0)
                info = store.entry_info(oid)
                meta, buffers = data_plane.to_frames(value)
                return meta, buffers, bool(info and info["is_error"])
        # not local yet: a push/commit may be in flight — wait on the head
        # store (blocking is fine on a data-plane serve thread)
        value = ObjectStore.get(cluster.head_node.store, oid, timeout=timeout)
        info = cluster.head_node.store.entry_info(oid)
        meta, buffers = data_plane.to_frames(value)
        return meta, buffers, bool(info and info["is_error"])

    def _head_put_frames(self, oid_bytes: bytes, meta: bytes, buffers, is_error: bool) -> None:
        from ray_tpu_torch.runtime import data_plane

        oid = ObjectID(oid_bytes)
        self.cluster.head_node.store.put(
            oid, data_plane.from_frames(meta, buffers), is_error=is_error
        )
        self.cluster.commit_location(self.cluster.head_node, oid)

    def _health_loop(self) -> None:
        from ray_tpu_torch.core.config import get_config

        cfg = get_config()
        period = max(0.2, cfg.health_check_period_s)
        stale_after = period * max(2, cfg.health_check_failure_threshold)
        ping_timeout = max(period, cfg.health_check_ping_timeout_s)
        while not self._stop.wait(period):
            for conn in self.server.connections():
                handle = conn.peer
                if handle is None or handle.dead:
                    continue
                silent_s = time.monotonic() - handle.last_report
                if silent_s < stale_after:
                    continue
                try:
                    conn.request("ping", {}, timeout=ping_timeout)
                    handle.last_report = time.monotonic()
                except Exception:  # noqa: BLE001 — unresponsive: declare dead
                    if not handle.dead:
                        self.cluster.kill_node(
                            handle.node_id,
                            handle,
                            reason=(
                                f"health check failed: no report for {silent_s:.1f}s "
                                f"and ping timed out after {ping_timeout:.0f}s"
                            ),
                        )
                    conn.close()

    # ------------------------------------------------------------------
    # incarnation fencing (gray failures): every state-bearing
    # frame from an agent is checked against the AUTHORITATIVE incarnation
    # of its node id before it can touch cluster state.  A stale frame —
    # from a dead handle, or stamped with an older incarnation after the
    # node re-registered — is dropped, counted, audited, and answered with
    # a one-way typed ``fenced`` notice so the sender can self-fence.
    # ------------------------------------------------------------------
    def _fence_guard(self, conn: rpc.RpcConnection, payload: dict, kind: str):
        handle: Optional[RemoteNodeHandle] = conn.peer
        if handle is None:
            return None
        frame_inc = payload.pop("inc", handle.incarnation)
        current = self.cluster.control.nodes.incarnation_of(handle.node_id)
        if not handle.dead and frame_inc == current:
            return handle
        metric_defs.FENCED_FRAMES.inc(tags={"kind": kind})
        task = payload.get("task_id")
        self.cluster.record_fence_event(
            {
                "kind": kind,
                "node": handle.node_id.hex()[:8],
                "incarnation": frame_inc,
                "current": current,
                "task": task.hex() if isinstance(task, bytes) else None,
            }
        )
        try:
            conn.send("fenced", {"kind": kind, "incarnation": frame_inc})
        except rpc.RpcError:
            pass  # sender already gone; nothing to notify
        return None

    def _guarded(self, kind: str, method: str):
        def handler(conn, payload):
            handle = self._fence_guard(conn, payload, kind)
            if handle is not None:
                getattr(handle, method)(payload)

        return handler

    def _handlers_for(self, conn: rpc.RpcConnection) -> dict:
        return {
            "register_node_config": self._h_register_config,
            "register_node": self._h_register,
            "task_finished": self._guarded("task_finished", "on_task_finished_msg"),
            "stream_item": self._guarded("stream_item", "on_stream_item_msg"),
            "stream_done": self._guarded("stream_done", "on_stream_done_msg"),
            "actor_created": self._guarded("actor_lifecycle", "on_actor_created_msg"),
            "actor_creation_failed": self._guarded(
                "actor_lifecycle", "on_actor_creation_failed_msg"
            ),
            "actor_died": self._guarded("actor_lifecycle", "on_actor_died_msg"),
            "resource_report": self._guarded("resource_report", "on_resource_report"),
            "plan_broken": self._h_plan_broken,
            "pull_object": self._h_pull_object,
            "locate_object": self._h_locate_object,
            "object_location": self._h_object_location,
            "object_locations": self._h_object_locations,
            "pull_failed": self._h_pull_failed,
            "mint_put_oid": self._h_mint_put_oid,
            "release_put_oid": self._h_release_put_oid,
            "worker_api": self._h_worker_api,
            "worker_api_async": self._h_worker_api_async,
            "worker_died": self._h_worker_died,
            "kv_put": self._h_kv_put,
            "kv_get": self._h_kv_get,
            "kv_del": self._h_kv_del,
            "log_batch": self._h_log_batch,
            "ping": lambda c, p, rid=None: {},
        }

    def _h_register_config(self, conn: rpc.RpcConnection, payload: dict, rid: int) -> dict:
        import dataclasses
        import multiprocessing

        from ray_tpu_torch.core.config import get_config

        reply = {
            "config": dataclasses.asdict(get_config()),
            "protocol_version": rpc.PROTOCOL_VERSION,
            "protocol": rpc.PROTOCOL_NAME,
            # composed per-connection: the head's data endpoint at the IP
            # THIS agent reached the head on (never a bind-side 0.0.0.0)
            "data_address": f"{conn.local_ip}:{self.data_server.port}",
        }
        peer = conn.peer_ip
        if peer.startswith("127.") or peer == "::1" or peer == conn.local_ip:
            # an agent on this host only (the CUDA IPC transfer server
            # listens on loopback, so no other host could use it): the key
            # of the head's transfer server, which the agent adopts, so the
            # device rung of a pull (device_plane) authenticates between them
            reply["ipc_authkey"] = bytes(multiprocessing.current_process().authkey)
        return reply

    def _h_register(self, conn: rpc.RpcConnection, payload: dict, rid: int) -> dict:
        node_id = NodeID(payload["node_id"])
        cluster = self.cluster
        from ray_tpu_torch.runtime.control import NodeState

        with cluster._node_lifecycle_lock:
            old = cluster.nodes.get(node_id)
            info = cluster.control.nodes.get(node_id)
            # fenced only when the node id is KNOWN dead: a rejoin against a
            # RESTARTED head legitimately finds no record at all (node
            # liveness is process state, rebuilt from the living),
            # and must be re-adopted, not fenced
            known_dead = (old is not None and old.dead) or (
                info is not None and info.state is NodeState.DEAD
            )
            if payload.get("rejoin") and known_dead:
                # The death sweep already ran for this node id (health-check
                # kill during a partition): its pending work was resubmitted
                # and its objects recovered around.  Re-adopting the stale
                # incarnation would let it double-commit — refuse with a
                # typed fenced reply; the agent self-fences and joins FRESH.
                metric_defs.FENCED_FRAMES.inc(tags={"kind": "register"})
                cluster.record_fence_event(
                    {"kind": "register", "node": node_id.hex()[:8]}
                )
                return {"fenced": True}
            incarnation = cluster.control.nodes.next_incarnation(node_id)
            handle = RemoteNodeHandle(
                cluster, conn, node_id,
                resources=payload["resources"],
                labels=payload.get("labels"),
                address=payload.get("address", "?"),
                data_address=payload.get("data_address"),
                data_client=self.data_client,
                transfer_pool=self._transfer_pool,
                incarnation=incarnation,
            )
            handle.push_pool = self._push_pool
            handle.push_gate = self._push_gate
            conn.peer = handle
            cluster._register_remote_node_locked(handle)
            if old is not None and old is not handle and not old.dead:
                # Transient-disconnect rejoin that BEAT the old connection's
                # death sweep: adopt the in-flight specs the agent kept
                # running (their completions will arrive on THIS connection)
                # and fence the superseded epoch so any straggler frames on
                # the old socket are rejected.
                with old._inflight_lock:
                    migrated, old._inflight = dict(old._inflight), {}
                with handle._inflight_lock:
                    handle._inflight.update(migrated)
                old.dead = True
        if payload.get("refenced"):
            # a previously-fenced agent completed its self-fence and joined
            # as a fresh node — the partition-heal rejoin, healthy again
            metric_defs.NODE_REJOINS.inc()
        if payload.get("rejoin"):
            # Head-restart reconciliation: the agent kept its actors alive
            # across our outage — rebuild routing state for the ones the
            # control service still tracks as live (a DEAD record stays
            # dead; an unknown actor belongs to a dead driver and is left
            # orphaned for the agent to reap).
            self.cluster.reconcile_rejoined_actors(
                handle, [ActorID(b) for b in payload.get("actors", ())]
            )
        return {"incarnation": incarnation}

    def _h_locate_object(self, conn: rpc.RpcConnection, payload: dict, rid: int):
        """Address-book lookup: resolve an ObjectID to a peer's data-plane
        address so the requesting agent can pull the bytes directly —
        metadata rides the control plane, bulk bytes never do (reference:
        OwnershipBasedObjectDirectory, ownership_based_object_directory.h:37).
        Defers until SOME location exists (directory waiter), kicking lineage
        recovery if nothing will ever produce the object."""
        requester: RemoteNodeHandle = conn.peer
        oid = ObjectID(payload["oid"])
        cluster = self.cluster

        def on_located(src_node_id):
            try:
                if src_node_id is None:
                    # forgotten/lost: the relay fallback owns error surfacing
                    conn.send_reply(rid, {"addr": None})
                    return
                if requester is not None:
                    # broadcast-aware source selection: balance committed
                    # replicas (bounded children each) and, when all are
                    # saturated, chain this requester behind an IN-FLIGHT
                    # one — its data server blocks until the copy lands, so
                    # N simultaneous pulls form a tree instead of N streams
                    # out of one producer (pull_manager.assign_remote_source)
                    alt = cluster.pull_manager.assign_remote_source(
                        oid, requester.node_id
                    )
                    if alt is not None:
                        src_node_id = alt
                if requester is not None and src_node_id == requester.node_id:
                    conn.send_reply(rid, {"addr": "self"})
                    return
                src = cluster.nodes.get(src_node_id)
                if src is None or src.dead:
                    conn.send_reply(rid, {"addr": None})
                    return
                # remote nodes serve their own store; in-process nodes are
                # served by the head's data server (addressed at the IP the
                # requester reaches the head on)
                addr = getattr(src, "data_address", None)
                if not addr:
                    addr = f"{conn.local_ip}:{self.data_server.port}"
                conn.send_reply(rid, {"addr": addr})
            except Exception:  # noqa: BLE001
                import traceback

                conn.send_reply(rid, {"_exc": traceback.format_exc()})

        cluster.directory.wait_for(oid, on_located)
        if not cluster.directory.locations(oid) and not cluster._is_pending(oid):
            cluster._try_recover(oid)
        return rpc.DEFER

    def _h_object_location(self, conn: rpc.RpcConnection, payload: dict) -> None:
        """Metadata notice after a direct peer pull: the agent now holds a
        copy — record it so future consumers/recovery see this location.
        Fence-guarded: a stale incarnation committing object locations is
        the canonical split-brain write (a consumer routed to it would read
        from a store the death sweep already recovered around)."""
        handle = self._fence_guard(conn, payload, "object_location")
        if handle is None:
            return
        self.cluster.directory.commit_placement(
            ObjectID(payload["oid"]), handle.node_id,
            payload.get("size"), bool(payload.get("device")),
        )

    def _h_object_locations(self, conn: rpc.RpcConnection, payload: dict) -> None:
        """Coalesced location commits: one control frame carrying a BATCH
        of per-put notices — the head pays O(batches), not O(puts), for a
        client's put stream.  Fence-guarded like the
        single-notice path."""
        handle = self._fence_guard(conn, payload, "object_location")
        if handle is None:
            return
        for oid_bin, size, device in payload["locs"]:
            self.cluster.directory.commit_placement(
                ObjectID(oid_bin), handle.node_id, size, bool(device)
            )

    def _h_plan_broken(self, conn: rpc.RpcConnection, payload: dict) -> None:
        """An agent's stage loop could not even forward its error downstream
        (transport death mid-plan): break the plan head-side so blocked
        executes surface the typed error instead of hanging."""
        plan = self.cluster.compiled_plans.get(payload.get("plan"))
        if plan is None:
            return
        error, _ = rpc.decode_value(payload["error"])
        if not isinstance(error, BaseException):
            from ray_tpu_torch.exceptions import WorkerCrashedError

            error = WorkerCrashedError(f"plan broke on an agent: {error!r}")
        try:
            plan._break_on_transport(error)
        except Exception:  # noqa: BLE001 — notice is best-effort
            pass

    def _h_pull_failed(self, conn: rpc.RpcConnection, payload: dict) -> None:
        """An agent's direct peer pull failed: purge the stale location
        BEFORE it re-resolves (the same purge-then-retry contract the head
        PullManager applies) and drop the peer from broadcast chain
        assignment, so a wedged-but-alive replica is not re-handed to every
        subsequent consumer."""
        oid = ObjectID(payload["oid"])
        addr = payload.get("addr")
        if not addr:
            return
        for node in list(self.cluster.nodes.values()):
            if getattr(node, "data_address", None) == addr:
                self.cluster.directory.remove_location(oid, node.node_id)
                self.cluster.pull_manager.note_source_failed(oid, node.node_id)
                return

    def _h_pull_object(self, conn: rpc.RpcConnection, payload: dict, rid: int):
        """An agent needs an object for a task dependency.  Resolve through
        the owner directory (pull into the head-side cache of that node),
        then ship the bytes."""
        handle: RemoteNodeHandle = conn.peer
        oid = ObjectID(payload["oid"])

        def on_local():
            try:
                # the value landed in handle.store (the pull's destination);
                # read it WITHOUT the remote-fetch fallback — it's local now
                value = ObjectStore.get(handle.store, oid, timeout=30)
                info = handle.store.entry_info(oid)
                conn.send_reply(rid, rpc.encode_value(value, bool(info and info["is_error"])))
            except Exception:  # noqa: BLE001
                import traceback

                conn.send_reply(rid, {"_exc": traceback.format_exc()})

        # Destination = the requesting node's head-side cache. skip_push:
        # the reply itself carries the bytes; pushing would double-send.
        handle.store.skip_push_once(oid)
        self.cluster.pull_object(oid, handle, on_local)
        return rpc.DEFER

    def _h_mint_put_oid(self, conn: rpc.RpcConnection, payload: dict, rid: int) -> dict:
        """Metadata half of an agent-local nested put: mint the ObjectID,
        register ownership and pin it for the job's lifetime (the worker
        holds the ref but has no reference counter — same contract as
        worker_api._pin_refs on the relay path).  The BYTES stay on the
        agent; its object_location notice records where.  Fence-guarded:
        a fenced epoch must not mint owned oids."""
        if self._fence_guard(conn, payload, "worker_api") is None:
            return {"_exc": "fenced: stale incarnation"}
        from ray_tpu_torch.core.object_ref import ObjectRef
        from ray_tpu_torch.runtime.worker_api import _pin_refs

        cw = self.cluster.core_worker
        if cw is None:
            raise RuntimeError("no core worker attached to this cluster")
        oid = cw.mint_put_oid()
        _pin_refs(cw, ObjectRef(oid))
        return {"oid": oid.binary()}

    def _h_release_put_oid(self, conn: rpc.RpcConnection, payload: dict) -> None:
        """Agent-local put aborted after minting: drop the pin so the oid
        doesn't stay owned forever."""
        cw = self.cluster.core_worker
        if cw is None:
            return
        pins = getattr(cw, "_worker_api_pins", None)
        if pins is not None:
            from ray_tpu_torch.core.ids import ObjectID as _OID

            pins.pop(_OID(payload["oid"]), None)

    def _h_worker_died(self, conn: rpc.RpcConnection, payload: dict) -> None:
        """A worker process on an agent died: drop its ref pins (keyed the
        same way _h_worker_api pins them)."""
        from ray_tpu_torch.runtime import worker_api

        peer = getattr(conn, "peer", None)
        worker_api.release_worker_pins(
            self.cluster.core_worker,
            (getattr(peer, "node_id", None), payload.get("pid")),
        )

    def _h_worker_api_async(self, conn: rpc.RpcConnection, payload: dict) -> None:
        """Fire-and-forget worker API op relayed from an agent (async
        submits, ref releases): processed inline — cheap, never blocking —
        so the control connection's frame order carries through.
        Fence-guarded: these carry state mutations (nested submits, put
        registrations) a stale incarnation must not land."""
        from ray_tpu_torch.runtime import worker_api

        if self._fence_guard(conn, payload, "worker_api") is None:
            return
        peer = getattr(conn, "peer", None)
        worker_api.execute(
            self.cluster.core_worker, payload["blob"],
            worker_key=(getattr(peer, "node_id", None), payload.get("worker_key")),
        )

    def _h_worker_api(self, conn: rpc.RpcConnection, payload: dict, rid: int):
        """Nested API call relayed from an agent's worker.  Served OFF the
        connection's dispatch thread: a blocking nested get must not stall
        the agent's task_finished messages — the very messages that resolve
        it (deadlock otherwise).  Fence-guarded like the async twin: the
        sync path carries the same mutation class (puts, submits) a stale
        incarnation must not land — the typed error reply fails the fenced
        worker's call instead of silently hanging it."""
        if self._fence_guard(conn, payload, "worker_api") is None:
            return {"_exc": "fenced: stale incarnation"}
        from ray_tpu_torch.runtime import worker_api

        # pin accounting key: (agent node, worker pid) — unique per worker
        # process cluster-wide, so one worker's release can't drop a pin a
        # different worker on another node still needs
        peer = getattr(conn, "peer", None)
        wkey = (getattr(peer, "node_id", None), payload.get("worker_key"))

        def run():
            try:
                blob = worker_api.execute(
                    self.cluster.core_worker, payload["blob"], worker_key=wkey
                )
                conn.send_reply(rid, {"blob": blob})
            except Exception:  # noqa: BLE001
                import traceback

                conn.send_reply(rid, {"_exc": traceback.format_exc()})

        import threading

        threading.Thread(target=run, name="head-worker-api", daemon=True).start()
        return rpc.DEFER

    def _h_kv_put(self, conn, payload, rid=None):
        # fenced epochs must not mutate rendezvous/collective metadata
        if self._fence_guard(conn, payload, "kv") is None:
            return {"_exc": "fenced: stale incarnation"}
        self.cluster.control.kv.put(
            payload["key"], payload["value"], overwrite=payload.get("overwrite", True)
        )
        return {}

    def _h_kv_get(self, conn, payload, rid=None):
        return {"value": self.cluster.control.kv.get(payload["key"])}

    def _h_kv_del(self, conn, payload, rid=None):
        if self._fence_guard(conn, payload, "kv") is None:
            return {"_exc": "fenced: stale incarnation"}
        self.cluster.control.kv.delete(payload["key"])
        return {}

    def _h_log_batch(self, conn, payload) -> None:
        import sys

        lines = payload.get("lines", ())
        node = conn.peer.node_id.hex()[:8] if conn.peer else "?"
        if conn.peer is not None:
            # dashboard log viewer: per-node ring buffer on the head
            self.cluster.node_logs.append(conn.peer.node_id.hex(), lines)
        for line in lines:
            print(f"(node={node}) {line}", file=sys.stderr)

    # ------------------------------------------------------------------
    def _on_disconnect(self, conn: rpc.RpcConnection) -> None:
        handle: Optional[RemoteNodeHandle] = conn.peer
        if handle is None or handle.dead:
            return
        # Socket death IS the failure detector (the reference health-checks
        # over gRPC, gcs_health_check_manager.h:39; a dead TCP session is
        # the same signal with no polling). kill_node runs the full
        # node-failure path: resubmit pending, recover objects, restart
        # actors.  Run it on a fresh thread: _teardown can fire from a SEND
        # failure on a thread already holding fabric locks (e.g. a per-actor
        # queue lock inside _pump_actor_queue) — kill_node re-acquiring them
        # synchronously would self-deadlock.
        threading.Thread(
            target=self.cluster.kill_node, args=(handle.node_id, handle),
            kwargs={"reason": "control connection to the node closed"},
            name="head-node-death", daemon=True,
        ).start()
