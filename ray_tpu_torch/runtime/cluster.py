"""The in-process cluster fabric: nodes, object directory, transfer, recovery.

The port's copy of ``ray_tpu/runtime/cluster.py`` for one host: the in-process
nodes, directory, pulls, retries, actors and chaos hooks are the same, as
are the usage report and the dashboard head's shutdown; the multi-host head
service raises ``NotPortedError``, and a collective death notice reaches
this process and its pool workers (no agents). Bulk values
cross to worker processes through the port's native shm store.

This object stitches together what the reference spreads over processes:

  * object locations + pulls — ``OwnershipBasedObjectDirectory``
    (``src/ray/object_manager/ownership_based_object_directory.h:37``) and
    ``PullManager`` (``pull_manager.h:52``): locations are looked up on
    demand, transfers copy an object's value between node stores (standing in
    for chunked Push/Pull gRPC; on real multi-host this becomes ICI/DCN
    device-to-device transfer),
  * owner-side task completion — ``TaskManager::CompletePendingTask``
    (``task_manager.h:283``): returns are committed, waiters woken, retries
    decided here,
  * actor call routing with per-actor ordered queues
    (``direct_actor_task_submitter.h:120``) including buffering while the
    actor is PENDING/RESTARTING,
  * failure handling — node death drops its store and resubmits its pending
    tasks; lost objects rebuild via lineage
    (``object_recovery_manager.h:41``); actors restart per the control
    service FSM (``gcs_actor_manager.h:513``).
"""

from __future__ import annotations

import os
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.ids import ActorID, NodeID, ObjectID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.sync import join_threads, when_all
from ray_tpu_torch.core.task_manager import TaskManager
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    DeadlineExceededError,
    NotPortedError,
    ObjectLostError,
    RayTaskError,
    WorkerCrashedError,
)
from ray_tpu_torch.observability import metric_defs, tracing
from ray_tpu_torch.runtime.control import ActorState, ControlService, NodeInfo
from ray_tpu_torch.runtime.node import Node
from ray_tpu_torch.runtime.scheduler import ClusterScheduler, LeaseManager, TaskSpec

# prebuilt tag dict: the actor direct-route hot path must not allocate it
_ACTOR_DIRECT_TAGS = {"transport": "actor_direct"}

# prebuilt fence tags (completion paths run per task)
_FENCE_TASK_TAGS = {"kind": "task_finished"}

# prebuilt admission tags (the park path can run per task under overload)
_DEMAND_QUEUE_TAGS = {"layer": "demand_queue"}

# How long a no-location, no-lineage object gets for an in-flight metadata
# notice to land before it is tombstoned as lost.  Covers the control-vs-
# data-plane ordering gap for worker-minted put refs that return through
# owner-routed push replies; genuine losses just raise this much later.
_LOST_NOTICE_GRACE_S = 0.25


class ObjectDirectory:
    """object id -> node locations, with waiters for not-yet-created objects.

    Beside locations it records per-object SIZE and TIER (host / device /
    shm / disk) captured at commit time — the inputs the locality stage of
    :meth:`ClusterScheduler.pick_node` sums per node (reference: the object
    directory feeds LocalityAwareLeasePolicy, ``lease_policy.cc``) and the
    PullManager charges against its in-flight-byte budget."""

    def __init__(self):
        self._lock = threading.Lock()
        self._locations: Dict[ObjectID, Set[NodeID]] = {}
        self._waiters: Dict[ObjectID, List[Callable[[NodeID], None]]] = {}
        # replica-aware source selection: per-object ring pointer (the last
        # node served) over the sorted replica set, so N concurrent
        # consumers spread across copies instead of all hammering whichever
        # location hashed first.  Successor rotation (not an index cursor):
        # it keeps rotating correctly while the replica set GROWS, and it
        # is deterministic — same call sequence -> same picks, which keeps
        # seeded chaos schedules byte-reproducible.
        self._rr: Dict[ObjectID, NodeID] = {}
        # called as observer(oid, node_id) after every add_location commit
        # (outside the directory lock); the PullManager uses it to mark
        # chained broadcast destinations as completed replicas.
        self.location_observer: Optional[Callable[[ObjectID, NodeID], None]] = None
        # oids whose primary copy is DEVICE-resident (HBM) at its location —
        # SURVEY §5.8: device placement recorded in the object directory.
        # This set IS the tier record: device vs host; finer tiering (shm /
        # disk) is a per-store detail copies don't share, so storing one
        # tier per oid would lie as soon as a second copy lands elsewhere.
        self._device: Set[ObjectID] = set()
        # oid -> payload size in bytes, captured when a copy commits
        self._meta: Dict[ObjectID, int] = {}

    def mark_device(self, oid: ObjectID) -> None:
        with self._lock:
            self._device.add(oid)

    def is_device(self, oid: ObjectID) -> bool:
        with self._lock:
            return oid in self._device

    def record_meta(self, oid: ObjectID, size: int, tier: str = "host") -> None:
        """Record payload size without touching locations (used when
        metadata arrives separately from the location notice, e.g. the wire
        protocol's lazy commits).  ``tier == "device"`` also sets the
        HBM-residency flag."""
        if not size:
            return
        with self._lock:
            self._meta[oid] = int(size)
            if tier == "device":
                self._device.add(oid)

    def object_size(self, oid: ObjectID) -> int:
        with self._lock:
            return self._meta.get(oid, 0)

    def local_bytes(self, oids) -> Dict[NodeID, int]:
        """Per-node sum of known sizes of the given objects."""
        return self.locality_view(oids)[0]

    def locality_view(self, oids) -> Tuple[Dict[NodeID, int], int]:
        """One lock pass over ``oids``: (per-node local bytes, total known
        bytes) — the inputs of the scheduler's locality stage."""
        out: Dict[NodeID, int] = {}
        total = 0
        with self._lock:
            for oid in oids:
                size = self._meta.get(oid)
                if size is None:
                    continue
                total += size
                for node_id in self._locations.get(oid, ()):
                    out[node_id] = out.get(node_id, 0) + size
        return out, total

    def add_location(
        self,
        oid: ObjectID,
        node_id: NodeID,
        size: Optional[int] = None,
        tier: Optional[str] = None,
    ) -> None:
        with self._lock:
            self._locations.setdefault(oid, set()).add(node_id)
            if size:
                self._meta[oid] = int(size)
                if tier == "device":
                    self._device.add(oid)
            waiters = self._waiters.pop(oid, [])
        for cb in waiters:
            cb(node_id)
        observer = self.location_observer
        if observer is not None:
            try:
                observer(oid, node_id)
            except Exception:  # noqa: BLE001 — observers must not block commits
                pass

    def commit_placement(
        self, oid: ObjectID, node_id: NodeID, size: Optional[int], device: bool
    ) -> None:
        """The one placement-commit idiom for agent-relayed put/pull notices
        (device flag + size/tier + location, waking waiters) — every wire
        path lands here so the commit semantics can't drift."""
        if device:
            self.mark_device(oid)
        self.add_location(
            oid, node_id, size=size or None, tier="device" if device else "host"
        )

    def remove_location(self, oid: ObjectID, node_id: NodeID) -> None:
        with self._lock:
            locs = self._locations.get(oid)
            if locs:
                locs.discard(node_id)

    def locations(self, oid: ObjectID) -> Set[NodeID]:
        with self._lock:
            return set(self._locations.get(oid, ()))

    def _pick_locked(self, oid: ObjectID, exclude=()) -> Tuple[Optional[NodeID], int]:
        """(chosen location, candidate count) under self._lock — successor
        rotation over the sorted replica set so consumers spread across
        copies (the pointer strictly advances, so consecutive picks can
        never pin one replica even while the set grows)."""
        locs = self._locations.get(oid)
        if not locs:
            return None, 0
        cands = sorted((n for n in locs if n not in exclude), key=lambda n: n.binary())
        if not cands:
            cands = sorted(locs, key=lambda n: n.binary())
        last = self._rr.get(oid)
        chosen = cands[0]
        if last is not None:
            for nid in cands:
                if nid.binary() > last.binary():
                    chosen = nid
                    break
        self._rr[oid] = chosen
        return chosen, len(cands)

    def pick_location(self, oid: ObjectID, exclude=()) -> Optional[NodeID]:
        """Replica-aware source selection: balance across live replicas
        instead of handing every consumer the deterministic first location
        (the pre-broadcast behavior that hammered one copy)."""
        with self._lock:
            chosen, n = self._pick_locked(oid, exclude)
        if chosen is not None:
            metric_defs.PULL_SOURCE_SELECTED.inc(
                tags={"kind": "sole" if n == 1 else "balanced"}
            )
        return chosen

    def wait_for(self, oid: ObjectID, callback: Callable[[NodeID], None]) -> None:
        with self._lock:
            chosen, n = self._pick_locked(oid)
            if chosen is None:
                self._waiters.setdefault(oid, []).append(callback)
                return
        metric_defs.PULL_SOURCE_SELECTED.inc(
            tags={"kind": "sole" if n == 1 else "balanced"}
        )
        callback(chosen)

    def sole_replica_objects(self, node_id: NodeID) -> List[ObjectID]:
        """Objects whose ONLY known location is ``node_id`` — what a
        graceful drain must evacuate before terminating it."""
        with self._lock:
            return [
                oid for oid, locs in self._locations.items()
                if locs == {node_id}
            ]

    def drop_node(self, node_id: NodeID) -> List[ObjectID]:
        """Remove all locations on a dead node; return objects now lost."""
        lost = []
        with self._lock:
            for oid, locs in self._locations.items():
                locs.discard(node_id)
                if not locs:
                    lost.append(oid)
            for oid in lost:
                del self._locations[oid]
                self._meta.pop(oid, None)
                self._rr.pop(oid, None)
        return lost

    def forget(self, oid: ObjectID) -> None:
        with self._lock:
            self._locations.pop(oid, None)
            self._device.discard(oid)
            self._meta.pop(oid, None)
            self._rr.pop(oid, None)
            waiters = self._waiters.pop(oid, None)
        # Fire waiters with None (object out of scope) instead of dropping
        # them: a silently-dropped waiter is a leak for ready-hooks (serve
        # router in-flight counts) and a hang for pull waiters.
        for cb in waiters or ():
            try:
                cb(None)
            except Exception:
                pass


class _ActorQueue:
    """Per-actor ordered send queue (head-of-line blocking on dep pulls)."""

    __slots__ = (
        "pending", "lock", "alive", "next_seq", "prefetched_seq",
        "direct_node", "direct_submits",
    )

    def __init__(self):
        self.pending: deque = deque()   # [spec, ready: bool]
        self.lock = threading.Lock()
        self.alive = False
        self.next_seq = 0               # per-actor submission order stamp
        self.prefetched_seq = -1        # dep-prefetch cursor (pump backlog)
        # cached dispatch route (the actor's hosting node) while the actor
        # is ALIVE — the actor-shaped worker lease: dep-free calls with an
        # empty queue stamp their seq and go straight to the instance,
        # skipping the control-registry lookups and the queue pump
        # (direct_actor_task_submitter cached-address parity).  Cleared
        # (under ``lock``) BEFORE the instance dies on every failure path.
        self.direct_node = None
        self.direct_submits = 0         # calls that took the direct route


def _request_latency_snapshot() -> dict:
    """Per-deployment SLO percentiles for /api/overload — empty (never an
    error) when request tracing is off or nothing has been served."""
    try:
        from ray_tpu_torch.observability import reqtrace

        return reqtrace.global_trace_store().deployment_percentiles()
    except Exception:  # noqa: BLE001 — observability must not fail the API
        return {}


class Cluster:
    def __init__(self, session_dir: Optional[str] = None, shm_capacity: int = 0):
        cfg = get_config()
        self.session_dir = session_dir or os.path.join(
            tempfile.gettempdir(), f"ray_tpu_session_{os.getpid()}"
        )
        os.makedirs(self.session_dir, exist_ok=True)
        self.control = ControlService()
        self._snapshot_stop = threading.Event()
        self._snapshot_thread = None
        if cfg.control_snapshot_path:
            # GCS-restart parity: durable cluster state reloads from the
            # last snapshot; a background writer keeps it fresh
            self.control.restore_snapshot(cfg.control_snapshot_path)
            if self.control.restored_restarting:
                # reconciliation deadline: restored-RESTARTING actors whose
                # host never rejoins must fail their buffered calls, not
                # hang them forever
                timer = threading.Timer(
                    cfg.agent_reconnect_timeout_s + 15.0,
                    self._expire_unreconciled_actors,
                    args=(list(self.control.restored_restarting),),
                )
                timer.daemon = True
                timer.start()
            self._snapshot_thread = threading.Thread(
                target=self._snapshot_loop,
                args=(cfg.control_snapshot_path, cfg.control_snapshot_interval_s),
                name="control-snapshot",
                daemon=True,
            )
            self._snapshot_thread.start()
        self.cluster_scheduler = ClusterScheduler()
        # cached worker leases: repeat-shape tasks skip per-task pick_node
        # (grant once, push direct; see scheduler.LeaseManager)
        self.lease_manager = LeaseManager(self)
        # gray-failure defenses: owner-side deadline enforcement + hedged
        # straggler retries (runtime/watchdog.py)
        from ray_tpu_torch.runtime.watchdog import TaskWatchdog

        self.watchdog = TaskWatchdog(self)
        # fence audit log: every frame/commit rejected for carrying a stale
        # node incarnation (split-brain attempts), read by the chaos
        # invariant sweep and /api/autoscaler.  BOUNDED — the dead-node
        # completion path feeds it, and a long-lived churning cluster must
        # not grow it forever; fence_events_total keeps the true count
        self.fence_events: deque = deque(maxlen=4096)
        self.fence_events_total = 0
        # overload audit log: every admission-control shed (layer, reason,
        # task id) recorded by runtime/admission.py — chaos invariant 11
        # verifies each one carried the typed signal and that no shed task
        # ever executed.  BOUNDED like fence_events; the monotonic total
        # keeps the true count for baseline-scoped slicing.
        self.overload_events: deque = deque(maxlen=4096)
        self.overload_events_total = 0
        # gray-partitioned nodes (declared dead, still running) awaiting a
        # heal_partition — see partition_node/heal_partition chaos hooks
        self._partitioned: List[tuple] = []
        self.directory = ObjectDirectory()
        # locality stage: pick_node scores candidate nodes by the dependency
        # bytes the directory says they already hold
        self.cluster_scheduler.bind_directory(self.directory)
        # oids whose lost-marking is deferred by the metadata grace window
        # (see _try_recover) — one timer per oid, not one per caller
        self._recover_grace: Set[bytes] = set()
        self._recover_grace_lock = threading.Lock()
        # entry cap derived from the byte budget at ~10 KiB per retained
        # spec (args are ref-compressed; the estimate only needs the right
        # order of magnitude for eviction to track max_lineage_bytes)
        self.task_manager = TaskManager(
            max_lineage_entries=max(1024, get_config().max_lineage_bytes // (10 * 1024))
        )
        # all inbound object traffic funnels through one admission-controlled
        # PullManager (pull_manager.h:52 parity); created lazily-free here —
        # its worker threads spawn on first use
        from ray_tpu_torch.runtime.pull_manager import PullManager

        self.pull_manager = PullManager(self)
        # broadcast bookkeeping: the planner marks chained destinations as
        # completed replicas the moment their copy commits a location
        self.directory.location_observer = self.pull_manager.on_location_committed
        self.nodes: Dict[NodeID, Node] = {}
        self.head_node: Optional[Node] = None
        self._actor_queues: Dict[ActorID, _ActorQueue] = {}
        self._actor_lock = threading.RLock()
        self._streams: Dict[bytes, Any] = {}  # task_id -> ObjectRefGenerator
        self._stream_lock = threading.Lock()  # serializes item commits vs force-close
        self._actor_specs: Dict[ActorID, TaskSpec] = {}      # creation specs
        self._actor_options: Dict[ActorID, dict] = {}
        # actors whose CREATION was shed by admission control: calls to
        # them surface this typed OverloadedError (with retry_after_s), not
        # a generic ActorDiedError — the caller can actually retry later.
        # BOUNDED like the other overload structures: sustained overload
        # must not grow head memory O(total sheds); evicted entries fall
        # back to the generic dead-actor error.
        from collections import OrderedDict as _OrderedDict

        self._actor_shed_errors: "_OrderedDict[ActorID, BaseException]" = _OrderedDict()
        # installed compiled execution plans (dag/plan.py): plan_id -> plan.
        # The node/actor death sweeps flip affected plans to BROKEN through
        # this registry; /api/plans and `rt plans` snapshot it.
        self.compiled_plans: Dict[str, Any] = {}
        # plan state transitions (plan_id, from, to) appended by every plan
        # lifecycle change — the chaos sweep audits the READY→BROKEN→READY
        # machine from this log even after a plan is torn down/released
        self.plan_transitions: List[tuple] = []
        # drain reports (drain_node): evacuation counts + outcome, audited
        # by the chaos elasticity invariants (nothing with a surviving
        # replica may be lost by a drain)
        self.drain_reports: List[dict] = []
        # live TrainController gang jobs (train/controller.py): name ->
        # controller.  The chaos `preempt_gang_member` kind and /api/train
        # find their targets here.
        self.train_controllers: Dict[str, Any] = {}
        # one audit row per gang repair/shrink recovery: checkpoint path,
        # resume step, world size, and the accumulating post-repair loss
        # bytes — invariant 12 replays these from the checkpoint and
        # byte-compares the trajectories
        self.train_repair_audits: List[dict] = []
        # live ServeControllerActor callables (serve/controller.py): id ->
        # controller.  The chaos `kill_decode_replica` kind finds its
        # targets here (mirrors train_controllers above).
        self.serve_controllers: Dict[str, Any] = {}
        # one audit row per KV-block migration lifecycle event ("staged" /
        # "released", serve/disagg.py) — chaos invariant 13 asserts every
        # staged block set reaches exactly one terminal outcome
        self.kv_migration_audits: List[dict] = []
        # head failover simulation state (kill_head/restart_head chaos
        # hooks); the lock makes the _head_down check and a snapshot write
        # atomic — the periodic writer must never clobber the kill-time
        # snapshot with doomed-incarnation state
        self._head_down = False
        self._head_lock = threading.Lock()
        self.head_restarts = 0
        self.core_worker = None       # set by worker.init
        # the native shared-memory arena that bulk values cross to worker
        # processes through (shm_capacity: 0 = 2 GiB, < 0 = none); without
        # a compiler the store is absent and they ride the socket
        self.shm_store = None
        if shm_capacity >= 0:
            try:
                from ray_tpu_torch.native.shm_store import SEGMENT_PREFIX, ShmObjectStore

                self.shm_store = ShmObjectStore(
                    f"{SEGMENT_PREFIX}{os.getpid()}_{id(self) & 0xffff:x}",
                    shm_capacity or (2 << 30),
                )
            except Exception:
                self.shm_store = None
        self.transfer_bytes = 0
        self.transfer_count = 0
        # serializes node (re)registration against node-death sweeps: a
        # rejoin landing mid-kill must not have its fresh state clobbered
        self._node_lifecycle_lock = threading.RLock()
        # dashboard reporter stores (per-node utilization time series +
        # worker log tails; reference: dashboard/modules/reporter/ + log)
        from ray_tpu_torch.dashboard.reporter import MetricsHistory, NodeLogStore

        self.metrics_history = MetricsHistory()
        self.node_logs = NodeLogStore()
        # pending resource demand, read by the autoscaler (parity with the
        # load the GCS reports to the monitor process,
        # python/ray/autoscaler/_private/monitor.py): spec id -> resource dict.
        self._infeasible_demands: Dict[int, Dict[str, float]] = {}
        self._resource_requests: List[Dict[str, float]] = []
        self._demand_lock = threading.Lock()
        # ONE demand queue + ONE drainer thread for all currently-infeasible
        # work (tasks and actor creations).  The reference keeps these in
        # scheduler queues drained on resource events
        # (cluster_task_manager.h:42 infeasible_tasks_); a thread per parked
        # task would turn a 10k-task burst into 10k threads.
        self._demand_cv = threading.Condition()
        self._demand_entries: List[list] = []   # [spec, kind, deadline]
        self._demand_thread: Optional[threading.Thread] = None
        self._demand_stop = False
        # first-park deadlines by spec identity: a re-park (placement race,
        # acquire failure) must NOT reset the clock, or work that never
        # becomes feasible loops forever instead of timing out
        self._park_deadlines: Dict[int, float] = {}
        # host-memory OOM guard (memory_monitor.h parity); one monitor for
        # the in-process fabric, candidates aggregated over all nodes.
        self.memory_monitor = None
        if cfg.memory_monitor_refresh_ms > 0:
            from ray_tpu_torch.runtime.memory_monitor import MemoryMonitor

            def _candidates():
                out = []
                for node in list(self.nodes.values()):
                    if not node.dead:
                        out.extend(node.kill_candidates())
                return out

            self.memory_monitor = MemoryMonitor(
                _candidates,
                usage_threshold=cfg.memory_usage_threshold,
                poll_interval_s=cfg.memory_monitor_refresh_ms / 1000.0,
            ).start()

    # ------------------------------------------------------------------
    # topology
    # ------------------------------------------------------------------
    def add_node(self, resources: Dict[str, float], labels: Optional[dict] = None) -> Node:
        node_id = NodeID.from_random()
        node = Node(node_id, resources, self, shm_store=self.shm_store, labels=labels)
        if self.core_worker is not None:
            # dead refs free (not spill) under memory pressure — same hook
            # CoreWorker wires onto init-time stores
            node.store.pressure_callback = self.core_worker.ref_counter.drain_deferred
        self.nodes[node_id] = node
        self.cluster_scheduler.register_node(node_id, node.pool, labels, queue_len=node.scheduler.queue_len)
        self.control.nodes.register(NodeInfo(node_id, f"inproc://{node_id.hex()[:8]}", resources, labels))
        if self.head_node is None:
            self.head_node = node
        # placement groups act on the live node pools
        self.control.placement_groups.bind_node_pools(
            {nid: n.pool for nid, n in self.nodes.items() if not n.dead}
        )
        self.control.placement_groups.retry_pending()
        self.notify_resources_changed()
        return node

    def start_head_service(self, host: str = "127.0.0.1", port: int = 0) -> str:
        """The JAX package opens its TCP control plane here for node agents
        on other machines to join; the port runs one node and raises."""
        raise NotPortedError(
            "the multi-host head service", "ray_tpu/runtime/cluster.py:522-543, remote_node.py"
        )

    def register_remote_node(self, handle) -> None:
        """A node agent registered over the transport: wire its proxy into
        the scheduler, control service and placement machinery exactly like
        an in-process node (add_node parity)."""
        with self._node_lifecycle_lock:
            self._register_remote_node_locked(handle)

    def _register_remote_node_locked(self, handle) -> None:
        self.nodes[handle.node_id] = handle
        self.cluster_scheduler.register_node(
            handle.node_id, handle.pool, handle.labels, queue_len=handle.scheduler.queue_len
        )
        self.control.nodes.register(
            NodeInfo(handle.node_id, f"tcp://{handle.address}", handle.pool.total.to_dict(), handle.labels)
        )
        self.control.placement_groups.bind_node_pools(
            {nid: n.pool for nid, n in self.nodes.items() if not n.dead}
        )
        self.control.placement_groups.retry_pending()
        self.notify_resources_changed()

    def _expire_unreconciled_actors(self, actor_ids: List[ActorID]) -> None:
        for actor_id in actor_ids:
            info = self.control.actors.get(actor_id)
            if info is None or info.state is not ActorState.RESTARTING or info.node_id is not None:
                continue  # reconciled (or restarting live elsewhere)
            self.control.actors.mark_dead(
                actor_id, "hosting node never rejoined after head restart"
            )
            self._fail_actor_queue(
                actor_id,
                ActorDiedError(actor_id, "The actor's node never rejoined the restarted head"),
            )

    def reconcile_rejoined_actors(self, handle, actor_ids: List[ActorID]) -> None:
        """An agent rejoined (head restart or transient disconnect) still
        hosting live actor instances: rebuild the head-side routing state —
        actor FSM back to ALIVE on that node, per-actor call queue pumping —
        for every actor the control service still tracks as non-DEAD.
        Reference role: raylets re-registering with a restarted GCS
        (core_worker.proto:443 RayletNotifyGCSRestart)."""
        for actor_id in actor_ids:
            info = self.control.actors.get(actor_id)
            if info is None or info.state is ActorState.DEAD:
                continue
            with self._actor_lock:
                q = self._actor_queues.get(actor_id)
                if q is None:
                    q = self._actor_queues[actor_id] = _ActorQueue()
            self.control.actors.mark_alive(actor_id, handle.node_id)
            with q.lock:
                q.alive = True
                q.direct_node = handle
            self._pump_actor_queue(actor_id)

    # ------------------------------------------------------------------
    # head failover (GCS restart parity, gcs_redis_failure_detector.h:28)
    # ------------------------------------------------------------------
    def _head_snapshot_path(self) -> str:
        cfg = get_config()
        return cfg.control_snapshot_path or os.path.join(
            self.session_dir, "control.snap"
        )

    def kill_head(self) -> str:
        """Chaos hook: simulate the head's control-service process dying.

        Durable control state — KV, jobs, actor records, task events, spans,
        and the failpoint hit counters (so same-seed fault logs stay
        byte-identical through the restart) — snapshots to disk exactly as
        the periodic writer would have.  The control service is then marked
        down: mutations landing between kill and restart go to the doomed
        incarnation and are DISCARDED at restart, which is precisely what
        writes to a dying GCS lose.  Data-plane state (object stores,
        in-flight tasks, live actor instances) is owned by workers/nodes
        and survives, per the ownership invariant (SURVEY §1)."""
        path = self._head_snapshot_path()
        with self._head_lock:
            if self._head_down:
                raise RuntimeError("kill_head while the head is already down")
            self.control.save_snapshot(path)
            self._head_down = True
        try:
            from ray_tpu_torch.observability.events import global_event_manager

            global_event_manager().warning("CLUSTER", "head_killed", "head control service down")
        except Exception:  # noqa: BLE001
            pass
        return path

    def restart_head(self) -> dict:
        """Chaos hook: bring a fresh control service up from the last
        snapshot.  Durable state reloads; live nodes re-adopt (raylet
        re-registration against a restarted GCS); live actor instances
        reconcile back to ALIVE; actors whose host died during the outage
        follow the restart FSM (restart elsewhere or DEAD)."""
        # rt-lint: disable=lock-discipline -- usage-error gate only: chaos
        # hooks are driver-driven, and a racing kill_head still serializes
        # on _node_lifecycle_lock below before any state is touched
        if not self._head_down:
            raise RuntimeError("restart_head called without a preceding kill_head")
        path = self._head_snapshot_path()
        old = self.control
        fresh = ControlService()
        fresh.restore_snapshot(path)
        # incarnations minted after the kill-time snapshot must not be
        # re-minted by the fresh table (merge keeps the max per node id)
        fresh.nodes.restore_incarnations(old.nodes.incarnation_snapshot())
        with self._node_lifecycle_lock:
            # live nodes re-register with the fresh service (liveness is
            # process state, rebuilt from the living — never snapshotted)
            for nid, node in self.nodes.items():
                if node.dead:
                    continue
                address = (
                    f"tcp://{node.address}" if hasattr(node, "conn")
                    else f"inproc://{nid.hex()[:8]}"
                )
                info = NodeInfo(
                    nid, address, node.pool.total.to_dict(),
                    getattr(node, "labels", None),
                )
                fresh.nodes.register(info)
                if self.cluster_scheduler.is_draining(nid):
                    fresh.nodes.drain(nid)
            # live placement groups re-adopt like live actors do: their
            # bundles still hold resources in surviving node pools (data
            # plane), and the old in-process registry is the durable record
            # a restarted GCS would reload them from — dropping them would
            # leak the acquired bundle capacity forever
            with old.placement_groups._lock:
                live_groups = dict(old.placement_groups._groups)
            with fresh.placement_groups._lock:
                fresh.placement_groups._groups.update(live_groups)
            fresh.placement_groups.bind_node_pools(
                {nid: n.pool for nid, n in self.nodes.items() if not n.dead}
            )
            # rt-lint: disable=lock-discipline -- atomic-rebind publication:
            # `control` is swapped exactly here (under the lifecycle lock so
            # restarts serialize); the many unlocked readers see either the
            # old or the new epoch, and both are valid service objects
            self.control = fresh
            with self._head_lock:
                self._head_down = False
        old.shutdown()
        # the driver demonstrably survived the head restart (in-process
        # fabric): its job is still RUNNING, not the FAILED a restore
        # infers for jobs whose driver died with the old head
        if self.core_worker is not None:
            job = fresh.jobs.get(self.core_worker.job_id)
            if job is not None:
                job.status = "RUNNING"
        # reconcile live actor instances (RayletNotifyGCSRestart parity):
        # restored records come back RESTARTING; instances still alive on
        # live nodes flip ALIVE and their queues pump, the rest follow the
        # restart FSM (restart elsewhere if the budget allows, else DEAD)
        reconciled = refailed = 0
        for actor_id, spec in list(self._actor_specs.items()):
            info = fresh.actors.get(actor_id)
            if info is None or info.state is ActorState.DEAD:
                continue
            node = self.nodes.get(spec.owner_node)
            live = False
            if node is not None and not node.dead:
                insts = getattr(node, "actors", None)
                if insts is None:
                    # remote agent: its instances survived with it (deaths
                    # during the outage re-report through the live channel)
                    live = True
                else:
                    inst = insts.get(actor_id)
                    live = inst is not None and not inst.dead
            if live:
                self.reconcile_rejoined_actors(node, [actor_id])
                reconciled += 1
            else:
                refailed += 1
                self._handle_actor_failure(
                    actor_id, "hosting node died during head outage"
                )
        fresh.restored_restarting.clear()
        self.head_restarts += 1
        metric_defs.HEAD_RESTARTS.inc()
        try:
            from ray_tpu_torch.observability.events import global_event_manager

            global_event_manager().warning(
                "CLUSTER", "head_restarted",
                f"head restored from {path}: {reconciled} actors reconciled",
            )
        except Exception:  # noqa: BLE001
            pass
        return {"snapshot": path, "reconciled": reconciled, "refailed": refailed}

    def kill_node(self, node_id: NodeID, expected=None, reason: str = "") -> None:
        """Chaos hook: simulate node failure (NodeKillerActor parity,
        python/ray/_private/test_utils.py:1497).  ``expected`` guards the
        async disconnect path: if the agent already REJOINED (same node_id,
        fresh handle) by the time this runs, the stale death must not kill
        the new registration.  The lifecycle lock makes guard+teardown
        atomic against a concurrent re-registration.  ``reason`` lands on
        the handle and in the event log — "node died" without why is
        undebuggable after the fact."""
        with self._node_lifecycle_lock:
            node = self.nodes.get(node_id)
            if node is None or node.dead:
                return
            if expected is not None and node is not expected:
                return
            self._kill_node_locked(node_id, node, reason=reason)

    # ------------------------------------------------------------------
    # gray partitions (chaos hooks: a node declared dead while its runtime
    # is still ALIVE — the split-brain scenario incarnation fencing exists
    # for; see docs/fault_tolerance.md "Fault model")
    # ------------------------------------------------------------------
    def partition_node(self, node_id: NodeID) -> None:
        """Declare the node dead — full death sweep: leases revoked,
        pending tasks resubmitted, objects recovered — WITHOUT shutting its
        runtime down.  Its workers keep executing and keep trying to commit
        results; every such commit must now be rejected as fenced."""
        with self._node_lifecycle_lock:
            node = self.nodes.get(node_id)
            if node is None or node.dead:
                return
            self._kill_node_locked(
                node_id, node, reason="gray partition (declared dead, still running)",
                shutdown=False,
            )
            self._partitioned.append((node_id, node))

    def heal_partition(self):
        """The partition healed: the stale incarnation learns it is fenced,
        self-fences (workers killed, store dropped, lease pins cleared with
        the pool), and a FRESH node joins through the add_node elasticity
        path — it can never double-commit what the death sweep already
        resubmitted.  Returns the fresh node, or None if nothing was
        partitioned."""
        with self._node_lifecycle_lock:
            if not self._partitioned:
                return None
            node_id, node = self._partitioned.pop(0)
        resources = node.pool.total.to_dict()
        labels = dict(getattr(node, "labels", None) or {}) or None
        node.shutdown()  # the self-fence: actors + workers die, pins clear
        metric_defs.NODE_REJOINS.inc()
        return self.add_node(resources, labels=labels)

    # ------------------------------------------------------------------
    # graceful drain (DrainRaylet parity, node_manager.proto)
    # ------------------------------------------------------------------
    def drain_node(self, node_id: NodeID, timeout_s: Optional[float] = None) -> dict:
        """Gracefully remove a node instead of hard-killing it:

        1. flip it to DRAINING — the scheduler stops placing tasks/actors
           there (including parked demand-queue entries re-resolving),
        2. evacuate sole-replica objects to survivors through the
           PullManager (directory commits make them replicas BEFORE the
           node goes away),
        3. push hosted actors through the restart FSM so restartable ones
           come back on survivors (buffered/in-flight calls follow the
           normal ``max_task_retries`` semantics),
        4. wait (bounded by ``drain_node_timeout_s``) for the node's
           in-flight tasks to finish, then terminate through the normal
           death sweep — which now finds a surviving replica for every
           evacuated object, so nothing with somewhere to go is lost.

        Returns the drain report (also appended to ``self.drain_reports``
        for the chaos elasticity invariants and ``/api/autoscaler``)."""
        cfg = get_config()
        if timeout_s is None:
            timeout_s = cfg.drain_node_timeout_s
        report = {
            "node": node_id.hex()[:8], "outcome": "ok",
            "evacuated": 0, "evacuated_bytes": 0,
            "failed_evacuations": 0, "actors_restarted": 0,
        }
        with self._node_lifecycle_lock:
            node = self.nodes.get(node_id)
            if node is None or node.dead:
                report["outcome"] = "noop"
                metric_defs.NODE_DRAINS.inc(tags={"outcome": "noop"})
                self.drain_reports.append(report)
                return report
            if node is self.head_node:
                raise ValueError("cannot drain the head node")
            # DRAINING before anything moves: evacuation pulls, actor
            # restarts, and task resubmits must never land back here
            self.cluster_scheduler.set_draining(node_id)
            # return this node's worker leases NOW: new grants already
            # exclude a draining node (pick_node), and revocation frees its
            # pinned workers so the drain never waits on an idle-but-leased
            # worker (ISSUE 7 satellite)
            self.lease_manager.revoke_node(node_id)
            self.control.nodes.drain(node_id)
        try:
            from ray_tpu_torch.observability.events import global_event_manager

            global_event_manager().info(
                "NODE", "node_draining", f"node {node_id.hex()[:8]} draining"
            )
        except Exception:  # noqa: BLE001 — diagnostics must not block the drain
            pass
        deadline = time.monotonic() + timeout_s

        # -- 2. evacuate sole-replica objects --------------------------
        sole = self.directory.sole_replica_objects(node_id)
        evacuated_bytes = 0
        if sole:
            pending = threading.Semaphore(0)

            def one_done():
                pending.release()

            started = 0
            for oid in sole:
                dest = self._pick_evacuation_dest(node_id, started)
                if dest is None:
                    break  # no survivor can take copies: nothing to do
                self.pull_manager.pull(oid, dest, one_done)
                started += 1
            done = 0
            for _ in range(started):
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not pending.acquire(timeout=max(0.01, remaining)):
                    break
                done += 1
            report["evacuated"] = done
            report["failed_evacuations"] = len(sole) - done
            if report["failed_evacuations"]:
                report["outcome"] = "timeout"
            for oid in sole:
                if len(self.directory.locations(oid)) > 1:
                    evacuated_bytes += self.directory.object_size(oid)
            report["evacuated_bytes"] = evacuated_bytes
            if evacuated_bytes:
                metric_defs.DRAIN_EVACUATED_BYTES.inc(evacuated_bytes)

        # -- 3. restart hosted actors elsewhere ------------------------
        for info in self.control.actors.list_actors():
            if info.node_id == node_id and info.state in (
                ActorState.ALIVE, ActorState.PENDING_CREATION
            ):
                report["actors_restarted"] += 1
                self._handle_actor_failure(
                    info.actor_id, f"node {node_id.hex()[:8]} draining"
                )

        # -- 4. wait for in-flight work, then terminate ----------------
        def _quiesced() -> bool:
            return not any(
                s.owner_node == node_id for s in self.task_manager.pending_specs()
            )

        while time.monotonic() < deadline and not _quiesced():
            time.sleep(0.01)
        if not _quiesced():
            # only a genuinely un-quiesced node is a timeout — a deadline
            # fully spent on (successful) evacuation is not
            report["outcome"] = "timeout"
        # the death sweep resubmits stragglers and drops the store —
        # every evacuated object now has a surviving replica to serve it
        self.kill_node(node_id, reason="drained")
        metric_defs.NODE_DRAINS.inc(tags={"outcome": report["outcome"]})
        self.drain_reports.append(report)
        # the drain report lands in the structured event ring too: a
        # timeout outcome is a WARNING (work may have been resubmitted)
        try:
            from ray_tpu_torch.observability import reqtrace

            reqtrace.flight_record(
                "node_drain_report",
                f"drain of node {report['node']} finished: {report['outcome']}",
                severity="WARNING" if report["outcome"] == "timeout" else "INFO",
                state=report,
            )
        except Exception:  # noqa: BLE001 — reporting must never fail a drain
            pass
        return report

    def _pick_evacuation_dest(self, draining: NodeID, seq: int):
        """Round-robin over alive, non-draining nodes (deterministic order:
        sorted node ids) so a drain spreads its bytes instead of dumping
        them all on one survivor."""
        survivors = sorted(
            (
                node for nid, node in list(self.nodes.items())
                if not node.dead
                and nid != draining
                and not self.cluster_scheduler.is_draining(nid)
            ),
            key=lambda n: n.node_id.binary(),
        )
        if not survivors:
            return None
        return survivors[seq % len(survivors)]

    def _kill_node_locked(
        self, node_id: NodeID, node, reason: str = "", shutdown: bool = True
    ) -> None:
        """``shutdown=False`` (gray partition): run the FULL death sweep but
        leave the node's runtime alive — exactly what a real partition looks
        like from the head's side."""
        node.dead = True
        node.death_reason = reason or "killed"
        try:
            from ray_tpu_torch.observability.events import global_event_manager

            global_event_manager().warning(
                "NODE", "node_died",
                f"node {node_id.hex()[:8]} died: {node.death_reason}",
            )
        except Exception:  # noqa: BLE001 — diagnostics must not block teardown
            pass
        self.cluster_scheduler.remove_node(node_id)
        # worker leases routed here are void: revoke BEFORE resubmitting
        # pending tasks so their retries re-grant on survivors
        self.lease_manager.revoke_node(node_id)
        self.control.nodes.mark_dead(node_id)
        self.control.placement_groups.on_node_dead(node_id)
        # objects whose only copy was there are lost
        lost = self.directory.drop_node(node_id)
        # broadcast plans: a relay node dying mid-broadcast re-parents its
        # parked subtree onto surviving replicas (purge-then-retry path)
        self.pull_manager.on_node_dead(node_id)
        # compiled execution plans with stages on this node flip to BROKEN
        # (typed error on their output channels, blocked executes unblock)
        for plan in list(self.compiled_plans.values()):
            try:
                plan.on_node_dead(node_id)
            except Exception:  # noqa: BLE001 — one plan must not block the sweep
                pass
        # resubmit this node's pending tasks (system failure → consumes retry)
        for spec in self.task_manager.pending_specs():
            if spec.owner_node == node_id and spec.actor_id is None:
                # streaming tasks never resubmit: already-yielded items
                # can't be un-delivered, so a replay would duplicate them
                if spec.num_returns != "streaming" and self.task_manager.should_retry(
                    spec, is_system_error=True
                ):
                    self._emit_retry_span(spec)
                    self.submit(spec)
                else:
                    self.task_manager.mark_failed(spec)
                    self._commit_error_everywhere(spec, WorkerCrashedError(f"node {node_id.hex()[:8]} died"))
        # recover lost objects that someone may still want
        for oid in lost:
            self._try_recover(oid)
        # dashboard stores: a dead node must not linger in the UI
        self.metrics_history.drop_node(node_id.hex())
        # open collective waits involving ranks on this node fail NOW, not
        # at the rendezvous timeout (direct_actor_task_submitter.h:120: the
        # reference fails pending calls atomically with the death notice)
        self._fail_collective_groups_for_node(node_id)
        # actors hosted there follow the restart FSM
        for info in self.control.actors.list_actors():
            if info.node_id == node_id and info.state in (ActorState.ALIVE, ActorState.PENDING_CREATION):
                self._handle_actor_failure(info.actor_id, f"node {node_id.hex()[:8]} died")
        # IN-FLIGHT actor calls (already popped from the per-actor queue and
        # pushed to the node) are invisible to _fail_actor_queue — without
        # this sweep their callers hang forever.  Runs AFTER the FSM updates
        # above so _maybe_retry_actor_task sees the post-death actor state
        # (reference: direct_actor_task_submitter.h:120 fails pending calls
        # atomically with the death notice).
        for spec in self.task_manager.pending_specs():
            if spec.owner_node == node_id and spec.actor_id is not None:
                if self._spec_is_queued(spec):
                    # owner_node is stale: the call was requeued (earlier
                    # retry) and sits in the per-actor queue, not in flight
                    # on this node — the queue machinery owns it.
                    continue
                if self._maybe_retry_actor_task(spec):
                    continue
                self.task_manager.mark_failed(spec)
                self._commit_error_everywhere(
                    spec, ActorDiedError(spec.actor_id, f"node {node_id.hex()[:8]} died")
                )
                self._after_commit(spec)
        if shutdown:
            node.shutdown()

    def _spec_is_queued(self, spec: TaskSpec) -> bool:
        q = self._actor_queues.get(spec.actor_id)
        if q is None:
            return False
        with q.lock:
            return any(e[0] is spec for e in q.pending)

    # ------------------------------------------------------------------
    # task submission (cluster-level)
    # ------------------------------------------------------------------
    def submit(self, spec: TaskSpec) -> None:
        # Lease fast path (direct dispatch): dependency-free, strategy-free
        # repeat-shape tasks ride a cached worker lease straight to their
        # node — the head's per-task scheduling hop (pick_node + placement
        # metric) runs only at lease churn, not per task.  Dep-bearing
        # tasks keep the locality stage; strategies keep their policies;
        # streaming keeps its registration ordering; retries re-enter here
        # and reuse (or re-grant) the lease like any other submission.
        if (
            spec.actor_id is None
            and not spec.dependencies
            and spec.scheduling_strategy is None
            and not spec.runtime_env
            and spec.num_returns != "streaming"
        ):
            node = self.lease_manager.route(spec)
            if node is not None:
                try:
                    node.submit_leased(spec)
                    return
                except ConnectionError:
                    # the leased node died under us: revoke and fall back
                    # to the scheduled path (which re-routes or parks)
                    self.lease_manager.revoke_node(node.node_id)
        self._submit_scheduled(spec)

    def _submit_scheduled(self, spec: TaskSpec) -> None:
        t0 = time.perf_counter()
        node_id = self.cluster_scheduler.pick_node(spec)
        metric_defs.SCHEDULER_PLACEMENT_LATENCY.observe(time.perf_counter() - t0)
        if node_id is None:
            # infeasible now: park until resources free up / nodes join.
            self._park_infeasible(spec)
            return
        try:
            self.nodes[node_id].submit(spec)
        except ConnectionError:
            # remote node died between pick and dispatch: its disconnect
            # handler will run kill_node; this task just re-routes
            self._park_infeasible(spec)

    def _park_infeasible(self, spec: TaskSpec, kind: str = "task") -> None:
        """Queue currently-unschedulable work on the shared demand queue.

        Zero threads per entry: one drainer (started lazily, parked while
        the queue is empty) retries placement on resource events / a short
        tick and fails entries past their deadline.

        The queue is BOUNDED (``demand_queue_max_entries``): offered load
        past the bound sheds with a typed OverloadedError instead of
        growing the parked set until the head OOMs.  A RE-park of an
        already-parked entry (placement race) is exempt — it held a slot
        moments ago; shedding it would turn a transient race into a loss."""
        cfg = get_config()
        bound = cfg.demand_queue_max_entries
        timeout = cfg.infeasible_task_timeout_s if kind == "task" else 30.0
        spec._stage = "parked"
        # demand registered BEFORE the entry appends (original ordering):
        # the drainer pops it on placement, so adding it after could leak a
        # phantom record the autoscaler keeps seeing; the shed path pops it
        # right back
        with self._demand_lock:
            self._infeasible_demands[id(spec)] = spec.resources.to_dict()
        with self._demand_cv:
            # bound check and append share ONE critical section — a
            # check-then-act split would let concurrent parks overshoot the
            # bound by the number of racing submitters
            depth = len(self._demand_entries)
            repark = id(spec) in self._park_deadlines
            if bound > 0 and depth >= bound and not repark:
                shed_depth = depth
            else:
                shed_depth = None
                deadline = self._park_deadlines.get(id(spec))
                if deadline is None:
                    deadline = time.monotonic() + timeout
                    self._park_deadlines[id(spec)] = deadline
                self._demand_entries.append([spec, kind, deadline])
                depth = len(self._demand_entries)
                if self._demand_thread is None or not self._demand_thread.is_alive():
                    self._demand_thread = threading.Thread(
                        target=self._demand_drain_loop, name="demand-drain", daemon=True
                    )
                    self._demand_thread.start()
                self._demand_cv.notify_all()
        if shed_depth is not None:
            with self._demand_lock:
                self._infeasible_demands.pop(id(spec), None)
            self._shed_parked(spec, kind, shed_depth)
            return
        metric_defs.ADMISSION_QUEUE_DEPTH.set(depth, _DEMAND_QUEUE_TAGS)

    def _shed_parked(self, spec: TaskSpec, kind: str, depth: int) -> None:
        """Terminal-commit a typed OverloadedError for work the bounded
        demand queue refused.  Claim-based for tasks so a racing completion
        or deadline fire loses atomically (terminal exactly once)."""
        from ray_tpu_torch.runtime import admission

        error = admission.shed(
            "demand_queue",
            "queue_full",
            task_id=spec.task_id.hex(),
            message=(
                f"demand queue at its {depth}-entry bound "
                f"(demand_queue_max_entries); task {spec.name!r} shed"
            ),
        )
        if kind == "task":
            if not self.task_manager.claim(spec):
                return  # something else already terminated it
            self.task_manager.mark_failed(spec)
            self._commit_error_everywhere(spec, error)
            self._after_commit(spec)
        else:
            # the TYPED error travels to the waiting callers (a shed is an
            # overload signal with retry_after_s, not an actor death), and
            # is remembered so LATER calls to the never-created actor get
            # the same typed signal instead of a generic ActorDiedError
            self._actor_shed_errors[spec.actor_id] = error
            while len(self._actor_shed_errors) > 4096:
                self._actor_shed_errors.popitem(last=False)
            self.on_actor_creation_failed(spec, error)

    def notify_resources_changed(self) -> None:
        """Wake the demand drainer (node join, capacity growth)."""
        with self._demand_cv:
            self._demand_cv.notify_all()

    def _demand_drain_loop(self) -> None:
        # rt-lint: disable=lock-discipline -- double-checked loop gate: the
        # unlocked read only decides to try again; the authoritative stop
        # check re-runs under _demand_cv two lines down
        while not self._demand_stop:
            with self._demand_cv:
                while not self._demand_entries and not self._demand_stop:
                    self._demand_cv.wait()   # park: empty queue costs nothing
                if self._demand_stop:
                    return
                entries = list(self._demand_entries)
            now = time.monotonic()
            placed_or_failed = []
            for entry in entries:
                spec, kind, deadline = entry
                node_id = self.cluster_scheduler.pick_node(spec)
                if node_id is not None:
                    # deregister demand BEFORE submit: dispatch can block
                    # (worker spawn) and the autoscaler must not see both the
                    # demand and its already-acquired resources.
                    with self._demand_lock:
                        self._infeasible_demands.pop(id(spec), None)
                    placed_or_failed.append(entry)
                    try:
                        if kind == "task":
                            self.nodes[node_id].submit(spec)
                            # Deadline cleared only AFTER submit succeeds: a
                            # dispatch-race re-park must keep the ORIGINAL
                            # infeasibility clock (same invariant as the
                            # actor kind) so a flapping node can't keep a
                            # never-feasible task parked forever.
                            with self._demand_cv:
                                self._park_deadlines.pop(id(spec), None)
                        else:
                            # success clears the deadline inside
                            # _start_actor_on; an acquire race re-parks on
                            # the ORIGINAL clock so it can still time out
                            self._start_actor_on(node_id, spec)
                    except Exception:  # noqa: BLE001 — one bad entry must not stall the queue
                        # dispatch raced a node death: re-park rather than
                        # silently losing the task
                        self._park_infeasible(spec, kind=kind)
                elif now >= deadline:
                    with self._demand_lock:
                        self._infeasible_demands.pop(id(spec), None)
                    with self._demand_cv:
                        self._park_deadlines.pop(id(spec), None)
                    placed_or_failed.append(entry)
                    if kind == "task":
                        self.task_manager.mark_failed(spec)
                        self._commit_error_everywhere(
                            spec,
                            RayTaskError(
                                spec.name,
                                f"Task {spec.name} is infeasible: requires {spec.resources.to_dict()}",
                            ),
                        )
                    else:
                        self.on_actor_creation_failed(
                            spec, ActorDiedError(spec.actor_id, "actor creation infeasible")
                        )
            with self._demand_cv:
                for entry in placed_or_failed:
                    try:
                        self._demand_entries.remove(entry)
                    except ValueError:
                        pass
                depth = len(self._demand_entries)
                metric_defs.ADMISSION_QUEUE_DEPTH.set(depth, _DEMAND_QUEUE_TAGS)
                if self._demand_entries:
                    self._demand_cv.wait(timeout=0.05)  # tick while backlogged

    def dump_cluster_stacks(self, timeout: float = 5.0) -> dict:
        """Live thread stacks from the driver, every local node's pool
        workers, and every remote agent (`rt stack`; reference:
        scripts.py:1830 `ray stack`, node-local py-spy)."""
        import threading as _t

        from ray_tpu_torch.runtime import stack as _stack

        out = {"driver": _stack.format_thread_stacks(), "nodes": {}}
        threads = []
        for nid, node in list(self.nodes.items()):
            if node.dead:
                continue
            if hasattr(node, "conn"):  # remote agent: ask it — in PARALLEL,
                # so N wedged agents cost one timeout, not N (a stuck
                # cluster is exactly when this command runs)
                def ask(nid=nid, node=node):
                    try:
                        entry = node.conn.request(
                            "dump_stacks", {"timeout": timeout}, timeout=timeout + 10
                        )
                    except Exception as exc:  # noqa: BLE001
                        entry = {"error": f"<agent unreachable: {exc}>"}
                    out["nodes"][nid.hex()] = entry

                th = _t.Thread(target=ask, name="stack-fanout", daemon=True)
                th.start()
                threads.append(th)
            else:  # in-process node: its pool workers answer directly
                entry = _stack.node_stacks(node, timeout=timeout)
                entry.pop("process", None)  # same process as the driver
                out["nodes"][nid.hex()] = entry
        deadline = time.monotonic() + timeout + 12
        for th in threads:
            th.join(max(0.0, deadline - time.monotonic()))
        return out

    def on_worker_process_died(self, pid) -> None:
        """A pool worker on the head host died: its borrower ledger can
        never report again, so drop every ref pin it held."""
        if self.core_worker is not None:
            from ray_tpu_torch.runtime.worker_api import release_worker_pins

            release_worker_pins(self.core_worker, pid)

    def handle_worker_api(
        self, blob: bytes, op: str = "", worker_key=None, pushed: bool = False
    ) -> bytes:
        """Nested runtime API call from a worker process on this host: runs
        against the driver's CoreWorker (the single owner).  ``pushed`` is
        accepted for agent-fabric signature parity — head-local workers
        have no cross-channel registration race."""
        from ray_tpu_torch.runtime import protocol, worker_api

        if self.core_worker is None:
            raise RuntimeError("no core worker attached to this cluster")
        decoded = None
        if op in ("put", "put_async") and self.shm_store is not None:
            # bulk put payloads arrive as shm markers, not in-band pickle;
            # hand execute() the decoded frame — a re-pickle round trip
            # would copy the bulk value twice
            decoded = protocol.decode_put_frame(blob, self.shm_store)
        return worker_api.execute(
            self.core_worker, blob, decoded=decoded, worker_key=worker_key
        )

    def cancel_task(self, spec: TaskSpec, force: bool = False) -> None:
        """Propagate a cancellation to wherever the task is queued/running.

        The ``_cancelled`` flag (set by the caller) covers the
        pre-dispatch window; this routes the running-task half: with
        ``force`` the hosting worker process is killed (CancelTask
        force_kill parity)."""
        node = self.nodes.get(spec.owner_node)
        if node is None or node.dead:
            return
        node.cancel_task(spec, force=force)

    # ------------------------------------------------------------------
    # gray-failure hooks: deadlines + hedges (runtime/watchdog.py callers)
    # ------------------------------------------------------------------
    def record_fence_event(self, event: dict) -> None:
        """One audited fence rejection (bounded log + monotonic total)."""
        self.fence_events.append(event)
        self.fence_events_total += 1
        # flight-record into the structured event ring (throttled: a fence
        # storm after an epoch bump is one snapshot a second, not one per
        # stale submission)
        try:
            from ray_tpu_torch.observability import reqtrace

            if reqtrace.snapshot_due("fence"):
                reqtrace.flight_record(
                    "fence_rejection",
                    "stale-epoch submission fenced",
                    severity="WARNING",
                    state={"fence_events_total": self.fence_events_total,
                           "last_event": event},
                )
        except Exception:  # noqa: BLE001 — auditing must never fail a fence
            pass

    def record_overload_event(self, event: dict) -> None:
        """One audited admission-control shed (bounded log + monotonic
        total) — appended by runtime/admission.py for every rejection."""
        self.overload_events.append(event)
        self.overload_events_total += 1

    def overload_snapshot(self) -> dict:
        """The /api/overload payload: per-layer bounds, current depths, and
        lifetime shed totals across the whole admission spine."""
        from ray_tpu_torch.runtime import admission

        cfg = get_config()
        with self._demand_cv:
            parked = len(self._demand_entries)
        head_store = (
            self.head_node.store.stats()
            if self.head_node is not None and not self.head_node.dead
            else {}
        )
        return {
            "shed_totals": admission.shed_totals(),
            "events_total": self.overload_events_total,
            "recent_events": list(self.overload_events)[-32:],
            "demand_queue": {
                "depth": parked,
                "bound": cfg.demand_queue_max_entries,
            },
            "submission": (
                self.core_worker.admission_gate.snapshot()
                if self.core_worker is not None
                else None
            ),
            "store": {
                "host_used": head_store.get("host_used", 0),
                "host_budget": head_store.get("host_budget", 0),
                "disk_used": head_store.get("disk_used", 0),
                "disk_budget": head_store.get("disk_budget", 0),
                "put_backpressure_waits": head_store.get("put_backpressure_waits", 0),
                "puts_shed": head_store.get("puts_shed", 0),
            },
            "sources": admission.sources_snapshot(),
            # per-deployment SLO percentiles from the request-trace store
            # (ms-scale e2e / queue-wait; engine sources above carry
            # ttft / inter_token under their own "latency" key)
            "request_latency": _request_latency_snapshot(),
            # disaggregated serving: per-role pool lines (replica count vs
            # target, ongoing requests, decode free-KV fraction) from every
            # registered serve controller (serve/disagg.py)
            "serve_pools": self._serve_pools_snapshot(),
        }

    def _serve_pools_snapshot(self) -> Dict[str, dict]:
        pools: Dict[str, dict] = {}
        for ctl in list(self.serve_controllers.values()):
            try:
                pools.update(ctl.pool_status())
            except Exception:  # noqa: BLE001 — observability never raises
                continue
        return pools

    def unpark_and_fail(self, spec: TaskSpec, error: BaseException) -> bool:
        """Remove a PARKED task from the demand queue and commit ``error``
        as its terminal state.  Returns False when the drainer placed it
        concurrently (the caller falls back to the cancel path)."""
        removed = False
        with self._demand_cv:
            for entry in list(self._demand_entries):
                if entry[0] is spec:
                    self._demand_entries.remove(entry)
                    removed = True
                    break
            if removed:
                self._park_deadlines.pop(id(spec), None)
        if not removed:
            return False
        with self._demand_lock:
            self._infeasible_demands.pop(id(spec), None)
        if not self.task_manager.claim(spec):
            return True  # something else already terminated it
        self._record_task_event(spec, self.head_node, "FAILED")
        self.task_manager.mark_failed(spec)
        self._commit_error_everywhere(spec, error)
        self._emit_task_spans(spec, "FAILED")
        self._after_commit(spec)
        return True

    def deadline_fail_now(self, spec: TaskSpec) -> bool:
        """Owner-side terminal commit of a deadline failure (pulling-stage
        fire, or the escalation safety net).  Claim-based: a straggler
        completion racing this loses atomically — terminal-exactly-once
        per (task_id, attempt) holds."""
        if not self.task_manager.claim(spec):
            return False
        error = self.watchdog.deadline_error(spec)
        node = self.nodes.get(spec.owner_node)
        if node is None or node.dead:
            node = self.head_node
        self._record_task_event(spec, node, "FAILED")
        self.task_manager.mark_failed(spec)
        self._commit_error_everywhere(spec, error)
        self._emit_task_spans(spec, "FAILED")
        self._after_commit(spec)
        return True

    def submit_hedge(self, spec: TaskSpec, exclude=()) -> bool:
        """Launch a hedged second attempt on a node OTHER than the
        (possibly straggling) primary's.  Deliberately bypasses the lease
        fast path — the cached lease points at the very node being hedged
        against.  False = no alternative node exists right now."""
        exclude = frozenset(n for n in exclude if n is not None)
        node_id = self.cluster_scheduler.pick_node(spec, exclude=exclude)
        if node_id is None or node_id in exclude:
            return False
        node = self.nodes.get(node_id)
        if node is None or node.dead:
            return False
        try:
            node.submit(spec)
        except ConnectionError:
            return False
        return True

    def request_resources(self, bundles: List[Dict[str, float]]) -> None:
        """Set the explicit capacity floor (parity:
        ``ray.autoscaler.sdk.request_resources``, commands.py). Replace
        semantics: each call overwrites the previous request; an empty list
        clears it. Floor semantics match the reference: bundles are
        satisfied by TOTAL cluster capacity (busy or free) — the autoscaler
        launches only the unmet residual and refuses idle scale-down that
        would drop the cluster below the floor."""
        with self._demand_lock:
            self._resource_requests = [dict(b) for b in bundles]

    def resource_requests(self) -> List[Dict[str, float]]:
        with self._demand_lock:
            return [dict(b) for b in self._resource_requests]

    @staticmethod
    def _pack_residual(
        bundles: List[Dict[str, float]], capacities: List[Dict[str, float]]
    ) -> List[Dict[str, float]]:
        """First-fit-decreasing of bundles into capacities; -> what didn't fit."""
        caps = [dict(c) for c in capacities]
        residual: List[Dict[str, float]] = []
        for b in sorted(bundles, key=lambda d: -sum(d.values())):
            for cap in caps:
                if all(cap.get(k, 0.0) >= v for k, v in b.items() if v > 0):
                    for k, v in b.items():
                        cap[k] = cap.get(k, 0.0) - v
                    break
            else:
                residual.append(dict(b))
        return residual

    def _alive_capacities(self) -> List[Dict[str, float]]:
        return [
            node.pool.total.to_dict()
            for node in list(self.nodes.values())
            if not node.dead
        ]

    def unmet_resource_requests(
        self, extra_capacities: Optional[List[Dict[str, float]]] = None
    ) -> List[Dict[str, float]]:
        """The part of the request_resources floor the cluster's TOTAL
        capacity cannot hold — the shapes the autoscaler must launch for.
        ``extra_capacities`` credits nodes already launched but not yet
        registered (booting), so the caller doesn't re-launch for the same
        residual every tick."""
        reqs = self.resource_requests()
        if not reqs:
            return []
        return self._pack_residual(
            reqs, self._alive_capacities() + list(extra_capacities or [])
        )

    def requests_fit(self, capacities: List[Dict[str, float]]) -> bool:
        """Would the floor still fit into these node capacities? (The
        autoscaler's pre-termination check.)"""
        return not self._pack_residual(self.resource_requests(), capacities)

    def pending_resource_demands(self) -> List[Dict[str, float]]:
        """Resource shapes of currently-unschedulable work, for the
        autoscaler (the load the reference's GCS reports to the monitor)."""
        with self._demand_lock:
            demands = list(self._infeasible_demands.values())
        from ray_tpu_torch.runtime.placement import PlacementGroupState

        for info in self.control.placement_groups.list_groups():
            if info.state is PlacementGroupState.PENDING:
                demands.extend(b.to_dict() for b in info.bundles)
        return demands

    # ------------------------------------------------------------------
    # object pulls / transfer
    # ------------------------------------------------------------------
    def pull_object(self, oid: ObjectID, dest_node: Node, callback: Callable[[], None]) -> None:
        """All inbound object traffic funnels through the PullManager:
        dedup of concurrent pulls, in-flight-byte admission, transfers on
        pull workers (never directory callback threads), retry-with-purge
        on failed sources (see runtime/pull_manager.py)."""
        self.pull_manager.pull(oid, dest_node, callback)

    def commit_location(self, node, oid: ObjectID) -> None:
        """Record a location WITH the committed entry's size/tier metadata
        — the inputs the scheduler's locality stage and the PullManager's
        admission control read from the directory."""
        store = getattr(node, "store", None)
        info = store.entry_info(oid) if store is not None else None
        if info:
            self.directory.add_location(
                oid, node.node_id, size=info["size"], tier=info["tier"]
            )
        else:
            self.directory.add_location(oid, node.node_id)

    def _is_pending(self, oid: ObjectID) -> bool:
        for spec in self.task_manager.pending_specs():
            if oid in spec.return_ids:
                return True
        return False

    def _try_recover(self, oid: ObjectID, _graced: bool = False) -> bool:
        if self.directory.locations(oid) or self._is_pending(oid):
            return True  # already available or being (re)produced
        spec = self.task_manager.lineage_spec(oid)
        if spec is None:
            if not _graced:
                # Cross-channel race, not loss: a worker-minted put's
                # ownership/location notice rides the CONTROL channel while
                # the task result that carried its ref can arrive
                # owner-routed on the DATA plane — nothing orders the two.
                # Re-check after a short grace before tombstoning; blocked
                # getters are parked on directory.wait_for either way (they
                # resolve the moment the notice lands, or raise when the
                # tombstone commits below).
                key = oid.binary()
                with self._recover_grace_lock:
                    if key in self._recover_grace:
                        return True  # a grace timer already owns this oid
                    self._recover_grace.add(key)

                def _expire():
                    with self._recover_grace_lock:
                        self._recover_grace.discard(key)
                    self._try_recover(oid, _graced=True)

                timer = threading.Timer(_LOST_NOTICE_GRACE_S, _expire)
                timer.daemon = True
                timer.start()
                return True
            # Unrecoverable: commit ObjectLostError so blocked getters raise
            # instead of hanging (reference: OwnerDiedError/ObjectLostError
            # surfaced at get).
            self.head_node.store.put(oid, ObjectLostError(oid), is_error=True)
            self.directory.add_location(oid, self.head_node.node_id)
            return False
        spec.retries_left = max(spec.retries_left, 1)
        spec.attempt += 1
        self._emit_retry_span(spec)
        self.task_manager.add_pending(spec)
        self.submit(spec)
        return True

    # ------------------------------------------------------------------
    # owner-side completion
    # ------------------------------------------------------------------
    def on_task_finished(
        self, node: Node, spec: TaskSpec, result: Any,
        error: Optional[BaseException], lazy: bool = False,
    ) -> None:
        """``lazy=True``: a remote node completed the task and kept the bulk
        result in its local store — commit locations + completion only; the
        bytes move peer-to-peer on the data plane when someone reads them."""
        if spec.num_returns == "streaming":
            # only reachable for pre-execution failures (cancellation, a
            # dispatch-time error): surface it as the stream's only item so
            # the consumer's iteration raises instead of hanging. No retry —
            # items already observed by the consumer can't be un-yielded.
            self.on_stream_done(node, spec, len(spec.return_ids), error)
            return
        if node.dead:
            # The node died. Normal tasks were resubmitted by kill_node (the
            # retry owns the returns), so straggler completions are dropped.
            # In-flight ACTOR tasks are not resubmitted — their callers must
            # see an error, not hang.
            if spec.actor_id is None:
                # fenced commit: a dead — possibly partitioned-but-ALIVE —
                # incarnation tried to land a task result.  Rejecting it is
                # what keeps a healed partition from double-committing what
                # the death sweep already resubmitted; audited by chaos
                # invariant 9 and surfaced as fenced_frames_total.
                metric_defs.FENCED_FRAMES.inc(tags=_FENCE_TASK_TAGS)
                self.record_fence_event(
                    {
                        "kind": "task_finished",
                        "node": node.node_id.hex()[:8],
                        "task": spec.task_id.hex(),
                        "attempt": spec.attempt,
                    }
                )
                return
            if lazy and error is None:
                # the result's only copy died with the node: surface as a
                # worker crash so retry/ActorDiedError policy applies
                error = WorkerCrashedError(
                    f"node {node.node_id.hex()[:8]} died before the result transferred"
                )
            if error is None:
                # the call actually completed: salvage the result onto
                # the head node's store.  Event recorded BEFORE the puts:
                # getters wake the instant the value commits, and the
                # terminal record must already be visible to them (and
                # to a racing shutdown snapshot).
                self._record_task_event(spec, node, "FINISHED")
                values = [result] if spec.num_returns == 1 else list(result or [None] * spec.num_returns)
                for oid, value in zip(spec.return_ids, values):
                    self.head_node.store.put(oid, value)
                    self.commit_location(self.head_node, oid)
                self.task_manager.mark_completed(spec)
                self._emit_task_spans(spec, "FINISHED")
            elif self._maybe_retry_actor_task(spec):
                return
            else:
                self._record_task_event(spec, node, "FAILED")
                self.task_manager.mark_failed(spec)
                self._commit_error_everywhere(spec, error)
                self._emit_task_spans(spec, "FAILED")
            self._after_commit(spec)
            return
        if spec._hedge is not None and not self.watchdog.arbitrate(spec, error):
            # hedge loser (or an error suppressed in favor of its live
            # sibling): this completion is discarded ENTIRELY — the winning
            # attempt owns the returns, the terminal event, the retries
            return
        if spec._deadline_fired and spec.num_returns != "streaming":
            # once the deadline fired, the outcome IS DeadlineExceededError
            # regardless of how the attempt ended; claim the terminal right
            # (the watchdog's direct-fail paths race this completion)
            if not self.task_manager.claim(spec):
                return
            error = self.watchdog.deadline_error(spec)
        if error is not None:
            from ray_tpu_torch.exceptions import OutOfMemoryError, TaskCancelledError

            if spec._cancelled and not isinstance(
                error, (TaskCancelledError, DeadlineExceededError)
            ):
                # a force-cancel kills the hosting worker: the death must
                # surface as cancellation, not WorkerCrashedError, and must
                # never retry
                error = TaskCancelledError(spec.task_id)
            is_system = isinstance(error, (WorkerCrashedError, ActorDiedError, OutOfMemoryError))
            retry_exceptions = getattr(spec, "_retry_exceptions", False)
            if spec._cancelled:
                pass  # cancelled tasks never retry
            elif spec.actor_id is None and self.task_manager.should_retry(spec, is_system, retry_exceptions):
                self._emit_retry_span(spec)
                self.submit(spec)
                return
            elif spec.actor_id is not None and is_system and self._maybe_retry_actor_task(spec):
                # max_task_retries: the actor is restarting (or alive again);
                # transparently resubmit the in-flight call
                # (task_manager.h:208 — owners resubmit in-flight methods)
                return
            if spec.actor_id is not None and isinstance(error, WorkerCrashedError):
                # an actor call that died with its worker surfaces as an
                # actor error, not a bare worker crash (RayActorError parity)
                error = ActorDiedError(spec.actor_id, str(error))
            # record BEFORE committing the error objects: committing wakes
            # blocked getters, and the terminal record must already be
            # visible to them (and to a racing shutdown snapshot)
            self._record_task_event(spec, node, "FAILED")
            self.task_manager.mark_failed(spec)
            self._commit_error_everywhere(spec, error)
            self._emit_task_spans(spec, "FAILED")
            self._after_commit(spec)
            return

        # split returns.  The terminal event is recorded BEFORE the value
        # commits: store.put wakes blocked getters, and a caller returning
        # from rt.get (or a shutdown snapshot racing this thread) must
        # already see the task's terminal record.
        self._record_task_event(spec, node, "FINISHED")
        if self.watchdog.auto_on and spec.actor_id is None and spec.submit_time:
            # per-SchedulingKey latency EWMA feed for the auto-hedge mode
            self.watchdog.observe_latency(spec, time.time() - spec.submit_time)
        if lazy:
            # values live in the remote node's store; record locations only
            for oid in spec.return_ids:
                self.directory.add_location(oid, node.node_id)
            self.task_manager.mark_completed(spec)
            self._emit_task_spans(spec, "FINISHED")
            self._after_commit(spec)
            return
        if spec.num_returns == 1:
            values = [result]
        else:
            values = list(result) if result is not None else [None] * spec.num_returns
        t_put = time.time()
        for oid, value in zip(spec.return_ids, values):
            node.store.put(oid, value)
            self.commit_location(node, oid)
        if spec.trace_ctx is not None and spec.return_ids:
            tracing.emit_span(
                f"put::{spec.name}", spec.trace_ctx[0], spec.trace_ctx[1],
                t_put, time.time(),
            )
        self.task_manager.mark_completed(spec)
        # root span emitted after the puts so its interval contains them
        self._emit_task_spans(spec, "FINISHED")
        self._after_commit(spec)

    def _emit_retry_span(self, spec: TaskSpec) -> None:
        """Every retried attempt becomes a distinct ``retry::`` span in the
        trace (chaos invariant: the span store must show each retry
        per-attempt, so a reproduced fault schedule can be audited from the
        timeline alone).  Instant span, parented to the task span."""
        ctx = spec.trace_ctx
        if ctx is None:
            return
        now = time.time()
        tracing.emit_span(
            f"retry::{spec.name}", ctx[0], ctx[1], now, now,
            attrs={"task_id": spec.task_id.hex(), "attempt": str(spec.attempt)},
        )

    def _record_task_event(self, spec: TaskSpec, node: Node, state: str) -> None:
        """TaskEventBuffer→GcsTaskManager parity (task_event_buffer.h:206):
        one record per terminal state with submit/start/end timestamps, from
        which ``rt timeline`` builds chrome-trace spans."""
        metric_defs.TASKS_TERMINAL.inc(tags={"state": state})
        now = time.time()
        if spec.submit_time and spec.start_time:
            metric_defs.TASK_QUEUE_WAIT.observe(spec.start_time - spec.submit_time)
        if spec.start_time:
            metric_defs.TASK_EXEC_TIME.observe(now - spec.start_time)
        if not get_config().task_events_enabled:
            return
        self.control.task_events.add(
            {
                "task_id": spec.task_id.hex(),
                "name": spec.name,
                "state": state,
                "node": node.node_id.hex()[:8],
                "attempt": spec.attempt,
                "submit_ts": spec.submit_time or None,
                "start_ts": spec.start_time or None,
                "ts": now,
            }
        )

    def _emit_task_spans(self, spec: TaskSpec, state: str) -> None:
        """Synthesize the task's ROOT span (submit→now; its id was reserved
        at submit so both sides of the process boundary parent to it) plus
        the owner-side schedule phase — worker-side execute spans arrive
        through result payloads and nest under the same root.  Called AFTER
        the return commits so the root covers the put phase (children must
        nest by time containment in the rendered trace)."""
        ctx = spec.trace_ctx
        if ctx is None:
            return
        trace_id, task_span_id, parent_id = ctx
        now = time.time()
        root_start = spec.submit_time or spec.start_time or now
        tracing.emit_span(
            f"task::{spec.name}", trace_id, parent_id, root_start, now,
            span_id=task_span_id,
            attrs={"task_id": spec.task_id.hex(), "state": state},
        )
        if spec.submit_time and spec.start_time:
            tracing.emit_span(
                f"schedule::{spec.name}", trace_id, task_span_id,
                spec.submit_time, spec.start_time,
            )

    # ------------------------------------------------------------------
    # streaming generators (reference: TryReadObjectRefStream,
    # core_worker.h:389 — item objects commit as they are produced)
    # ------------------------------------------------------------------
    def register_stream(self, spec: TaskSpec, gen) -> None:
        self._streams[spec.task_id.binary()] = gen

    def on_stream_item(
        self, node: Node, spec: TaskSpec, index: int, value: Any,
        is_error: bool = False, _force: bool = False, lazy: bool = False,
    ) -> Optional[bool]:
        """Returns False when the commit was DROPPED (force-closed stream) —
        remote callers use it to free a lazily-staged copy on the agent."""
        # the lock makes check-flag -> commit atomic against force-close:
        # without it a producer that passed the flag check could overwrite
        # the force-committed error object (same ObjectID index)
        with self._stream_lock:
            if spec._stream_closed and not _force:
                # stream force-closed (node death / infeasibility) while the
                # producer thread was still running: late items must not
                # overwrite the committed error object or reopen the stream
                return False
            oid = ObjectID.for_task_return(spec.task_id, index + 1)
            if self.core_worker is not None:
                self.core_worker.ref_counter.add_owned_object(oid)
            if lazy:
                # bulk item: the bytes stayed in the producing node's store;
                # commit the location only (consumers pull peer-to-peer)
                if node.dead:
                    self.head_node.store.put(oid, ObjectLostError(oid), is_error=True)
                    self.directory.add_location(oid, self.head_node.node_id)
                else:
                    self.directory.add_location(oid, node.node_id)
            else:
                store_node = self.head_node if node.dead else node
                store_node.store.put(oid, value, is_error=is_error)
                self.commit_location(store_node, oid)
            spec.return_ids.append(oid)
            gen = self._streams.get(spec.task_id.binary())
            if gen is not None:
                gen._push(ObjectRef(oid))

    def on_stream_done(self, node: Node, spec: TaskSpec, index: int, error: Optional[BaseException]) -> None:
        if spec._stream_closed:
            return  # already force-closed and marked failed
        if error is not None:
            # reference semantics: the failure IS the next item — iteration
            # surfaces an errored ref, then the stream ends
            self.on_stream_item(node, spec, index, error, is_error=True)
            self.task_manager.mark_failed(spec)
            self._record_task_event(spec, node, "FAILED")
            self._emit_task_spans(spec, "FAILED")
        else:
            self.task_manager.mark_completed(spec)
            self._record_task_event(spec, node, "FINISHED")
            self._emit_task_spans(spec, "FINISHED")
        gen = self._streams.pop(spec.task_id.binary(), None)
        if gen is not None:
            gen._finish()
        self._after_commit(spec)

    def _commit_error_everywhere(self, spec: TaskSpec, error: BaseException) -> None:
        node = self.nodes.get(spec.owner_node)
        if node is None or node.dead:
            node = self.head_node
        if spec.num_returns == "streaming":
            # close the stream with the error as its next item — otherwise a
            # consumer blocked in ObjectRefGenerator.__next__ hangs forever
            # (reachable via kill_node and infeasible-task expiry). Flag set
            # FIRST (under the stream lock via _force commit) so a racing
            # producer's late commits are no-ops, never overwrites; a second
            # force-close is itself a no-op (idempotent — a killed node's
            # producer may also surface its crash through this path).
            with self._stream_lock:
                if spec._stream_closed:
                    return
                spec._stream_closed = True
                idx = len(spec.return_ids)
            self.on_stream_item(node, spec, idx, error, is_error=True, _force=True)
            gen = self._streams.pop(spec.task_id.binary(), None)
            if gen is not None:
                gen._finish()
            return
        for oid in spec.return_ids:
            node.store.put(oid, error, is_error=True)
            self.directory.add_location(oid, node.node_id)

    def _after_commit(self, spec: TaskSpec) -> None:
        self.watchdog.on_terminal(spec)
        if self.core_worker is not None:
            self.core_worker.on_task_committed(spec)

    # ------------------------------------------------------------------
    # actors
    # ------------------------------------------------------------------
    def create_actor(
        self, spec: TaskSpec, mode: str, max_concurrency: int, info,
        namespace: str = "default", max_task_retries: int = 0,
    ) -> None:
        with self._actor_lock:
            q = self._actor_queues[spec.actor_id] = _ActorQueue()
            self._actor_specs[spec.actor_id] = spec
            self._actor_options[spec.actor_id] = {
                "mode": mode,
                "max_concurrency": max_concurrency,
                "max_task_retries": max_task_retries,
            }
        self.control.actors.register(info, namespace=namespace)
        self._schedule_actor_creation(spec)

    def _schedule_actor_creation(self, spec: TaskSpec) -> None:
        node_id = self.cluster_scheduler.pick_node(spec)
        if node_id is None:
            self._retry_actor_creation(spec)
            return
        self._start_actor_on(node_id, spec)

    def _retry_actor_creation(self, spec: TaskSpec) -> None:
        """Actor creation is currently infeasible (resources may free as
        actors die or restarts settle): park it on the shared demand queue;
        the drainer fails it after the deadline."""
        self._park_infeasible(spec, kind="actor")

    def _start_actor_on(self, node_id: NodeID, spec: TaskSpec) -> None:
        opts = self._actor_options[spec.actor_id]
        node = self.nodes[node_id]
        if not node.pool.acquire(spec.resources):
            # Raced with another placement (or the node merely fits by
            # TOTAL while its resources are held): back on the demand
            # queue — the first-park deadline is preserved there, so a
            # never-feasible creation still times out.
            self._retry_actor_creation(spec)
            return
        with self._demand_cv:
            self._park_deadlines.pop(id(spec), None)
        spec.owner_node = node_id
        deps = [d for d in spec.dependencies if not node.store.contains(d)]
        when_all(
            deps,
            lambda dep, done: self.pull_object(dep, node, done),
            lambda: node.create_actor(spec, opts["mode"], opts["max_concurrency"]),
        )

    def on_actor_created(self, node: Node, spec: TaskSpec) -> None:
        self.control.actors.mark_alive(spec.actor_id, node.node_id)
        q = self._actor_queues.get(spec.actor_id)
        if q is not None:
            with q.lock:
                q.alive = True
                # grant the direct route: dep-free calls now skip the
                # registry and the pump while the queue stays drained
                q.direct_node = node
            self._pump_actor_queue(spec.actor_id)

    def on_actor_creation_failed(self, spec: TaskSpec, error: BaseException) -> None:
        node = self.nodes.get(spec.owner_node)
        if node is not None:
            node.pool.release(spec.resources)
        state = self.control.actors.on_failure(spec.actor_id, str(error))
        if state is ActorState.RESTARTING:
            self._schedule_actor_creation(self._actor_specs[spec.actor_id])
        else:
            self._fail_actor_queue(spec.actor_id, error)

    def on_actor_process_died(self, node: Node, actor_id: ActorID) -> None:
        self._handle_actor_failure(actor_id, "actor process died")

    def _handle_actor_failure(self, actor_id: ActorID, cause: str) -> None:
        # Revoke the direct route FIRST, before the instance dies: a call
        # racing this sweep must fall onto the buffering slow path (where
        # the restart FSM preserves it) rather than land on a dead
        # instance it could have avoided.
        q = self._actor_queues.get(actor_id)
        if q is not None:
            with q.lock:
                q.alive = False
                q.direct_node = None
        spec = self._actor_specs.get(actor_id)
        if spec is not None:
            node = self.nodes.get(spec.owner_node)
            if node is not None and not node.dead:
                node.kill_actor(actor_id)
                node.pool.release(spec.resources)
        # declaratively-bound collective groups the actor belongs to fail
        # open waits immediately (direct_actor_task_submitter.h:120 parity)
        self._fail_collective_groups_for_actor(actor_id, cause)
        # compiled execution plans using this actor as a stage are BROKEN —
        # even between iterations, so the next execute fails fast
        for plan in list(self.compiled_plans.values()):
            try:
                plan.on_actor_dead(actor_id, cause)
            except Exception:  # noqa: BLE001
                pass
        state = self.control.actors.on_failure(actor_id, cause)
        if state is ActorState.RESTARTING and spec is not None:
            spec.attempt += 1
            # restarts are retries of the creation task: each must be a
            # distinct retry:: span or the chaos invariant sweep flags a
            # healthy recovery as an unaccounted attempt
            self._emit_retry_span(spec)
            self._schedule_actor_creation(spec)
        else:
            self._fail_actor_queue(actor_id, ActorDiedError(actor_id, f"The actor died: {cause}"))

    # ------------------------------------------------------------------
    # collective death notices
    # ------------------------------------------------------------------
    def _fail_collective_groups_for_node(self, node_id: NodeID) -> None:
        """Groups with a rank registered from the dead node (the rank's
        process published its hosting node beside its address —
        ``p2p.node_key``) get a death notice."""
        node_hex = node_id.hex().encode()
        groups = set()
        try:
            for key in self.control.kv.keys(b"rt_coll_node/"):
                if self.control.kv.get(key) == node_hex:
                    parts = key.decode().split("/")
                    if len(parts) == 3:
                        groups.add(parts[1])
        except Exception:  # noqa: BLE001 — notice is best-effort
            return
        if groups:
            self._broadcast_collective_failure(
                groups, f"node {node_id.hex()[:8]} died"
            )

    def _fail_collective_groups_for_actor(self, actor_id: ActorID, cause: str) -> None:
        """Groups the actor was declaratively bound to
        (``create_collective_group`` records actor->rank in the KV)."""
        import pickle as _pickle

        aid = actor_id.hex()
        groups = set()
        try:
            for key in self.control.kv.keys(b"rt_coll_grp/"):
                raw = self.control.kv.get(key)
                if raw is None:
                    continue
                record = _pickle.loads(raw)
                if aid in record.get("binding", {}):
                    groups.add(key.decode().split("/", 1)[1])
        except Exception:  # noqa: BLE001
            return
        if groups:
            self._broadcast_collective_failure(groups, f"actor {aid[:8]} died: {cause}")

    def _broadcast_collective_failure(self, groups, reason: str) -> None:
        """Fan the death notice to every fabric process of this host: this
        (driver) process and the pool workers (the JAX package also relays
        it to agents, which the port does not have)."""
        from ray_tpu_torch.runtime import p2p

        if self._snapshot_stop.is_set():
            # this cluster is shutting down (or already gone): a late
            # handler must NOT write failure records into process-global p2p
            # state — a NEXT runtime in this process may own same-named groups
            return
        group_list = sorted(groups)
        for g in group_list:
            p2p.fail_group(g, reason)
        for node in list(self.nodes.values()):
            if node.dead:
                continue
            pool = getattr(node, "worker_pool", None)
            if pool is not None:
                pool.broadcast_fail_group(group_list, reason)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        info = self.control.actors.get(actor_id)
        if info is None:
            return
        if not no_restart:
            # kill the process/thread but let the restart FSM bring it back
            # (ray.kill(handle, no_restart=False) parity).
            self._handle_actor_failure(actor_id, "killed via kill_actor (restartable)")
            return
        info.max_restarts = info.num_restarts  # exhaust restarts
        q = self._actor_queues.get(actor_id)
        if q is not None:
            # route revoked BEFORE the kill so a racing direct call buffers
            # (and is then failed by _fail_actor_queue) instead of racing
            # the dying instance
            with q.lock:
                q.alive = False
                q.direct_node = None
        if info.node_id is not None:
            node = self.nodes.get(info.node_id)
            if node is not None:
                node.kill_actor(actor_id)
        spec = self._actor_specs.get(actor_id)
        if spec is not None:
            node = self.nodes.get(spec.owner_node)
            if node is not None and not node.dead:
                node.pool.release(spec.resources)
        self.control.actors.mark_dead(actor_id, "killed via kill_actor")
        self._fail_actor_queue(actor_id, ActorDiedError(actor_id, "The actor was killed"))
        for plan in list(self.compiled_plans.values()):
            try:
                plan.on_actor_dead(actor_id, "killed via kill_actor")
            except Exception:  # noqa: BLE001
                pass

    def _maybe_retry_actor_task(self, spec: TaskSpec) -> bool:
        """max_task_retries: resubmit an in-flight actor call whose actor
        died but is restarting (reference: owners resubmit in-flight methods
        when max_task_retries is set — task_manager.h:208, SURVEY §3.3
        step 5). Returns True if the retry was queued."""
        info = self.control.actors.get(spec.actor_id)
        if info is None or info.state is ActorState.DEAD:
            return False
        if not self.task_manager.should_retry(spec, is_system_error=True):
            return False
        self._emit_retry_span(spec)
        self.submit_actor_task(spec, _is_retry=True)
        return True

    def _stamp_actor_retries(self, spec: TaskSpec) -> None:
        """First submission of an actor call: stamp the actor's
        max_task_retries onto the spec (-1 = retry until the actor is
        permanently dead).  ONE reader of _actor_options so the direct
        route and the queued path can't drift."""
        opts = self._actor_options.get(spec.actor_id)
        retries = opts.get("max_task_retries", 0) if opts else 0
        if retries:
            spec.max_retries = (1 << 30) if retries < 0 else retries
            spec.retries_left = spec.max_retries

    # -- ordered per-actor call queue -----------------------------------
    def _dead_actor_error(self, actor_id: ActorID) -> BaseException:
        """The error a call to a dead actor commits: the remembered typed
        shed error when the creation was refused by admission control (the
        caller can retry after the hint), the generic death otherwise."""
        from ray_tpu_torch.exceptions import raised_copy

        shed = self._actor_shed_errors.get(actor_id)
        if shed is not None:
            return raised_copy(shed)
        return ActorDiedError(actor_id)

    def submit_actor_task(self, spec: TaskSpec, _is_retry: bool = False) -> None:
        # Direct route (the actor-shaped worker lease): while the actor is
        # ALIVE with an empty call queue, a dependency-free call stamps its
        # seq and goes straight to the hosting node — no control-registry
        # lookups, no queue churn, no pump.  Submission happens UNDER
        # q.lock (exactly like the pump) so the per-actor order guarantee
        # holds against concurrent submitters; a dead instance surfaces
        # through the normal in-flight failure path (node-level
        # ActorDiedError -> retry FSM), the same window in-flight pumped
        # calls already have.
        q = self._actor_queues.get(spec.actor_id)
        if (
            q is not None
            and not _is_retry
            and q.direct_node is not None
            and not spec.dependencies
        ):
            submitted = False
            with q.lock:
                node = q.direct_node
                if q.alive and node is not None and not q.pending:
                    self._stamp_actor_retries(spec)
                    spec._actor_seq = q.next_seq
                    q.next_seq += 1
                    try:
                        node.submit_actor_task(spec)
                        submitted = True
                        q.direct_submits += 1
                    except ConnectionError:
                        pass  # node died: the slow path below reinserts
                        # by the stamped seq and the death sweep owns it
            if submitted:
                metric_defs.DIRECT_PUSHES.inc(tags=_ACTOR_DIRECT_TAGS)
                metric_defs.HEAD_RPCS_AVOIDED.inc()
                return
        if not _is_retry:
            self._stamp_actor_retries(spec)
        q = self._actor_queues.get(spec.actor_id)
        info = self.control.actors.get(spec.actor_id)
        if q is None and info is not None and info.state is not ActorState.DEAD:
            # snapshot-restored actor: its record survived the head restart
            # but no queue exists yet — create one; calls buffer until the
            # hosting agent rejoins and reconcile marks it alive
            with self._actor_lock:
                q = self._actor_queues.setdefault(spec.actor_id, _ActorQueue())
        if q is None or info is None or info.state is ActorState.DEAD:
            self.task_manager.mark_failed(spec)
            self._commit_error_everywhere(spec, self._dead_actor_error(spec.actor_id))
            self._after_commit(spec)
            return
        entry = [spec, False]
        with q.lock:
            seq = getattr(spec, "_actor_seq", None)
            if seq is None:
                # first submission: stamp and append (stamps are monotonic,
                # so plain appends keep the queue sorted)
                spec._actor_seq = q.next_seq
                q.next_seq += 1
                q.pending.append(entry)
            else:
                # a RETRIED in-flight call (actor restart, node death):
                # reinsert by its original stamp so it runs BEFORE calls
                # submitted after it — per-actor submission order is the
                # execution-order guarantee (_pump_actor_queue docstring;
                # reference: seq-no ordered ActorSchedulingQueue).
                idx = len(q.pending)
                for i, e in enumerate(q.pending):
                    if getattr(e[0], "_actor_seq", float("inf")) > seq:
                        idx = i
                        break
                q.pending.insert(idx, entry)
        # Post-append DEAD re-check: the death sweep (_handle_actor_failure →
        # _fail_actor_queue) may have flipped the state and drained the queue
        # BETWEEN the check above and the append — in that window the entry
        # would never be failed and the caller would hang forever (reference:
        # per-actor queues fail pending calls atomically with the death
        # notice, direct_actor_task_submitter.h:120).  Only fail it ourselves
        # if WE removed it — if the sweep ran after the append it already did.
        info = self.control.actors.get(spec.actor_id)
        if info is None or info.state is ActorState.DEAD:
            removed = False
            with q.lock:
                try:
                    q.pending.remove(entry)
                    removed = True
                except ValueError:
                    pass
            if removed:
                self.task_manager.mark_failed(spec)
                self._commit_error_everywhere(spec, self._dead_actor_error(spec.actor_id))
                self._after_commit(spec)
            return
        # start dep pulls targeting the actor's node (known once alive)
        self._prepare_actor_entry(entry)

    def _prepare_actor_entry(self, entry) -> None:
        spec = entry[0]
        info = self.control.actors.get(spec.actor_id)
        if info is None or info.state is not ActorState.ALIVE or info.node_id is None:
            # deps pulled when the actor lands; mark ready if no deps
            if not spec.dependencies:
                entry[1] = True
            return
        node = self.nodes[info.node_id]
        deps = [d for d in spec.dependencies if not node.store.contains(d)]

        def ready():
            entry[1] = True
            self._pump_actor_queue(spec.actor_id)

        when_all(deps, lambda dep, done: self.pull_object(dep, node, done), ready)

    def _pump_actor_queue(self, actor_id: ActorID) -> None:
        q = self._actor_queues.get(actor_id)
        info = self.control.actors.get(actor_id)
        if q is None or info is None:
            return
        if info.state is not ActorState.ALIVE or info.node_id is None:
            return
        node = self.nodes[info.node_id]
        # Submit under q.lock so concurrent pumps (dep-pull callbacks,
        # on_actor_created) cannot interleave and reorder the per-actor
        # stream — submission order IS the execution order guarantee.
        # Contiguous ready calls drain as ONE batch (one IPC frame for
        # process-worker actors — the per-call submit cost dominated the
        # async actor path).
        needs_prep = None
        batch_submit = getattr(node, "submit_actor_task_batch", None)
        with q.lock:
            while q.alive and q.pending:
                batch = []
                # bounded batches: a deep backlog must not become one giant
                # encode + IPC frame built under the queue lock
                while q.alive and q.pending and len(batch) < 100:
                    head = q.pending[0]
                    if not head[1]:
                        spec = head[0]
                        if bool(spec.dependencies) and any(
                            not node.store.contains(d) for d in spec.dependencies
                        ):
                            needs_prep = head
                            break
                        head[1] = True
                    q.pending.popleft()
                    batch.append(head)
                if not batch:
                    break
                failed = False
                if batch_submit is not None and len(batch) > 1:
                    try:
                        # one frame, all-or-nothing (remote handles raise
                        # BEFORE anything is sent)
                        batch_submit([e[0] for e in batch])
                    except ConnectionError:
                        q.pending.extendleft(reversed(batch))
                        failed = True
                else:
                    for i, entry in enumerate(batch):
                        try:
                            node.submit_actor_task(entry[0])
                        except ConnectionError:
                            # The node died under us: requeue the UNSENT
                            # tail at the front (order preserved) and let
                            # the death sweep fail/retry the whole queue.
                            # Raising would surface a transport error at
                            # the caller's .remote() site.
                            q.pending.extendleft(reversed(batch[i:]))
                            failed = True
                            break
                if failed or needs_prep is not None:
                    break
        if needs_prep is not None:
            self._prepare_actor_entry(needs_prep)
            # pipeline the backlog: calls QUEUED BEHIND the head start their
            # dependency pulls now, in dispatch order, instead of one
            # head-of-line transfer at a time (PullManager prefetch role).
            # The cursor makes this incremental — each pump only touches
            # calls queued since the last one, not the whole backlog again.
            with q.lock:
                upcoming = [
                    e[0] for e in q.pending
                    if not e[1]
                    and e[0] is not needs_prep[0]
                    and e[0].dependencies
                    and (e[0]._actor_seq or 0) > q.prefetched_seq
                ]
                if upcoming:
                    q.prefetched_seq = max(
                        (s._actor_seq or 0) for s in upcoming
                    )
            for queued_spec in upcoming:
                self.pull_manager.prefetch(queued_spec.dependencies, node)

    def actor_route_stats(self) -> dict:
        """Direct actor-route snapshot for /api/leases: how many live
        actors currently carry a cached route and how many calls rode it."""
        with self._actor_lock:
            queues = list(self._actor_queues.values())
        active = sum(1 for q in queues if q.direct_node is not None)
        return {
            "active_routes": active,
            "direct_submits": sum(q.direct_submits for q in queues),
        }

    def _fail_actor_queue(self, actor_id: ActorID, error: BaseException) -> None:
        q = self._actor_queues.get(actor_id)
        if q is None:
            return
        with q.lock:
            pending = list(q.pending)
            q.pending.clear()
        for spec, _ready in pending:
            self.task_manager.mark_failed(spec)
            self._commit_error_everywhere(spec, error)
            self._after_commit(spec)

    # ------------------------------------------------------------------
    def _snapshot_loop(self, path: str, interval_s: float) -> None:
        while not self._snapshot_stop.wait(interval_s):
            try:
                # flag check + write under one lock: a kill_head racing in
                # between would otherwise have its kill-time snapshot
                # rotated away by a write of doomed-incarnation state
                with self._head_lock:
                    if self._head_down:
                        continue
                    self.control.save_snapshot(path)
            except Exception:  # noqa: BLE001 — persistence must not kill the fabric
                pass

    def shutdown(self) -> None:
        from ray_tpu_torch.runtime import p2p

        # FIRST: mark this incarnation dead, so async handlers racing the
        # teardown stop writing state the moment we start clearing it
        self._snapshot_stop.set()
        self.lease_manager.stop()
        self.watchdog.stop()
        p2p.clear_endpoint()
        # collective groups/counters index this runtime incarnation; a
        # survivor would desync the next init against fresh-born peers
        # (loaded only where a group was used: the module imports torch)
        collective = sys.modules.get("ray_tpu_torch.parallel.collective")
        if collective is not None:
            collective.reset_module_state()
        with self._demand_cv:
            self._demand_stop = True
            self._demand_cv.notify_all()
        # release installed compiled plans: their channels and stage loops
        # are process-global and must not outlive this runtime incarnation
        for plan in list(self.compiled_plans.values()):
            try:
                plan.teardown()
            except Exception:  # noqa: BLE001 — teardown is best-effort here
                pass
        self.pull_manager.shutdown()
        if self._snapshot_thread is not None:
            self._snapshot_thread.join(timeout=10)
        cfg = get_config()
        if cfg.control_snapshot_path:
            # a cleanly-shut-down driver job is SUCCEEDED, not a phantom
            # RUNNING that the next restore would rewrite to FAILED
            if self.core_worker is not None:
                try:
                    self.control.jobs.finish(self.core_worker.job_id, "SUCCEEDED")
                except Exception:  # noqa: BLE001
                    pass
            try:
                self.control.save_snapshot(cfg.control_snapshot_path)
            except Exception:  # noqa: BLE001
                pass
        try:
            from ray_tpu_torch.usage.usage_lib import usage_stats_enabled, write_usage_report

            if usage_stats_enabled():
                write_usage_report(self.session_dir)
        except Exception:  # noqa: BLE001 — the report must not fail a shutdown
            pass
        if self.memory_monitor is not None:
            self.memory_monitor.stop()
        # the head (and the job children it signals) goes before the nodes
        dashboard = getattr(self, "dashboard", None)
        if dashboard is not None:
            dashboard.shutdown()
            self.dashboard = None
        self.control.shutdown()
        # Remote handles first: proxy.shutdown marks them dead BEFORE the
        # socket drops, so the disconnect callback doesn't run the
        # node-failure path (resubmission) during teardown.
        for node in self.nodes.values():
            if not node.dead:
                node.shutdown()
        # the demand drainer may have been inside a blocking submit when it
        # was told to stop: wait for it (bounded), so no thread bound to
        # this cluster outlives its shutdown
        with self._demand_cv:
            drainer = self._demand_thread
        if drainer is not None:
            join_threads([drainer])
        if self.shm_store is not None:
            self.shm_store.close()
            self.shm_store.unlink()
