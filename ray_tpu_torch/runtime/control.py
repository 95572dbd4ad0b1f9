"""Control service — the GCS (Global Control Service) equivalent.

The port's copy of ``ray_tpu/runtime/control.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Parity with the reference's ``src/ray/gcs/gcs_server/``: the single authority
for *cluster-level* state only — node membership (``GcsNodeManager``), the
actor directory + restart FSM (``gcs_actor_manager.h:88,513``), placement
groups (``gcs_placement_group_manager.h:230``), jobs (``GcsJobManager``),
internal KV (``gcs_kv_manager.h``), pubsub broadcast, health checks
(``gcs_health_check_manager.h:39``) and a bounded task-event store
(``gcs_task_manager.h:85``).  Object/task state stays decentralized in owning
workers (the ownership invariant, SURVEY §1).

In-process, lock-guarded tables; multi-host access goes through the transport
layer (``ray_tpu/runtime/rpc.py``) rather than gRPC.  Storage is pluggable the
way ``store_client`` is: the default is in-memory; a snapshot-to-disk backend
covers GCS-restart parity.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from enum import Enum
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, PlacementGroupID


# --------------------------------------------------------------------------
# Internal KV (parity: GcsInternalKVManager)
# --------------------------------------------------------------------------
class InternalKV:
    def __init__(self):
        self._lock = threading.RLock()
        self._data: Dict[str, Dict[bytes, bytes]] = {}

    def snapshot(self) -> Dict[str, Dict[bytes, bytes]]:
        with self._lock:
            return {ns: dict(entries) for ns, entries in self._data.items()}

    def restore(self, data: Dict[str, Dict[bytes, bytes]]) -> None:
        with self._lock:
            for ns, entries in data.items():
                self._data.setdefault(ns, {}).update(entries)

    def put(self, key: bytes, value: bytes, namespace: str = "default", overwrite: bool = True) -> bool:
        with self._lock:
            ns = self._data.setdefault(namespace, {})
            if not overwrite and key in ns:
                return False
            ns[key] = value
            return True

    def get(self, key: bytes, namespace: str = "default") -> Optional[bytes]:
        with self._lock:
            return self._data.get(namespace, {}).get(key)

    def delete(self, key: bytes, namespace: str = "default") -> bool:
        with self._lock:
            return self._data.get(namespace, {}).pop(key, None) is not None

    def exists(self, key: bytes, namespace: str = "default") -> bool:
        with self._lock:
            return key in self._data.get(namespace, {})

    def keys(self, prefix: bytes = b"", namespace: str = "default") -> List[bytes]:
        with self._lock:
            return [k for k in self._data.get(namespace, {}) if k.startswith(prefix)]


# --------------------------------------------------------------------------
# Pubsub (parity: src/ray/pubsub — but push-based callbacks, no long-poll)
# --------------------------------------------------------------------------
class PubSub:
    def __init__(self):
        self._lock = threading.RLock()
        self._subs: Dict[str, List[Callable[[Any], None]]] = {}

    def subscribe(self, channel: str, callback: Callable[[Any], None]) -> Callable[[], None]:
        with self._lock:
            self._subs.setdefault(channel, []).append(callback)

        def unsubscribe():
            with self._lock:
                try:
                    self._subs.get(channel, []).remove(callback)
                except ValueError:
                    pass

        return unsubscribe

    def publish(self, channel: str, message: Any) -> None:
        with self._lock:
            subs = list(self._subs.get(channel, []))
        for cb in subs:
            try:
                cb(message)
            except Exception:
                pass


# --------------------------------------------------------------------------
# Nodes (parity: GcsNodeManager + GcsHealthCheckManager)
# --------------------------------------------------------------------------
class NodeState(Enum):
    ALIVE = "ALIVE"
    DEAD = "DEAD"
    DRAINING = "DRAINING"


class NodeInfo:
    def __init__(self, node_id: NodeID, address: str, resources: Dict[str, float], labels: Optional[dict] = None):
        self.node_id = node_id
        self.address = address
        self.resources_total = dict(resources)
        self.resources_available = dict(resources)
        self.labels = labels or {}
        self.state = NodeState.ALIVE
        self.last_heartbeat = time.monotonic()
        self.missed_heartbeats = 0
        # incarnation granted at registration (gray-failure fencing): frames
        # stamped with an OLDER incarnation of this node id are rejected
        self.incarnation = 0


class NodeTable:
    def __init__(self, pubsub: PubSub):
        self._lock = threading.RLock()
        self._nodes: Dict[NodeID, NodeInfo] = {}
        self._pubsub = pubsub
        # node_id bytes -> last granted incarnation.  Monotonic per node id
        # for the life of the cluster (persisted across head restarts): a
        # re-registration ALWAYS gets a higher incarnation, so frames from
        # the previous epoch of the same node id are detectably stale.
        self._incarnations: Dict[bytes, int] = {}

    def next_incarnation(self, node_id: NodeID) -> int:
        """Mint the next incarnation for this node id (registration time)."""
        with self._lock:
            key = node_id.binary()
            inc = self._incarnations.get(key, 0) + 1
            self._incarnations[key] = inc
            return inc

    def incarnation_of(self, node_id: NodeID) -> int:
        """The CURRENT (authoritative) incarnation of a node id; frames
        carrying anything else are fenced."""
        with self._lock:
            return self._incarnations.get(node_id.binary(), 0)

    def incarnation_snapshot(self) -> Dict[bytes, int]:
        with self._lock:
            return dict(self._incarnations)

    def restore_incarnations(self, data: Dict[bytes, int]) -> None:
        with self._lock:
            for key, inc in (data or {}).items():
                self._incarnations[key] = max(self._incarnations.get(key, 0), int(inc))

    def register(self, info: NodeInfo) -> None:
        with self._lock:
            info.incarnation = self._incarnations.get(info.node_id.binary(), 0)
            self._nodes[info.node_id] = info
        self._pubsub.publish("node", ("ALIVE", info.node_id))

    def heartbeat(self, node_id: NodeID, resources_available: Optional[Dict[str, float]] = None) -> None:
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None:
                return
            node.last_heartbeat = time.monotonic()
            node.missed_heartbeats = 0
            if resources_available is not None:
                node.resources_available = dict(resources_available)

    def mark_dead(self, node_id: NodeID) -> None:
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None or node.state is NodeState.DEAD:
                return
            node.state = NodeState.DEAD
        self._pubsub.publish("node", ("DEAD", node_id))

    def drain(self, node_id: NodeID) -> None:
        with self._lock:
            node = self._nodes.get(node_id)
            if node is not None:
                node.state = NodeState.DRAINING

    def get(self, node_id: NodeID) -> Optional[NodeInfo]:
        with self._lock:
            return self._nodes.get(node_id)

    def alive_nodes(self) -> List[NodeInfo]:
        with self._lock:
            return [n for n in self._nodes.values() if n.state is NodeState.ALIVE]

    def all_nodes(self) -> List[NodeInfo]:
        with self._lock:
            return list(self._nodes.values())

    def check_health(self, threshold: int) -> List[NodeID]:
        """Called periodically; returns newly-dead nodes."""
        dead = []
        with self._lock:
            for node in self._nodes.values():
                if node.state is not NodeState.ALIVE:
                    continue
                node.missed_heartbeats += 1
                if node.missed_heartbeats >= threshold:
                    dead.append(node.node_id)
        for node_id in dead:
            self.mark_dead(node_id)
        return dead


# --------------------------------------------------------------------------
# Actors (parity: GcsActorManager — registration, FSM, restarts, names)
# --------------------------------------------------------------------------
class ActorState(Enum):
    PENDING_CREATION = "PENDING_CREATION"
    ALIVE = "ALIVE"
    RESTARTING = "RESTARTING"
    DEAD = "DEAD"


class ActorInfo:
    def __init__(self, actor_id: ActorID, name: Optional[str], max_restarts: int, job_id: JobID, class_name: str = ""):
        self.actor_id = actor_id
        self.name = name
        self.class_name = class_name
        self.max_restarts = max_restarts
        self.num_restarts = 0
        self.job_id = job_id
        self.state = ActorState.PENDING_CREATION
        self.node_id: Optional[NodeID] = None
        self.address: Optional[str] = None
        self.death_cause: Optional[str] = None


class ActorDirectory:
    def __init__(self, pubsub: PubSub):
        self._lock = threading.RLock()
        self._actors: Dict[ActorID, ActorInfo] = {}
        self._named: Dict[tuple, ActorID] = {}  # (namespace, name) -> id
        self._pubsub = pubsub

    def register(self, info: ActorInfo, namespace: str = "default") -> None:
        with self._lock:
            if info.name:
                key = (namespace, info.name)
                existing_id = self._named.get(key)
                if existing_id is not None:
                    existing = self._actors.get(existing_id)
                    if existing is not None and existing.state is not ActorState.DEAD:
                        raise ValueError(f"Actor name {info.name!r} already taken in namespace {namespace!r}")
                self._named[key] = info.actor_id
            self._actors[info.actor_id] = info

    def mark_alive(self, actor_id: ActorID, node_id: NodeID, address: str = "") -> None:
        with self._lock:
            info = self._actors[actor_id]
            info.state = ActorState.ALIVE
            info.node_id = node_id
            info.address = address
        self._pubsub.publish("actor", ("ALIVE", actor_id))

    def on_failure(self, actor_id: ActorID, cause: str = "") -> ActorState:
        """Actor process/thread died: decide restart vs dead (ReconstructActor
        parity, gcs_actor_manager.h:513)."""
        with self._lock:
            info = self._actors.get(actor_id)
            if info is None:
                return ActorState.DEAD
            if info.max_restarts < 0 or info.num_restarts < info.max_restarts:
                info.num_restarts += 1
                info.state = ActorState.RESTARTING
            else:
                info.state = ActorState.DEAD
                info.death_cause = cause
            state = info.state
        self._pubsub.publish("actor", (state.value, actor_id))
        return state

    def mark_dead(self, actor_id: ActorID, cause: str = "") -> None:
        with self._lock:
            info = self._actors.get(actor_id)
            if info is None:
                return
            info.state = ActorState.DEAD
            info.death_cause = cause
            if info.name:
                for key, aid in list(self._named.items()):
                    if aid == actor_id:
                        del self._named[key]
        self._pubsub.publish("actor", ("DEAD", actor_id))

    def get(self, actor_id: ActorID) -> Optional[ActorInfo]:
        with self._lock:
            return self._actors.get(actor_id)

    def get_by_name(self, name: str, namespace: str = "default") -> Optional[ActorInfo]:
        with self._lock:
            actor_id = self._named.get((namespace, name))
            return self._actors.get(actor_id) if actor_id else None

    def list_actors(self, job_id: Optional[JobID] = None) -> List[ActorInfo]:
        with self._lock:
            actors = list(self._actors.values())
        if job_id is not None:
            actors = [a for a in actors if a.job_id == job_id]
        return actors


# --------------------------------------------------------------------------
# Jobs (parity: GcsJobManager)
# --------------------------------------------------------------------------
class JobInfo:
    def __init__(self, job_id: JobID, entrypoint: str = "", metadata: Optional[dict] = None):
        self.job_id = job_id
        self.entrypoint = entrypoint
        self.metadata = metadata or {}
        self.start_time = time.time()
        self.end_time: Optional[float] = None
        self.status = "RUNNING"


class JobTable:
    def __init__(self):
        self._lock = threading.RLock()
        self._jobs: Dict[JobID, JobInfo] = {}

    def add(self, info: JobInfo) -> None:
        with self._lock:
            self._jobs[info.job_id] = info

    def finish(self, job_id: JobID, status: str = "SUCCEEDED") -> None:
        with self._lock:
            job = self._jobs.get(job_id)
            if job:
                job.status = status
                job.end_time = time.time()

    def get(self, job_id: JobID) -> Optional[JobInfo]:
        with self._lock:
            return self._jobs.get(job_id)

    def list_jobs(self) -> List[JobInfo]:
        with self._lock:
            return list(self._jobs.values())


# --------------------------------------------------------------------------
# Task events (parity: GcsTaskManager — bounded, evicting store)
# --------------------------------------------------------------------------
class TaskEventStore:
    def __init__(self, max_entries: Optional[int] = None):
        self._lock = threading.RLock()
        self._events: deque = deque(maxlen=max_entries or get_config().task_events_max_entries)

    def add(self, event: dict) -> None:
        with self._lock:
            self._events.append(event)

    def list_events(self, limit: int = 1000) -> List[dict]:
        with self._lock:
            items = list(self._events)
        return items[-limit:]

    def __len__(self):
        with self._lock:
            return len(self._events)


# --------------------------------------------------------------------------
# The control service itself
# --------------------------------------------------------------------------
class ControlService:
    def __init__(self):
        self.kv = InternalKV()
        self.pubsub = PubSub()
        self.nodes = NodeTable(self.pubsub)
        self.actors = ActorDirectory(self.pubsub)
        self.jobs = JobTable()
        self.task_events = TaskEventStore()
        # finished tracing spans (observability/tracing.py), kept separate
        # from task-state records so state-API task listings/summaries stay
        # span-free; ray_tpu_torch.timeline() merges the two streams
        self.spans = TaskEventStore()
        from ray_tpu_torch.runtime.placement import PlacementGroupManager

        self.placement_groups = PlacementGroupManager(self.nodes, self.pubsub)
        self._health_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # actor ids restored as RESTARTING by restore_snapshot — the fabric
        # arms a reconciliation deadline for them (never-rejoining hosts
        # must surface ActorDiedError, not hang callers forever)
        self.restored_restarting: List[ActorID] = []

    # ---------------------------------------------------------- persistence
    # Parity: GCS fault tolerance (RedisStoreClient-backed GcsTableStorage,
    # gcs_table_storage.h:238): the durable cluster-level state — internal
    # KV, job history, task events — snapshots to disk and reloads on the
    # next runtime start. Node/actor liveness is process state and is
    # rebuilt live, exactly as raylets re-register with a restarted GCS.
    def snapshot_state(self) -> dict:
        kv_data = self.kv.snapshot()
        jobs = [
            {
                "job_id": info.job_id.binary(),
                "entrypoint": info.entrypoint,
                "metadata": info.metadata,
                "start_time": info.start_time,
                "end_time": info.end_time,
                "status": info.status,
            }
            for info in self.jobs.list_jobs()
        ]
        # Actor RECORDS (identity, names, restart budget) persist so a
        # restarted head can reconcile rejoining agents' live instances and
        # resolve get_actor(name); liveness itself is rebuilt from those
        # rejoin reports (reference: GcsActorManager records in
        # gcs_table_storage.h:238; raylet rejoin core_worker.proto:443).
        actors = []
        with self.actors._lock:
            named = {aid: key for key, aid in self.actors._named.items()}
            for info in self.actors._actors.values():
                actors.append(
                    {
                        "actor_id": info.actor_id.binary(),
                        "name": info.name,
                        "namespace": named.get(info.actor_id, (None, None))[0],
                        "class_name": info.class_name,
                        "max_restarts": info.max_restarts,
                        "num_restarts": info.num_restarts,
                        "job_id": info.job_id.binary(),
                        "dead": info.state is ActorState.DEAD,
                        "death_cause": info.death_cause,
                    }
                )
        from ray_tpu_torch.runtime import failpoints

        return {
            "version": 1,
            "kv": kv_data,
            "jobs": jobs,
            "actors": actors,
            "task_events": self.task_events.list_events(limit=len(self.task_events)),
            # finished spans ride along so the chaos sweep's retry-span
            # audit (invariant 5) survives a head restart
            "spans": self.spans.list_events(limit=len(self.spans)),
            # failpoint hit counters + fault log: same-seed chaos fault logs
            # must stay byte-identical THROUGH a head restart
            "failpoints": failpoints.snapshot_state(),
            # incarnation counters: a restarted head must never re-mint an
            # incarnation a fenced epoch already held, or fencing breaks
            "node_incarnations": self.nodes.incarnation_snapshot(),
        }

    _snapshot_write_lock = threading.Lock()

    #: snapshot framing: magic + blake2b-16(payload) + payload.  The digest
    #: rejects a torn/truncated file outright; the ``.prev`` generation kept
    #: by save_snapshot is the fallback a rejected file restores from.
    _SNAP_MAGIC = b"RTSNAP1\n"

    def save_snapshot(self, path: str) -> None:
        """Crash-atomic snapshot write: temp file + fsync + rename, with the
        previous generation rotated to ``<path>.prev`` first.  A head killed
        at ANY instant (``kill_head`` chaos, kill -9) leaves either the new
        complete snapshot, or the previous complete one — never a torn file
        a restart would restore."""
        import hashlib
        import os
        import pickle

        # serialized: the periodic writer and the shutdown save share the
        # tmp path; concurrent writes would publish a torn snapshot
        with self._snapshot_write_lock:
            payload = pickle.dumps(self.snapshot_state())
            digest = hashlib.blake2b(payload, digest_size=16).digest()
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(self._SNAP_MAGIC + digest + payload)
                f.flush()
                os.fsync(f.fileno())  # bytes durable BEFORE the rename publishes them
            if os.path.exists(path):
                # keep the last good generation: if the crash lands between
                # the two renames, restore falls back to .prev
                os.replace(path, path + ".prev")
            os.replace(tmp, path)   # atomic: readers never see a torn file
            try:
                dir_fd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
                try:
                    os.fsync(dir_fd)  # the renames themselves survive power loss
                finally:
                    os.close(dir_fd)
            except OSError:
                pass

    @classmethod
    def _load_snapshot_file(cls, path: str):
        """One snapshot file -> state dict, or None if missing/torn.  The
        digest check rejects truncated and bit-flipped files before pickle
        ever sees them; headerless files fall back to plain pickle (legacy
        snapshots from before the framing)."""
        import hashlib
        import logging
        import os
        import pickle

        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                raw = f.read()
            if raw.startswith(cls._SNAP_MAGIC):
                off = len(cls._SNAP_MAGIC)
                digest, payload = raw[off:off + 16], raw[off + 16:]
                if hashlib.blake2b(payload, digest_size=16).digest() != digest:
                    raise ValueError("snapshot digest mismatch (torn/partial write)")
                return pickle.loads(payload)
            return pickle.loads(raw)
        except Exception:  # noqa: BLE001 — persistence must not brick init()
            logging.getLogger(__name__).exception(
                "control snapshot %s unreadable/torn; trying fallback", path
            )
            return None

    def restore_snapshot(self, path: str) -> bool:
        import logging

        from ray_tpu_torch.runtime import failpoints

        state = self._load_snapshot_file(path)
        if state is None:
            # torn/missing current generation: the previous complete one
            # (rotated by save_snapshot) is strictly better than empty
            state = self._load_snapshot_file(path + ".prev")
            if state is None:
                return False
            logging.getLogger(__name__).warning(
                "control snapshot %s rejected; restored previous generation %s",
                path, path + ".prev",
            )
        self.kv.restore(state.get("kv", {}))
        max_job = 0
        for row in state.get("jobs", []):
            job_id = JobID(row["job_id"])
            max_job = max(max_job, job_id.int_value())
            info = JobInfo(job_id, row["entrypoint"], row["metadata"])
            info.start_time = row["start_time"]
            info.end_time = row["end_time"]
            # RUNNING jobs from a dead runtime did not survive it
            info.status = "FAILED" if row["status"] == "RUNNING" else row["status"]
            self.jobs.add(info)
        # a fresh process restarts the JobID counter at 0 — new driver jobs
        # must not overwrite restored history
        JobID.ensure_above(max_job)
        for row in state.get("actors", []):
            # dead actors keep their record (death_cause introspection) but
            # release their name — mark_dead would have freed it live
            info = ActorInfo(
                ActorID(row["actor_id"]),
                None if row.get("dead") else row["name"],
                row["max_restarts"],
                JobID(row["job_id"]), class_name=row.get("class_name", ""),
            )
            info.num_restarts = row.get("num_restarts", 0)
            if row.get("dead"):
                info.state = ActorState.DEAD
                info.death_cause = row.get("death_cause")
            else:
                # not dead, but its node binding did not survive the old
                # head: RESTARTING until the hosting agent rejoins and
                # reports the instance alive (reconcile_rejoined_actors)
                info.state = ActorState.RESTARTING
                self.restored_restarting.append(info.actor_id)
            try:
                self.actors.register(info, namespace=row.get("namespace") or "default")
            except ValueError:
                pass  # name collision with a live record wins
        for event in state.get("task_events", []):
            self.task_events.add(event)
        for event in state.get("spans", []):
            self.spans.add(event)
        # resume the failpoint decision streams exactly where the dead head
        # left them (counters merge forward; a no-op when nothing was armed)
        failpoints.restore_state(state.get("failpoints") or {})
        self.nodes.restore_incarnations(state.get("node_incarnations") or {})
        return True

    # health-check loop (GcsHealthCheckManager parity)
    def start_health_checks(self, on_node_dead: Callable[[NodeID], None]) -> None:
        cfg = get_config()

        def loop():
            while not self._stop.wait(cfg.health_check_period_s):
                for node_id in self.nodes.check_health(cfg.health_check_failure_threshold):
                    try:
                        on_node_dead(node_id)
                    except Exception:
                        pass

        self._health_thread = threading.Thread(target=loop, name="control-health", daemon=True)
        self._health_thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=2)
            self._health_thread = None
