"""Two-level distributed scheduler.

The port's copy of ``ray_tpu/runtime/scheduler.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Parity with the reference (``src/ray/raylet/scheduling/``):

  * :class:`ClusterScheduler` — the cluster-wide decision: pick the best node
    for a task or spill it over (``cluster_task_manager.h:42``), using the
    **hybrid** policy (pack until a utilization threshold, then spread;
    random tie-break among top-k — ``policy/hybrid_scheduling_policy.cc:48-59``),
    plus spread / node-affinity / placement-group policies.
  * :class:`LocalScheduler` — per-node dispatch once dependencies are local
    (``local_task_manager.h:58``): tasks wait first on their argument objects
    (DependencyManager parity, ``dependency_manager.h:51``), then on
    resources, then dispatch to an executor.

TPU-first deltas: dispatch hands tasks to in-process executors (device
command queue / thread pool / process pool) instead of leasing worker
processes over RPC — the lease round-trip disappears, which is most of the
reference's per-task latency (SURVEY §3.2).  Gang-scheduling of SPMD programs
uses placement groups (STRICT_PACK = one ICI domain).
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.ids import ActorID, NodeID, ObjectID, PlacementGroupID, TaskID
from ray_tpu_torch.core.resources import ResourcePool, ResourceSet
from ray_tpu_torch.core.sync import join_threads, when_all
from ray_tpu_torch.observability import metric_defs

# prebuilt tag dicts: the locality stage runs per placement decision
_LOCALITY_HIT = {"result": "hit"}
_LOCALITY_MISS = {"result": "miss"}


# --------------------------------------------------------------------------
# Scheduling strategies (parity: python/ray/util/scheduling_strategies.py)
# --------------------------------------------------------------------------
class PlacementGroupSchedulingStrategy:
    def __init__(self, placement_group, placement_group_bundle_index: int = -1, placement_group_capture_child_tasks: bool = False):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = placement_group_capture_child_tasks


class NodeAffinitySchedulingStrategy:
    def __init__(self, node_id, soft: bool = False):
        self.node_id = node_id
        self.soft = soft


class NodeLabelSchedulingStrategy:
    def __init__(self, hard: Optional[dict] = None, soft: Optional[dict] = None):
        self.hard = hard or {}
        self.soft = soft or {}


# --------------------------------------------------------------------------
# Task specification (parity: src/ray/common/task/task_spec.h)
# --------------------------------------------------------------------------
class TaskSpec:
    __slots__ = (
        "task_id", "name", "func", "args", "kwargs", "dependencies",
        "num_returns", "return_ids", "resources", "max_retries",
        "retries_left", "execution", "actor_id", "scheduling_strategy",
        "runtime_env", "owner_node", "is_actor_creation", "actor_method",
        "attempt", "submit_time", "start_time", "_retry_exceptions", "_cancelled",
        "_oom_killed", "_stream_closed", "_actor_seq", "trace_ctx",
        "_leased", "_push_reply",
        "deadline_ts", "deadline_s", "hedge_after_s",
        "_stage", "_deadline_fired", "_deadline_stage", "_hedge",
    )

    def __init__(
        self,
        task_id: TaskID,
        name: str,
        func: Any,
        args: Tuple,
        kwargs: dict,
        dependencies: Sequence[ObjectID],
        num_returns: int,
        return_ids: List[ObjectID],
        resources: ResourceSet,
        max_retries: int = 0,
        execution: str = "auto",
        actor_id: Optional[ActorID] = None,
        scheduling_strategy: Any = None,
        runtime_env: Optional[dict] = None,
        owner_node: Optional[NodeID] = None,
        is_actor_creation: bool = False,
        actor_method: Optional[str] = None,
    ):
        self.task_id = task_id
        self.name = name
        self.func = func
        self.args = args
        self.kwargs = kwargs
        self.dependencies = list(dependencies)
        self.num_returns = num_returns
        self.return_ids = return_ids
        self.resources = resources
        self.max_retries = max_retries
        self.retries_left = max_retries
        self.execution = execution
        self.actor_id = actor_id
        self.scheduling_strategy = scheduling_strategy
        self.runtime_env = runtime_env
        self.owner_node = owner_node
        self.is_actor_creation = is_actor_creation
        self.actor_method = actor_method
        self.attempt = 0
        self.submit_time = 0.0
        self.start_time = 0.0
        self._retry_exceptions = False
        self._cancelled = False
        self._oom_killed = False
        self._stream_closed = False
        # per-actor submission-order stamp, assigned on first enqueue;
        # retries reinsert by it (see Cluster.submit_actor_task)
        self._actor_seq = None
        # propagated trace context (trace_id, task_span_id, parent_span_id)
        # stamped at submit time when tracing is enabled (tracing.py)
        self.trace_ctx = None
        # dispatched through a cached worker lease (direct dispatch): the
        # hosting node may pin a process worker to the task's shape
        self._leased = False
        # agent-side: (box, event) of a peer-pushed task — the completion
        # frames go back on the data-plane connection to the OWNER instead
        # of the head control channel (owner-routed results)
        self._push_reply = None
        # end-to-end deadline (wall-clock absolute + the original budget for
        # error messages); None = no deadline.  Stamped by CoreWorker.submit
        # from .options(deadline_s=) min'd with any inherited parent budget.
        self.deadline_ts = None
        self.deadline_s = None
        # hedged straggler retry threshold (.options(hedge_after_s=)); the
        # watchdog launches a second attempt on a different node past it
        self.hedge_after_s = None
        # owner-side lifecycle stage for deadline attribution: parked /
        # queued / pulling / executing (best-effort; remote nodes report
        # coarser — the owner sees "queued" until completion)
        self._stage = "queued"
        self._deadline_fired = False
        self._deadline_stage = None
        # hedge-group handle while this spec participates in a hedged pair
        # (watchdog._HedgeGroup); completions arbitrate first-commit-wins
        self._hedge = None


# --------------------------------------------------------------------------
# Cluster-level policies
# --------------------------------------------------------------------------
class ClusterScheduler:
    """Cluster-wide node choice over all nodes' resource pools.

    In-process "ray_syncer": node pools are shared objects, so the resource
    view is always fresh (the reference syncs views over bidi gRPC streams,
    ``ray_syncer.h:88``; multi-host mode will do the same over the transport
    layer).
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._pools: Dict[NodeID, ResourcePool] = {}
        self._labels: Dict[NodeID, dict] = {}
        self._alive: Dict[NodeID, bool] = {}
        # DRAINING nodes (graceful removal in progress): still alive — their
        # running work finishes and their objects evacuate — but pick_node
        # never places NEW tasks/actors there, including parked demand-queue
        # entries re-resolving (DrainRaylet lease rejection parity).
        self._draining: set = set()
        self._queue_lens: Dict[NodeID, Callable[[], int]] = {}
        # object directory for the locality stage (bound by the cluster
        # fabric; None = locality disabled, e.g. bare unit tests)
        self._directory = None
        # head scheduling decisions made (every pick_node call).  THE
        # O(tasks)-vs-O(lease churn) witness: a steady-state repeat-shape
        # workload must grow this by the number of lease grants, not the
        # number of tasks.  Racy += under the GIL only ever UNDER-counts,
        # which keeps upper-bound assertions sound.
        self.num_picks = 0

    def bind_directory(self, directory) -> None:
        """Wire the object directory so pick_node can score candidate nodes
        by local dependency bytes (locality_with_output parity)."""
        self._directory = directory

    def register_node(
        self,
        node_id: NodeID,
        pool: ResourcePool,
        labels: Optional[dict] = None,
        queue_len: Optional[Callable[[], int]] = None,
    ) -> None:
        with self._lock:
            self._pools[node_id] = pool
            self._labels[node_id] = labels or {}
            self._alive[node_id] = True
            if queue_len is not None:
                self._queue_lens[node_id] = queue_len

    def _queued(self, node_id: NodeID) -> int:
        fn = self._queue_lens.get(node_id)
        try:
            return fn() if fn is not None else 0
        except Exception:
            return 0

    def remove_node(self, node_id: NodeID) -> None:
        with self._lock:
            self._alive[node_id] = False
            self._draining.discard(node_id)

    def set_draining(self, node_id: NodeID, draining: bool = True) -> None:
        """Flip a node's DRAINING bit: a draining node is excluded from
        every placement decision until it either terminates (remove_node)
        or the drain is cancelled."""
        with self._lock:
            if draining:
                self._draining.add(node_id)
            else:
                self._draining.discard(node_id)

    def is_draining(self, node_id: NodeID) -> bool:
        with self._lock:
            return node_id in self._draining

    def node_pools(self) -> Dict[NodeID, ResourcePool]:
        with self._lock:
            return {nid: p for nid, p in self._pools.items() if self._alive.get(nid)}

    def pick_node(self, spec: TaskSpec, exclude=()) -> Optional[NodeID]:
        """Returns the chosen node, or None if currently infeasible.
        ``exclude`` removes specific nodes from every policy — hedged
        retries use it to force the second attempt onto a DIFFERENT node
        than the (possibly straggling) primary."""
        self.num_picks += 1
        cfg = get_config()
        strategy = spec.scheduling_strategy
        with self._lock:
            # draining nodes are filtered out of EVERY policy below — the
            # single-node fast path, affinity fallbacks, SPREAD, locality,
            # hybrid — and of demand-queue re-resolution (which re-enters
            # here); a drain must stop new placements atomically
            alive = [
                (nid, self._pools[nid])
                for nid, ok in self._alive.items()
                if ok and nid not in self._draining and nid not in exclude
            ]
        if not alive:
            return None
        if len(alive) == 1 and strategy is None:
            # single-node fast path (the common laptop/head-only case):
            # no scoring — fits-total means run-or-queue here
            nid, pool = alive[0]
            return nid if spec.resources.fits(pool.total) else None

        if isinstance(strategy, NodeAffinitySchedulingStrategy):
            target = strategy.node_id
            for nid, pool in alive:
                if nid == target:
                    if spec.resources.fits(pool.total):
                        return nid  # queues locally if currently busy
                    return None if not strategy.soft else self._hybrid(alive, spec, cfg)
            return self._hybrid(alive, spec, cfg) if strategy.soft else None

        if isinstance(strategy, PlacementGroupSchedulingStrategy):
            pg = strategy.placement_group
            info = pg._info if hasattr(pg, "_info") else pg
            idx = strategy.placement_group_bundle_index
            placements = info.bundle_placements
            if not placements:
                return None
            if idx >= 0:
                return placements.get(idx)
            # any bundle's node that fits
            for bundle_idx, nid in placements.items():
                pool = self._pools.get(nid)
                if pool and spec.resources.fits(pool.available):
                    return nid
            return next(iter(placements.values()))

        if isinstance(strategy, NodeLabelSchedulingStrategy):
            feasible = [
                (nid, pool) for nid, pool in alive
                if all(self._labels.get(nid, {}).get(k) == v for k, v in strategy.hard.items())
            ]
            if not feasible:
                return None
            soft = [
                (nid, pool) for nid, pool in feasible
                if all(self._labels.get(nid, {}).get(k) == v for k, v in strategy.soft.items())
            ]
            return self._hybrid(soft or feasible, spec, cfg)

        if strategy == "SPREAD":
            feasible = [(nid, p) for nid, p in alive if spec.resources.fits(p.available)]
            if not feasible:
                feasible = [(nid, p) for nid, p in alive if spec.resources.fits(p.total)]
            if not feasible:
                return None
            return self._pick_with_locality(
                feasible, spec, cfg,
                lambda: min(feasible, key=lambda kv: (self._queued(kv[0]), kv[1].utilization()))[0],
            )

        if spec.dependencies and self._directory is not None:
            feasible = [(nid, p) for nid, p in alive if spec.resources.fits(p.total)]
            return self._pick_with_locality(
                feasible, spec, cfg, lambda: self._hybrid(alive, spec, cfg)
            )
        return self._hybrid(alive, spec, cfg)  # no-dep hot path: zero overhead

    def _pick_with_locality(
        self,
        feasible: List[Tuple[NodeID, ResourcePool]],
        spec: TaskSpec,
        cfg,
        fallback: Callable[[], Optional[NodeID]],
    ) -> Optional[NodeID]:
        """Locality stage (reference: locality_with_output,
        lease_policy.cc): rank feasible nodes by the dependency bytes the
        directory says they already hold; prefer the leader when it beats
        the runner-up by at least ``scheduler_locality_threshold_bytes``.
        Ties and small-arg tasks fall back to the wrapped policy — locality
        must never override load balance for cheap-to-move args."""
        directory = self._directory
        deps = spec.dependencies
        threshold = cfg.scheduler_locality_threshold_bytes
        # multi-node decisions only: with one candidate there is no
        # placement choice to make (or to count in the hit/miss metric)
        if not deps or directory is None or threshold <= 0 or len(feasible) < 2:
            return fallback()
        by_node, total_known = directory.locality_view(deps)
        chosen = None
        if by_node:
            # stable sort on bytes only (NodeID has no ordering)
            ranked = sorted(
                ((by_node.get(nid, 0), nid) for nid, _pool in feasible),
                key=lambda t: t[0], reverse=True,
            )
            best_bytes, best_nid = ranked[0]
            if best_bytes >= ranked[1][0] + threshold:
                chosen = best_nid
        if chosen is None:
            chosen = fallback()
        if chosen is not None:
            hit = by_node.get(chosen, 0)
            miss = max(0, total_known - hit)
            if hit:
                metric_defs.SCHEDULER_LOCALITY_BYTES.inc(hit, tags=_LOCALITY_HIT)
            if miss:
                metric_defs.SCHEDULER_LOCALITY_BYTES.inc(miss, tags=_LOCALITY_MISS)
        return chosen

    def _hybrid(self, nodes: List[Tuple[NodeID, ResourcePool]], spec: TaskSpec, cfg) -> Optional[NodeID]:
        """Hybrid policy (hybrid_scheduling_policy.cc:48): prefer packing
        nodes under the spread threshold; score = utilization if under
        threshold else 1+utilization; random choice among top-k.

        A node that is merely BUSY (request fits its total but not its
        current availability) is still schedulable — the task queues in its
        LocalScheduler (raylet queueing parity).  None only when no node's
        total resources could ever satisfy the request."""
        available_now = [(nid, p) for nid, p in nodes if spec.resources.fits(p.available)]
        if available_now:
            thr = cfg.scheduler_spread_threshold

            def score(pool: ResourcePool) -> float:
                u = pool.utilization()
                return u if u < thr else 1.0 + u

            ranked = sorted(available_now, key=lambda kv: score(kv[1]))
            k = max(1, int(len(ranked) * cfg.scheduler_top_k_fraction))
            return random.choice(ranked[:k])[0]
        # All nodes busy: queue on the shortest local queue (not plain
        # utilization — queued tasks don't move `available`, so a
        # deterministic min() would pile the whole backlog on one node).
        eventually = [(nid, p) for nid, p in nodes if spec.resources.fits(p.total)]
        if not eventually:
            return None
        return min(eventually, key=lambda kv: (self._queued(kv[0]), kv[1].utilization(), random.random()))[0]


# --------------------------------------------------------------------------
# Worker leases (cached dispatch routes; reference parity:
# CoreWorkerDirectTaskSubmitter's lease cache — RequestWorkerLease reuse per
# SchedulingKey, direct_task_transport.cc:409 — with raylet spillback)
# --------------------------------------------------------------------------
class WorkerLease:
    """One cached dispatch route: scheduling key -> node.

    Holding the lease means repeat-shape tasks go STRAIGHT to this node's
    local scheduler (peer-to-peer for remote nodes) — the head's per-task
    work collapses to lease churn.  ``func``/``resources`` pin the key's
    referents so the id()-based key cannot be recycled while the lease
    lives."""

    __slots__ = (
        "key", "node_id", "func", "resources",
        "granted_at", "last_used", "uses", "last_spill_check",
    )

    def __init__(self, key, node_id, func, resources):
        now = time.monotonic()
        self.key = key
        self.node_id = node_id
        self.func = func
        self.resources = resources
        self.granted_at = now
        self.last_used = now
        self.uses = 0
        self.last_spill_check = 0.0


# prebuilt tag dicts for the per-task hot path
_GRANT_MISS = {"reason": "miss"}
_GRANT_SPILLBACK = {"reason": "spillback"}


class LeaseManager:
    """Grant/reuse/return of worker leases, keyed by task shape.

    A scheduling key is ``(function identity, resource-demand identity,
    execution tier)`` — the same shape the reference's SchedulingKey
    captures.  The FIRST task of a shape pays one head scheduling decision
    (``ClusterScheduler.pick_node``) and caches the chosen node as a lease;
    every repeat-shape task reuses it with zero head-side work.  Leases
    return on idle expiry, revoke on node death/DRAINING, and spill back to
    a fresh grant when the leased node's local queue saturates while an
    alternative exists (raylet spillback parity).

    Only dependency-free, strategy-free, non-streaming normal tasks are
    lease-eligible (the caller checks) — dep-bearing tasks keep the
    locality stage, strategies keep their policies."""

    def __init__(self, cluster):
        self._cluster = cluster
        self._lock = threading.Lock()
        self._by_key: Dict[tuple, List[WorkerLease]] = {}
        self._rr: Dict[tuple, int] = {}
        self._next_sweep = 0.0
        # periodic expiry driver (lazily started on first grant): route()
        # also sweeps, but once lease-eligible submissions stop, nothing
        # else would ever expire the last leases or return their pinned
        # workers to the idle pool
        self._sweep_stop = threading.Event()
        self._sweep_thread: Optional[threading.Thread] = None
        # lifetime stats (snapshot + /api/leases; racy ints are fine)
        self.grants = 0
        self.reuse_hits = 0
        self.spillbacks = 0
        self.expired = 0
        self.revoked = 0

    def stop(self) -> None:
        self._sweep_stop.set()
        with self._lock:
            sweeper = self._sweep_thread
        if sweeper is not None:
            join_threads([sweeper])

    def _ensure_sweeper(self) -> None:
        # called under self._lock
        if self._sweep_thread is None and not self._sweep_stop.is_set():
            self._sweep_thread = threading.Thread(
                target=self._sweep_loop, name="lease-sweep", daemon=True
            )
            self._sweep_thread.start()

    def _sweep_loop(self) -> None:
        while True:
            try:
                interval = max(0.5, get_config().lease_idle_timeout_s / 2.0)
            except Exception:  # noqa: BLE001 — config torn down at exit
                return
            if self._sweep_stop.wait(interval):
                return
            try:
                self._sweep(time.monotonic(), get_config())
                for node in list(self._cluster.nodes.values()):
                    # head-local pools never see the remote agents' report-
                    # cadence pin sweep; stubs without the hook are skipped
                    sweep = getattr(getattr(node, "worker_pool", None),
                                    "sweep_stale_pins", None)
                    if sweep is not None and not node.dead:
                        sweep()
            except Exception:  # noqa: BLE001 — sweeping must not die mid-teardown
                pass

    @staticmethod
    def key_for(spec: TaskSpec) -> tuple:
        # id()-keyed on purpose: O(1) on the submit hot path. The lease
        # entry pins func/resources so neither id can be recycled while
        # cached (same pinning discipline as Node._fn_profile).
        return (id(spec.func), id(spec.resources), spec.execution)

    # ------------------------------------------------------------------
    def route(self, spec: TaskSpec):
        """The node to dispatch ``spec`` on — a cached lease (no scheduling
        decision) or a fresh grant (exactly one ``pick_node``).  None means
        currently infeasible: the caller takes the scheduled path, which
        parks the task on the demand queue."""
        cfg = get_config()
        if cfg.lease_idle_timeout_s <= 0:
            return None
        key = self.key_for(spec)
        now = time.monotonic()
        if now >= self._next_sweep:
            self._sweep(now, cfg)
        leases = self._by_key.get(key)
        if leases:
            i = self._rr.get(key, 0)
            self._rr[key] = i + 1
            try:
                lease = leases[i % len(leases)]
            except (IndexError, ZeroDivisionError):
                lease = None  # raced a revoke; re-grant below
            if lease is not None:
                node = self._cluster.nodes.get(lease.node_id)
                if node is None or node.dead:
                    self._drop(key, lease, count_revoked=True)
                elif now - lease.last_used > cfg.lease_idle_timeout_s:
                    self._drop(key, lease, count_expired=True)
                elif self._saturated(node, lease, now, cfg):
                    self.spillbacks += 1
                    granted = self._grant(spec, key, _GRANT_SPILLBACK, cfg)
                    # nothing strictly better: keep the lease, queue here
                    return granted if granted is not None else node
                else:
                    lease.last_used = now
                    lease.uses += 1
                    self.reuse_hits += 1
                    metric_defs.LEASE_REUSE_HITS.inc()
                    metric_defs.HEAD_RPCS_AVOIDED.inc()
                    return node
        return self._grant(spec, key, _GRANT_MISS, cfg)

    # ------------------------------------------------------------------
    def _saturated(self, node, lease: WorkerLease, now: float, cfg) -> bool:
        depth = cfg.lease_spillback_queue_depth
        if depth <= 0:
            return False
        try:
            if node.scheduler.queue_len() < depth:
                return False
        except Exception:  # noqa: BLE001 — remote view mid-teardown
            return False
        # bounded re-evaluation: while saturated, re-run the (O(nodes))
        # alternative check at most every 50ms, not per pushed task
        if now - lease.last_spill_check < 0.05:
            return False
        lease.last_spill_check = now
        # snapshot: a node registering concurrently must not blow up the
        # submit path with "dict changed size during iteration"
        alive = sum(1 for n in list(self._cluster.nodes.values()) if not n.dead)
        return alive > 1

    def _grant(self, spec: TaskSpec, key: tuple, reason_tags: dict, cfg):
        node_id = self._cluster.cluster_scheduler.pick_node(spec)
        if node_id is None:
            return None
        node = self._cluster.nodes.get(node_id)
        if node is None or node.dead:
            return None
        now = time.monotonic()
        with self._lock:
            leases = self._by_key.setdefault(key, [])
            for lease in leases:
                if lease.node_id == node_id:
                    # the decision landed on an already-leased node (single
                    # node, or spillback found nothing better): refresh it
                    lease.last_used = now
                    return node
            lease = WorkerLease(key, node_id, spec.func, spec.resources)
            while len(leases) >= max(1, cfg.max_leases_per_key):
                stale = min(leases, key=lambda l: l.last_used)
                leases.remove(stale)
                self._return_worker(stale)
            leases.append(lease)
            self.grants += 1
            self._ensure_sweeper()
        metric_defs.LEASE_GRANTS.inc(tags=reason_tags)
        return node

    # ------------------------------------------------------------------
    def _drop(self, key: tuple, lease: WorkerLease,
              count_expired: bool = False, count_revoked: bool = False) -> None:
        with self._lock:
            leases = self._by_key.get(key)
            if leases is None:
                return
            try:
                leases.remove(lease)
            except ValueError:
                return  # a concurrent drop won
            if not leases:
                self._by_key.pop(key, None)
                self._rr.pop(key, None)
            # inside the lock: += is a read-modify-write, and concurrent
            # drops (sweeper vs. revoke vs. spillback) would lose counts
            if count_expired:
                self.expired += 1
            if count_revoked:
                self.revoked += 1
        self._return_worker(lease)

    def _return_worker(self, lease: WorkerLease) -> None:
        """Return the lease's pinned worker (if the shape ever dispatched
        to a process worker) to the pool's idle set so normal reaping
        applies — a returned lease must never strand a warm process."""
        node = self._cluster.nodes.get(lease.node_id)
        if node is None:
            return
        blob = getattr(lease.func, "_rt_fn_blob", None)
        if blob is None:
            return
        pool = getattr(node, "worker_pool", None)
        if pool is None:
            return
        try:
            pool.unpin_lease(blob[0])
        except Exception:  # noqa: BLE001 — pool torn down with the node
            pass

    def _sweep(self, now: float, cfg) -> None:
        """Expire every idle lease, not just the ones a route touches."""
        self._next_sweep = now + max(0.5, cfg.lease_idle_timeout_s / 2.0)
        with self._lock:
            stale = [
                (key, lease)
                for key, leases in self._by_key.items()
                for lease in leases
                if now - lease.last_used > cfg.lease_idle_timeout_s
            ]
        for key, lease in stale:
            self._drop(key, lease, count_expired=True)

    # ------------------------------------------------------------------
    def revoke_node(self, node_id) -> int:
        """Drop every lease routed at ``node_id`` (node death, DRAINING):
        the next repeat-shape task re-grants on a survivor.  Returns the
        number revoked."""
        dropped = []
        with self._lock:
            for key, leases in list(self._by_key.items()):
                for lease in list(leases):
                    if lease.node_id == node_id:
                        leases.remove(lease)
                        dropped.append(lease)
                if not leases:
                    self._by_key.pop(key, None)
                    self._rr.pop(key, None)
            self.revoked += len(dropped)
        for lease in dropped:
            self._return_worker(lease)
        return len(dropped)

    def leases_on(self, node_id) -> int:
        with self._lock:
            return sum(
                1
                for leases in self._by_key.values()
                for lease in leases
                if lease.node_id == node_id
            )

    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            entries = [
                {
                    "function": getattr(lease.func, "__name__", None)
                    or getattr(lease.func, "_rt_name", "?"),
                    "execution": lease.key[2],
                    "resources": lease.resources.to_dict(),
                    "node": lease.node_id.hex()[:8],
                    "uses": lease.uses,
                    "age_s": round(now - lease.granted_at, 3),
                    "idle_s": round(now - lease.last_used, 3),
                }
                for leases in self._by_key.values()
                for lease in leases
            ]
        # rt-lint: disable=lock-discipline -- observability counters: a
        # torn read skews one stats poll, never a grant/revoke decision
        return {
            "active": entries,
            "grants": self.grants,
            "reuse_hits": self.reuse_hits,
            "spillbacks": self.spillbacks,
            "expired": self.expired,
            "revoked": self.revoked,
        }


# --------------------------------------------------------------------------
# Local scheduler
# --------------------------------------------------------------------------
class LocalScheduler:
    """Per-node dispatch: deps → resources → executor.

    ``dispatch_fn(spec)`` is provided by the node runtime and must eventually
    call :meth:`on_task_done`.
    """

    def __init__(self, pool: ResourcePool, object_store, dispatch_fn: Callable[[TaskSpec], None],
                 metrics_tags: Optional[Dict[str, str]] = None):
        self._pool = pool
        self._store = object_store
        self._dispatch_fn = dispatch_fn
        self._lock = threading.Lock()
        self._ready: deque = deque()          # deps satisfied, waiting resources
        self._infeasible: List[TaskSpec] = []
        self._metrics_tags = metrics_tags
        self.num_submitted = 0
        self.num_dispatched = 0

    # ------------------------------------------------------------------
    def submit_ready(self, spec: TaskSpec) -> None:
        """Submit a task whose dependencies are already local."""
        self.num_submitted += 1
        self._enqueue_ready(spec)

    def submit(self, spec: TaskSpec) -> None:
        self.num_submitted += 1
        # Dependency manager: wait on all args, then enqueue.
        when_all(
            spec.dependencies,
            lambda dep, done: self._store.get_async(dep).add_done_callback(done),
            lambda: self._enqueue_ready(spec),
        )

    def _enqueue_ready(self, spec: TaskSpec) -> None:
        spec._stage = "queued"  # deps local; waiting on node resources
        dispatch_now = False
        with self._lock:
            if not self._ready and self._pool.acquire(spec.resources):
                dispatch_now = True
            else:
                self._ready.append(spec)
                depth = len(self._ready)
        if dispatch_now:
            self._run(spec)
        else:
            metric_defs.SCHEDULER_QUEUE_DEPTH.set(depth, self._metrics_tags)
            self._drain()

    def _drain(self) -> None:
        cfg = get_config()
        drained = False
        while True:
            to_run = None
            with self._lock:
                if self._ready and self._pool.acquire(self._ready[0].resources):
                    to_run = self._ready.popleft()
                    drained = True
                elif drained:
                    depth = len(self._ready)
            if to_run is None:
                if drained:
                    metric_defs.SCHEDULER_QUEUE_DEPTH.set(depth, self._metrics_tags)
                return
            self._run(to_run)

    def _run(self, spec: TaskSpec) -> None:
        self.num_dispatched += 1
        metric_defs.SCHEDULER_TASKS_DISPATCHED.inc(tags=self._metrics_tags)
        try:
            self._dispatch_fn(spec)
        except Exception:
            self._pool.release(spec.resources)
            raise

    # ------------------------------------------------------------------
    def on_task_done(self, spec: TaskSpec) -> None:
        self._pool.release(spec.resources)
        self._drain()

    def release_blocked(self, spec: TaskSpec) -> None:
        """The task's worker blocked in a nested get/wait: return its
        resources so children can dispatch (blocked-worker CPU release,
        reference raylet NotifyUnblocked role)."""
        self._pool.release(spec.resources)
        self._drain()

    def reacquire_blocked(self, spec: TaskSpec) -> None:
        """Wake from a nested block: take the resources back.  Forced —
        refusing would deadlock the parent; the oversubscription lasts only
        until currently-running tasks finish."""
        self._pool.force_acquire(spec.resources)

    def cancel_queued(self, spec: TaskSpec) -> bool:
        """Remove a ready-queued (resources-waiting) task.  True iff it was
        removed HERE — its resources were never acquired, so the caller
        commits the cancellation without an on_task_done release."""
        with self._lock:
            try:
                self._ready.remove(spec)
                return True
            except ValueError:
                return False

    def queue_len(self) -> int:
        return len(self._ready)

    def stats(self) -> dict:
        with self._lock:
            return {
                "submitted": self.num_submitted,
                "dispatched": self.num_dispatched,
                "queued": len(self._ready),
                "available": self._pool.available.to_dict(),
            }
