"""Admission-controlled dependency pulls (parity: ``pull_manager.h:52``).

The port's copy of ``ray_tpu/runtime/pull_manager.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Every inbound object transfer in the in-process fabric funnels through one
:class:`PullManager` owned by the cluster.  It replaces the old ad-hoc
per-dependency copy in ``Cluster.pull_object`` with the reference
PullManager's load-bearing properties:

  * **dedup** — concurrent pulls of the same ``(object, destination)``
    coalesce into ONE in-flight transfer with a waiter list (N consumers of
    a shuffle block cost one copy, not N),
  * **admission** — bytes of ACTIVE transfers are capped by
    ``pull_manager_max_inflight_bytes``; located-but-over-budget transfers
    queue FIFO, so a burst of bulk args cannot buffer unbounded memory on
    the destination.  A pull idling for a not-yet-produced object holds no
    budget — lineage recovery's own dependency pulls can never deadlock
    behind the pull that triggered the recovery,
  * **dedicated transfer threads** — the blocking source read
    (``src.store.get``, which for remote sources is a chunked data-plane
    pull) runs on a small pull-worker pool, never on directory callback
    threads (the old path parked object-commit threads behind 30 s gets),
  * **retry with backoff + source purge** — a failed source's location is
    removed from the directory BEFORE re-resolving, so a wedged-but-alive
    node is not retried in a hot loop (the old path re-waited without
    purging), and repeated failures back off exponentially,
  * **prefetch** — queued tasks' dependencies can be warmed in dispatch
    order (``prefetch``), pipelining transfers behind head-of-line waits,
  * **broadcast** — concurrent pulls of ONE object to >= 2 different
    destinations coalesce into a bounded-fanout spanning tree
    (:class:`_BroadcastPlan`, Cornet/Orchestra-style): the source serves
    at most ``broadcast_fanout`` direct children, every other destination
    parks budget-free under an earlier destination and transfers from it
    once that copy commits, late joiners attach under completed replicas,
    and a dead relay re-parents its subtree onto survivors through the
    purge-then-retry path.  (The JAX package also serves remote destination
    groups by one chunk-pipelined data-plane relay; the port runs one node
    and has no data plane yet, so it has no such relay.)

Chaos: the ``data_plane.send_frame`` and ``object_store.put`` failpoints
fire at the same logical points as the old path (a dropped "frame" retries
off-thread; a failed destination commit retries off-thread), so seeded
schedules keep reproducing; replica rotation is deterministic (no
randomness), so same (seed, schedule, workload) still yields identical
fault logs.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Set, Tuple

from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.ids import NodeID, ObjectID
from ray_tpu_torch.observability import metric_defs
from ray_tpu_torch.runtime import failpoints


class _Pull:
    """One registered transfer of an object to a destination."""

    __slots__ = ("oid", "dest", "waiters", "charged", "admitted", "attempts",
                 "src", "via_relay")

    def __init__(self, oid: ObjectID, dest, callback: Callable[[], None]):
        self.oid = oid
        self.dest = dest
        self.waiters: List[Callable[[], None]] = [callback]
        self.charged = 0        # bytes currently held against the budget
        self.admitted = False   # True while a transfer attempt is budgeted
        self.attempts = 0       # failed-source retries so far
        self.src: Optional[NodeID] = None  # source of the current attempt
        self.via_relay = False  # current attempt reads from a tree parent,
        #                         not the root — its bytes count as relayed


class _BroadcastPlan:
    """Bounded-fanout spanning tree for concurrent pulls of ONE object to
    many destinations (Cornet/Orchestra-style cooperative broadcast).

    The root is the source replica; each destination is attached under the
    first parent with spare fanout — completed members first (they can
    serve immediately, which is also where late joiners land), then the
    root, then pending members in attach order (those children PARK, no
    budget held, until their parent's copy commits).  Root egress is
    bounded at ``fanout`` direct children; every further copy is relayed by
    a destination.  All mutation happens under the PullManager's lock."""

    __slots__ = ("oid", "fanout", "root", "members", "order", "parent",
                 "children", "done", "failed", "parked")

    def __init__(self, oid: ObjectID, fanout: int):
        self.oid = oid
        self.fanout = max(1, fanout)
        self.root: Optional[NodeID] = None   # source replica, fixed on first locate
        self.members: Dict[NodeID, _Pull] = {}
        self.order: List[NodeID] = []        # attach order (parent scan order)
        self.parent: Dict[NodeID, Optional[NodeID]] = {}  # None = root slot
        self.children: Dict[Optional[NodeID], List[NodeID]] = {None: []}
        self.done: Set[NodeID] = set()
        self.failed: Set[NodeID] = set()
        self.parked: Set[NodeID] = set()

    def _capacity(self, nid: Optional[NodeID]) -> bool:
        return len(self.children.get(nid, ())) < self.fanout

    def _pick_parent(self) -> Optional[NodeID]:
        for nid in self.order:              # completed members serve NOW
            if nid in self.done and nid not in self.failed and self._capacity(nid):
                return nid
        if self._capacity(None):            # then the root's direct slots
            return None
        for nid in self.order:              # then pending members (child parks)
            if nid not in self.failed and self._capacity(nid):
                return nid
        live = [n for n in self.order if n not in self.failed]
        if live:                            # tree full: chain off the lightest
            return min(live, key=lambda n: (len(self.children.get(n, ())), n.binary()))
        return None

    def attach(self, p: _Pull) -> None:
        dest = p.dest.node_id
        parent = self._pick_parent()
        self.members[dest] = p
        self.order.append(dest)
        self.parent[dest] = parent
        self.children.setdefault(parent, []).append(dest)
        self.children.setdefault(dest, [])

    def reparent(self, dest: NodeID) -> Optional[NodeID]:
        """Failed parent: move ``dest`` under a completed member with spare
        fanout, else back under the root (surviving-replica fallback; the
        fanout bound yields to liveness here)."""
        old = self.parent.get(dest)
        siblings = self.children.get(old)
        if siblings is not None and dest in siblings:
            siblings.remove(dest)
        new = None
        for nid in self.order:
            if nid is not dest and nid in self.done and nid not in self.failed \
                    and self._capacity(nid):
                new = nid
                break
        self.parent[dest] = new
        self.children.setdefault(new, []).append(dest)
        return new

    def drained(self) -> bool:
        return all(m in self.done or m in self.failed for m in self.members)


class PullManager:
    def __init__(self, cluster):
        cfg = get_config()
        self.cluster = cluster
        self._lock = threading.Lock()
        self._pulls: Dict[Tuple[ObjectID, NodeID], _Pull] = {}
        # same-object pulls to DIFFERENT destinations (broadcast coalescing)
        self._by_oid: Dict[ObjectID, List[_Pull]] = {}
        self._plans: Dict[ObjectID, _BroadcastPlan] = {}
        self._fanout = cfg.broadcast_fanout
        # remote chained-pull bookkeeping for agents' locate_object requests:
        # oid -> {node_id: [children_assigned, in_flight, monotonic_ts,
        # assigned_parent]}.  In-flight entries are requesters mid-pull —
        # assignable as tree parents (their data server blocks until the
        # copy materializes); the parent pointer lets a completed/failed
        # child release its parent's slot and blocks assignment cycles.
        self._remote_chain: Dict[ObjectID, Dict[NodeID, list]] = {}
        # located transfers awaiting byte budget, FIFO: (pull, src_node_id, size)
        self._pending: "deque[Tuple[_Pull, NodeID, int]]" = deque()
        self._inflight_bytes = 0
        self._admitted = 0
        self._max_inflight = max(1, cfg.pull_manager_max_inflight_bytes)
        self._backoff_s = max(0.0, cfg.pull_manager_retry_backoff_s)
        self._closed = False
        self._executor = ThreadPoolExecutor(
            max_workers=max(1, cfg.max_concurrent_object_transfers),
            thread_name_prefix="pull-worker",
        )
        # lifetime counters (snapshot() / `rt pulls`)
        self.dedup_hits = 0
        self.retries = 0
        self.completed = 0
        self.bytes_pulled = 0
        self.plans_created = 0
        self.relay_bytes = 0

    # ------------------------------------------------------------------
    # public surface
    # ------------------------------------------------------------------
    def pull(self, oid: ObjectID, dest_node, callback: Callable[[], None]) -> None:
        """Ensure ``oid`` is (or becomes) readable in ``dest_node``'s store,
        then invoke ``callback``.  Concurrent pulls of the same
        ``(oid, dest)`` share one transfer."""
        if dest_node.store.contains(oid):
            callback()
            return
        key = (oid, dest_node.node_id)
        new_plan = False
        with self._lock:
            if self._closed:
                return
            existing = self._pulls.get(key)
            if existing is not None:
                existing.waiters.append(callback)
                self.dedup_hits += 1
                metric_defs.PULL_MANAGER_DEDUP_HITS.inc()
                return
            p = _Pull(oid, dest_node, callback)
            self._pulls[key] = p
            peers = self._by_oid.setdefault(oid, [])
            peers.append(p)
            # broadcast coalescing: >= 2 concurrent destinations for ONE
            # object become a bounded-fanout spanning tree — the source
            # serves at most `fanout` children, completed destinations
            # relay the rest (~N/fanout less root egress than N unicasts)
            plan = self._plans.get(oid)
            if plan is not None:
                plan.attach(p)
            elif self._fanout > 0 and len(peers) >= 2:
                plan = _BroadcastPlan(oid, self._fanout)
                for q in peers:
                    plan.attach(q)
                plan.root = peers[0].src  # may still be unlocated (None)
                self._plans[oid] = plan
                self.plans_created += 1
                new_plan = True
        if new_plan:
            metric_defs.BROADCAST_PLANS.inc()
        self._resolve(p)

    def prefetch(self, oids, dest_node) -> None:
        """Warm transfers for a queued task's dependencies (dispatch order):
        each missing object starts a pull, so by the time the task reaches
        the head of its queue the bytes are already moving (reference:
        PullManager pulls for queued lease requests, not just the active
        one).  Objects whose pull is already in flight are skipped WITHOUT
        joining the waiter list — a prefetch needs no completion signal,
        and repeat prefetches of a slow transfer must not grow its waiter
        list or inflate the dedup-hit metric."""
        for oid in oids:
            if dest_node.store.contains(oid):
                continue
            with self._lock:
                if (oid, dest_node.node_id) in self._pulls:
                    continue
            self.pull(oid, dest_node, _noop)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "inflight": self._admitted,
                "queued": len(self._pending),
                "inflight_bytes": self._inflight_bytes,
                "max_inflight_bytes": self._max_inflight,
                "dedup_hits": self.dedup_hits,
                "retries": self.retries,
                "completed": self.completed,
                "bytes_pulled": self.bytes_pulled,
                "broadcast_plans": self.plans_created,
                "relay_bytes": self.relay_bytes,
            }

    def broadcast_snapshot(self) -> dict:
        """Live broadcast-plan view (`rt pulls` / GET /api/pulls)."""
        with self._lock:
            active = [
                {
                    "oid": oid.hex()[:12],
                    "fanout": plan.fanout,
                    "dests": len(plan.members),
                    "done": len(plan.done),
                    "parked": len(plan.parked),
                    "root": plan.root.hex()[:8] if plan.root is not None else None,
                }
                for oid, plan in self._plans.items()
            ]
            return {
                "plans_total": self.plans_created,
                "relay_bytes": self.relay_bytes,
                "active": active,
            }

    def shutdown(self) -> None:
        with self._lock:
            self._closed = True
            self._pulls.clear()
            self._by_oid.clear()
            self._plans.clear()
            self._remote_chain.clear()
            self._pending.clear()
        # cancel_futures: queued transfers must not run against a cluster
        # mid-teardown, and the futures atexit hook must not join workers
        # parked in a 30 s store.get
        self._executor.shutdown(wait=False, cancel_futures=True)

    # ------------------------------------------------------------------
    # admission: budget is held only while a transfer attempt is active —
    # a pull waiting for its object to exist (or to be reconstructed)
    # charges nothing
    # ------------------------------------------------------------------
    def _admit_or_queue(self, p: _Pull, src_node_id: NodeID) -> None:
        """A source is known: start the transfer if the byte budget allows,
        else queue it FIFO (later arrivals never jump a waiting pull)."""
        with self._lock:
            if self._closed or p.admitted:
                return  # a concurrent wire relay already charged this pull
            p.src = src_node_id
            size = self.cluster.directory.object_size(p.oid)
            if not self._pending and (
                self._admitted == 0
                or self._inflight_bytes + size <= self._max_inflight
            ):
                self._charge_locked(p, size)
            else:
                self._pending.append((p, src_node_id, size))
                metric_defs.PULL_MANAGER_QUEUE_DEPTH.set(len(self._pending))
                return
        self._submit_transfer(p, src_node_id)

    def _charge_locked(self, p: _Pull, size: int) -> None:
        p.charged = size
        p.admitted = True
        self._admitted += 1
        self._inflight_bytes += size
        metric_defs.PULL_MANAGER_INFLIGHT_BYTES.set(self._inflight_bytes)

    def _uncharge(self, p: _Pull) -> None:
        """Return p's budget and start whatever it unblocks."""
        ready: List[Tuple[_Pull, NodeID]] = []
        with self._lock:
            if not p.admitted:
                return
            p.admitted = False
            self._admitted = max(0, self._admitted - 1)
            self._inflight_bytes = max(0, self._inflight_bytes - p.charged)
            p.charged = 0
            while self._pending and (
                self._admitted == 0
                or self._inflight_bytes + self._pending[0][2] <= self._max_inflight
            ):
                nxt, nxt_src, nxt_size = self._pending.popleft()
                if nxt.admitted:
                    continue  # a wire relay claimed it while it queued
                self._charge_locked(nxt, nxt_size)
                ready.append((nxt, nxt_src))
            metric_defs.PULL_MANAGER_INFLIGHT_BYTES.set(self._inflight_bytes)
            metric_defs.PULL_MANAGER_QUEUE_DEPTH.set(len(self._pending))
        for nxt, nxt_src in ready:
            self._submit_transfer(nxt, nxt_src)

    def _submit_transfer(self, p: _Pull, src_node_id: NodeID) -> None:
        src = self.cluster.nodes.get(src_node_id)
        if src is None or src.dead:
            # went away while queued: purge the stale location, return the
            # budget, and re-resolve for a fresh copy
            self.cluster.directory.remove_location(p.oid, src_node_id)
            self._uncharge(p)
            self._resolve(p)
            return
        # the blocking read runs on a pull worker, NEVER the caller thread —
        # callers include store-commit threads waking directory waiters
        try:
            self._executor.submit(self._transfer, p, src)
        except RuntimeError:  # executor shut down mid-teardown
            pass

    def _complete(self, p: _Pull) -> None:
        self._uncharge(p)
        promote: List[Tuple[_Pull, NodeID]] = []
        with self._lock:
            self._pulls.pop((p.oid, p.dest.node_id), None)
            peers = self._by_oid.get(p.oid)
            if peers is not None:
                try:
                    peers.remove(p)
                except ValueError:
                    pass
                if not peers:
                    self._by_oid.pop(p.oid, None)
            self.completed += 1
            waiters = list(p.waiters)
            plan = self._plans.get(p.oid)
            if plan is not None and p.dest.node_id in plan.members:
                dest = p.dest.node_id
                plan.done.add(dest)
                # this destination is now a replica: promote its parked
                # children — their edge transfers read from it, not the root
                for child in list(plan.children.get(dest, ())):
                    if child in plan.parked:
                        plan.parked.discard(child)
                        cp = plan.members.get(child)
                        if cp is not None:
                            cp.via_relay = True
                            promote.append((cp, dest))
                if plan.drained():
                    self._plans.pop(p.oid, None)
        for cp, src in promote:
            self._admit_or_queue(cp, src)
        for cb in waiters:
            try:
                cb()
            except Exception:  # noqa: BLE001 — one waiter must not strand the rest
                import sys
                import traceback

                print(
                    f"ray_tpu: pull waiter for object {p.oid.hex()[:12]} -> "
                    f"node {p.dest.node_id.hex()[:8]} raised:\n"
                    f"{traceback.format_exc()}",
                    file=sys.stderr,
                )

    # ------------------------------------------------------------------
    # location resolution (event-driven; cheap — safe on commit threads)
    # ------------------------------------------------------------------
    def _resolve(self, p: _Pull) -> None:
        # rt-lint: disable=lock-discipline -- one-way close gate: a
        # stale read just does doomed-but-harmless work one more time
        if self._closed:
            return
        directory = self.cluster.directory
        directory.wait_for(p.oid, lambda src: self._on_located(p, src))
        # if nothing will ever produce it, try lineage reconstruction
        if not directory.locations(p.oid) and not self.cluster._is_pending(p.oid):
            self.cluster._try_recover(p.oid)

    def _resolve_later(self, p: _Pull, delay: float) -> None:
        timer = threading.Timer(delay, self._resolve, args=(p,))
        timer.daemon = True
        timer.start()

    def _plan_route(self, p: _Pull, src_node_id: NodeID):
        """Broadcast routing decision for a located pull (self._lock held):
        returns ``("go", src)`` to start the edge transfer from ``src``, or
        ``("park", None)`` to wait (budget-free) for the assigned tree
        parent's copy to commit."""
        plan = self._plans.get(p.oid)
        if plan is None:
            return "go", src_node_id
        dest = p.dest.node_id
        if dest not in plan.members:
            return "go", src_node_id
        parent = plan.parent.get(dest)
        p.via_relay = False
        if parent is not None and (parent in plan.failed or parent not in plan.members):
            # the assigned parent died/left: re-parent onto a surviving
            # replica (completed member first, else back to the root)
            parent = plan.reparent(dest)
        if parent is None:
            # root child: pin the plan root on first locate so the tree has
            # ONE source, then route every root edge through it
            if plan.root is None:
                plan.root = src_node_id
            root = plan.root
            node = self.cluster.nodes.get(root) if root is not None else None
            if node is not None and not node.dead:
                return "go", root
            plan.root = None
            return "go", src_node_id
        if parent in plan.done:
            p.via_relay = True
            return "go", parent
        plan.parked.add(dest)
        return "park", None

    def _on_located(self, p: _Pull, src_node_id: Optional[NodeID]) -> None:
        # rt-lint: disable=lock-discipline -- one-way close gate: a
        # stale read just does doomed-but-harmless work one more time
        if self._closed:
            return
        cluster = self.cluster
        if src_node_id is None:
            # The object went out of scope while we waited.  Reconstruct
            # from lineage if possible; otherwise surface ObjectLostError
            # to the dependents instead of hanging them.
            if cluster._try_recover(p.oid):
                self._resolve(p)
                return
            from ray_tpu_torch.exceptions import ObjectLostError

            # Local error tombstone so dependent tasks fail fast; NOT
            # registered in the directory — the object is forgotten and no
            # other node must discover this node as a "location".
            p.dest.store.put(p.oid, ObjectLostError(p.oid), is_error=True)
            self._complete(p)
            return
        if src_node_id == p.dest.node_id:
            self._complete(p)
            return
        with self._lock:
            if p.admitted:
                return  # a wire relay already owns this pull's attempt
            action, src = self._plan_route(p, src_node_id)
        if action == "park":
            return  # promoted (budget-free) when the parent's copy commits
        self._admit_or_queue(p, src)

    # ------------------------------------------------------------------
    # the transfer itself (pull-worker threads only)
    # ------------------------------------------------------------------
    def _transfer(self, p: _Pull, src) -> None:
        try:
            self._transfer_inner(p, src)
        except Exception:  # noqa: BLE001 — NOTHING may leak budget/waiters
            # an unexpected failure (dest store MemoryError/arena-full,
            # entry_info race, directory error) must not strand the pull:
            # return the budget, report loudly, and retry with backoff —
            # a transient condition (memory pressure spilling) clears, a
            # permanent one shows up in the log instead of as silence
            import sys
            import traceback

            print(
                f"ray_tpu: pull of object {p.oid.hex()[:12]} -> node "
                f"{p.dest.node_id.hex()[:8]} failed unexpectedly:\n"
                f"{traceback.format_exc()}",
                file=sys.stderr,
            )
            with self._lock:
                self.retries += 1
            metric_defs.PULL_MANAGER_RETRIES.inc()
            p.attempts += 1
            self._uncharge(p)
            delay = min(self._backoff_s * (2 ** (p.attempts - 1)), 2.0)
            self._resolve_later(p, max(delay, 0.001))

    def _transfer_inner(self, p: _Pull, src) -> None:
        # rt-lint: disable=lock-discipline -- one-way close gate: a
        # stale read just does doomed-but-harmless work one more time
        if self._closed:
            return  # teardown: cluster state is going away under us
        cluster = self.cluster
        if p.dest.store.contains(p.oid):
            self._complete(p)
            return
        if failpoints.ARMED:
            # chaos: the in-process fabric's store-to-store copy IS its
            # data plane — a dropped "frame" here retries off-thread (a
            # Timer, not recursion: a p=1 partition must stall the pull,
            # not blow the stack or spin a worker)
            try:
                action = failpoints.fp("data_plane.send_frame")
            except failpoints.FailpointInjected:
                action = "drop"
            if action is not None:
                self._uncharge(p)
                self._resolve_later(p, 0.02)
                return
        try:
            value = src.store.get(p.oid, timeout=30)
        except Exception:  # noqa: BLE001 — wedged/emptied source
            # purge the failed location FIRST: without it a wedged-but-alive
            # source is retried in a hot loop forever (the pre-PullManager
            # bug); backoff doubles per attempt so a flapping source costs
            # bounded churn.  The budget returns while we back off.
            cluster.directory.remove_location(p.oid, src.node_id)
            with self._lock:
                self.retries += 1
            metric_defs.PULL_MANAGER_RETRIES.inc()
            p.attempts += 1
            self._uncharge(p)
            delay = min(self._backoff_s * (2 ** (p.attempts - 1)), 2.0)
            self._resolve_later(p, max(delay, 0.001))
            if not cluster.directory.locations(p.oid) and not cluster._is_pending(p.oid):
                cluster._try_recover(p.oid)
            return
        src_info = src.store.entry_info(p.oid)
        size = getattr(value, "nbytes", 0) or 0
        try:
            if failpoints.ARMED:
                failpoints.fp("object_store.put")  # raise/delay
            p.dest.store.put(
                p.oid, value, is_error=bool(src_info and src_info["is_error"])
            )
        except failpoints.FailpointInjected:
            # chaos: the destination commit failed — retry off-thread;
            # repeated failures keep consuming hit indices until the
            # deterministic decision stream lets one through
            self._uncharge(p)
            self._resolve_later(p, 0.02)
            return
        # chunked-transfer accounting (object_manager 5MiB chunks parity);
        # under the manager lock — multiple pull workers commit concurrently
        with self._lock:
            cluster.transfer_bytes += size
            cluster.transfer_count += 1
            self.bytes_pulled += size
            if p.via_relay:
                # this edge read from a tree parent, not the root — bytes
                # the broadcast spared the source from sending
                self.relay_bytes += size
        if p.via_relay and size:
            metric_defs.BROADCAST_RELAY_BYTES.inc(size)
        dest_info = p.dest.store.entry_info(p.oid)
        cluster.directory.add_location(
            p.oid, p.dest.node_id,
            size=dest_info["size"] if dest_info else None,
            tier=dest_info["tier"] if dest_info else None,
        )
        self._complete(p)

    # ------------------------------------------------------------------
    # broadcast: node death / remote chained-pull bookkeeping
    # ------------------------------------------------------------------
    def on_node_dead(self, node_id: NodeID) -> None:
        """A node died (cluster kill path).  A relay member's PARKED
        children re-resolve through the directory — replica-aware
        wait_for lands them on a surviving copy (the purge-then-retry
        path); in-flight children self-heal when their transfer fails."""
        resolves: List[_Pull] = []
        with self._lock:
            if self._closed:
                return
            for plan in self._plans.values():
                if plan.root == node_id:
                    plan.root = None
                if node_id in plan.members:
                    plan.failed.add(node_id)
                    plan.done.discard(node_id)
                    for child in list(plan.children.get(node_id, ())):
                        if child in plan.parked:
                            plan.parked.discard(child)
                            cp = plan.members.get(child)
                            if cp is not None:
                                resolves.append(cp)
            for table in self._remote_chain.values():
                if node_id in table:
                    self._chain_release_locked(table, node_id)
                    del table[node_id]
        for cp in resolves:
            self._resolve(cp)

    @staticmethod
    def _chain_release_locked(table: dict, node_id: NodeID) -> None:
        """The edge into ``node_id`` ended (commit/failure/staleness):
        return the assigned-child slot to its parent."""
        entry = table.get(node_id)
        if entry is None or entry[3] is None:
            return
        parent = table.get(entry[3])
        if parent is not None and parent[0] > 0:
            parent[0] -= 1
        entry[3] = None

    @staticmethod
    def _chain_ancestors(table: dict, node_id: NodeID, limit: int = 16):
        """Walk assigned-parent pointers upward (bounded)."""
        out = []
        entry = table.get(node_id)
        while entry is not None and entry[3] is not None and len(out) < limit:
            out.append(entry[3])
            entry = table.get(entry[3])
        return out

    def on_location_committed(self, oid: ObjectID, node_id: NodeID) -> None:
        """Directory observer: a copy committed somewhere.  A chained
        remote destination that was mid-pull is now a full replica, and
        its parent gets its assignment slot back."""
        with self._lock:
            table = self._remote_chain.get(oid)
            if table is not None:
                entry = table.get(node_id)
                if entry is not None:
                    entry[1] = False  # in-flight -> committed replica
                    self._chain_release_locked(table, node_id)

    def note_source_failed(self, oid: ObjectID, node_id: NodeID) -> None:
        """An agent reported a failed direct pull from this peer: drop it
        from chain assignment (the directory location is purged by the
        caller) so new pulls re-parent onto surviving replicas."""
        with self._lock:
            table = self._remote_chain.get(oid)
            if table is not None:
                self._chain_release_locked(table, node_id)
                table.pop(node_id, None)

    def assign_remote_source(self, oid: ObjectID, requester: NodeID) -> Optional[NodeID]:
        """Broadcast-aware source selection for an agent's ``locate_object``
        request.  Committed replicas are load-balanced with at most
        ``broadcast_fanout`` concurrently-assigned children each; once every
        replica is saturated, an IN-FLIGHT requester is assigned as a
        chained parent — its data server blocks until its copy
        materializes, so N simultaneous pulls form a tree instead of N
        point-to-point streams out of one producer.  Returns None when the
        caller's directory pick should stand."""
        fanout = self._fanout
        if fanout <= 0:
            return None
        kind = None
        now = time.monotonic()
        with self._lock:
            if self._closed:
                return None
            if len(self._remote_chain) > 512:
                # prune whole tables whose every entry went stale
                for key in [
                    k for k, t in self._remote_chain.items()
                    if all(now - e[2] > 90.0 for e in t.values())
                ]:
                    self._remote_chain.pop(key, None)
            table = self._remote_chain.setdefault(oid, {})
            for nid in [n for n, e in table.items() if e[1] and now - e[2] > 90.0]:
                # in-flight entry that never committed: stale — free its slot
                self._chain_release_locked(table, nid)
                del table[nid]
            committed = self.cluster.directory.locations(oid)
            for nid in committed:
                entry = table.get(nid)
                if entry is None:
                    table[nid] = [0, False, now, None]
                elif entry[1]:
                    entry[1] = False
                    self._chain_release_locked(table, nid)
            nodes = self.cluster.nodes
            cands = []
            n_committed = 0
            for nid, entry in table.items():
                if nid == requester:
                    continue
                node = nodes.get(nid)
                if node is None or getattr(node, "dead", False):
                    continue
                if entry[1] and requester in self._chain_ancestors(table, nid):
                    # chaining the requester behind a node that (transitively)
                    # pulls FROM the requester would deadlock both until the
                    # pull timeout — never close the loop
                    continue
                cands.append((entry[0], 1 if entry[1] else 0, nid.binary(), nid, entry))
                if not entry[1]:
                    n_committed += 1
            chosen = None
            if cands:
                under = [c for c in cands if c[0] < fanout and c[1] == 0]
                if not under:
                    under = [c for c in cands if c[0] < fanout]
                pick = min(under or cands)
                pick[4][0] += 1
                chosen = pick[3]
                kind = "relay" if pick[1] else ("balanced" if n_committed > 1 else "sole")
            # register the requester as an in-flight (assignable) copy and
            # record the edge so completion releases the parent's slot
            mine = table.get(requester)
            if mine is None:
                mine = table[requester] = [0, requester not in committed, now, None]
            else:
                mine[2] = now
            if chosen is not None:
                self._chain_release_locked(table, requester)  # drop any old edge
                mine[3] = chosen
        if kind is not None:
            metric_defs.PULL_SOURCE_SELECTED.inc(tags={"kind": kind})
        return chosen


def _noop() -> None:
    pass
