"""Autoscaler v2: declarative instance lifecycle management.

Parity: ``python/ray/autoscaler/v2/`` — the rewrite's shape is (a) an
``InstanceManager`` owning a per-instance state machine with validated
transitions and full history (``instance_manager/instance_manager.py``,
states mirroring ``instance_manager.proto``), and (b) a declarative
reconciler (``scheduler.py``): each tick computes the DESIRED node set
from demand, then converges tracked instances toward it by queueing
launches and terminations, stepping each instance through its lifecycle
against the ``NodeProvider``.

States (v2 proto subset):

    QUEUED -> REQUESTED -> ALLOCATED -> RUNNING -> STOPPING -> TERMINATED
       \\                     (provider up)  (joined fabric)
        -> ALLOCATION_FAILED (requeued up to max_retries)
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ray_tpu_torch.autoscaler.demand import NodeTypeConfig, get_nodes_to_launch
from ray_tpu_torch.autoscaler.node_provider import NodeProvider

logger = logging.getLogger(__name__)

# -- instance states (instance_manager.proto parity) -----------------------
QUEUED = "QUEUED"
REQUESTED = "REQUESTED"
ALLOCATED = "ALLOCATED"
RUNNING = "RUNNING"
STOPPING = "STOPPING"
TERMINATED = "TERMINATED"
ALLOCATION_FAILED = "ALLOCATION_FAILED"

_VALID_TRANSITIONS = {
    QUEUED: {REQUESTED, TERMINATED},
    REQUESTED: {ALLOCATED, ALLOCATION_FAILED},
    ALLOCATED: {RUNNING, STOPPING, TERMINATED},
    RUNNING: {STOPPING, TERMINATED},
    STOPPING: {TERMINATED},
    ALLOCATION_FAILED: {QUEUED, TERMINATED},
    TERMINATED: set(),
}


@dataclass
class Instance:
    instance_id: str
    node_type: str
    state: str = QUEUED
    provider_node_id: Optional[str] = None
    launch_attempt: int = 0
    created_ts: float = field(default_factory=time.monotonic)
    state_ts: float = field(default_factory=time.monotonic)
    history: List[tuple] = field(default_factory=list)  # (ts, from, to)


class InvalidTransitionError(RuntimeError):
    pass


class InstanceManager:
    """Owns instance records; every state change is validated and logged
    (parity: InstanceManager.update_instance_manager_state)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instances: Dict[str, Instance] = {}
        self._subscribers: List[Callable[[Instance, str, str], None]] = []

    def subscribe(self, cb: Callable[[Instance, str, str], None]) -> None:
        self._subscribers.append(cb)

    def create_instance(self, node_type: str) -> Instance:
        inst = Instance(instance_id=f"inst-{uuid.uuid4().hex[:10]}", node_type=node_type)
        with self._lock:
            self._instances[inst.instance_id] = inst
        return inst

    def transition(self, instance_id: str, new_state: str, **updates) -> Instance:
        with self._lock:
            inst = self._instances[instance_id]
            if new_state not in _VALID_TRANSITIONS[inst.state]:
                raise InvalidTransitionError(
                    f"{instance_id}: {inst.state} -> {new_state} is not a legal transition"
                )
            old = inst.state
            inst.history.append((time.monotonic(), old, new_state))
            inst.state = new_state
            inst.state_ts = time.monotonic()
            for k, v in updates.items():
                setattr(inst, k, v)
        for cb in self._subscribers:
            try:
                cb(inst, old, new_state)
            except Exception:  # noqa: BLE001 — subscriber errors don't break the FSM
                logger.exception("instance subscriber failed")
        return inst

    def instances(self, states: Optional[set] = None) -> List[Instance]:
        with self._lock:
            out = list(self._instances.values())
        if states is not None:
            out = [i for i in out if i.state in states]
        return out

    def get(self, instance_id: str) -> Optional[Instance]:
        with self._lock:
            return self._instances.get(instance_id)


@dataclass
class AutoscalerV2Config:
    node_types: Dict[str, NodeTypeConfig] = field(default_factory=dict)
    max_workers: int = 64
    idle_timeout_s: float = 60.0
    max_launch_retries: int = 3


class AutoscalerV2:
    """Declarative reconciler: desired-state in, provider calls out.

    Each ``reconcile()``:
      1. computes desired additional nodes from the demand snapshot
         (the same bin-packing scheduler as v1),
      2. queues instances for the gap; requeues failed launches,
      3. steps lifecycles: QUEUED -> provider.create_nodes -> ALLOCATED ->
         RUNNING once the node joined the fabric,
      4. stops instances whose nodes idled past the timeout (respecting
         per-type min_workers).
    """

    def __init__(self, cluster, provider: NodeProvider, config: AutoscalerV2Config):
        self._cluster = cluster
        self._provider = provider
        self.config = config
        self.im = InstanceManager()
        self._lock = threading.Lock()
        self._idle_since: Dict[str, float] = {}

    # -- live-state helpers -------------------------------------------------
    def _live_instances(self) -> List[Instance]:
        return self.im.instances({QUEUED, REQUESTED, ALLOCATED, RUNNING})

    def _counts_by_type(self, instances: List[Instance]) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for inst in instances:
            out[inst.node_type] = out.get(inst.node_type, 0) + 1
        return out

    # -- reconcile ----------------------------------------------------------
    def reconcile(self) -> None:
        with self._lock:
            self._requeue_failed()
            self._scale_up()
            self._launch_queued()
            self._mark_running()
            self._scale_down_idle()

    def _requeue_failed(self) -> None:
        for inst in self.im.instances({ALLOCATION_FAILED}):
            if inst.launch_attempt <= self.config.max_launch_retries:
                self.im.transition(inst.instance_id, QUEUED)
            else:
                self.im.transition(inst.instance_id, TERMINATED)

    def _scale_up(self) -> None:
        # floor residual vs TOTAL capacity, like v1 (scale-down re-checks
        # the floor itself before terminating)
        demands = (
            self._cluster.pending_resource_demands()
            + self._cluster.unmet_resource_requests()
        )
        available = [
            node.pool.available.to_dict()
            for node in self._cluster.nodes.values()
            if not node.dead
        ]
        live = self._live_instances()
        # Credit capacity that is already on its way: QUEUED/REQUESTED/
        # ALLOCATED instances haven't joined the fabric yet, but launching
        # again for the same demand every tick would over-provision to
        # max_workers on any provider slower than one reconcile interval.
        for inst in live:
            if inst.state in (QUEUED, REQUESTED, ALLOCATED):
                tcfg = self.config.node_types.get(inst.node_type)
                if tcfg is not None:
                    available.append(dict(tcfg.resources))
        to_launch = get_nodes_to_launch(
            self.config.node_types,
            self._counts_by_type(live),
            available,
            demands,
            max_total_workers=self.config.max_workers,
        )
        for tname, count in to_launch.items():
            for _ in range(count):
                self.im.create_instance(tname)

    def _launch_queued(self) -> None:
        queued = self.im.instances({QUEUED})
        by_type: Dict[str, List[Instance]] = {}
        for inst in queued:
            by_type.setdefault(inst.node_type, []).append(inst)
        for tname, insts in by_type.items():
            tcfg = self.config.node_types.get(tname)
            if tcfg is None:
                for inst in insts:
                    self.im.transition(inst.instance_id, TERMINATED)
                continue
            for inst in insts:
                self.im.transition(inst.instance_id, REQUESTED, launch_attempt=inst.launch_attempt + 1)
            try:
                ids = self._provider.create_nodes(tcfg, len(insts))
            except Exception:  # noqa: BLE001 — provider errors mark instances failed
                ids = []
            for inst, pid in zip(insts, ids):
                self.im.transition(inst.instance_id, ALLOCATED, provider_node_id=pid)
            for inst in insts[len(ids):]:
                self.im.transition(inst.instance_id, ALLOCATION_FAILED)

    def _mark_running(self) -> None:
        fabric_nodes = {nid.hex() for nid in self._cluster.nodes}
        provider_nodes = self._provider.non_terminated_nodes()
        for inst in self.im.instances({ALLOCATED}):
            pid = inst.provider_node_id or ""
            # in-process providers name nodes by fabric node id; a provider
            # whose ids differ reports liveness via non_terminated_nodes
            if pid in fabric_nodes or pid in provider_nodes:
                self.im.transition(inst.instance_id, RUNNING)

    def _scale_down_idle(self) -> None:
        now = time.monotonic()
        demands = self._cluster.pending_resource_demands()
        live = self.im.instances({RUNNING})
        counts = self._counts_by_type(live)
        node_by_hex = {nid.hex(): node for nid, node in self._cluster.nodes.items()}
        removed_this_sweep: set = set()
        for inst in live:
            node = node_by_hex.get(inst.provider_node_id or "")
            busy = False
            if node is not None and not node.dead:
                avail = node.pool.available.to_dict()
                total = node.pool.total.to_dict()
                busy = not all(
                    abs(avail.get(k, 0.0) - v) < 1e-9 for k, v in total.items()
                ) or node.scheduler.queue_len() > 0
            if busy or demands:
                self._idle_since.pop(inst.instance_id, None)
                continue
            first_idle = self._idle_since.setdefault(inst.instance_id, now)
            tcfg = self.config.node_types.get(inst.node_type)
            min_workers = tcfg.min_workers if tcfg else 0
            if (
                now - first_idle >= self.config.idle_timeout_s
                and counts.get(inst.node_type, 0) > min_workers
                and self._floor_allows_removal(inst, removed_this_sweep)
            ):
                removed_this_sweep.add(inst.provider_node_id or "")
                self.im.transition(inst.instance_id, STOPPING)
                try:
                    self._provider.terminate_node(inst.provider_node_id)
                except Exception:  # noqa: BLE001
                    pass
                self.im.transition(inst.instance_id, TERMINATED)
                self._idle_since.pop(inst.instance_id, None)
                counts[inst.node_type] -= 1

    def _floor_allows_removal(self, inst, removed_this_sweep: set = frozenset()) -> bool:
        """False if terminating this instance would drop TOTAL capacity
        below the request_resources floor. ``removed_this_sweep`` excludes
        nodes already terminated in this reconcile that an async-death
        provider hasn't marked dead yet."""
        if not self._cluster.resource_requests():
            return True
        excluded = set(removed_this_sweep) | {inst.provider_node_id or ""}
        remaining = []
        for node_id, node in list(self._cluster.nodes.items()):
            if node.dead or node_id.hex() in excluded:
                continue
            provider_id = (getattr(node, "labels", None) or {}).get("rt_provider_id")
            if provider_id and provider_id in excluded:
                continue
            remaining.append(node.pool.total.to_dict())
        return self._cluster.requests_fit(remaining)

    # -- introspection ------------------------------------------------------
    def cluster_status(self) -> dict:
        """Parity: v2 ClusterStatus / `ray status` v2 output."""
        by_state: Dict[str, int] = {}
        for inst in self.im.instances():
            by_state[inst.state] = by_state.get(inst.state, 0) + 1
        return {
            "instances_by_state": by_state,
            "instances": [
                {
                    "id": i.instance_id,
                    "type": i.node_type,
                    "state": i.state,
                    "provider_node_id": i.provider_node_id,
                    "attempts": i.launch_attempt,
                }
                for i in self.im.instances()
            ],
            "pending_demands": self._cluster.pending_resource_demands(),
        }
