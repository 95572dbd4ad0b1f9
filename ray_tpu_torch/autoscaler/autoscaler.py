"""StandardAutoscaler: the reconcile loop between demand and nodes.

Rebuild of ``python/ray/autoscaler/_private/autoscaler.py:172`` (v1
``StandardAutoscaler.update``) with the v2 rewrite's shape (declarative
desired-state reconciliation, ``python/ray/autoscaler/v2/scheduler.py``):
each ``update()`` reads a load snapshot, computes launches via the demand
scheduler, terminates idle managed nodes past the timeout, and enforces
min/max workers. Pure control plane — all cloud/infra specifics live behind
the ``NodeProvider``.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ray_tpu_torch.autoscaler.demand import NodeTypeConfig, get_nodes_to_launch
from ray_tpu_torch.autoscaler.node_provider import NodeProvider

logger = logging.getLogger(__name__)


@dataclass
class AutoscalerConfig:
    """Scaling policy (reference cluster-YAML top level: ``max_workers``,
    ``idle_timeout_minutes``, ``upscaling_speed``)."""

    node_types: Dict[str, NodeTypeConfig] = field(default_factory=dict)
    max_workers: int = 64
    idle_timeout_s: float = 60.0
    upscaling_speed: float = 1.0  # max new nodes per update = max(5, speed * current)
    update_interval_s: float = 0.5


class StandardAutoscaler:
    def __init__(self, cluster, provider: NodeProvider, config: AutoscalerConfig):
        self._cluster = cluster
        self._provider = provider
        self.config = config
        self._lock = threading.Lock()
        self._idle_since: Dict[str, float] = {}  # provider node id -> ts
        self.num_launches = 0
        self.num_terminations = 0

    # ------------------------------------------------------------------
    def _load_snapshot(self):
        """Pending demand + per-managed-node idleness, from the live fabric
        (the reference polls this from GCS: monitor.py -> GetResourceLoad)."""
        demands = self._cluster.pending_resource_demands()
        available: List[Dict[str, float]] = []
        busy: Dict[str, bool] = {}
        totals: Dict[str, Dict[str, float]] = {}
        draining = getattr(self._cluster.cluster_scheduler, "is_draining", None)
        for node_id, node in list(self._cluster.nodes.items()):
            if node.dead:
                continue
            if draining is not None and draining(node_id):
                # mid-drain: its capacity must not satisfy pending demand
                # (nothing new places there) and it must not be re-picked
                # for idle termination — mark busy, skip its availability
                busy[node_id.hex()] = True
                continue
            avail = node.pool.available.to_dict()
            total = node.pool.total.to_dict()
            available.append(avail)
            totals[node_id.hex()] = total
            is_idle = all(
                abs(avail.get(k, 0.0) - v) < 1e-9 for k, v in total.items()
            ) and node.scheduler.queue_len() == 0
            busy[node_id.hex()] = not is_idle
            # subprocess/SSH-provisioned nodes are known to the provider by
            # their rt_provider_id label, not their cluster node id
            provider_id = (getattr(node, "labels", None) or {}).get("rt_provider_id")
            if provider_id:
                # multiple hosts may share one provider id (a TPU slice):
                # the slice is busy if ANY host is
                busy[provider_id] = busy.get(provider_id, False) or not is_idle
                totals[provider_id] = total
        return demands, available, busy, totals

    def update(self) -> None:
        with self._lock:
            self._update_locked()

    def _update_locked(self) -> None:
        demands, available, busy, totals = self._load_snapshot()
        managed = self._provider.non_terminated_nodes()
        # the request_resources floor launches only its UNMET residual
        # (vs TOTAL capacity — a busy cluster that already holds the floor
        # must not over-provision); scale-down has its own floor check.
        # Credit managed-but-unregistered (booting) nodes or every tick of
        # a slow provider re-launches for the same residual (the credit v2
        # gets from its QUEUED/REQUESTED/ALLOCATED instance states).
        registered = {
            (getattr(node, "labels", None) or {}).get("rt_provider_id")
            for node in list(self._cluster.nodes.values())
            if not node.dead
        }
        booting = []
        for pid, tname in managed.items():
            if pid not in registered and pid not in totals:
                tcfg = self.config.node_types.get(tname)
                if tcfg is not None:
                    booting.append(dict(tcfg.resources))
        demands = demands + self._cluster.unmet_resource_requests(booting)
        existing_by_type: Dict[str, int] = {}
        for tname in managed.values():
            existing_by_type[tname] = existing_by_type.get(tname, 0) + 1

        to_launch = get_nodes_to_launch(
            self.config.node_types,
            existing_by_type,
            available,
            demands,
            max_total_workers=self.config.max_workers,
        )
        # upscaling_speed throttle (reference autoscaler.py _get_nodes_allowed_to_launch)
        allowed = max(5, int(self.config.upscaling_speed * max(1, len(managed))))
        launched = 0
        for tname, count in to_launch.items():
            count = min(count, allowed - launched)
            if count <= 0:
                break
            tcfg = self.config.node_types[tname]
            ids = self._provider.create_nodes(tcfg, count)
            self.num_launches += len(ids)
            launched += len(ids)
            logger.info("autoscaler: launched %d x %s", len(ids), tname)

        self._terminate_idle(managed, busy, demands, totals)
        self._elastic_train_tick()

    def _elastic_train_tick(self) -> None:
        """Elastic training hook: after capacity changes land, let every
        registered gang reconcile its size against live CPU capacity —
        scale-up re-traces at the new mesh size, scale-down drains the
        departing member (zero lost step state)."""
        for name in sorted(getattr(self._cluster, "train_controllers", {})):
            ctl = self._cluster.train_controllers.get(name)
            if ctl is None:
                continue
            try:
                ctl.elastic_tick()
            except Exception:  # noqa: BLE001 — a wedged gang must not stall scaling
                logger.exception("autoscaler: elastic_tick failed for train job %s", name)

    def _terminate_idle(
        self,
        managed: Dict[str, str],
        busy: Dict[str, bool],
        demands: List[Dict[str, float]],
        totals: Dict[str, Dict[str, float]],
    ) -> None:
        now = time.monotonic()
        counts_by_type: Dict[str, int] = {}
        for tname in managed.values():
            counts_by_type[tname] = counts_by_type.get(tname, 0) + 1
        # nodes terminated earlier in THIS sweep: async-death providers
        # haven't marked them dead in cluster.nodes yet, so the floor check
        # must exclude them explicitly or one sweep can drop below the floor
        removed_this_sweep: set = set()
        for pid, tname in list(managed.items()):
            # a slice is busy if any member host is busy
            members = (
                self._provider.slice_members(pid)
                if hasattr(self._provider, "slice_members")
                else []
            ) or [pid]
            # a member absent from `busy` is dead — a half-dead slice must be
            # treated as idle (terminable), not pinned alive forever
            if any(busy.get(m, False) for m in members):
                self._idle_since.pop(pid, None)
                continue
            first_idle = self._idle_since.setdefault(pid, now)
            tcfg = self.config.node_types.get(tname)
            min_workers = tcfg.min_workers if tcfg else 0
            # keep a node only if a pending demand could actually run on it
            # (a permanently-infeasible demand must not pin the whole cluster)
            could_serve = any(
                all(totals.get(m, {}).get(k, 0.0) >= v for k, v in d.items() if v > 0)
                for d in demands
                for m in members
            )
            if (
                now - first_idle >= self.config.idle_timeout_s
                and counts_by_type.get(tname, 0) > min_workers
                and not could_serve
                and self._floor_allows_removal(set(members) | removed_this_sweep)
            ):
                removed_this_sweep.update(members)
                self._provider.terminate_node(pid)
                self._idle_since.pop(pid, None)
                counts_by_type[tname] -= 1
                self.num_terminations += 1
                logger.info("autoscaler: terminated idle node %s (%s)", pid[:8], tname)

    def _floor_allows_removal(self, members) -> bool:
        """False if terminating this node/slice would drop TOTAL capacity
        below the request_resources floor (reference: commands.py keeps
        nodes needed to satisfy resource_requests)."""
        if not self._cluster.resource_requests():
            return True
        members = set(members)
        remaining = []
        for node_id, node in list(self._cluster.nodes.items()):
            if node.dead:
                continue
            provider_id = (getattr(node, "labels", None) or {}).get("rt_provider_id")
            if node_id.hex() in members or (provider_id and provider_id in members):
                continue
            remaining.append(node.pool.total.to_dict())
        return self._cluster.requests_fit(remaining)

    # ------------------------------------------------------------------
    # rt-lint: disable=lock-discipline -- observability counters: a torn
    # read skews one summary poll, never a launch/terminate decision
    def summary(self) -> dict:
        managed = self._provider.non_terminated_nodes()
        by_type: Dict[str, int] = {}
        for t in managed.values():
            by_type[t] = by_type.get(t, 0) + 1
        return {
            "active_nodes": by_type,
            "pending_demands": self._cluster.pending_resource_demands(),
            "num_launches": self.num_launches,
            "num_terminations": self.num_terminations,
        }
