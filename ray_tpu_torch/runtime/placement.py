"""Placement groups: gang resource reservation with 2-phase commit.

The port's copy of ``ray_tpu/runtime/placement.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Parity with the reference (``src/ray/gcs/gcs_server/gcs_placement_group_manager.h:230``
and the 2PC scheduler ``gcs_placement_group_scheduler.h:113-116``): a group of
resource bundles is PREPAREd on chosen nodes (resources moved out of the
general pool), then COMMITted (bundle-indexed resources become schedulable);
on any prepare failure all prepared bundles are returned.  Strategies: PACK,
SPREAD, STRICT_PACK, STRICT_SPREAD (``src/ray/protobuf/common.proto:921-928``).

TPU-first: bundles may carry a ``TPU`` resource; STRICT_PACK maps a whole
group onto one host (one ICI domain) which is the natural unit for a pjit
mesh — the parallel layer requests groups this way so SPMD programs are
gang-placed on connected chips.
"""

from __future__ import annotations

import threading
from enum import Enum
from typing import Dict, List, Optional

from ray_tpu_torch.core.ids import NodeID, PlacementGroupID
from ray_tpu_torch.core.resources import ResourceSet


class PlacementStrategy(Enum):
    PACK = "PACK"
    SPREAD = "SPREAD"
    STRICT_PACK = "STRICT_PACK"
    STRICT_SPREAD = "STRICT_SPREAD"


class PlacementGroupState(Enum):
    PENDING = "PENDING"
    PREPARED = "PREPARED"
    CREATED = "CREATED"
    REMOVED = "REMOVED"
    RESCHEDULING = "RESCHEDULING"


class PlacementGroupInfo:
    def __init__(
        self, pg_id: PlacementGroupID, bundles: List[ResourceSet],
        strategy: PlacementStrategy, name: str = "",
        labels: Optional[Dict[str, str]] = None,
        pack_by_label: Optional[str] = None,
    ):
        self.pg_id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self.name = name
        # node-label selector: only nodes carrying every (k, v) qualify
        self.labels = dict(labels or {})
        # gang-at-slice-granularity: all bundles must land on nodes sharing
        # ONE value of this label (e.g. "ray_tpu_torch.io/slice-id" places a
        # STRICT_SPREAD gang across the hosts of a single TPU slice)
        self.pack_by_label = pack_by_label
        self.state = PlacementGroupState.PENDING
        # bundle index -> node id
        self.bundle_placements: Dict[int, NodeID] = {}


class PlacementGroupManager:
    """Schedules bundles onto nodes via each node's resource pool.

    The scheduler side is bound late (``bind_node_pools``) to avoid a
    control↔scheduler import cycle; node pools are the authoritative
    LocalResourceManager-equivalents.
    """

    def __init__(self, node_table, pubsub):
        self._nodes = node_table
        self._pubsub = pubsub
        self._lock = threading.RLock()
        self._groups: Dict[PlacementGroupID, PlacementGroupInfo] = {}
        self._node_pools = None  # NodeID -> ResourcePool

    def bind_node_pools(self, pools) -> None:
        self._node_pools = pools

    def retry_pending(self) -> None:
        """Re-attempt PENDING groups (called when capacity joins — parity
        with GcsPlacementGroupManager retrying on node add)."""
        with self._lock:
            pending = [g for g in self._groups.values() if g.state is PlacementGroupState.PENDING]
        for info in pending:
            self.create(info)

    # ------------------------------------------------------------------
    def create(self, info: PlacementGroupInfo) -> bool:
        with self._lock:
            if info.state is PlacementGroupState.REMOVED:
                # a retry_pending snapshot racing a concurrent remove() must
                # not resurrect the group
                return False
            if info.state is PlacementGroupState.CREATED:
                # concurrent retry_pending calls must not double-acquire
                return True
            self._groups[info.pg_id] = info
            placements = self._schedule(info)
            if placements is None:
                info.state = PlacementGroupState.PENDING
                return False
            # phase 1: prepare — take resources from each node's pool
            prepared: List[tuple] = []
            ok = True
            for idx, node_id in placements.items():
                pool = self._node_pools[node_id]
                if pool.acquire(info.bundles[idx]):
                    prepared.append((idx, node_id))
                else:
                    ok = False
                    break
            if not ok:
                for idx, node_id in prepared:
                    self._node_pools[node_id].release(info.bundles[idx])
                return False
            # phase 2: commit — bundle resources become schedulable under
            # PG-scoped names (resource "CPU_group_<hex>" parity).
            for idx, node_id in prepared:
                pool = self._node_pools[node_id]
                pool.add_capacity(self._bundle_resources(info, idx))
                info.bundle_placements[idx] = node_id
            info.state = PlacementGroupState.CREATED
        self._pubsub.publish("placement_group", ("CREATED", info.pg_id))
        return True

    def remove(self, pg_id: PlacementGroupID) -> None:
        with self._lock:
            info = self._groups.get(pg_id)
            if info is None or info.state is PlacementGroupState.REMOVED:
                return
            for idx, node_id in info.bundle_placements.items():
                pool = self._node_pools.get(node_id)
                if pool is None:
                    continue
                pool.remove_capacity(self._bundle_resources(info, idx))
                pool.release(info.bundles[idx])
            info.state = PlacementGroupState.REMOVED
            info.bundle_placements.clear()
        self._pubsub.publish("placement_group", ("REMOVED", pg_id))

    def get(self, pg_id: PlacementGroupID) -> Optional[PlacementGroupInfo]:
        with self._lock:
            return self._groups.get(pg_id)

    def list_groups(self) -> List[PlacementGroupInfo]:
        with self._lock:
            return list(self._groups.values())

    def on_node_dead(self, node_id: NodeID) -> List[PlacementGroupID]:
        """Bundles on a dead node put the group into RESCHEDULING."""
        affected = []
        with self._lock:
            for info in self._groups.values():
                if info.state is PlacementGroupState.CREATED and node_id in info.bundle_placements.values():
                    info.state = PlacementGroupState.RESCHEDULING
                    affected.append(info.pg_id)
        return affected

    # ------------------------------------------------------------------
    def _bundle_resources(self, info: PlacementGroupInfo, idx: int) -> ResourceSet:
        """PG-scoped resource names for a committed bundle: both the
        per-bundle name (CPU_group_<idx>_<hex>) and the wildcard
        (CPU_group_<hex>), matching the reference's naming."""
        scoped = {}
        for name, qty in info.bundles[idx].to_dict().items():
            scoped[bundle_resource_name(info.pg_id, name, idx)] = qty
            scoped[bundle_resource_name(info.pg_id, name)] = qty
        return ResourceSet(scoped)

    def _schedule(self, info: PlacementGroupInfo) -> Optional[Dict[int, NodeID]]:
        """Choose a node per bundle per the strategy. Returns None if
        infeasible."""
        nodes = self._nodes.alive_nodes()
        if not nodes or self._node_pools is None:
            return None
        if info.labels:
            nodes = [
                n for n in nodes
                if all((n.labels or {}).get(k) == v for k, v in info.labels.items())
            ]
        if info.pack_by_label:
            # candidate groups = nodes sharing one value of the label; the
            # whole gang must fit inside a single group (a TPU slice)
            by_value: Dict[str, list] = {}
            for n in nodes:
                value = (n.labels or {}).get(info.pack_by_label)
                if value is not None:
                    by_value.setdefault(value, []).append(n)
            for _value, group_nodes in sorted(by_value.items()):
                placements = self._schedule_on(info, group_nodes)
                if placements is not None:
                    return placements
            return None
        return self._schedule_on(info, nodes)

    def _schedule_on(self, info: PlacementGroupInfo, nodes) -> Optional[Dict[int, NodeID]]:
        pools = {n.node_id: self._node_pools.get(n.node_id) for n in nodes}
        pools = {nid: p for nid, p in pools.items() if p is not None}
        if not pools:
            return None

        n_bundles = len(info.bundles)
        placements: Dict[int, NodeID] = {}

        if info.strategy in (PlacementStrategy.PACK, PlacementStrategy.STRICT_PACK):
            # try to fit all on one node, preferring most-utilized feasible
            for node_id, pool in sorted(pools.items(), key=lambda kv: -kv[1].utilization()):
                total_req = info.bundles[0]
                for b in info.bundles[1:]:
                    total_req = total_req + b
                if total_req.fits(pool.available):
                    return {i: node_id for i in range(n_bundles)}
            if info.strategy is PlacementStrategy.STRICT_PACK:
                return None
            # PACK falls back to spreading leftovers
            remaining = dict(enumerate(info.bundles))
            for node_id, pool in sorted(pools.items(), key=lambda kv: -kv[1].utilization()):
                avail = pool.available
                for idx in list(remaining):
                    if remaining[idx].fits(avail):
                        placements[idx] = node_id
                        avail = avail - remaining[idx]
                        del remaining[idx]
            return placements if not remaining else None

        # SPREAD / STRICT_SPREAD: round-robin distinct nodes
        node_ids = sorted(pools.keys(), key=lambda nid: pools[nid].utilization())
        if info.strategy is PlacementStrategy.STRICT_SPREAD and len(node_ids) < n_bundles:
            return None
        used_budget: Dict[NodeID, ResourceSet] = {}
        for idx, bundle in enumerate(info.bundles):
            placed = False
            order = node_ids[idx % len(node_ids):] + node_ids[: idx % len(node_ids)]
            for node_id in order:
                if info.strategy is PlacementStrategy.STRICT_SPREAD and node_id in placements.values():
                    continue
                avail = pools[node_id].available
                if node_id in used_budget:
                    avail = avail - used_budget[node_id]
                if bundle.fits(avail):
                    placements[idx] = node_id
                    used_budget[node_id] = used_budget.get(node_id, ResourceSet({})) + bundle
                    placed = True
                    break
            if not placed:
                return None
        return placements


def bundle_resource_name(pg_id: PlacementGroupID, name: str, idx: int = -1) -> str:
    """The name a committed bundle's ``name`` resource takes on its node:
    ``<name>_group_<idx>_<hex>`` for bundle ``idx``, ``<name>_group_<hex>``
    for any bundle of the group."""
    hexid = pg_id.hex()[:12]
    return f"{name}_group_{hexid}" if idx < 0 else f"{name}_group_{idx}_{hexid}"


def bundle_demands(resources: Optional[Dict[str, float]], strategy) -> Optional[Dict[str, float]]:
    """A task's or actor's demands as it takes them from its placement
    group: under a ``PlacementGroupSchedulingStrategy`` each resource is
    charged to the group's bundle (``placement_group_bundle_index``, or any
    bundle for -1) instead of the node's free pool, as Ray rewrites them.
    Port-only: the JAX package charges the free pool, so a group that
    reserves a node's whole device leaves no device for the group's own
    actors (ROADMAP F7). Any other strategy: ``resources`` unchanged."""
    from ray_tpu_torch.runtime.scheduler import PlacementGroupSchedulingStrategy

    if not isinstance(strategy, PlacementGroupSchedulingStrategy):
        return resources
    pg = strategy.placement_group
    info = pg._info if hasattr(pg, "_info") else pg
    idx = strategy.placement_group_bundle_index
    demands = {"CPU": 1.0} if resources is None else resources
    return {bundle_resource_name(info.pg_id, name, idx): qty
            for name, qty in demands.items() if qty}

