"""User-facing placement-group API.

The port's copy of ``ray_tpu/util/placement.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Parity: ``ray.util.placement_group`` / ``remove_placement_group`` /
``placement_group_table`` (``python/ray/util/placement_group.py``) — the
convenience layer over the control service's PG manager, returning a
handle usable with ``PlacementGroupSchedulingStrategy``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch.core.ids import PlacementGroupID
from ray_tpu_torch.core.resources import ResourceSet
from ray_tpu_torch.runtime.placement import PlacementGroupInfo, PlacementStrategy


class PlacementGroup:
    """Handle over a created group (parity: util PlacementGroup)."""

    def __init__(self, info: PlacementGroupInfo):
        self._info = info

    @property
    def id(self) -> PlacementGroupID:
        return self._info.pg_id

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return [b.to_dict() for b in self._info.bundles]

    def ready(self):
        """ObjectRef resolving True once the group is scheduled — a PENDING
        group (awaiting capacity) blocks until the manager's retry places
        it (parity: PlacementGroup.ready())."""
        import ray_tpu_torch

        info = self._info

        def _ready() -> bool:
            import time

            from ray_tpu_torch.runtime.placement import PlacementGroupState

            while info.state is not PlacementGroupState.CREATED:
                if info.state is PlacementGroupState.REMOVED:
                    raise RuntimeError("placement group was removed before it was placed")
                time.sleep(0.05)
            return True

        return ray_tpu_torch.remote(_ready).options(execution="thread").remote()

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        """Block up to timeout_seconds for the group to be scheduled."""
        import time

        from ray_tpu_torch.runtime.placement import PlacementGroupState

        deadline = time.monotonic() + timeout_seconds
        while time.monotonic() < deadline:
            if self._info.state is PlacementGroupState.CREATED:
                return True
            if self._info.state is PlacementGroupState.REMOVED:
                return False
            time.sleep(0.02)
        return self._info.state is PlacementGroupState.CREATED


def get_placement_group(name: str) -> PlacementGroup:
    """Look up a live placement group by name (parity:
    util.get_placement_group)."""
    from ray_tpu_torch.api import get_cluster

    cluster = get_cluster()
    for info in cluster.control.placement_groups.list_groups():
        if info.name == name and info.state.name != "REMOVED":
            return PlacementGroup(info)
    raise ValueError(f"no placement group named {name!r}")


def get_current_placement_group() -> Optional[PlacementGroup]:
    """The placement group the CURRENT actor was scheduled under, or None
    (parity: util.get_current_placement_group).  Resolved from the actor's
    creation spec — available for in-process/thread execution, where the
    cluster state is reachable; process workers see None."""
    from ray_tpu_torch.api import get_cluster
    from ray_tpu_torch.runtime.context import task_context
    from ray_tpu_torch.runtime.scheduler import PlacementGroupSchedulingStrategy

    current = task_context.current()
    if current is None:
        return None
    task_id, _node = current
    try:
        cluster = get_cluster()
    except Exception:  # noqa: BLE001 — no in-proc cluster (process worker)
        return None
    # actor tasks embed their ActorID: the creation spec carries the
    # scheduling strategy the actor was placed with
    actor_id = task_id.actor_id()
    if actor_id.is_nil():
        return None
    spec = getattr(cluster, "_actor_specs", {}).get(actor_id)
    strategy = getattr(spec, "scheduling_strategy", None)
    if strategy is None:
        return None
    if isinstance(strategy, PlacementGroupSchedulingStrategy):
        pg = strategy.placement_group
        if isinstance(pg, PlacementGroup):
            return pg
        info = cluster.control.placement_groups.get(getattr(pg, "id", pg))
        return PlacementGroup(info) if info is not None else None
    return None


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
    lifetime: Optional[str] = None,
    labels: Optional[Dict[str, str]] = None,
    pack_by_label: Optional[str] = None,
) -> PlacementGroup:
    """Create (and synchronously schedule) a placement group.

    ``labels`` restricts candidate nodes to those carrying every (k, v);
    ``pack_by_label`` places the whole gang on nodes sharing ONE value of
    that label — e.g. ``pack_by_label="ray_tpu.io/slice-id"`` with
    ``strategy="STRICT_SPREAD"`` gang-places one bundle per host of a
    single TPU slice (reference: TPU pod affinity via the
    ``TPU-<pod>-head`` resource, accelerators/tpu.py:13-33)."""
    import ray_tpu_torch
    from ray_tpu_torch.runtime.worker import global_worker

    if not bundles:
        raise ValueError("placement group bundles cannot be empty")
    try:
        PlacementStrategy[strategy]
    except KeyError:
        valid = [s.name for s in PlacementStrategy]
        raise ValueError(f"invalid placement strategy {strategy!r}; valid: {valid}")
    if lifetime not in (None, "detached"):
        raise ValueError(f"lifetime must be None or 'detached', got {lifetime!r}")
    # lifetime="detached" is accepted for API parity; in-process groups are
    # process-scoped either way (no cross-driver registry to detach into)

    worker = global_worker()
    info = PlacementGroupInfo(
        PlacementGroupID.of(worker.job_id),
        [ResourceSet(b) for b in bundles],
        PlacementStrategy[strategy],
        name=name,
        labels=labels,
        pack_by_label=pack_by_label,
    )
    cluster = ray_tpu_torch.get_cluster()
    # create() registers the group either way; an infeasible one stays
    # PENDING and is retried when capacity joins (autoscaler parity)
    cluster.control.placement_groups.create(info)
    return PlacementGroup(info)


def remove_placement_group(pg: PlacementGroup) -> None:
    import ray_tpu_torch

    ray_tpu_torch.get_cluster().control.placement_groups.remove(pg.id)


def placement_group_table(pg: Optional[PlacementGroup] = None) -> Dict:
    import ray_tpu_torch

    mgr = ray_tpu_torch.get_cluster().control.placement_groups
    rows = {}
    for info in mgr.list_groups():
        with mgr._lock:   # remove() clears bundle_placements under this lock
            placements = dict(info.bundle_placements)
            state = info.state.name
        rows[info.pg_id.hex()] = {
            "name": info.name,
            "strategy": info.strategy.name,
            "state": state,
            "bundles": [b.to_dict() for b in info.bundles],
            "bundle_placements": {i: nid.hex() for i, nid in placements.items()},
        }
    if pg is not None:
        return rows.get(pg.id.hex(), {})
    return rows
