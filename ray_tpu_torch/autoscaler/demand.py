"""Resource-demand scheduler: bin-pack pending demand onto node types.

Rebuild of ``python/ray/autoscaler/_private/resource_demand_scheduler.py``:
given the catalog of launchable node types, the nodes that already exist, and
the resource shapes of unschedulable work, decide how many of each type to
launch. Pure function — no provider/cloud coupling — so it unit-tests exactly
like the reference's scheduler tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

ResourceDict = Dict[str, float]


@dataclass
class NodeTypeConfig:
    """One launchable node shape (reference ``available_node_types`` YAML
    entries, ``python/ray/autoscaler/ray-schema.json``)."""

    name: str
    resources: ResourceDict
    min_workers: int = 0
    max_workers: int = 2**31 - 1
    labels: Dict[str, str] = field(default_factory=dict)


def _fits(capacity: ResourceDict, demand: ResourceDict) -> bool:
    return all(capacity.get(k, 0.0) >= v for k, v in demand.items() if v > 0)


def _subtract(capacity: ResourceDict, demand: ResourceDict) -> None:
    for k, v in demand.items():
        if v > 0:
            capacity[k] = capacity.get(k, 0.0) - v


def _utilization_score(node_resources: ResourceDict, remaining: ResourceDict) -> Tuple:
    """Prefer node types the demand uses most fully (the reference's
    ``_utilization_score``): higher minimum-fraction-used wins, then higher
    total fraction used."""
    fracs = []
    for k, total in node_resources.items():
        if total <= 0:
            continue
        used = total - remaining.get(k, total)
        fracs.append(used / total)
    if not fracs:
        return (0.0, 0.0)
    return (min(fracs), sum(fracs) / len(fracs))


def bin_pack_residual(
    capacities: List[ResourceDict], demands: List[ResourceDict]
) -> List[ResourceDict]:
    """First-fit-decreasing pack of ``demands`` into mutable ``capacities``;
    returns the demands that did not fit (the residual the autoscaler must
    launch nodes for)."""
    residual: List[ResourceDict] = []
    for demand in sorted(demands, key=lambda d: -sum(d.values())):
        for cap in capacities:
            if _fits(cap, demand):
                _subtract(cap, demand)
                break
        else:
            residual.append(demand)
    return residual


def get_nodes_to_launch(
    node_types: Mapping[str, NodeTypeConfig],
    existing_by_type: Mapping[str, int],
    available_capacities: List[ResourceDict],
    pending_demands: List[ResourceDict],
    max_total_workers: Optional[int] = None,
) -> Dict[str, int]:
    """Decide node launches (reference ``get_nodes_to_launch``,
    ``resource_demand_scheduler.py``).

    1. enforce ``min_workers`` per type;
    2. pack pending demand into capacity that already exists (idle headroom);
    3. for the residual, greedily pick the node type whose shape the demand
       utilizes best, respecting per-type ``max_workers`` and the global cap.
    """
    to_launch: Dict[str, int] = {}
    counts = dict(existing_by_type)
    total = sum(counts.values())

    def launch(tname: str) -> None:
        nonlocal total
        to_launch[tname] = to_launch.get(tname, 0) + 1
        counts[tname] = counts.get(tname, 0) + 1
        total += 1

    for tname, tcfg in node_types.items():
        while counts.get(tname, 0) < tcfg.min_workers:
            if max_total_workers is not None and total >= max_total_workers:
                break
            launch(tname)
            available_capacities.append(dict(tcfg.resources))

    residual = bin_pack_residual([dict(c) for c in available_capacities], pending_demands)

    while residual:
        best: Optional[Tuple[Tuple, str, List[ResourceDict]]] = None
        for tname, tcfg in node_types.items():
            if counts.get(tname, 0) >= tcfg.max_workers:
                continue
            if max_total_workers is not None and total >= max_total_workers:
                continue
            cap = dict(tcfg.resources)
            still = bin_pack_residual([cap], residual)
            if len(still) == len(residual):
                continue  # this type helps nothing
            score = _utilization_score(tcfg.resources, cap)
            if best is None or score > best[0]:
                best = (score, tname, still)
        if best is None:
            break  # demand is infeasible for every launchable type
        _, tname, residual = best
        launch(tname)
    return to_launch
