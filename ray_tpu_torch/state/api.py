"""State API implementation over the control service's live tables.

The port's copy of ``ray_tpu/state/api.py``: the same functions, rows and
keys, over the port's control tables, with one key more: an actor's row
carries ``resources``, the demands it holds (its GPU share on the card),
which the JAX package's rows do not show.

Parity: ``python/ray/util/state/api.py`` (list_* :788,:1020; summarize_*
:1382) + the dashboard's ``state_aggregator.py``.  The reference aggregates
from GCS task events and per-raylet ``GetTasksInfo``/``GetObjectsInfo`` RPCs
(``node_manager.proto:424-426``); here the same facts live in the in-process
control service and node object stores, so listing is a table scan.

Every entry is a plain dict (stable keys documented per function) so the
dashboard REST layer can serialize them unchanged.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional


def _cluster():
    from ray_tpu_torch.api import get_cluster

    return get_cluster()


def _limited(rows: List[dict], limit: int, filters: Optional[List[tuple]]) -> List[dict]:
    if filters:
        for key, op, value in filters:
            if op == "=":
                rows = [r for r in rows if str(r.get(key)) == str(value)]
            elif op == "!=":
                rows = [r for r in rows if str(r.get(key)) != str(value)]
            else:
                raise ValueError(f"unsupported filter op {op!r} (use '=' or '!=')")
    return rows[:limit]


# ----------------------------------------------------------------------
def list_nodes(filters: Optional[List[tuple]] = None, limit: int = 1000) -> List[dict]:
    """Keys: node_id, state, address, resources_total, resources_available, labels, is_head."""
    cluster = _cluster()
    rows = []
    head_id = cluster.head_node.node_id if cluster.head_node else None
    for info in cluster.control.nodes.all_nodes():
        node = cluster.nodes.get(info.node_id)
        rows.append(
            {
                "node_id": info.node_id.hex(),
                "state": info.state.name,
                "address": info.address,
                "resources_total": dict(info.resources_total),
                "resources_available": node.pool.available.to_dict() if node and not node.dead else {},
                "labels": dict(info.labels or {}),
                "is_head": info.node_id == head_id,
            }
        )
    return _limited(rows, limit, filters)


def list_actors(filters: Optional[List[tuple]] = None, limit: int = 1000) -> List[dict]:
    """Keys: actor_id, class_name, name, state, node_id, job_id, restarts, max_restarts,
    death_cause, resources."""
    cluster = _cluster()
    rows = []
    for info in cluster.control.actors.list_actors():
        spec = cluster._actor_specs.get(info.actor_id)
        rows.append(
            {
                "actor_id": info.actor_id.hex(),
                "class_name": info.class_name,
                "name": info.name or "",
                "state": info.state.name,
                "node_id": info.node_id.hex() if info.node_id else "",
                "job_id": info.job_id.hex() if info.job_id else "",
                "restarts": getattr(info, "num_restarts", 0),
                "max_restarts": info.max_restarts,
                "death_cause": getattr(info, "death_cause", "") or "",
                "resources": spec.resources.to_dict() if spec is not None else {},
            }
        )
    return _limited(rows, limit, filters)


def list_tasks(filters: Optional[List[tuple]] = None, limit: int = 1000) -> List[dict]:
    """Pending tasks first (live view), then recent finished task events.

    Keys: task_id, name, state, node_id, attempt, duration_s.
    """
    cluster = _cluster()
    rows = []
    for spec in cluster.task_manager.pending_specs():
        rows.append(
            {
                "task_id": spec.task_id.hex(),
                "name": spec.name,
                "state": "PENDING" if spec.actor_id is None else "PENDING_ACTOR_TASK",
                "node_id": spec.owner_node.hex() if spec.owner_node else "",
                "attempt": spec.attempt,
                "duration_s": None,
            }
        )
    for ev in reversed(cluster.control.task_events.list_events(limit=limit)):
        dur = None
        if ev.get("ts") and ev.get("start_ts"):
            dur = round(ev["ts"] - ev["start_ts"], 6)
        rows.append(
            {
                "task_id": ev.get("task_id", ""),
                "name": ev.get("name", ""),
                "state": ev.get("state", "FINISHED"),
                "node_id": ev.get("node", ""),
                "attempt": ev.get("attempt", 0),
                "duration_s": dur,
            }
        )
    return _limited(rows, limit, filters)


def list_objects(filters: Optional[List[tuple]] = None, limit: int = 1000) -> List[dict]:
    """Keys: object_id, node_id, size_bytes, tier, is_error, ref_count."""
    cluster = _cluster()
    rc = cluster.core_worker.ref_counter if cluster.core_worker is not None else None
    rows = []
    for node in cluster.nodes.values():
        if node.dead:
            continue
        for oid, info in node.store.list_entries():
            rows.append(
                {
                    "object_id": oid.hex(),
                    "node_id": node.node_id.hex(),
                    "size_bytes": info["size"],
                    "tier": info["tier"],
                    "is_error": info["is_error"],
                    "ref_count": rc.reference_counts(oid) if rc is not None else None,
                }
            )
    return _limited(rows, limit, filters)


def list_placement_groups(filters: Optional[List[tuple]] = None, limit: int = 1000) -> List[dict]:
    """Keys: placement_group_id, name, state, strategy, bundles."""
    cluster = _cluster()
    rows = []
    for info in cluster.control.placement_groups.list_groups():
        rows.append(
            {
                "placement_group_id": info.pg_id.hex(),
                "name": info.name,
                "state": info.state.name,
                "strategy": info.strategy.name,
                "bundles": [b.to_dict() for b in info.bundles],
            }
        )
    return _limited(rows, limit, filters)


def list_jobs(filters: Optional[List[tuple]] = None, limit: int = 1000) -> List[dict]:
    """Keys: job_id, entrypoint, status, start_time, end_time."""
    cluster = _cluster()
    rows = []
    for info in cluster.control.jobs.list_jobs():
        rows.append(
            {
                "job_id": info.job_id.hex(),
                "entrypoint": info.entrypoint,
                "status": getattr(info, "status", "RUNNING"),
                "start_time": getattr(info, "start_time", None),
                "end_time": getattr(info, "end_time", None),
            }
        )
    return _limited(rows, limit, filters)


# ----------------------------------------------------------------------
# Summaries (parity: summarize_tasks/actors/objects api.py:1382+)
# ----------------------------------------------------------------------
def summarize_tasks() -> Dict[str, Any]:
    """Group tasks by (name, state) with counts — ``ray summary tasks``."""
    groups: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
    for row in list_tasks(limit=100_000):
        groups[row["name"]][row["state"]] += 1
    return {
        "summary": {
            name: {"state_counts": dict(states), "total": sum(states.values())}
            for name, states in groups.items()
        },
        "total_tasks": sum(sum(s.values()) for s in groups.values()),
    }


def summarize_actors() -> Dict[str, Any]:
    groups: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
    for row in list_actors(limit=100_000):
        groups[row["class_name"] or "<anonymous>"][row["state"]] += 1
    return {
        "summary": {
            cls: {"state_counts": dict(states), "total": sum(states.values())}
            for cls, states in groups.items()
        },
        "total_actors": sum(sum(s.values()) for s in groups.values()),
    }


def summarize_objects() -> Dict[str, Any]:
    rows = list_objects(limit=1_000_000)
    by_tier: Dict[str, Dict[str, float]] = defaultdict(lambda: {"count": 0, "bytes": 0})
    for r in rows:
        t = by_tier[r["tier"]]
        t["count"] += 1
        t["bytes"] += r["size_bytes"] or 0
    return {"summary": {k: dict(v) for k, v in by_tier.items()}, "total_objects": len(rows)}


# ---------------------------------------------------------------------------
# Singular accessors + the listing tail (parity: ray.util.state get_*/list_*
# in python/ray/util/state/api.py and its StateApiClient)
# ---------------------------------------------------------------------------
def _first(rows: List[dict], key: str, value: str) -> Optional[dict]:
    for r in rows:
        if r.get(key) == value or str(r.get(key, "")).startswith(value):
            return r
    return None


def get_node(node_id: str) -> Optional[dict]:
    return _first(list_nodes(limit=100_000), "node_id", node_id)


def get_actor(actor_id: str) -> Optional[dict]:
    return _first(list_actors(limit=100_000), "actor_id", actor_id)


def get_task(task_id: str) -> Optional[dict]:
    return _first(list_tasks(limit=100_000), "task_id", task_id)


def get_objects(object_id: str) -> List[dict]:
    """All state rows for one object id (an object can live on several
    nodes; parity: get_objects returns a list)."""
    return [
        r
        for r in list_objects(limit=1_000_000)
        if r.get("object_id", "").startswith(object_id)
    ]


def get_placement_group(placement_group_id: str) -> Optional[dict]:
    return _first(
        list_placement_groups(limit=100_000), "placement_group_id", placement_group_id
    )


def get_job(job_id: str) -> Optional[dict]:
    rows = list_jobs(limit=100_000)
    return _first(rows, "job_id", job_id) or _first(rows, "submission_id", job_id)


def list_workers(filters: Optional[List[tuple]] = None, limit: int = 1000) -> List[dict]:
    """Pool workers across in-process nodes. Keys: worker_id (pid-derived),
    node_id, pid, is_alive, dedicated."""
    cluster = _cluster()
    rows: List[dict] = []
    for node_id, node in list(cluster.nodes.items()):
        pool = getattr(node, "worker_pool", None)
        if pool is None:
            continue
        with pool._lock:
            handles = list(pool._all.values())
        for h in handles:
            rows.append(
                {
                    "worker_id": f"worker-{h.pid}",
                    "node_id": node_id.hex(),
                    "pid": h.pid,
                    "is_alive": h.alive,
                    "dedicated": h.dedicated,
                }
            )
    return _limited(rows, limit, filters)


def get_worker(worker_id: str) -> Optional[dict]:
    return _first(list_workers(limit=100_000), "worker_id", worker_id)


def list_runtime_envs(limit: int = 1000) -> List[dict]:
    """Cached runtime-env URIs with reference counts (parity:
    list_runtime_envs over the agent's cached envs)."""
    from ray_tpu_torch.runtime_env.plugin import _cache

    return _cache.describe()[:limit]


def list_logs(node_id: Optional[str] = None) -> Dict[str, List[str]]:
    """Log sources per node (parity: list_logs — here one worker-log
    stream per remote node, captured by the head's NodeLogStore)."""
    cluster = _cluster()
    store = cluster.node_logs
    known = list(store.nodes())
    nodes = [n for n in known if n.startswith(node_id)] if node_id else known
    return {n: ["worker_out"] for n in nodes}


def get_log(node_id: str, *, lines: int = 100) -> List[str]:
    """Tail one node's captured worker logs (parity: get_log)."""
    return _cluster().node_logs.tail(node_id, lines)


def list_cluster_events(limit: int = 1000) -> List[dict]:
    """Structured cluster events (parity: list_cluster_events)."""
    from ray_tpu_torch.observability.events import global_event_manager

    return [
        {
            "timestamp": e.timestamp,
            "severity": getattr(e.severity, "name", str(e.severity)),
            "source_type": e.source_type,
            "label": e.label,
            "message": e.message,
            "custom_fields": dict(e.custom_fields or {}),
        }
        for e in global_event_manager().list_events(limit=limit)
    ]


class StateApiClient:
    """Programmatic client over the state API (parity:
    ray.util.state.StateApiClient). In-process: methods call the module
    functions against the current cluster; the REST dashboard serves the
    same data cross-process."""

    def list(self, resource: str, *, filters=None, limit: int = 1000):
        fn = {
            "nodes": list_nodes,
            "actors": list_actors,
            "tasks": list_tasks,
            "objects": list_objects,
            "placement_groups": list_placement_groups,
            "jobs": list_jobs,
            "workers": list_workers,
        }.get(resource)
        if fn is None:
            raise ValueError(f"unknown resource {resource!r}")
        return fn(filters=filters, limit=limit)

    def get(self, resource: str, id: str):  # noqa: A002
        fn = {
            "nodes": get_node,
            "actors": get_actor,
            "tasks": get_task,
            "objects": get_objects,
            "placement_groups": get_placement_group,
            "jobs": get_job,
            "workers": get_worker,
        }.get(resource)
        if fn is None:
            raise ValueError(f"unknown resource {resource!r}")
        return fn(id)
