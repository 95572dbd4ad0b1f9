"""State API — cluster-state listing and summaries (the port's copy of
``ray_tpu/state/``, the same ``__all__``).

Parity with ``python/ray/util/state/`` (``api.py:788 list_actors``,
``:1020 list_tasks``, ``:1382 summarize_tasks``): programmatic and CLI access
to live nodes, actors, tasks, objects, placement groups, jobs, workers,
runtime envs, logs and events, backed by the control service's tables
instead of a dashboard aggregator hop.
"""

from ray_tpu_torch.state.api import (
    StateApiClient,
    get_actor,
    get_job,
    get_log,
    get_node,
    get_objects,
    get_placement_group,
    get_task,
    get_worker,
    list_actors,
    list_cluster_events,
    list_jobs,
    list_logs,
    list_nodes,
    list_objects,
    list_placement_groups,
    list_runtime_envs,
    list_tasks,
    list_workers,
    summarize_actors,
    summarize_objects,
    summarize_tasks,
)

__all__ = [
    "StateApiClient",
    "get_actor",
    "get_job",
    "get_log",
    "get_node",
    "get_objects",
    "get_placement_group",
    "get_task",
    "get_worker",
    "list_actors",
    "list_cluster_events",
    "list_jobs",
    "list_logs",
    "list_nodes",
    "list_objects",
    "list_placement_groups",
    "list_runtime_envs",
    "list_tasks",
    "list_workers",
    "summarize_actors",
    "summarize_objects",
    "summarize_tasks",
]
