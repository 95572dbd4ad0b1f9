"""ray_tpu_torch.util: utility APIs layered on the core.

The port's copy of ``ray_tpu/util/__init__.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``; ``connect`` is the port's thin client
(``util/client/``).

Parity: ``python/ray/util/`` (SURVEY §2.4 util misc) — ActorPool, Queue,
collective ops, scheduling strategies, serializability checking.
"""

from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.queue import Empty, Full, Queue
from ray_tpu_torch.util.check_serialize import inspect_serializability
from ray_tpu_torch.util import iter, pdb  # noqa: A004 — reference name
from ray_tpu_torch.util import pdb as ray_debugpy  # reference exports util.debugpy under this name
from ray_tpu_torch.util.misc import (
    deregister_serializer,
    disable_log_once_globally,
    enable_periodic_logging,
    get_node_ip_address,
    list_named_actors,
    log_once,
    register_serializer,
)
from ray_tpu_torch.util.placement import (
    PlacementGroup,
    get_current_placement_group,
    get_placement_group,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from ray_tpu_torch.runtime.scheduler import (
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)
from ray_tpu_torch.util.client.worker import connect
from ray_tpu_torch import accelerators


def __getattr__(name: str):
    # ``collective`` imports torch (its groups reduce tensors): load it on
    # first use, so that ``import ray_tpu_torch.util`` stays torch-free for
    # worker processes
    if name == "collective":
        import importlib

        return importlib.import_module(__name__ + ".collective")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def disconnect() -> None:
    """Close the thin-client session opened by util.connect (parity:
    ray.util.disconnect — connect() returns the context; keeping a module
    handle on the last one mirrors the reference's global stub)."""
    ctx = getattr(connect, "_last_context", None)
    if ctx is not None:
        ctx.disconnect()


__all__ = [
    "ActorPool",
    "PlacementGroup",
    "accelerators",
    "collective",
    "connect",
    "disconnect",
    "get_current_placement_group",
    "get_placement_group",
    "placement_group",
    "placement_group_table",
    "remove_placement_group",
    "Empty",
    "Full",
    "NodeAffinitySchedulingStrategy",
    "NodeLabelSchedulingStrategy",
    "PlacementGroupSchedulingStrategy",
    "Queue",
    "deregister_serializer",
    "disable_log_once_globally",
    "enable_periodic_logging",
    "get_node_ip_address",
    "inspect_serializability",
    "iter",
    "list_named_actors",
    "log_once",
    "pdb",
    "ray_debugpy",
    "register_serializer",
]
