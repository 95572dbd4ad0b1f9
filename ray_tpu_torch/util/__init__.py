"""ray_tpu_torch.util: utility APIs layered on the core.

The port's copy of ``ray_tpu/util/__init__.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``. Two names wait for later slices and raise
``NotPortedError``: ``connect`` (the thin client, ``ray_tpu/util/client/``)
and ``collective`` (actor collective groups, ``ray_tpu/util/collective.py``).

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
from ray_tpu_torch import accelerators
from ray_tpu_torch.exceptions import NotPortedError


def connect(*args, **kwargs):
    """The thin client's ``util.connect``: not ported yet."""
    raise NotPortedError("util.connect (the thin client)", "ray_tpu/util/client/worker.py")


def __getattr__(name: str):
    if name == "collective":
        raise NotPortedError("util.collective (actor collective groups)",
                             "ray_tpu/util/collective.py")
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
