"""PyTorch/CUDA port of ray_tpu: the host runtime, the LLM serving path and
the train step.

The JAX package ``ray_tpu`` is the reference this package is held against;
nothing here imports it (or JAX). Layout mirrors it module for module:
``api`` (``init``, ``@remote`` on functions and classes, ``get`` / ``put`` /
``wait`` / ``kill`` / ``get_actor``), ``core`` (ids, config, the tiered object
store whose device tier holds CUDA tensors, serialization, reference
counting), ``runtime`` (the single-host cluster fabric, scheduler, control
service, process worker pool, admission control), ``ops`` (attention
kernels, forward and backward, hand-written CUDA under ``ops/csrc``),
``models`` (decoder, its train step, cached generation and model
checkpoints), ``serve`` (the continuous-batching engine, its block
allocator and prefix cache), ``parallel`` (meshes, collectives, sharded
steps), ``train`` (trainers, the session, ``TrainController`` gangs and
framed checkpoints), ``tune``, ``job`` and ``workflow`` (submitted jobs and
durable DAGs), ``state`` (listings over the control tables), plus
``convert`` (JAX param trees and train states as numpy arrays to tensors).
Entry points run on the GPU unless the caller asks for the CPU.  Importing
the package imports no torch: CPU worker processes start without it.
"""

from ray_tpu_torch._version import version as __version__
from ray_tpu_torch.api import (
    ActorClass,
    ActorHandle,
    ActorMethod,
    RemoteFunction,
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    get_cluster,
    get_runtime_context,
    init,
    is_initialized,
    kill,
    method,
    nodes,
    put,
    remote,
    shutdown,
    timeline,
    wait,
)
from ray_tpu_torch.core.generator import ObjectRefGenerator
from ray_tpu_torch.core.ids import (
    ActorClassID,
    ActorID,
    FunctionID,
    JobID,
    NodeID,
    ObjectID,
    PlacementGroupID,
    TaskID,
    UniqueID,
    WorkerID,
)
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    ActorUnavailableError,
    GetTimeoutError,
    NotPortedError,
    ObjectLostError,
    RayActorError,
    RayTaskError,
    RayTpuError,
    TaskCancelledError,
    WorkerCrashedError,
)

#: Streaming-generator return type under its reference alias.
DynamicObjectRefGenerator = ObjectRefGenerator

__all__ = [
    "__version__",
    "ActorClass",
    "ActorHandle",
    "ActorMethod",
    "ObjectRef",
    "ObjectRefGenerator",
    "RemoteFunction",
    "available_resources",
    "cancel",
    "cluster_resources",
    "get",
    "get_actor",
    "get_cluster",
    "get_gpu_ids",
    "get_runtime_context",
    "init",
    "is_initialized",
    "kill",
    "method",
    "nodes",
    "put",
    "remote",
    "shutdown",
    "timeline",
    "wait",
    # exceptions
    "ActorDiedError",
    "ActorUnavailableError",
    "GetTimeoutError",
    "NotPortedError",
    "ObjectLostError",
    "RayActorError",
    "RayTaskError",
    "RayTpuError",
    "TaskCancelledError",
    "WorkerCrashedError",
    # ids
    "ActorClassID",
    "ActorID",
    "DynamicObjectRefGenerator",
    "FunctionID",
    "JobID",
    "NodeID",
    "ObjectID",
    "PlacementGroupID",
    "TaskID",
    "UniqueID",
    "WorkerID",
]


_LAZY_SUBMODULES = (
    "accelerators", "air", "chaos", "data", "experimental", "job", "models", "ops",
    "parallel", "rllib", "serve", "state", "train", "tune", "util", "workflow",
)


def __getattr__(name: str):
    # `import ray_tpu_torch as rt; rt.data.range(...)` works without paying
    # every library's import cost at package import, as in the JAX package
    if name in _LAZY_SUBMODULES:
        import importlib

        return importlib.import_module(f"ray_tpu_torch.{name}")
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")


def get_gpu_ids() -> list:
    """The CUDA device indices visible to this process (empty in a worker
    process, which hides the card)."""
    from ray_tpu_torch.accelerators import gpu

    return list(range(gpu.get_num_gpus()))
