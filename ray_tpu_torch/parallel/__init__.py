"""Parallelism layer: meshes, collectives, sequence and pipeline parallelism.

Counterpart of ``ray_tpu/parallel/``, SPMD as PyTorch does it: one process
a rank, every rank running the function the reference runs inside
``shard_map`` on its own shard, the collectives from ``torch.distributed``
on the process group of a mesh axis. dp/tp by the models' sharding rules,
sp by ring attention or Ulysses, pp by the microbatch pipeline.

With the host runtime: the actor collective groups
(``init_collective_group`` and the ``*_tensor`` calls; ``util.collective``
is their public face) and ``rendezvous_via_cluster`` on the control KV.
"""

from ray_tpu_torch.parallel.mesh import (
    Mesh,
    MeshManager,
    P,
    PartitionSpec,
    current_mesh,
    gather_array,
    mesh_manager,
    named_sharding,
    replicate,
    reset_mesh_manager,
    shard_array,
)
from ray_tpu_torch.parallel import collective
from ray_tpu_torch.parallel.collective import (
    allgather,
    allreduce,
    allreduce_mean,
    all_to_all,
    barrier,
    broadcast,
    init_collective_group,
    ppermute,
    reducescatter,
    send_recv,
)
from ray_tpu_torch.parallel.distributed import (
    initialize as distributed_initialize,
    multihost_mesh,
    rendezvous_via_cluster,
)
from ray_tpu_torch.parallel.launch import run_ranks
from ray_tpu_torch.parallel.pipeline import pipeline_apply, pipeline_sharded
from ray_tpu_torch.parallel.ring import (
    ring_attention,
    ring_attention_sharded,
    ulysses_attention,
    ulysses_attention_sharded,
)

__all__ = [
    "Mesh", "MeshManager", "P", "PartitionSpec", "current_mesh", "gather_array",
    "mesh_manager", "named_sharding", "replicate", "reset_mesh_manager", "shard_array",
    "collective", "allgather", "allreduce", "allreduce_mean", "all_to_all", "barrier",
    "broadcast", "init_collective_group", "distributed_initialize", "multihost_mesh",
    "rendezvous_via_cluster", "ppermute", "reducescatter",
    "send_recv", "pipeline_apply", "pipeline_sharded", "ring_attention",
    "ring_attention_sharded", "ulysses_attention", "ulysses_attention_sharded", "run_ranks",
]
