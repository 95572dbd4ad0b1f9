"""The process group: joining it, and meshes that span hosts.

Counterpart of ``ray_tpu/parallel/distributed.py``. The reference joins
``jax.distributed``'s coordination service, after which one process sees
every host's devices. Here each rank is a process, and joining means
``torch.distributed.init_process_group``:

* :func:`initialize` — join the process group (idempotent), from explicit
  arguments or, with none, from the launcher's environment (``MASTER_ADDR``,
  ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, as ``torchrun`` sets them: the
  counterpart of a TPU pod's discovery). The backend is ``"nccl"`` for CUDA
  and ``"gloo"`` for ``device="cpu"`` unless the caller names one; nothing
  swaps it on failure.
* :func:`before_leave` — what :func:`shutdown` stops before this process
  leaves the group.
* :func:`multihost_mesh` — a :class:`~ray_tpu_torch.parallel.mesh.Mesh` whose
  dcn axis owns whole hosts' blocks of ranks (the reference's reshape and
  ``moveaxis``).
* :func:`rendezvous_via_cluster` — agree on rank 0's address through the
  runtime's control KV; :func:`initialize` takes what it returns.
"""

from __future__ import annotations

import datetime
import os
import time
import weakref
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

_device_type: Optional[str] = None
_before_leave: "weakref.WeakSet" = weakref.WeakSet()


def device_type() -> str:
    """``"cuda"`` or ``"cpu"``: the device the ranks of this process group
    compute on (set by :func:`initialize`; ``"cuda"`` when CUDA is there
    and the group was joined some other way)."""
    if _device_type is not None:
        return _device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    timeout_s: float = 120.0,
    backend: Optional[str] = None,
    device=None,
) -> bool:
    """Join the process group (idempotent). Returns True if this call
    joined it, False if this process already had.

    ``coordinator_address``: ``"host:port"`` (TCP rendezvous at rank 0's
    address) or a ``file://`` path (a file store); with None, the
    launcher's environment. ``device``: where the ranks compute, ``"cuda"``
    (the default) or ``"cpu"``; ``backend``: ``"nccl"`` for CUDA and
    ``"gloo"`` for the CPU unless named. ``timeout_s`` bounds every
    collective of the group: a rank that waits longer fails instead of
    hanging. A CUDA rank takes device ``process_id % device_count`` (so
    several ranks may share one card)."""
    global _device_type
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the process group computes on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the ranks on the CPU")
        device = "cuda"
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if coordinator_address is None:
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    elif coordinator_address.startswith(("file://", "tcp://", "env://")):
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if num_processes is None or process_id is None:
        raise ValueError("num_processes and process_id go with a coordinator_address")
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
        if backend == "nccl":
            kwargs["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    _device_type = dev.type
    return True


def before_leave(obj) -> None:
    """Have :func:`shutdown` call ``obj.shutdown()`` before this process
    leaves the group, if ``obj`` is alive then: a tensor-parallel engine's
    driver, whose peers leave their collectives only on its stop call."""
    _before_leave.add(obj)


def shutdown() -> None:
    """Leave the process group (no-op outside one), after shutting down
    what :func:`before_leave` named."""
    global _device_type
    import torch.distributed as dist

    if dist.is_initialized():
        for obj in list(_before_leave):
            obj.shutdown()
        _before_leave.clear()
        dist.destroy_process_group()
    _device_type = None


def multihost_mesh(axis_names: Sequence[str], axis_sizes: Sequence[int], *,
                   dcn_axis: str = "dp", devices: Optional[Sequence] = None):
    """A mesh over every rank with the dcn (host-crossing) axis owning
    whole, contiguous host blocks of ranks: only that axis's collectives
    cross hosts. ``axis_sizes`` may use -1 once. ``devices``: the ranks in
    host order (every rank of the process group by default); the layout is
    computed without a process group when they are given."""
    from ray_tpu_torch.parallel.mesh import Mesh, mesh_manager

    devs = list(devices) if devices is not None else mesh_manager().devices()
    names = list(axis_names)
    sizes = list(axis_sizes)
    n = len(devs)
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} devices")
    if dcn_axis in names:
        # dcn axis first so the reshape gives it whole host blocks; axis j of
        # the reshaped array is the axis NAMED names[order[j]], so it moves to
        # position order[j]
        order = [names.index(dcn_axis)] + [i for i in range(len(names)) if names[i] != dcn_axis]
        arr = np.array(devs).reshape([sizes[i] for i in order])
        arr = np.moveaxis(arr, range(len(order)), order)
    else:
        arr = np.array(devs).reshape(sizes)
    return Mesh(arr, tuple(names))


def rendezvous_via_cluster(
    rank: int,
    world_size: int,
    *,
    group_name: str = "default",
    port: int = 0,
    timeout_s: float = 120.0,
) -> Tuple[str, int, int]:
    """Agree on a coordinator via the control-plane KV (NCCL-id-actor
    parity): rank 0 picks ``host:port`` and publishes it; other ranks poll.
    ``group_name`` scopes the key per gang — a retry or a second job must
    not read a dead gang's address. Returns (coordinator_address,
    world_size, rank) ready for :func:`initialize`.

    The port's runtime is one host, so rank 0 publishes its loopback
    address, where the JAX package publishes a routable one for agents on
    other hosts (the multi-node runtime is not ported)."""
    import socket

    from ray_tpu_torch.runtime.kv_client import get_kv

    # the in-process control KV on the driver, the worker-api KV in a pool
    # worker
    kv = get_kv()
    if kv is None:
        raise RuntimeError("no cluster KV reachable from this process (init ray_tpu_torch first)")
    key = f"jax_distributed_coordinator/{group_name}".encode()
    if rank == 0:
        host = "127.0.0.1"
        if port == 0:
            with socket.socket() as s:
                s.bind((host, 0))
                port = s.getsockname()[1]
        address = f"{host}:{port}"
        kv.put(key, address.encode())
    else:
        deadline = time.monotonic() + timeout_s
        while True:
            raw = kv.get(key)
            if raw:
                address = raw.decode()
                break
            if time.monotonic() > deadline:
                raise TimeoutError("rank 0 never published the coordinator address")
            time.sleep(0.05)
    return address, world_size, rank
