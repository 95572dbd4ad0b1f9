"""Meshes and shardings: named axes over the ranks of a process group.

Counterpart of ``ray_tpu/parallel/mesh.py``. The JAX package is single
controller: one process holds a ``jax.sharding.Mesh`` of devices and XLA
inserts the collectives. Here every rank is a process of its own (SPMD as
PyTorch does it), and a :class:`Mesh` lays the ranks of the process group
out under the reference's axis names, in its canonical order (dp outermost,
tp innermost). With a process group it wraps a
``torch.distributed.device_mesh.DeviceMesh``, whose per-axis process groups
the collectives of :mod:`ray_tpu_torch.parallel.collective` run on; without
one it is the layout alone (what the reference's tests of construction,
inference and order check).

A JAX global array becomes "every rank holds its block": :func:`shard_array`
takes the full tensor (every rank holds the same one) and returns this
rank's block of it under a :class:`PartitionSpec`; :func:`gather_array`
reads a sharded value back whole, as ``np.asarray`` of a global array does.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# Canonical axis order: dp outermost, sp/tp innermost (the most-communicating
# axes on adjacent ranks), as the reference lays out its devices.
_CANONICAL_ORDER = ("dp", "fsdp", "pp", "ep", "sp", "tp")


class PartitionSpec(tuple):
    """One entry a tensor dimension: a mesh axis name, a tuple of names, or
    None (replicated), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """Named axes over the ranks of the default process group.

    ``devices`` is the array of global ranks (``jax.sharding.Mesh.devices``
    holds devices there); ``shape`` maps each axis name to its size, in axis
    order, and ``axis_names`` lists them. With a process group the mesh
    holds a ``DeviceMesh`` (``device_mesh``) and :meth:`group` gives an
    axis's process group; entering the mesh (``with mesh:``) makes it the
    current mesh, whose axes the collectives name."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))
        self.device_mesh = None
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and dist.get_world_size() == devices.size:
            from torch.distributed.device_mesh import DeviceMesh

            from ray_tpu_torch.parallel import distributed as _dist

            self.device_mesh = DeviceMesh(
                _dist.device_type(), torch.as_tensor(devices.astype(np.int64)),
                mesh_dim_names=self.axis_names)

    def __repr__(self):
        return f"Mesh({self.shape})"

    @property
    def size(self) -> int:
        return int(self.devices.size)

    # -- the process-group side ------------------------------------------
    def _need_group(self):
        if self.device_mesh is None:
            raise RuntimeError(
                "this mesh is a layout only: initialize the process group "
                "(ray_tpu_torch.parallel.distributed.initialize) before creating it")
        return self.device_mesh

    def group(self, axis: str):
        """The process group of ``axis`` that holds this rank."""
        if axis not in self.shape:
            raise ValueError(f"{axis!r} is not a mesh axis (mesh has {list(self.axis_names)})")
        return self._need_group().get_group(axis)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        if axis not in self.shape:
            raise ValueError(f"{axis!r} is not a mesh axis (mesh has {list(self.axis_names)})")
        return int(self._need_group().get_local_rank(axis))

    def coords(self) -> Dict[str, int]:
        return {a: self.axis_index(a) for a in self.axis_names}

    def __enter__(self):
        _current.append(self)
        return self

    def __exit__(self, *exc):
        _current.pop()
        return False


# the meshes entered, innermost last: one for the process, not a thread (a
# rank is a process, and autograd runs a CUDA backward, a checkpointed
# layer's recompute included, on a thread of its own)
_current: List[Mesh] = []


def current_mesh() -> Mesh:
    """The innermost mesh entered with ``with mesh:``."""
    if not _current:
        raise RuntimeError("no current mesh: call inside `with mesh:` (or a *_sharded wrapper)")
    return _current[-1]


class MeshManager:
    """Named-mesh registry and construction in the canonical axis order."""

    def __init__(self, devices: Optional[Sequence] = None):
        self._lock = threading.Lock()
        self._meshes: Dict[str, Mesh] = {}
        self._devices = list(devices) if devices is not None else None

    def devices(self) -> List:
        """The ranks a mesh is laid over: those given, or every rank of the
        default process group (rank 0 alone without one)."""
        if self._devices is None:
            import torch.distributed as dist

            n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
            self._devices = list(range(n))
        return self._devices

    def create_mesh(self, axes: Dict[str, int], *, name: Optional[str] = None,
                    devices: Optional[Sequence] = None) -> Mesh:
        """A mesh with the given axis sizes. They must multiply to the rank
        count; one ``-1`` axis is inferred. Axes are laid out in canonical
        order so the highest-traffic axes (tp, sp) take adjacent ranks."""
        devs = list(devices) if devices is not None else self.devices()
        axes = dict(axes)
        known = math.prod(v for v in axes.values() if v != -1)
        inferred = [k for k, v in axes.items() if v == -1]
        if len(inferred) > 1:
            raise ValueError("at most one axis may be -1")
        if inferred:
            if len(devs) % known:
                raise ValueError(f"{len(devs)} devices not divisible by {known}")
            axes[inferred[0]] = len(devs) // known
        if math.prod(axes.values()) != len(devs):
            raise ValueError(f"axis sizes {axes} do not multiply to {len(devs)} devices")
        ordered = sorted(axes.items(), key=_axis_sort_key)
        names = tuple(k for k, _ in ordered)
        shape = tuple(v for _, v in ordered)
        mesh = Mesh(np.asarray(devs).reshape(shape), names)
        if name:
            with self._lock:
                self._meshes[name] = mesh
        return mesh

    def get_mesh(self, name: str) -> Mesh:
        with self._lock:
            if name not in self._meshes:
                raise KeyError(f"no mesh named {name!r}")
            return self._meshes[name]

    def list_meshes(self) -> Dict[str, Mesh]:
        with self._lock:
            return dict(self._meshes)

    def auto_mesh(self, *, dp: Optional[int] = None, tp: Optional[int] = None,
                  name: Optional[str] = None) -> Mesh:
        """Every rank on one 'dp' axis unless tp is given."""
        n = len(self.devices())
        if tp is None and dp is None:
            return self.create_mesh({"dp": n}, name=name)
        if tp is None:
            tp = n // dp
        if dp is None:
            dp = n // tp
        return self.create_mesh({"dp": dp, "tp": tp}, name=name)


def _axis_sort_key(item: Tuple[str, int]):
    name, _ = item
    try:
        return (_CANONICAL_ORDER.index(name), name)
    except ValueError:
        return (len(_CANONICAL_ORDER), name)


# --------------------------------------------------------------------------
# sharding helpers
# --------------------------------------------------------------------------
def named_sharding(mesh: Mesh, *spec) -> Tuple[Mesh, PartitionSpec]:
    """(mesh, spec): what ``jax.sharding.NamedSharding`` names."""
    return mesh, PartitionSpec(*spec)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name or a tuple of names)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _block(mesh: Mesh, entry) -> Tuple[int, int]:
    """(this rank's block index, block count) of a dimension sharded over
    ``entry``'s axes, the first axis major (the reference's order)."""
    idx, n = 0, 1
    for a in spec_axes(entry):
        idx = idx * mesh.shape[a] + mesh.axis_index(a)
        n *= mesh.shape[a]
    return idx, n


def shard_array(x: torch.Tensor, mesh: Mesh, *spec) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec`` (each
    dimension's entry names the axes it is split over; a dimension must
    divide evenly). A copy, so the block owns its memory."""
    out = x
    for dim, entry in enumerate(spec):
        i, n = _block(mesh, entry)
        if n == 1:
            continue
        if out.shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {out.shape[dim]} does not split over "
                             f"{n} ranks ({entry!r})")
        step = out.shape[dim] // n
        out = out.narrow(dim, i * step, step)
    return out.clone() if out is x else out.contiguous().clone()


def replicate(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank holds all of ``x`` (it already does: a copy of it)."""
    del mesh
    return x.clone()


def gather_array(x: torch.Tensor, mesh: Mesh, *spec) -> torch.Tensor:
    """The full tensor whose block under ``spec`` this rank holds: the
    blocks gathered from every rank of each sharded dimension's axes (last
    axis first, so the first axis ends up major). Every rank returns it."""
    from ray_tpu_torch.parallel.collective import _all_gather

    out = x.detach()
    for dim, entry in enumerate(spec):
        for a in reversed(spec_axes(entry)):
            out = _all_gather(out, mesh.group(a), dim)
    return out


def block_start(mesh: Mesh, entry, size: int) -> int:
    """The index, in the full dimension of ``size``, where this rank's
    block of a dimension sharded over ``entry`` starts."""
    i, n = _block(mesh, entry)
    return i * (size // n)


def shard_tree(tree, specs, mesh: Mesh):
    """:func:`shard_array` of every leaf of nested dicts under the spec of
    the same place in ``specs``."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return shard_array(tree, mesh, *specs)


def gather_tree(tree, specs, mesh: Mesh):
    """:func:`gather_array` of every leaf: the full tree on every rank."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, specs[k], mesh) for k, v in tree.items()}
    return gather_array(tree, mesh, *specs)


# --------------------------------------------------------------------------
# SPMD stage-group split/assemble (compiled-plan gang stages, dag/plan.py)
# --------------------------------------------------------------------------
def split_for_group(value: torch.Tensor, n: int, axis: int = 0) -> List[torch.Tensor]:
    """Split a tensor into ``n`` member shards along ``axis``.

    ``torch.split`` gives views on the tensor's device: no copy and no host
    round trip, so a gang stage's input fan-out is pure device work.  The
    split dimension must divide evenly (callers replicate non-divisible
    args instead)."""
    if n <= 1:
        return [value]
    size = int(value.shape[axis])
    if size % n:
        raise ValueError(f"dimension {axis} of size {size} does not split into {n} equal parts")
    return list(torch.split(value, size // n, dim=axis))


def assemble_from_group(parts: Sequence[torch.Tensor], mesh: Optional[Mesh] = None,
                        axis: int = 0) -> torch.Tensor:
    """Assemble gang-member outputs into one tensor.

    With a mesh over a process group whose size matches the member count,
    the parts are the blocks of one array sharded over all the mesh's axes
    (the first axis major, as :func:`shard_array` lays them out), and this
    rank holds its own block: that part is returned.  Otherwise, a
    layout-only mesh and the single-process gang included, the parts are
    concatenated on their device along ``axis``."""
    parts = list(parts)
    if not parts:
        raise ValueError("no member outputs to assemble")
    if len(parts) == 1 and mesh is None:
        return parts[0]
    if mesh is not None and mesh.size == len(parts) and mesh.device_mesh is not None:
        idx, _ = _block(mesh, tuple(mesh.axis_names))
        return parts[idx]
    return torch.cat(parts, dim=axis)


_global_manager: Optional[MeshManager] = None
_global_lock = threading.Lock()


def mesh_manager() -> MeshManager:
    global _global_manager
    if _global_manager is None:
        with _global_lock:
            if _global_manager is None:
                _global_manager = MeshManager()
    return _global_manager


def reset_mesh_manager() -> None:
    global _global_manager
    _global_manager = None
