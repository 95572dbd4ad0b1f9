"""SPMD collectives over the axes of the current mesh.

Counterpart of layer 1 of ``ray_tpu/parallel/collective.py`` (the functional
collectives the reference calls inside ``shard_map``; its actor collective
groups and device-channel stager need the host runtime and are not here).
Every rank calls the same function on its own shard, and ``axis_name`` means
that axis of ``mesh=`` where the caller gives one, else of the current mesh
(:func:`ray_tpu_torch.parallel.mesh.current_mesh`). Code that autograd may
re-run later (a checkpointed layer's recompute) passes ``mesh=``, so that it
does not depend on which mesh is entered when the backward runs.

Each collective is differentiable where JAX's is, with JAX's transposes:
``allreduce`` (psum) transposes to psum, as in ``shard_map`` with checking
off (the gradient of a sum of every rank's local function); ``allgather``
to a reduce-scatter and back; ``all_to_all`` to the reverse swap;
``ppermute`` to the inverse permutation.

Transport. The collectives run on the axis's process group. A gloo group
takes CUDA tensors for its collectives (it copies them through host memory
itself) but not for send and receive: for ``ppermute`` on a gloo group a
CUDA tensor is staged through host memory here (copied to the CPU, sent,
copied back), keyed on the group's backend, never on an exception. The
bytes that cross the host for a gloo group holding CUDA tensors, by
either copy, are counted in :data:`staged`, and every operation in
:data:`calls`. The kernels still run on the
card; only the transfer goes through the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import Mesh, current_mesh, spec_axes

# bytes of CUDA tensors carried through host memory by a gloo group (each
# operation's input and output), by operation
staged: Dict[str, int] = {}
# operations run, by operation (every group and device)
calls: Dict[str, int] = {}


def reset_staged() -> None:
    staged.clear()
    calls.clear()


def _on_host(group, x: torch.Tensor) -> bool:
    """A gloo group carrying a CUDA tensor: it crosses host memory."""
    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _count(op: str, group, *ts: torch.Tensor) -> None:
    calls[op] = calls.get(op, 0) + 1
    if ts and _on_host(group, ts[0]):
        staged[op] = staged.get(op, 0) + sum(t.numel() * t.element_size() for t in ts)


def _gather_fn():
    return getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _reduce_scatter_fn():
    return getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


# --------------------------------------------------------------------------
# the transfers (no autograd): group-level operations on one tensor
# --------------------------------------------------------------------------
def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    _count("all_reduce", group, out, out)
    return out


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order."""
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=src.dtype, device=src.device)
    _gather_fn()(out, src, group=group)
    _count("all_gather", group, src, out)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over ranks of ``x``, this rank's block of it along ``dim``."""
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce-scatter of size {x.shape[dim]} over {n} ranks")
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=src.dtype, device=src.device)
    _reduce_scatter_fn()(out, src, group=group)
    _count("reduce_scatter", group, src, out)
    return out.movedim(0, dim)


def _all_to_all(chunks: torch.Tensor, group) -> torch.Tensor:
    """``chunks`` [n, ...]: chunk j goes to group rank j; returns [n, ...]
    with the chunk from rank j at j."""
    src = chunks.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    _count("all_to_all", group, src, out)
    return out


def _permute(x: torch.Tensor, group, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Send ``x`` to the destination of this rank's pair in ``perm`` and
    receive from the source naming it; zeros where no pair names this rank
    as a destination (``lax.ppermute``)."""
    me = dist.get_group_rank(group, dist.get_rank())
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute {perm}: rank {me} appears twice")
    out = torch.zeros_like(x)
    if dst and dst[0] == me:
        return x.clone()
    send = x.contiguous()
    # gloo's send and receive take host memory only (on CUDA they write a
    # device pointer to the socket): stage through it
    staging = _on_host(group, send)
    if staging:
        send = send.cpu()
        out = out.cpu()
    ops = []
    if dst:
        ops.append(dist.P2POp(dist.isend, send, dist.get_global_rank(group, dst[0]), group))
    if src:
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src[0]), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    _count("ppermute", group, x, *([x] if src else []))
    if staging:
        out = out.to(x.device)
    return out


# --------------------------------------------------------------------------
# autograd: JAX's transposes
# --------------------------------------------------------------------------
class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    """[n, ...] chunks in, [n, ...] chunks out; its own transpose."""

    @staticmethod
    def forward(ctx, chunks, group):
        ctx.group = group
        return _all_to_all(chunks, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _permute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return _permute(g, ctx.group, inverse), None, None


class _ReplicatedSum(torch.autograd.Function):
    """Sum over the group into a value every rank then holds alike, and
    whose cotangent every rank holds alike (every rank computes the one
    loss on it): the cotangent passes through. ``shard_map`` divides a
    replicated output's cotangent by the replication before its psum
    transpose, which comes to the same."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Tie(torch.autograd.Function):
    """``x`` itself, with ``others`` joined to it in the graph: their
    cotangent is zeros. A communication whose result one rank does not use
    (a K/V shard a causal ring skips) must still run its backward there, or
    the peers that do use theirs wait on it for ever."""

    @staticmethod
    def forward(ctx, x, *others):
        ctx.others = [(o.shape, o.dtype, o.device) for o in others]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=v) for s, d, v in ctx.others))


def tie(x: torch.Tensor, *others: torch.Tensor) -> torch.Tensor:
    """``x``, with the backward of whatever produced ``others`` run on
    every rank (with zero cotangents) whenever ``x``'s is."""
    others = [o for o in others if o.requires_grad]
    return _Tie.apply(x, *others) if others and torch.is_grad_enabled() else x


def _mesh(mesh: Optional[Mesh]) -> Mesh:
    return mesh if mesh is not None else current_mesh()


# --------------------------------------------------------------------------
# layer 1: SPMD functional collectives (the reference's names)
# --------------------------------------------------------------------------
def allreduce(x: torch.Tensor, axis_name, *, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Sum over a mesh axis (or a tuple of axes); psum."""
    for a in spec_axes(axis_name):
        x = _AllReduce.apply(x, _mesh(mesh).group(a))
    return x


def replicated_sum(x: torch.Tensor, axis_name, *, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Sum over a mesh axis (or axes) into a replicated output (the
    ``out_specs=P()`` of a ``shard_map``): forward a psum, and the
    cotangent, the same on every rank, passes through."""
    for a in spec_axes(axis_name):
        x = _ReplicatedSum.apply(x, _mesh(mesh).group(a))
    return x


def allreduce_mean(x: torch.Tensor, axis_name, *, mesh: Optional[Mesh] = None) -> torch.Tensor:
    n = 1
    for a in spec_axes(axis_name):
        n *= axis_size(a, mesh=mesh)
    return allreduce(x, axis_name, mesh=mesh) / n


def allgather(x: torch.Tensor, axis_name: str, *, axis: int = 0, tiled: bool = True,
              mesh: Optional[Mesh] = None):
    """The shards concatenated along ``axis`` (``tiled``) or stacked on a
    new ``axis``."""
    if not tiled:
        x = x.unsqueeze(axis)
    return _AllGather.apply(x, _mesh(mesh).group(axis_name), axis % x.ndim)


def reducescatter(x: torch.Tensor, axis_name: str, *, scatter_dimension: int = 0,
                  mesh: Optional[Mesh] = None):
    """The sum over the axis, this rank's block along ``scatter_dimension``."""
    return _ReduceScatter.apply(x, _mesh(mesh).group(axis_name), scatter_dimension % x.ndim)


def broadcast(x: torch.Tensor, axis_name: str, *, root: int = 0,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Every shard receives ``root``'s value: mask and psum, as the
    reference lowers it (so it transposes as a psum)."""
    keep = torch.tensor(axis_index(axis_name, mesh=mesh) == root, device=x.device)
    return allreduce(torch.where(keep, x, torch.zeros_like(x)), axis_name, mesh=mesh)


def ppermute(x: torch.Tensor, axis_name: str, perm, *,
             mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``perm``: (source, destination) pairs of axis coordinates."""
    return _PPermute.apply(x, _mesh(mesh).group(axis_name),
                           tuple((int(s), int(d)) for s, d in perm))


def all_to_all(x: torch.Tensor, axis_name: str, split_axis: int, concat_axis: int, *,
               tiled: bool = True, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Split ``x`` along ``split_axis`` into one chunk a rank; chunk j goes
    to rank j; the received chunks are concatenated along ``concat_axis``
    (``tiled``), or with ``tiled=False`` the split axis (of size n) is
    removed and the chunks stacked on a new ``concat_axis``."""
    n = axis_size(axis_name, mesh=mesh)
    split_axis %= x.ndim
    if tiled:
        if x.shape[split_axis] % n:
            raise ValueError(f"all_to_all: axis {split_axis} of size {x.shape[split_axis]} "
                             f"does not split over {n} ranks")
        chunks = x.unflatten(split_axis, (n, x.shape[split_axis] // n)).movedim(split_axis, 0)
    else:
        if x.shape[split_axis] != n:
            raise ValueError(f"all_to_all(tiled=False): axis {split_axis} must have size {n}")
        chunks = x.movedim(split_axis, 0)
    got = _AllToAll.apply(chunks, _mesh(mesh).group(axis_name))  # [n, ...chunk]
    if tiled:
        concat_axis %= x.ndim
        # chunk j's dims are x's dims; concatenate them along concat_axis
        got = got.movedim(0, concat_axis)  # [..., n, chunk_dim(concat_axis), ...]
        return got.flatten(concat_axis, concat_axis + 1)
    return got.movedim(0, concat_axis % (x.ndim))


def send_recv(x: torch.Tensor, axis_name: str, *, shift: int = 1,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Neighbour exchange on a ring: send to rank+shift, receive from
    rank-shift."""
    n = axis_size(axis_name, mesh=mesh)
    return ppermute(x, axis_name, [(i, (i + shift) % n) for i in range(n)], mesh=mesh)


def axis_index(axis_name: str, *, mesh: Optional[Mesh] = None) -> int:
    """This rank's coordinate along the axis."""
    return _mesh(mesh).axis_index(axis_name)


def axis_size(axis_name: str, *, mesh: Optional[Mesh] = None) -> int:
    return _mesh(mesh).shape[axis_name]


def barrier(axis_name: str, *, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Every rank of the axis reaches this point: a psum of an int32 zero
    (the reference's form), on the device the mesh computes on."""
    from ray_tpu_torch.parallel import distributed

    zero = torch.zeros((), dtype=torch.int32, device=distributed.device_type())
    return _all_reduce(zero, _mesh(mesh).group(axis_name))


__all__: List[str] = [
    "allreduce", "allreduce_mean", "allgather", "reducescatter", "broadcast", "ppermute",
    "all_to_all", "send_recv", "axis_index", "axis_size", "barrier", "replicated_sum",
    "tie", "staged", "calls", "reset_staged",
]
