"""SPMD collectives over the axes of the current mesh.

Counterpart of layer 1 of ``ray_tpu/parallel/collective.py`` (the functional
collectives the reference calls inside ``shard_map``) and of its layer 3,
the device-channel exchange of compiled plans (:class:`DeviceChannelStager`
and the functions after it), and its actor collective groups (layer 2:
``init_collective_group`` and the ``*_tensor`` calls, which
``ray_tpu_torch.util.collective`` exposes).
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

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
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


# --------------------------------------------------------------------------
# layer 2: actor collective groups (ray.util.collective API parity)
# --------------------------------------------------------------------------
# The JAX package's layer 2, its own copy: ranks that all live in this
# process (in-process actors, threads) meet in a shared in-memory group and
# reduce in member order, on the card when the contributions are CUDA
# tensors; a group with a rank in a spawned worker process meets over the
# data-plane transport (``runtime/p2p.py``), tensors crossing as CPU
# copies.
class _Group:
    def __init__(self, world_size: int):
        self.world_size = world_size
        self.lock = threading.Lock()
        self.condition = threading.Condition(self.lock)
        self.contributions: Dict[int, Any] = {}
        self.result: Any = None
        self.generation = 0
        self.arrived = 0
        # DISTINCT ranks init_collective_group'd in THIS process: covering
        # all of range(world_size) proves every rank is local and the
        # in-memory rendezvous is safe.  A set, not a counter: a restarted
        # actor re-initing its rank must not inflate the count past world
        # and mis-latch a cross-process group to "inproc"
        self.local_ranks: set = set()
        # Latched routing ("transport" | "inproc"), decided on the group's
        # first collective.  The latch lives on the (per-process) group
        # object, so co-located ranks can never split across mechanisms;
        # cross-process groups see local_inits < world_size in EVERY
        # process and all choose transport — also consistent.
        self.routing: Optional[str] = None


class _GroupRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._groups: Dict[str, _Group] = {}

    def get_or_create(self, name: str, world_size: int) -> _Group:
        with self._lock:
            group = self._groups.get(name)
            if group is None:
                group = _Group(world_size)
                self._groups[name] = group
            return group

    def get(self, name: str) -> _Group:
        with self._lock:
            if name not in self._groups:
                raise KeyError(f"collective group {name!r} not initialized")
            return self._groups[name]

    def destroy(self, name: str) -> None:
        with self._lock:
            self._groups.pop(name, None)

    def clear(self) -> None:
        with self._lock:
            self._groups.clear()


_registry = _GroupRegistry()


def reset_module_state() -> None:
    """Fresh-runtime reset, called from cluster shutdown.  Collective groups
    belong to a runtime incarnation: a group surviving ``rt.shutdown()``
    carries stale generation counters and a stale routing latch, and the
    next ``rt.init()`` in this process would desync against peers that
    start at generation 0."""
    _registry.clear()
    from ray_tpu_torch.util.collective import _reset_binding_state

    _reset_binding_state()


def init_collective_group(world_size: int, rank: int, backend: str = "gpu", group_name: str = "default") -> None:
    """Reference parity: collective.py:120. Each participant calls this once
    with its rank before using group collectives."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for world_size {world_size}")
    group = _registry.get_or_create(group_name, world_size)
    if group.world_size != world_size:
        raise ValueError(
            f"collective group {group_name!r} already exists with world_size "
            f"{group.world_size}, got {world_size}; destroy it first"
        )
    with group.condition:
        group.local_ranks.add(rank)
    # NOTE: stale death notices from a previous runtime incarnation are
    # prevented at the source (cluster.shutdown marks the incarnation dead
    # before async death handlers can write into fresh p2p state); clearing
    # here would also erase GENUINE notices for a live group whose last
    # rank inits after a peer died.
    # publish this rank's data-plane address immediately: senders must be
    # able to reach a rank that has not yet issued any collective call.
    # ensure_endpoint: process workers and the driver build their transport
    # lazily here (every execution mode owns one — core_worker.h:292).
    try:
        from ray_tpu_torch.runtime import p2p
        from ray_tpu_torch.runtime.kv_client import is_multiprocess

        if is_multiprocess() and p2p.ensure_endpoint() is not None:
            p2p.register_rank(group_name, rank)
    except Exception:  # noqa: BLE001 — in-proc clusters have no data plane
        pass


def destroy_collective_group(group_name: str = "default") -> None:
    world = None
    try:
        world = _registry.get(group_name).world_size
    except KeyError:
        pass
    _registry.destroy(group_name)
    # drop rank-address registrations so a re-created group with different
    # placement can't resolve stale endpoints
    try:
        from ray_tpu_torch.runtime import p2p
        from ray_tpu_torch.runtime.kv_client import get_kv

        p2p.forget_group(group_name)
        kv = get_kv()
        if kv is not None and world is not None:
            for r in range(world):
                kv.delete(p2p.addr_key(group_name, r))
            kv.delete(f"rt_coll_grp/{group_name}".encode())
    except Exception:  # noqa: BLE001 — best-effort cleanup
        pass


def _host_value(value: Any) -> Any:
    """A tensor crosses the process boundary as a CPU copy (a worker
    process never sees the card)."""
    if isinstance(value, torch.Tensor) and value.device.type != "cpu":
        return value.detach().cpu()
    return value


def _rendezvous_transport(
    group_name: str, group: _Group, rank: int, value: Any, reduce_fn, timeout: float
):
    """Cross-process rendezvous over the data plane: contributions flow to
    rank 0's store as direct store-to-store pushes, rank 0 reduces and
    pushes the result back to every rank's store.  Receivers block on their
    LOCAL store condition variable — no polling.  Role parity:
    the reference's NCCL rendezvous + ring execution in
    collective_group/nccl_collective_group.py."""
    from ray_tpu_torch.runtime import p2p

    with group.condition:
        if not hasattr(group, "kv_gen"):
            group.kv_gen = {}
        gen = group.kv_gen.get(rank, 0)
        group.kv_gen[rank] = gen + 1
    world = group.world_size
    # mailbox ids carry the group EPOCH so a re-created same-named group
    # can never consume a stale contribution left by a timed-out round of
    # its predecessor
    epoch = getattr(group, "epoch", "")
    p2p.register_rank(group_name, rank)
    if rank == 0:
        p2p.post(
            p2p.get_endpoint().address,
            p2p.mailbox_oid("rdv", group_name, epoch, gen, "c", 0),
            _host_value(value),
        )
        values: List[Any] = [
            p2p.take_group(group_name, p2p.mailbox_oid("rdv", group_name, epoch, gen, "c", r), timeout)
            for r in range(world)
        ]
        result = reduce_fn(values)
        host_result = _host_value(result)
        for r in range(1, world):
            p2p.post_to_rank(
                group_name, r, p2p.mailbox_oid("rdv", group_name, epoch, gen, "r", r),
                host_result, timeout=timeout,
            )
        return result
    p2p.post_to_rank(
        group_name, 0, p2p.mailbox_oid("rdv", group_name, epoch, gen, "c", rank),
        _host_value(value), timeout=timeout,
    )
    return p2p.take_group(group_name, p2p.mailbox_oid("rdv", group_name, epoch, gen, "r", rank), timeout)


def _route(group_name: str, group: _Group) -> str:
    """Latch the group's rendezvous mechanism.

    ``inproc`` only when PROVABLY safe: every rank of the group called
    ``init_collective_group`` in this process (``local_inits == world``), so
    the shared in-memory group object reaches all of them.  Anything less —
    declaratively-bound groups, ranks in agents or process workers — routes
    over the data-plane transport, where same-process delivery still
    short-circuits to a local store put.  Every execution mode can own a
    transport (``p2p.ensure_endpoint``), so there is exactly ONE
    cross-process mechanism and mixed thread/process groups cannot split."""
    from ray_tpu_torch.runtime import p2p
    from ray_tpu_torch.runtime.kv_client import get_kv, is_multiprocess

    with group.condition:
        if group.routing is not None:
            return group.routing
        provably_local = len(group.local_ranks) >= group.world_size
    if provably_local:
        routing = "inproc"
    elif not is_multiprocess():
        # single-process clusters stay socket-free (is_multiprocess is True
        # in agents/workers, with remote nodes, and on a driver hosting
        # process-actor participants) — but this answer is UNPROVEN, so it
        # is NOT latched: the evidence can appear moments later (a process
        # actor finishing its spawn), and a sticky wrong "inproc" would
        # strand every subsequent send/recv in process-local mailboxes
        return "inproc"
    else:
        # endpoint build (sockets) happens outside the group lock
        ep = p2p.ensure_endpoint() if get_kv() is not None else None
        if ep is None:
            return "inproc"  # also unproven: don't latch
        routing = "transport"
    with group.condition:
        if group.routing is None:
            group.routing = routing
        return group.routing


def use_transport(group_name: str) -> bool:
    """Shared routing decision for group ops AND point-to-point send/recv —
    one answer per group per process, so the two can't disagree."""
    try:
        group = _registry.get(group_name)
    except KeyError:
        from ray_tpu_torch.runtime import p2p
        from ray_tpu_torch.runtime.kv_client import get_kv, is_multiprocess

        return (
            is_multiprocess()
            and get_kv() is not None
            and p2p.ensure_endpoint() is not None
        )
    return _route(group_name, group) == "transport"


class _ReRoute(Exception):
    """Internal: an unproven in-memory wait detected that the group spans
    processes after all — unwind and run the round over the transport."""


def _run_rendezvous(
    group_name: str, group: _Group, rank: int, value: Any, reduce_fn,
    timeout: Optional[float] = None,
):
    """Route one collective round (see :func:`_route`).

    An "inproc" route that is NOT proven local (chosen only because no
    multiprocess evidence existed yet) can be wrong by a race: a thread
    actor's first collective may run before the process-actor rank's worker
    even spawns.  Such waits poll the evidence every 250 ms and re-route
    mid-round — the in-memory contribution is unwound and replayed over the
    transport with the same generation the remote ranks are using."""
    from ray_tpu_torch.core.config import get_config
    from ray_tpu_torch.runtime.kv_client import is_multiprocess

    if timeout is None:
        timeout = get_config().collective_timeout_s
    try:
        if _route(group_name, group) == "transport":
            return _rendezvous_transport(group_name, group, rank, value, reduce_fn, timeout)
        with group.condition:
            proven = len(group.local_ranks) >= group.world_size
        escape = None if proven else is_multiprocess
        try:
            return _rendezvous(group, rank, value, reduce_fn, timeout, escape=escape)
        except _ReRoute:
            with group.condition:
                group.routing = None
            if _route(group_name, group) != "transport":
                raise TimeoutError(
                    f"collective group {group_name!r} spans processes but no "
                    "transport endpoint could be built"
                ) from None
            return _rendezvous_transport(group_name, group, rank, value, reduce_fn, timeout)
    except TimeoutError:
        # A timed-out round may mean the latch chose wrong (e.g. the group's
        # first collective ran before an endpoint became available): clear
        # it so the next attempt re-evaluates instead of being stuck.
        with group.condition:
            group.routing = None
        raise


def _rendezvous(group: _Group, rank: int, value: Any, reduce_fn, timeout: float, escape=None):
    """All-contribute-then-all-collect with generation counting so groups are
    reusable across rounds.  ``escape`` (optional zero-arg predicate) is
    polled during the wait; when it turns true the rank's contribution is
    unwound and :class:`_ReRoute` raised (see _run_rendezvous)."""
    import time as _time

    with group.condition:
        my_generation = group.generation
        group.contributions[rank] = value
        group.arrived += 1
        if group.arrived == group.world_size:
            ordered = [group.contributions[r] for r in sorted(group.contributions)]
            group.result = reduce_fn(ordered)
            group.contributions = {}
            group.arrived = 0
            group.generation += 1
            group.condition.notify_all()
            return group.result
        deadline = _time.monotonic() + timeout
        while True:
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"collective rendezvous timed out (rank {rank})")
            done = group.condition.wait_for(
                lambda: group.generation > my_generation,
                timeout=min(0.25, remaining) if escape is not None else remaining,
            )
            if done:
                return group.result
            if escape is not None and escape():
                if group.generation == my_generation and rank in group.contributions:
                    del group.contributions[rank]
                    group.arrived -= 1
                raise _ReRoute()


def allreduce_tensor(tensor, rank: int, group_name: str = "default", op: str = "sum"):
    """Group allreduce (reference: collective.py:258 allreduce): the
    contributions summed in member order (``acc = v0; acc = acc + v1; ...``),
    on the contributions' device."""
    group = _registry.get(group_name)

    def reduce_fn(values: List[Any]):
        acc = values[0]
        for v in values[1:]:
            acc = acc + v
        if op == "mean":
            acc = acc / len(values)
        elif op == "max":
            if isinstance(values[0], torch.Tensor):
                acc = torch.stack(list(values)).amax(0)
            elif hasattr(values[0], "shape"):
                acc = np.stack([np.asarray(v) for v in values]).max(0)
            else:
                acc = max(values)
        return acc

    return _run_rendezvous(group_name, group, rank, tensor, reduce_fn)


def allgather_tensor(tensor, rank: int, group_name: str = "default"):
    group = _registry.get(group_name)
    return _run_rendezvous(group_name, group, rank, tensor, lambda values: list(values))


def broadcast_tensor(tensor, rank: int, src_rank: int = 0, group_name: str = "default"):
    group = _registry.get(group_name)
    return _run_rendezvous(group_name, group, rank, tensor, lambda values: values[src_rank])


def reducescatter_tensor(tensor, rank: int, group_name: str = "default"):
    group = _registry.get(group_name)

    def reduce_fn(values: List[Any]):
        acc = values[0]
        for v in values[1:]:
            acc = acc + v
        if isinstance(acc, torch.Tensor):
            return list(torch.tensor_split(acc, group.world_size, dim=0))
        return np.array_split(np.asarray(acc), group.world_size, axis=0)

    chunks = _run_rendezvous(group_name, group, rank, tensor, reduce_fn)
    return chunks[rank]


def barrier_group(rank: int, group_name: str = "default") -> None:
    group = _registry.get(group_name)
    _run_rendezvous(group_name, group, rank, None, lambda values: None)


# --------------------------------------------------------------------------
# layer 3: device-channel exchange (compiled-plan DEVICE edges)
# --------------------------------------------------------------------------
# A device edge between processes demotes chan_push to a control-only
# header; the tensor either rides a device-to-device pull of a
# producer-staged tensor (below, DeviceChannelStager, over the process's
# transfer server: CUDA IPC on one host) or, when no transfer server is up
# (the CPU), host-staged raw bytes rebuilt into a tensor by
# ``_rendezvous_device_frame``.  Either way pickle never sees the payload.


class DeviceChannelStager:
    """Producer half of a device edge's device-to-device exchange.

    Each ``offer`` stages the tensor with the local transfer server under a
    deterministic (edge, seq) uuid and returns the pull descriptor the
    control header carries, or ``None`` when no transfer server is running
    (callers then send the payload host-staged).  Double-buffered: with
    ``device_channel_double_buffer`` on, the stager keeps the last TWO
    seqs' tensors referenced (seq-parity slots) so a late or retried
    consumer pull can still fetch seq N-1 while seq N stages.
    """

    def __init__(self, edge_key: str, double_buffer: bool = True):
        self._edge_key = edge_key
        self._double = double_buffer
        self._lock = threading.Lock()
        # parity -> (seq, tensor): holding the ref keeps the staged memory
        # until the slot is overwritten by seq+2 (or seq+1, single-buffered)
        self._slots: Dict[int, Any] = {}

    def offer(self, seq: int, array) -> Optional[Dict[str, Any]]:
        from ray_tpu_torch.runtime import device_plane

        addr = device_plane.transfer_address()
        if addr is None:
            return None
        uuid = _device_frame_uuid(self._edge_key, seq)
        if not device_plane.offer_device_pull(uuid, array):
            return None
        with self._lock:
            parity = (seq & 1) if self._double else 0
            self._slots[parity] = (seq, array)
        return {"addr": addr, "uuid": uuid}


def _device_frame_uuid(edge_key: str, seq: int) -> int:
    """Deterministic per-(edge, seq) staging uuid: both ends derive it
    from the control header alone, no extra negotiation round."""
    import zlib

    h = zlib.crc32(edge_key.encode("utf-8")) & 0x7FFFFFFF
    return ((h << 32) | (seq & 0xFFFFFFFF)) or 1


def _dtype(dtype_str: str) -> torch.dtype:
    return getattr(torch, dtype_str.removeprefix("torch."))


def pull_device_value(desc: Dict[str, Any], shape, dtype_str: str):
    """Consumer half: pull a producer-staged tensor device-to-device.

    Returns the tensor, or ``None`` when the pull could not be served (no
    local transfer server, entry already consumed or withdrawn): the caller
    nacks with a fallback flag and the producer resends host-staged."""
    from ray_tpu_torch.runtime import device_plane

    template = torch.empty(tuple(shape), dtype=_dtype(dtype_str), device="meta")
    return device_plane.device_pull(desc["addr"], desc["uuid"], template)


def _rendezvous_device_frame(shape, dtype_str: str, buf, device=None) -> torch.Tensor:
    """Host-staged rendezvous of one device-channel frame (the CPU and
    fallback transport): raw wire bytes -> a tensor on ``device`` (this
    process's current CUDA device when it has one, else the CPU).  No
    pickle anywhere: the bytes ARE the tensor."""
    view = memoryview(buf).cast("B")
    raw = torch.frombuffer(bytearray(view) if view.readonly else view, dtype=torch.uint8) \
        if view.nbytes else torch.empty(0, dtype=torch.uint8)
    out = raw.view(_dtype(dtype_str)).reshape(tuple(shape))
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    return out if device is None else out.to(device)


__all__: List[str] = [
    "allreduce", "allreduce_mean", "allgather", "reducescatter", "broadcast", "ppermute",
    "all_to_all", "send_recv", "axis_index", "axis_size", "barrier", "replicated_sum",
    "tie", "staged", "calls", "reset_staged", "DeviceChannelStager", "pull_device_value",
]
