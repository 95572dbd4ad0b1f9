"""ray_tpu_torch.util.collective: the public collective-communication API.

The port's copy of ``ray_tpu/util/collective.py``, whole. Parity:
``python/ray/util/collective/collective.py`` — ``init_collective_group``
:120, ``create_collective_group`` :151, ``allreduce`` :258, ``barrier``
:298, ``broadcast`` :373, ``allgather`` :423, ``reducescatter`` :472,
``send`` :531 / ``recv`` :594. Group ops ride the in-process rendezvous of
``ray_tpu_torch.parallel.collective`` (in-process actors and threads,
tensors reduced on their device) or, for a group with a rank in a spawned
worker process, the data-plane transport (``runtime/p2p.py``). SPMD code
inside a process group uses ``ray_tpu_torch.parallel.collective``'s axis
collectives instead.

The reference's rendezvous-through-a-named-actor (NCCLUniqueID store)
disappears: groups are fabric-local state, no unique-id exchange needed.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from ray_tpu_torch.parallel.collective import (
    _registry,
    allgather_tensor,
    allreduce_tensor,
    broadcast_tensor,
    destroy_collective_group,
    init_collective_group,
    reducescatter_tensor,
)


def create_collective_group(
    actors: List[Any],
    world_size: int,
    ranks: List[int],
    backend: str = "gpu",
    group_name: str = "default",
) -> None:
    """Declarative group creation (reference: collective.py:151): binds each
    actor to its rank so collective ops called from actor code resolve their
    rank automatically (no manual ``set_rank``), and pre-registers every
    rank's data-plane address so cross-process sends never wait on lazy
    registration."""
    if len(actors) != len(ranks) or len(ranks) != world_size:
        raise ValueError("actors/ranks/world_size mismatch")
    for group_rank in ranks:
        if not 0 <= group_rank < world_size:
            raise ValueError(f"rank {group_rank} out of range for world_size {world_size}")
    if len(set(ranks)) != world_size:
        raise ValueError("ranks must be unique")
    # Create the registry entry directly — init_collective_group would also
    # publish THIS (driver) process's address as ranks[0]'s endpoint, which
    # is wrong when that rank's actor lives elsewhere.
    _registry.destroy(group_name)
    _registry.get_or_create(group_name, world_size)

    # actor -> rank binding, readable from any process via the cluster KV
    binding = {}
    for actor, group_rank in zip(actors, ranks):
        actor_id = getattr(actor, "_actor_id", None)
        if actor_id is None:
            raise ValueError("create_collective_group expects actor handles")
        binding[actor_id.hex()] = group_rank
    _bind_group(group_name, world_size, binding)

    # Rank addresses are NOT pre-published here: each rank's process
    # registers its OWN endpoint at round start (_rendezvous_transport /
    # recv), which is the only address that's always right — a
    # process-worker actor's endpoint is the worker's own data server, not
    # its hosting node's, and the driver can't know which from here.


# group-name -> {actor_id_hex: rank}; mirrored in the KV for other processes
_group_bindings: Dict[str, Dict[str, int]] = {}
_bindings_lock = threading.Lock()


def _bind_group(group_name: str, world_size: int, binding: Dict[str, int]) -> None:
    import os
    import pickle

    with _bindings_lock:
        _group_bindings[group_name] = dict(binding)
    from ray_tpu_torch.runtime.kv_client import get_kv

    kv = get_kv()
    if kv is not None:
        # epoch: unique per creation, so participant processes holding state
        # from an earlier same-named group reset instead of desyncing
        kv.put(
            f"rt_coll_grp/{group_name}".encode(),
            pickle.dumps(
                {
                    "world_size": world_size,
                    "binding": binding,
                    "epoch": os.urandom(8).hex(),
                },
                protocol=5,
            ),
        )


def _rank_from_actor_context(group_name: str) -> Optional[int]:
    """Declarative-binding fallback for _need_rank: the currently-executing
    actor's rank in the group, if bound via create_collective_group."""
    from ray_tpu_torch.runtime.context import task_context

    current = task_context.current()
    if current is None:
        return None
    actor = current[0].actor_id()
    if actor.is_nil():
        return None
    aid = actor.hex()
    with _bindings_lock:
        binding = _group_bindings.get(group_name)
    if binding is None:
        import pickle

        from ray_tpu_torch.runtime.kv_client import get_kv

        kv = get_kv()
        if kv is None:
            return None
        raw = kv.get(f"rt_coll_grp/{group_name}".encode())
        if raw is None:
            return None
        binding = pickle.loads(raw)["binding"]
        with _bindings_lock:
            _group_bindings[group_name] = binding
    return binding.get(aid)


def is_group_initialized(group_name: str = "default") -> bool:
    try:
        _registry.get(group_name)
        return True
    except KeyError:
        return False


def get_collective_group_size(group_name: str = "default") -> int:
    return _registry.get(group_name).world_size


def _ensure_group(group_name: str) -> None:
    """Materialize a declaratively-created group in THIS process: an actor
    bound via create_collective_group never called init_collective_group
    here, so pull world_size from the group record in the KV.  The record's
    epoch detects a re-created group: stale local state (generation
    counters, cached bindings) resets instead of desyncing mailbox ids."""
    import pickle

    from ray_tpu_torch.runtime import p2p
    from ray_tpu_torch.runtime.kv_client import get_kv

    existing = None
    try:
        existing = _registry.get(group_name)
    except KeyError:
        pass
    kv = get_kv()
    if kv is None:
        return
    raw = kv.get(f"rt_coll_grp/{group_name}".encode())
    if raw is None:
        return
    record = pickle.loads(raw)
    epoch = record.get("epoch")
    if existing is not None and getattr(existing, "epoch", None) == epoch:
        return
    if existing is not None:
        _registry.destroy(group_name)
        p2p.forget_group(group_name)
        with _bindings_lock:
            _group_bindings.pop(group_name, None)
        # p2p FIFO counters belong to the dead incarnation
        with _p2p_lock:
            for key in [k for k in _p2p_send_seq if k[0] == group_name]:
                del _p2p_send_seq[key]
            for key in [k for k in _p2p_recv_seq if k[0] == group_name]:
                del _p2p_recv_seq[key]
    group = _registry.get_or_create(group_name, record["world_size"])
    group.epoch = epoch


def _group_epoch(group_name: str) -> str:
    try:
        return getattr(_registry.get(group_name), "epoch", "") or ""
    except KeyError:
        return ""


# ------------------------------------------------------------------- ops
def allreduce(tensor, group_name: str = "default", op: str = "sum", *, rank: Optional[int] = None):
    _ensure_group(group_name)
    return allreduce_tensor(tensor, _need_rank(rank, group_name), group_name, op)


def allgather(tensor, group_name: str = "default", *, rank: Optional[int] = None) -> List[Any]:
    _ensure_group(group_name)
    return allgather_tensor(tensor, _need_rank(rank, group_name), group_name)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default", *, rank: Optional[int] = None):
    _ensure_group(group_name)
    return broadcast_tensor(tensor, _need_rank(rank, group_name), src_rank, group_name)


def reducescatter(tensor, group_name: str = "default", *, rank: Optional[int] = None):
    _ensure_group(group_name)
    return reducescatter_tensor(tensor, _need_rank(rank, group_name), group_name)


def barrier(group_name: str = "default", *, rank: Optional[int] = None) -> None:
    _ensure_group(group_name)
    allreduce_tensor(0, _need_rank(rank, group_name), group_name)


# ---------------------------------------------------------- point-to-point
class _Mailboxes:
    def __init__(self):
        self.lock = threading.Lock()
        self.boxes: Dict[tuple, "_Box"] = {}

    def box(self, group: str, src: int, dst: int) -> "_Box":
        key = (group, src, dst)
        with self.lock:
            if key not in self.boxes:
                self.boxes[key] = _Box()
            return self.boxes[key]


class _Box:
    def __init__(self):
        self.cond = threading.Condition()
        self.items: list = []


_mail = _Mailboxes()


# per-process sequence counters for the cross-process (KV) channel: each
# (group, src, dst) pair is a FIFO stream; the sender numbers messages and
# the receiver consumes them in order
_p2p_send_seq: Dict[tuple, int] = {}
_p2p_recv_seq: Dict[tuple, int] = {}
_p2p_lock = threading.Lock()


def _reset_binding_state() -> None:
    """Runtime-shutdown reset (see parallel.collective.reset_module_state):
    bindings, mailboxes and FIFO counters all index a dead incarnation."""
    with _bindings_lock:
        _group_bindings.clear()
    with _p2p_lock:
        _p2p_send_seq.clear()
        _p2p_recv_seq.clear()
    with _mail.lock:
        _mail.boxes.clear()


def send(tensor, dst_rank: int, group_name: str = "default", *, rank: Optional[int] = None) -> None:
    """Reference: collective.py:531 — point-to-point send.

    Transport-native: across OS processes the message moves store-to-store
    on the chunked data plane (``runtime/p2p.py``) — a direct push into the
    destination process, never a value through the head KV.  Same-process
    ranks (no fabric endpoint) use in-memory mailboxes."""
    src = _need_rank(rank, group_name)
    from ray_tpu_torch.parallel.collective import use_transport
    from ray_tpu_torch.runtime import p2p

    _ensure_group(group_name)
    if use_transport(group_name):
        from ray_tpu_torch.parallel.collective import _host_value

        with _p2p_lock:
            seq = _p2p_send_seq.get((group_name, src, dst_rank), 0)
            _p2p_send_seq[(group_name, src, dst_rank)] = seq + 1
        # make sure the counterpart can answer/see us before first contact
        p2p.register_rank(group_name, src)
        oid = p2p.mailbox_oid("p2p", group_name, _group_epoch(group_name), src, dst_rank, seq)
        # budget: the destination registers its address on ITS first op
        # (addresses are not pre-published — the binding process can't know
        # a worker-hosted rank's endpoint), so a sender may legitimately
        # wait for a receiver that is still loading; give it the collective
        # timeout, not resolve_rank's 30 s metadata default
        from ray_tpu_torch.core.config import get_config

        p2p.post_to_rank(
            group_name, dst_rank, oid, _host_value(tensor),
            timeout=get_config().collective_timeout_s,
        )
        return
    box = _mail.box(group_name, src, dst_rank)
    with box.cond:
        box.items.append(tensor)
        box.cond.notify_all()


def recv(src_rank: int, group_name: str = "default", *, rank: Optional[int] = None, timeout: float = 120.0):
    """Reference: collective.py:594 — blocking point-to-point receive.

    Waits on the LOCAL store's condition variable (the inbound data-plane
    push wakes it) — no polling anywhere.  A mailbox wait that routed
    "inproc" WITHOUT proof (no multiprocess evidence yet) re-checks the
    routing every 250 ms and switches to the transport mid-wait — the same
    self-heal the rendezvous path gets from its _ReRoute escape."""
    import time as _time

    dst = _need_rank(rank, group_name)
    from ray_tpu_torch.parallel.collective import use_transport
    from ray_tpu_torch.runtime import p2p

    _ensure_group(group_name)
    deadline = _time.monotonic() + timeout
    if use_transport(group_name):
        return _recv_transport(src_rank, dst, group_name, timeout)
    box = _mail.box(group_name, src_rank, dst)
    with box.cond:
        while not box.items:
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"recv from rank {src_rank} timed out")
            box.cond.wait(min(0.25, remaining))
            if not box.items and use_transport(group_name):
                break
        else:
            return box.items.pop(0)
    # routing evidence appeared mid-wait: finish the receive on the transport
    return _recv_transport(
        src_rank, dst, group_name, max(0.0, deadline - _time.monotonic())
    )


def _recv_transport(src_rank: int, dst: int, group_name: str, timeout: float):
    from ray_tpu_torch.exceptions import GetTimeoutError
    from ray_tpu_torch.runtime import p2p

    # publish where this rank lives so senders can reach us
    p2p.register_rank(group_name, dst)
    with _p2p_lock:
        seq = _p2p_recv_seq.get((group_name, src_rank, dst), 0)
    oid = p2p.mailbox_oid("p2p", group_name, _group_epoch(group_name), src_rank, dst, seq)
    try:
        value = p2p.take_group(group_name, oid, timeout)
    except GetTimeoutError as exc:
        # only a genuine wait expiry maps to TimeoutError — endpoint /
        # store failures propagate with their real cause
        raise TimeoutError(f"recv from rank {src_rank} timed out") from exc
    # consume the sequence number only on success — a timed-out recv
    # must retry the SAME slot, or the FIFO desyncs
    with _p2p_lock:
        _p2p_recv_seq[(group_name, src_rank, dst)] = seq + 1
    return value


# ----------------------------------------------------------------- helpers
_rank_local = threading.local()


def set_rank(rank: int) -> None:
    """Bind this thread's rank (actors call once; the reference infers rank
    from the actor registered in the group)."""
    _rank_local.value = rank


def _need_rank(rank: Optional[int], group_name: str = "default") -> int:
    if rank is not None:
        return rank
    r = getattr(_rank_local, "value", None)
    if r is not None:
        return r
    # declarative binding: the executing actor's rank from
    # create_collective_group (reference: collective.py:151 infers rank
    # from the registered actor)
    r = _rank_from_actor_context(group_name)
    if r is None:
        raise ValueError(
            "rank not set: pass rank=, call collective.set_rank(rank), or bind "
            "this actor via create_collective_group"
        )
    return r


__all__ = [
    "allgather",
    "allreduce",
    "barrier",
    "broadcast",
    "create_collective_group",
    "destroy_collective_group",
    "get_collective_group_size",
    "init_collective_group",
    "is_group_initialized",
    "recv",
    "reducescatter",
    "send",
    "set_rank",
]
