"""Per-process channel registry + stage executors for compiled execution plans.

The port's copy of ``ray_tpu/runtime/channel_manager.py``.  Hosting stages
for a plan installed from another process (``install_remote_plan``, on a
node agent) waits for the multi-node runtime and raises ``NotPortedError``.
Reference parity: ``python/ray/experimental/channel/`` — the aDAG runtime's
mutable plasma/NCCL channels and the per-actor compiled-DAG loops
(``compiled_dag_node.py:278``).  A compiled :class:`~ray_tpu.dag.plan.
ExecutionPlan` partitions a DAG of actor-method stages across the processes
hosting the actors; every DAG edge becomes a **named channel**:

  * producer and consumer in the SAME process  -> a local :class:`SeqChannel`
    (single-slot rendezvous, a reference move),
  * producer and consumer in DIFFERENT processes -> a persistent data-plane
    channel stream (``chan_push`` op in ``runtime/data_plane.py``):
    seq-numbered single-slot frames whose ack is withheld until the consumer
    side slot accepted the value — end-to-end backpressure with at most one
    frame in flight plus one in the slot per edge.

This module is the per-process half: the global :class:`ChannelManager`
(which the data plane's ``chan_push`` server delivers into), the
:class:`StageExecutor` that runs one thread per locally-hosted stage
(read inputs -> invoke the actor method -> write outputs), and the
:class:`NodeActorInvoker` that calls a hosted actor WITHOUT a TaskSpec, a
scheduler hop, or an ObjectRef — the whole point of the compiled hot path.

Error semantics: a stage whose actor call fails writes the typed error AS the
iteration's value (``is_error=True``) downstream, so downstream stages
forward it without invoking their actors and the driver's output read raises
it — exactly how errored ObjectRefs propagate through the interpreted DAG,
minus the objects.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.dag.channel import ChannelClosed, StreamFence


def _set_future(fut: Future, value: Any = None, exc: Optional[BaseException] = None) -> None:
    """Resolve a future that a death notification may already have resolved."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(value)
    except InvalidStateError:
        pass


class _Occupancy:
    """Occupied-slot counter feeding the ``compiled_channel_occupancy``
    gauge — one per process, shared by every channel."""

    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0

    def delta(self, d: int) -> None:
        with self._lock:
            self._count += d
            count = self._count
        try:
            from ray_tpu_torch.observability import metric_defs

            metric_defs.COMPILED_CHANNEL_OCCUPANCY.set(count)
        except Exception:  # noqa: BLE001 — metrics must not break the data path
            pass


_occupancy = _Occupancy()


class _DeviceChannelStats:
    """Resident accounting for DEVICE-kind channel slots in this process
    (the reference's ``/api/plans`` fields): how many device slots
    currently hold a tensor, and how many tensor bytes they keep resident
    (``hbm_resident_bytes``, the reference's name, counts device memory on
    the card and host memory for a CPU tensor)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.occupied = 0
        self.hbm_bytes = 0

    def delta(self, slots: int, nbytes: int) -> None:
        with self._lock:
            self.occupied += slots
            self.hbm_bytes += nbytes

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"occupied_slots": self.occupied, "hbm_resident_bytes": self.hbm_bytes}


_device_stats = _DeviceChannelStats()


def device_channel_stats() -> Dict[str, int]:
    """Process-wide device-channel occupancy (dashboard/CLI surface)."""
    return _device_stats.snapshot()


class SeqChannel:
    """Single-slot seq-numbered channel: ``write`` blocks while full, ``read``
    blocks while empty; ``close(error)`` wakes both sides with the typed
    error (or :class:`ChannelClosed`).  The mutable-plasma-channel protocol
    of ``dag/channel.Channel``, plus the iteration sequence number the
    cross-process stream carries on the wire.

    ``kind="device"`` extends ``dag/channel.DeviceChannel``'s slot semantics:
    a tensor payload stays where it is in the slot (handing it between
    co-located stages is a reference move, never a host copy), the slot
    contributes to the process's resident accounting while occupied.  On
    either kind, CUDA tensors in a payload carry the writer's stream fence
    to the reader (``dag/channel.StreamFence``)."""

    __slots__ = ("name", "kind", "_device", "_cond", "_slot", "_closed",
                 "_error", "_slot_nbytes", "_fence")

    def __init__(self, name: str = "", kind: str = "pickle", device=None):
        self.name = name
        self.kind = kind
        self._device = device
        self._cond = threading.Condition()
        self._slot: Optional[Tuple[int, Any, bool]] = None
        self._closed = False
        self._error: Optional[BaseException] = None
        self._slot_nbytes = 0
        self._fence: Optional[StreamFence] = None

    def _raise_closed_locked(self) -> None:
        if self._error is not None:
            from ray_tpu_torch.exceptions import raised_copy

            raise raised_copy(self._error)
        raise ChannelClosed(f"channel {self.name!r} closed")

    def _place(self, value: Any, is_error: bool) -> Tuple[Any, int]:
        """Device-kind slot placement: runs AFTER slot acquisition (the
        ``dag/channel.Channel._place`` contract: a writer blocked on a full
        slot must not hold a second device copy for the whole wait), and
        ONLY on kind transitions: a tensor is a pure reference move; a host
        ndarray arriving on a device channel is placed once
        (``device_place``: onto the current CUDA device where there is one);
        other payloads (the per-seq pickle fallback) pass through
        untouched."""
        if self.kind != "device" or is_error:
            return value, 0
        from ray_tpu_torch.runtime import device_plane

        if device_plane.is_device_array(value):
            return value, int(value.nbytes)
        import numpy as np

        if isinstance(value, np.ndarray):
            from ray_tpu_torch.dag.channel import device_place

            value = device_place(value, self._device)
            return value, int(value.nbytes)
        return value, 0

    def write(self, seq: int, value: Any, is_error: bool = False,
              timeout: Optional[float] = None) -> None:
        with self._cond:
            if not self._cond.wait_for(lambda: self._slot is None or self._closed, timeout):
                raise TimeoutError(f"channel {self.name!r} write timed out")
            if self._closed:
                self._raise_closed_locked()
            value, nbytes = self._place(value, is_error)
            self._slot = (seq, value, is_error)
            self._slot_nbytes = nbytes
            self._fence = None if is_error else StreamFence.record(value)
            self._cond.notify_all()
        _occupancy.delta(1)
        if nbytes:
            _device_stats.delta(1, nbytes)

    def read(self, timeout: Optional[float] = None) -> Tuple[int, Any, bool]:
        with self._cond:
            if not self._cond.wait_for(lambda: self._slot is not None or self._closed, timeout):
                raise TimeoutError(f"channel {self.name!r} read timed out")
            if self._slot is None:  # closed and empty
                self._raise_closed_locked()
            item = self._slot
            self._slot = None
            nbytes, self._slot_nbytes = self._slot_nbytes, 0
            fence, self._fence = self._fence, None
            self._cond.notify_all()
        _occupancy.delta(-1)
        if nbytes:
            _device_stats.delta(-1, -nbytes)
        if fence is not None:
            fence.join(item[1])
        return item

    def close(self, error: Optional[BaseException] = None) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._error = error
            if self._slot is not None:
                self._slot = None
                drained = True
            else:
                drained = False
            nbytes, self._slot_nbytes = self._slot_nbytes, 0
            self._fence = None
            self._cond.notify_all()
        if drained:
            _occupancy.delta(-1)
            if nbytes:
                _device_stats.delta(-1, -nbytes)

    @property
    # rt-lint: disable=lock-discipline -- lock-free snapshot: close() is
    # one-way, and every read/write path re-checks under _cond anyway
    def closed(self) -> bool:
        return self._closed


class ChannelManager:
    """Process-global (plan id, channel name) -> :class:`SeqChannel` registry.

    The data plane's ``chan_push`` server resolves inbound frames here;
    installed plans register their locally-hosted channels at install time
    and release them at teardown (closing each channel wakes every blocked
    stage thread)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._channels: Dict[Tuple[str, str], SeqChannel] = {}

    def register(self, plan_id: str, names,
                 kinds: Optional[Dict[str, str]] = None) -> Dict[str, SeqChannel]:
        out = {}
        with self._lock:
            for name in names:
                ch = self._channels.get((plan_id, name))
                if ch is None:
                    kind = (kinds or {}).get(name, "pickle")
                    ch = self._channels[(plan_id, name)] = SeqChannel(name, kind=kind)
                out[name] = ch
        return out

    def channel(self, plan_id: str, name: str) -> Optional[SeqChannel]:
        with self._lock:
            return self._channels.get((plan_id, name))

    def deliver(self, plan_id: str, name: str, seq: int, value: Any,
                is_error: bool, timeout: float = 300.0) -> Tuple[bool, str]:
        """Land one inbound frame; BLOCKS while the slot is full — the
        caller (the data server's chan_push handler) withholds its ack until
        this returns, which is the stream's backpressure."""
        ch = self.channel(plan_id, name)
        if ch is None:
            return False, "unknown channel"
        try:
            ch.write(seq, value, is_error=is_error, timeout=timeout)
        except ChannelClosed:
            return False, "channel closed"
        except BaseException as exc:  # noqa: BLE001 — close(error) raised it
            return False, f"channel closed: {type(exc).__name__}"
        return True, ""

    def release_plan(self, plan_id: str, error: Optional[BaseException] = None) -> None:
        with self._lock:
            doomed = [(k, ch) for k, ch in self._channels.items() if k[0] == plan_id]
            for k, _ in doomed:
                del self._channels[k]
        for _, ch in doomed:
            ch.close(error)

    def break_plan(self, plan_id: str, error: BaseException) -> None:
        """Close this plan's local channels WITH the typed error, leaving the
        registrations (so straggler chan_push frames get a clean 'closed'
        nack rather than 'unknown channel')."""
        with self._lock:
            doomed = [ch for k, ch in self._channels.items() if k[0] == plan_id]
        for ch in doomed:
            ch.close(error)


_global_manager = ChannelManager()


def global_manager() -> ChannelManager:
    return _global_manager


def deliver(plan_id: str, name: str, seq: int, value: Any, is_error: bool) -> Tuple[bool, str]:
    """Entry point for ``data_plane._serve_chan_push`` (lazy import there)."""
    from ray_tpu_torch.core.config import get_config

    return _global_manager.deliver(
        plan_id, name, seq, value, is_error,
        timeout=get_config().compiled_plan_channel_timeout_s,
    )


# --------------------------------------------------------------------------
# actor invocation without a TaskSpec
# --------------------------------------------------------------------------
class NodeActorInvoker:
    """Call a method on an actor hosted by ``node`` directly — no TaskSpec,
    no scheduler hop, no ObjectRef.

    inproc actors: the call rides the actor's own call queue (the
    ``__direct__`` fast path, serialized with queued ``.remote()`` calls so
    the single-threaded actor guarantee holds), with the waiting future
    registered on the instance's death notification so a kill surfaces
    :class:`ActorDiedError` immediately.  Process actors: one worker-IPC
    frame per call via the pool's dedicated actor worker (worker death fails
    the future through the pool's inflight sweep)."""

    def __init__(self, node):
        self._node = node

    def resolve(self, actor_id):
        inst = self._node.actors.get(actor_id)
        if inst is None or inst.dead:
            from ray_tpu_torch.exceptions import ActorDiedError

            raise ActorDiedError(actor_id, "actor is not alive on this node")
        return inst

    def invoke(self, inst, actor_id, method: str, args: tuple, kwargs: dict):
        from ray_tpu_torch.exceptions import ActorDiedError

        if inst.dead:
            raise ActorDiedError(actor_id)
        fut: Future = Future()
        if inst.mode == "inproc":
            def on_death():
                _set_future(fut, exc=ActorDiedError(actor_id, "actor killed mid-plan"))

            inst.on_death(on_death)
            try:
                inst.call_queue.put(("__direct__", (method, args, kwargs, fut)))
                return fut.result()
            finally:
                inst.remove_death_callback(on_death)
        # process actor: encode args once, one IPC frame, decode the reply
        import os

        from ray_tpu_torch.runtime import protocol

        shm = self._node.store._shm

        def on_result(value, err, exec_s=None):
            if err is not None:
                _set_future(fut, exc=err if isinstance(err, BaseException)
                            else RuntimeError(str(err)))
            else:
                try:
                    _set_future(fut, protocol.decode_value(value, shm))
                except BaseException as exc:  # noqa: BLE001
                    _set_future(fut, exc=exc)

        enc = self._node._encode_args(args, kwargs, shm)
        self._node.worker_pool.submit_to_worker(
            inst.worker, "actor_call", os.urandom(16),
            {"method": method, "args_blob": enc, "name": f"plan::{method}"},
            on_result,
        )
        return fut.result()


# --------------------------------------------------------------------------
# stage programs
# --------------------------------------------------------------------------
class StageSpec:
    """One locally-hosted stage of an installed plan (plain data)."""

    __slots__ = ("stage_id", "actor_id", "method", "name", "arg_slots",
                 "kw_slots", "inchan", "outs", "group")

    def __init__(self, stage_id: int, actor_id, method: str, name: str,
                 arg_slots: List[tuple], kw_slots: Dict[str, tuple],
                 inchan: Optional[str], outs: List[str],
                 group: Optional[dict] = None):
        self.stage_id = stage_id
        self.actor_id = actor_id
        self.method = method
        self.name = name
        #: slots: ("chan", name) | ("input", key|None) | ("const", index)
        self.arg_slots = arg_slots
        self.kw_slots = kw_slots
        self.inchan = inchan          # entry channel carrying the DAG input
        self.outs = outs              # output channel names (local or remote)
        #: SPMD stage group: {"members": [ActorID, ...], "split_axis": int,
        #: "mesh": name|None, "warmup": [shape, dtype]|None}: the stage is a
        #: gang executing the same step on per-member tensor shards
        self.group = group


def select_input(payload: Any, key) -> Any:
    """Resolve an ("input", key) slot against the per-iteration DAG input
    (mirrors the interpreted walker's InputNode/_DagInput semantics)."""
    from ray_tpu_torch.dag.dag_node import _DagInput

    if key is None:
        return payload
    if isinstance(payload, _DagInput):
        return payload.select(key)
    raise ValueError(
        f"DAG input selector {key!r} used but execute() got a single argument"
    )


class StageExecutor:
    """Run the locally-hosted stages of one plan: a thread per stage loops
    read-inputs -> invoke -> write-outputs until its channels close.

    ``writers`` maps the names of CROSS-PROCESS output channels to their
    persistent :class:`~ray_tpu.runtime.data_plane.ChannelStream`; every
    other out name resolves against the local manager.  ``on_broken(error)``
    fires when a stage can no longer even FORWARD its error downstream
    (transport death) — the plan must be broken out-of-band."""

    def __init__(self, plan_id: str, stages: List[StageSpec], consts: List[Any],
                 manager: ChannelManager, invoker: NodeActorInvoker,
                 writers: Dict[str, Any],
                 on_broken: Optional[Callable[[BaseException], None]] = None,
                 trace_id: Optional[str] = None):
        self.plan_id = plan_id
        self._stages = stages
        self._consts = consts
        self._mgr = manager
        self._invoker = invoker
        self._writers = writers
        self._on_broken = on_broken
        self._trace_id = trace_id or f"plan-{plan_id[:12]}"
        self._stop = False
        self._insts = {}
        self._group_insts: Dict[int, List[Any]] = {}
        self._group_pools: Dict[int, Any] = {}
        for s in stages:
            if s.group:
                members = [invoker.resolve(a) for a in s.group["members"]]
                self._group_insts[s.stage_id] = members
                self._insts[s.stage_id] = members[0]
            else:
                self._insts[s.stage_id] = invoker.resolve(s.actor_id)
        self._threads: List[threading.Thread] = []

    def start(self) -> None:
        from concurrent.futures import ThreadPoolExecutor

        for stage in self._stages:
            if stage.group:
                n = len(stage.group["members"])
                if n > 1:
                    self._group_pools[stage.stage_id] = ThreadPoolExecutor(
                        max_workers=n - 1,
                        thread_name_prefix=f"plan-{self.plan_id[:8]}-g{stage.stage_id}",
                    )
                self._warmup_group(stage)
        for stage in self._stages:
            t = threading.Thread(
                target=self._stage_loop, args=(stage,),
                name=f"plan-{self.plan_id[:8]}-s{stage.stage_id}", daemon=True,
            )
            self._threads.append(t)
            t.start()

    def stop(self) -> None:
        self._stop = True
        for writer in self._writers.values():
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass
        for pool in self._group_pools.values():
            pool.shutdown(wait=False)

    # ------------------------------------------------------------------
    def _warmup_group(self, stage: StageSpec) -> None:
        """Install-time warm-up: invoke every gang member ONCE on zeros
        examples shaped like its per-member split, placed on the current
        CUDA device where there is one, so the member's first step (kernel
        builds, allocator growth, workspace set-up) runs at install and
        every ``execute`` finds it warm.  One ``[shape, dtype]`` pair per
        step argument (dtype a torch dtype name); each pair follows the same
        split-or-replicate rule ``_invoke_group`` applies to real inputs."""
        g = stage.group
        warm = g.get("warmup")
        if not warm:
            return
        import torch

        from ray_tpu_torch.dag.channel import device_place

        # legacy single [shape, dtype] vs a list of such pairs
        pairs = [warm] if len(warm) == 2 and isinstance(warm[1], str) else warm
        n = len(g["members"])
        axis = g.get("split_axis", 0)
        examples = []
        for shape, dtype in pairs:
            shape = list(shape)
            if n > 1 and len(shape) > axis and shape[axis] % n == 0:
                shape[axis] //= n
            examples.append(device_place(
                torch.zeros(tuple(shape), dtype=getattr(torch, str(dtype).removeprefix("torch.")))))
        for inst, actor_id in zip(self._group_insts[stage.stage_id], g["members"]):
            self._invoker.invoke(inst, actor_id, stage.method, tuple(examples), {})

    def _group_mesh(self, g: dict):
        name = g.get("mesh")
        if not name:
            return None
        try:
            from ray_tpu_torch.parallel.mesh import mesh_manager

            return mesh_manager().get_mesh(name)
        except KeyError:
            return None

    def _invoke_group(self, stage: StageSpec, args: tuple, kwargs: dict) -> Any:
        """One gang dispatch: split tensor args across the members along
        the group axis (replicating everything else), run every member's
        step concurrently, reassemble the outputs into one tensor (this
        rank's block when a process-group mesh matches, a device concat
        otherwise)."""
        from ray_tpu_torch.exceptions import ActorDiedError, WorkerCrashedError
        from ray_tpu_torch.observability import metric_defs
        from ray_tpu_torch.parallel import mesh as mesh_mod
        from ray_tpu_torch.runtime import device_plane

        g = stage.group
        members = g["members"]
        insts = self._group_insts[stage.stage_id]
        n = len(members)
        axis = g.get("split_axis", 0)

        def parts_of(v):
            if (n > 1 and device_plane.is_device_array(v)
                    and getattr(v, "ndim", 0) > axis and v.shape[axis] % n == 0):
                return mesh_mod.split_for_group(v, n, axis=axis)
            return [v] * n

        arg_parts = [parts_of(a) for a in args]
        kw_parts = {k: parts_of(v) for k, v in kwargs.items()}

        def member_call(i: int):
            m_args = tuple(p[i] for p in arg_parts)
            m_kwargs = {k: p[i] for k, p in kw_parts.items()}
            return self._invoker.invoke(insts[i], members[i], stage.method,
                                        m_args, m_kwargs)

        pool = self._group_pools.get(stage.stage_id)
        futs = {i: pool.submit(member_call, i) for i in range(1, n)} if pool else {}
        outs: List[Any] = [None] * n
        first_err: Optional[BaseException] = None
        try:
            outs[0] = member_call(0)
        except BaseException as exc:  # noqa: BLE001
            first_err = exc
        for i, fut in futs.items():
            try:
                outs[i] = fut.result()
            except BaseException as exc:  # noqa: BLE001
                # prefer the typed death over a secondary failure
                if first_err is None or (
                    isinstance(exc, (ActorDiedError, WorkerCrashedError))
                    and not isinstance(first_err, (ActorDiedError, WorkerCrashedError))
                ):
                    first_err = exc
        if first_err is not None:
            raise first_err
        metric_defs.PLAN_STAGE_GROUP_EXECUTIONS.inc()
        if n == 1:
            return outs[0]
        if all(device_plane.is_device_array(o) and getattr(o, "ndim", 0) > axis
               for o in outs):
            return mesh_mod.assemble_from_group(outs, mesh=self._group_mesh(g), axis=axis)
        return outs  # non-array member outputs pass through as the raw list

    def _emit(self, stage: StageSpec, seq: int, value: Any, is_error: bool) -> None:
        for name in stage.outs:
            writer = self._writers.get(name)
            if writer is not None:
                writer.push(seq, value, is_error=is_error)
            else:
                ch = self._mgr.channel(self.plan_id, name)
                if ch is None:
                    raise ChannelClosed(f"channel {name!r} released")
                ch.write(seq, value, is_error=is_error)

    def _resolve_slot(self, slot: tuple, payload: Any, chan_vals: Dict[str, Any]) -> Any:
        kind, ref = slot
        if kind == "chan":
            return chan_vals[ref]
        if kind == "input":
            return select_input(payload, ref)
        return self._consts[ref]

    def _stage_loop(self, stage: StageSpec) -> None:
        from ray_tpu_torch.exceptions import (
            ActorDiedError,
            RayTaskError,
            WorkerCrashedError,
        )
        from ray_tpu_torch.observability import tracing
        from ray_tpu_torch.runtime.data_plane import DataPlaneError

        inst = self._insts[stage.stage_id]
        chan_inputs = sorted(
            {ref for kind, ref in list(stage.arg_slots) + list(stage.kw_slots.values())
             if kind == "chan"}
        )
        while not self._stop:
            # -- 1. gather this iteration's inputs -------------------------
            payload = None
            seq = 0
            error: Optional[BaseException] = None
            try:
                if stage.inchan is not None:
                    ch = self._mgr.channel(self.plan_id, stage.inchan)
                    if ch is None:
                        return
                    seq, payload, is_err = ch.read()
                    if is_err:
                        error = payload
                chan_vals: Dict[str, Any] = {}
                for name in chan_inputs:
                    ch = self._mgr.channel(self.plan_id, name)
                    if ch is None:
                        return
                    seq, v, is_err = ch.read()
                    if is_err and error is None:
                        error = v
                    chan_vals[name] = v
            except (ChannelClosed, ActorDiedError, WorkerCrashedError):
                return  # plan torn down / broken
            except Exception:  # noqa: BLE001 — close(error) re-raised typed errors
                return
            # -- 2. forward upstream errors without invoking ----------------
            if error is None:
                try:
                    args = tuple(
                        self._resolve_slot(s, payload, chan_vals) for s in stage.arg_slots
                    )
                    kwargs = {
                        k: self._resolve_slot(s, payload, chan_vals)
                        for k, s in stage.kw_slots.items()
                    }
                    t0 = time.time()
                    if stage.group:
                        result = self._invoke_group(stage, args, kwargs)
                    else:
                        result = self._invoker.invoke(
                            inst, stage.actor_id, stage.method, args, kwargs
                        )
                    if tracing.enabled():
                        tracing.emit_span(
                            f"stage::{stage.name}", self._trace_id, None,
                            t0, time.time(),
                            attrs={"seq": str(seq), "stage": str(stage.stage_id)},
                        )
                except BaseException as exc:  # noqa: BLE001
                    error = exc if isinstance(
                        exc, (ActorDiedError, WorkerCrashedError, RayTaskError)
                    ) else RayTaskError.from_exception(stage.name, exc)
            # -- 3. write the value (or the typed error) downstream ---------
            try:
                if error is not None:
                    self._emit(stage, seq, error, True)
                else:
                    self._emit(stage, seq, result, False)
            except (ChannelClosed, ActorDiedError, WorkerCrashedError):
                # the channel was closed/broken under us (plan death sweep
                # re-raises its typed error from close(error)): the plan is
                # already broken out-of-band — just stand down
                return
            except (DataPlaneError, OSError, TimeoutError) as exc:
                # the error itself could not travel: break the plan out of
                # band, else the driver's output read blocks forever
                if self._on_broken is not None:
                    try:
                        self._on_broken(exc)
                    except Exception:  # noqa: BLE001
                        pass
                return


# --------------------------------------------------------------------------
# remote (agent-side) plan hosting: the multi-node runtime
# --------------------------------------------------------------------------
def install_remote_plan(payload: dict, node, conn) -> None:
    """``install_plan`` control-RPC body on a node agent: not ported."""
    from ray_tpu_torch.exceptions import NotPortedError

    raise NotPortedError("plan stages on a node agent", "ray_tpu/runtime/channel_manager.py")


def uninstall_remote_plan(plan_id: str) -> None:
    """``uninstall_plan`` on a node agent: not ported."""
    from ray_tpu_torch.exceptions import NotPortedError

    raise NotPortedError("plan stages on a node agent", "ray_tpu/runtime/channel_manager.py")
