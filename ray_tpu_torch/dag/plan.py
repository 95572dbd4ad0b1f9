"""Compiled execution plans: install-once DAG schedules.

The port's copy of ``ray_tpu/dag/plan.py``, for stages whose actors live in
the driver's process: the nodes of the in-process cluster, in-process
(GPU) actors included.  A stage on a node agent's process waits for the
multi-node runtime and raises ``NotPortedError`` at compile time.

Reference parity: the accelerated-DAG runtime
(``python/ray/dag/compiled_dag_node.py:278`` + the mutable plasma/NCCL
channels under ``python/ray/experimental/channel/``), and the insight
behind it: amortize single-controller dispatch by building the graph ONCE
and executing many times over pre-established channels.

Compiling builds a **stage program** per stage, installed once: a thread
per stage loops read-inputs -> call the actor -> write-outputs, and every
DAG edge becomes a named single-slot channel (``runtime/channel_manager.py``).
``plan.execute(args)`` then pushes the input to the entry channels and
awaits the output channel: zero TaskSpecs, zero scheduler hops, zero
ObjectRefs per iteration; ``execute_async`` pipelines successive iterations
through the stages (each single-slot edge buffers one iteration, so a
k-stage pipeline runs ~k iterations concurrently).  Edges are of the
``device`` kind unless ``plan_channel_kind`` is ``"pickle"``: a tensor is
handed over as a reference, with the writer's stream fence when it is on
the card.  A :class:`StageGroup` stage is a gang of actors running the same
step on the splits of each tensor input.

Failure story: a stage actor raising a USER exception fails that iteration
(the typed error travels the channels like any value) and the plan stays
READY; actor or node DEATH surfaces a typed error (ActorDiedError /
WorkerCrashedError) on the output channel and flips the plan to BROKEN:
subsequent executes raise immediately, ``repair()`` (or ``auto_repair``)
reinstalls onto the restarted actors, and ``teardown()`` releases the
channels.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

from ray_tpu_torch.dag.channel import ChannelClosed
from ray_tpu_torch.dag.dag_node import (
    ClassMethodNode,
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
    _DagInput,
)
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    RayTpuError,
    WorkerCrashedError,
    raised_copy,
)
from ray_tpu_torch.runtime.channel_manager import (
    NodeActorInvoker,
    StageExecutor,
    StageSpec,
    _set_future,
    global_manager,
)

_SYSTEM_ERRORS = (ActorDiedError, WorkerCrashedError)


class _DriverInvoker:
    """Invoker over DRIVER-PROCESS nodes: resolves each stage actor against
    the in-process Node hosting it (the driver process may host several
    nodes of an in-process cluster)."""

    def __init__(self, cluster, actor_node_ids: Dict[Any, Any]):
        self._subs = {
            actor_id: NodeActorInvoker(cluster.nodes[node_id])
            for actor_id, node_id in actor_node_ids.items()
        }

    def resolve(self, actor_id):
        return self._subs[actor_id].resolve(actor_id)

    def invoke(self, inst, actor_id, method, args, kwargs):
        return self._subs[actor_id].invoke(inst, actor_id, method, args, kwargs)


class StageGroup:
    """An SPMD gang executing the SAME step as ONE plan stage.

    ``StageGroup([a0, a1, ...], "step").bind(inp)`` places a gang stage in a
    compiled plan: every iteration the stage executor splits tensor inputs
    across the members along ``split_axis`` (replicating everything else),
    runs each member's ``method`` concurrently, and reassembles the outputs
    into one tensor (``parallel.mesh.assemble_from_group``: this rank's
    block when ``mesh``, a name registered in
    ``parallel.mesh.mesh_manager()``, is over a process group of the member
    count, a device concat otherwise).  ``warmup=(shape, dtype)``, or a
    sequence of such pairs for multi-argument steps (dtype a torch dtype
    name), runs every member's step ONCE at install on zeros examples of
    the per-member split, so the first iteration finds it warm.  All
    members must be co-hosted in one process; a member death flips the plan
    BROKEN with :class:`ActorDiedError` and ``repair()`` waits for every
    member before reinstalling."""

    def __init__(self, actors, method: str, *, mesh: Optional[str] = None,
                 split_axis: int = 0, warmup=None):
        if not actors:
            raise ValueError("StageGroup needs at least one member actor")
        self.actors = list(actors)
        self.method = method
        self.mesh = mesh
        self.split_axis = split_axis
        self.warmup = warmup

    def bind(self, *args, **kwargs) -> "StageGroupNode":
        return StageGroupNode(self, args, kwargs)


class StageGroupNode(ClassMethodNode):
    """DAG node for a gang stage — shaped like a ClassMethodNode (the plan
    compiler treats member 0 as the stage's nominal actor) but carrying the
    whole :class:`StageGroup`."""

    def __init__(self, group: StageGroup, args: tuple, kwargs: dict):
        DAGNode.__init__(self, args, kwargs)
        self.group = group

    @property
    def actor_handle(self):
        return self.group.actors[0]

    @property
    def method_name(self) -> str:
        return self.group.method

    def _submit(self, cache, input_args, input_kwargs):
        raise ValueError(
            "stage groups execute through compile_plan(), not interpreted .execute()"
        )


def _group_payload(group: Optional[StageGroup]) -> Optional[dict]:
    """The StageSpec encoding of a StageGroup (``runtime/channel_manager.py``
    reads it)."""
    if group is None:
        return None
    warm = None
    if group.warmup is not None:
        pairs = group.warmup
        # a single (shape, dtype) vs a sequence of them (multi-arg steps): a
        # shape's first element is an int, a pair's is a shape
        if len(pairs) == 2 and not (pairs[0] and isinstance(pairs[0][0], (list, tuple))):
            pairs = [pairs]
        warm = [[list(shape), str(dtype)] for shape, dtype in pairs]
    return {
        "members": [a._actor_id for a in group.actors],
        "split_axis": group.split_axis,
        "mesh": group.mesh,
        "warmup": warm,
    }


class _StageDraft:
    __slots__ = ("stage_id", "node", "actor_id", "node_id", "proc",
                 "arg_slots", "kw_slots", "inchan", "outs", "name", "group")

    def __init__(self, stage_id: int, node: ClassMethodNode):
        self.stage_id = stage_id
        self.node = node
        self.actor_id = node.actor_handle._actor_id
        self.node_id = None
        self.proc = None
        self.arg_slots: List[tuple] = []
        self.kw_slots: Dict[str, tuple] = {}
        self.inchan: Optional[str] = None
        self.outs: List[str] = []
        self.name = node.method_name
        #: the StageGroup when this stage is an SPMD gang, else None
        self.group: Optional[StageGroup] = getattr(node, "group", None)


class ExecutionPlan:
    """Compile a DAG of actor-method stages into an installed multi-host
    schedule; see the module docstring.  Build via
    ``dag_node.compile_plan()``."""

    def __init__(self, root: DAGNode, name: str = "", auto_repair: bool = False):
        from ray_tpu_torch.api import _auto_init, get_cluster

        _auto_init()
        self._cluster = get_cluster()
        self.plan_id = os.urandom(8).hex()
        self.name = name or f"plan-{self.plan_id[:8]}"
        self._state = "READY"
        self._error: Optional[BaseException] = None
        self._auto_repair = auto_repair
        self._repair_lock = threading.Lock()   # serializes repair attempts
        self.state_history: List[str] = ["READY"]
        self._state_lock = threading.Lock()
        self._submit_lock = threading.Lock()
        self._seq = 0
        self._completed = 0
        self._failed = 0
        self._manager = global_manager()
        self._executor: Optional[StageExecutor] = None
        self._entry_writes: List[Any] = []          # callables write(seq, payload)
        self._out_channels: List[Any] = []
        self._trace_id = f"plan-{self.plan_id[:12]}"
        self._pending: "queue.Queue" = queue.Queue()

        self._compile(root)
        try:
            self._install()
        except BaseException:
            # partial install: release everything so nothing leaks from a
            # failed compile
            self._state = "TORN_DOWN"
            if self._executor is not None:
                self._executor.stop()
            self._manager.release_plan(self.plan_id)
            raise
        self._cluster.compiled_plans[self.plan_id] = self
        self._drainer = threading.Thread(
            target=self._drain_loop, name=f"plan-{self.plan_id[:8]}-out", daemon=True
        )
        self._drainer.start()

    # ------------------------------------------------------------------
    # compilation: DAG -> stages + channels
    # ------------------------------------------------------------------
    # rt-lint: disable=lock-discipline -- construction phase: _compile runs
    # only from __init__, before the plan is published to
    # cluster.compiled_plans; no other thread can see these fields yet
    def _compile(self, root: DAGNode) -> None:
        order = root.topological()
        for node in order:
            if isinstance(node, FunctionNode):
                raise ValueError(
                    "ExecutionPlan compiles actor-method DAGs; function nodes "
                    "belong to CompiledDAG (experimental_compile)"
                )
        drafts: Dict[int, _StageDraft] = {}
        consts: List[Any] = []
        for node in order:
            if not isinstance(node, ClassMethodNode):
                continue
            draft = _StageDraft(len(drafts), node)
            drafts[id(node)] = draft

            def slot_for(value, draft=draft):
                if isinstance(value, InputNode):
                    return ("input", None)
                if isinstance(value, InputAttributeNode):
                    return ("input", value._key)
                if isinstance(value, ClassMethodNode):
                    producer = drafts[id(value)]
                    chan = f"s{producer.stage_id}_s{draft.stage_id}"
                    if chan not in producer.outs:
                        producer.outs.append(chan)
                    return ("chan", chan)
                if isinstance(value, DAGNode):
                    raise ValueError(f"unsupported DAG node {type(value).__name__} in plan")
                consts.append(value)
                return ("const", len(consts) - 1)

            draft.arg_slots = [slot_for(a) for a in node._bound_args]
            draft.kw_slots = {k: slot_for(v) for k, v in node._bound_kwargs.items()}
            slots = list(draft.arg_slots) + list(draft.kw_slots.values())
            if any(kind == "input" for kind, _ in slots):
                draft.inchan = f"in_s{draft.stage_id}"
            if not any(kind in ("input", "chan") for kind, _ in slots):
                raise ValueError(
                    f"stage {draft.name!r} has no per-iteration inputs "
                    "(all-constant stages have nothing to trigger them)"
                )
        if not drafts:
            raise ValueError("ExecutionPlan needs at least one actor-method stage")

        # terminal node(s) -> output channels, in leaf order
        if isinstance(root, MultiOutputNode):
            leaves = list(root._bound_args)
            if not all(isinstance(leaf, ClassMethodNode) for leaf in leaves):
                raise ValueError("MultiOutputNode leaves must be actor-method stages")
            self._multi_output = True
        elif isinstance(root, ClassMethodNode):
            leaves = [root]
            self._multi_output = False
        else:
            raise ValueError(
                f"plan root must be an actor-method stage, got {type(root).__name__}"
            )
        self._output_names: List[str] = []
        for j, leaf in enumerate(leaves):
            draft = drafts[id(leaf)]
            chan = f"s{draft.stage_id}_out{j}"
            draft.outs.append(chan)
            self._output_names.append(chan)

        # placement: every stage actor must be ALIVE somewhere; gang stages
        # additionally require every member co-hosted in ONE process (the
        # split/assemble handoff is an in-process device move, never a wire hop)
        from ray_tpu_torch.core.config import get_config

        cfg = get_config()
        self._stages = list(drafts.values())
        self._consts = consts
        self._actor_ids = set()
        self._node_ids = set()
        for draft in self._stages:
            if draft.group is not None:
                members = draft.group.actors
                if len(members) > cfg.plan_stage_group_max_members:
                    raise ValueError(
                        f"stage group {draft.name!r} has {len(members)} members "
                        f"(plan_stage_group_max_members={cfg.plan_stage_group_max_members})"
                    )
                member_nodes = [
                    self._wait_actor_alive(a._actor_id) for a in members
                ]
                procs = {self._proc_key(nid) for nid in member_nodes}
                if len(procs) != 1:
                    raise ValueError(
                        f"stage group {draft.name!r} members span processes "
                        f"{sorted(procs)}; a gang must be co-hosted in one process"
                    )
                draft.node_id = member_nodes[0]
                draft.proc = procs.pop()
                for a, nid in zip(members, member_nodes):
                    self._actor_ids.add(a._actor_id)
                    self._node_ids.add(nid)
            else:
                draft.node_id = self._wait_actor_alive(draft.actor_id)
                draft.proc = self._proc_key(draft.node_id)
                self._actor_ids.add(draft.actor_id)
                self._node_ids.add(draft.node_id)

        # channel kinds: with plan_channel_kind "auto"/"device" every edge is
        # device-capable (tensor payloads stay where they are; other values
        # fall back to pickle per-seq on the same edge); "pickle" forces the
        # original frame path everywhere
        kind = "pickle" if cfg.plan_channel_kind == "pickle" else "device"
        all_chans = (
            {c for d in self._stages for c in d.outs}
            | {d.inchan for d in self._stages if d.inchan}
        )
        self._chan_kinds: Dict[str, str] = {c: kind for c in all_chans}

    def _wait_actor_alive(self, actor_id, timeout: float = 30.0):
        from ray_tpu_torch.runtime.control import ActorState

        deadline = time.monotonic() + timeout
        while True:
            info = self._cluster.control.actors.get(actor_id)
            if info is None:
                raise ValueError(f"unknown actor {actor_id.hex()[:8]} in plan")
            if info.state is ActorState.DEAD:
                raise ActorDiedError(actor_id, "stage actor died before plan install")
            if info.state is ActorState.ALIVE and info.node_id is not None:
                return info.node_id
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"stage actor {actor_id.hex()[:8]} never became ALIVE"
                )
            time.sleep(0.01)

    def _wait_stage_actor_live(self, actor_id, deadline: float):
        """Repair's stricter liveness wait: the control record may still
        say ALIVE-on-the-dead-node for a beat (the death sweep breaks the
        plan BEFORE it runs the actor FSM), so besides the FSM state the
        hosting node must be alive and — for in-process nodes — the actor
        instance must actually exist there.  ``deadline`` is a monotonic
        instant shared by the whole repair, not a per-actor budget."""
        from ray_tpu_torch.runtime.control import ActorState

        while True:
            info = self._cluster.control.actors.get(actor_id)
            if info is None:
                raise ValueError(f"unknown actor {actor_id.hex()[:8]} in plan")
            if info.state is ActorState.DEAD:
                raise ActorDiedError(
                    actor_id, "stage actor is permanently dead; plan unrepairable"
                )
            if info.state is ActorState.ALIVE and info.node_id is not None:
                node = self._cluster.nodes.get(info.node_id)
                if node is not None and not node.dead:
                    insts = getattr(node, "actors", None)
                    if insts is None:  # remote agent hosts it
                        return info.node_id
                    inst = insts.get(actor_id)
                    if inst is not None and not inst.dead:
                        return info.node_id
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"stage actor {actor_id.hex()[:8]} never came back ALIVE"
                )
            time.sleep(0.01)

    def _proc_key(self, node_id) -> str:
        node = self._cluster.nodes.get(node_id)
        if node is None:
            raise ValueError(f"stage actor's node {node_id.hex()[:8]} is unknown")
        if hasattr(node, "conn"):
            from ray_tpu_torch.exceptions import NotPortedError

            raise NotPortedError("plan stages on a node agent", "ray_tpu/dag/plan.py")
        return "driver"

    # ------------------------------------------------------------------
    # install: stage programs + channels (ONCE)
    # ------------------------------------------------------------------
    # rt-lint: guarded-by(_repair_lock) -- callers: repair() holds it;
    # __init__ runs pre-publication with exclusive access (stronger)
    def _install(self) -> None:
        chans = self._manager.register(
            self.plan_id,
            [c for d in self._stages for c in d.outs] + [d.inchan for d in self._stages if d.inchan],
            kinds=self._chan_kinds,
        )
        self._out_channels = [chans[c] for c in self._output_names]
        # entry writes, one per stage consuming the DAG input, in stage order
        for draft in sorted(self._stages, key=lambda d: d.stage_id):
            if draft.inchan is not None:
                ch = chans[draft.inchan]
                self._entry_writes.append(lambda seq, payload, ch=ch: ch.write(seq, payload))
        stages = [
            StageSpec(d.stage_id, d.actor_id, d.node.method_name, d.name,
                      d.arg_slots, d.kw_slots, d.inchan, d.outs,
                      group=_group_payload(d.group))
            for d in self._stages
        ]
        invoker_map: Dict[Any, Any] = {}
        for d in self._stages:
            if d.group is not None:
                # gang members may sit on different in-process nodes of the
                # driver cluster: resolve each against control
                for a in d.group.actors:
                    info = self._cluster.control.actors.get(a._actor_id)
                    invoker_map[a._actor_id] = info.node_id if info is not None else d.node_id
            else:
                invoker_map[d.actor_id] = d.node_id
        invoker = _DriverInvoker(self._cluster, invoker_map)
        self._executor = StageExecutor(
            self.plan_id, stages, self._consts, self._manager, invoker, {},
            on_broken=self._mark_broken, trace_id=self._trace_id,
        )
        self._executor.start()

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    @property
    # rt-lint: disable=lock-discipline -- lock-free state snapshot for
    # callers that tolerate staleness; transitions happen under _state_lock
    def state(self) -> str:
        return self._state

    # rt-lint: disable=lock-discipline -- optimistic gate: a torn read here
    # only lets one extra iteration into the entry-write path, where the
    # failure is caught and converted to the plan's typed error
    def _check_alive(self) -> None:
        if self._state == "TORN_DOWN":
            raise RuntimeError("ExecutionPlan was torn down")
        if self._state == "BROKEN":
            raise raised_copy(self._error) if self._error is not None else RuntimeError(
                "ExecutionPlan is broken"
            )

    def execute(self, *args, **kwargs):
        """Run one iteration through the installed pipeline; returns the raw
        output value(s) — no ObjectRefs."""
        return self.execute_async(*args, **kwargs).result()

    def execute_async(self, *args, **kwargs) -> Future:
        """Push one iteration's input and return a Future for its output.
        Successive calls pipeline: each single-slot edge buffers one
        iteration, so a k-stage plan keeps ~k iterations in flight."""
        self._check_alive()
        payload = (
            _DagInput(args, kwargs) if (kwargs or len(args) != 1) else args[0]
        )
        fut: Future = Future()
        # rt-lint: disable=lock-discipline -- optimistic fabric reads:
        # repair only swaps _entry_writes/_error under _repair_lock while
        # state is BROKEN, and _check_alive (re-run under _submit_lock)
        # gates entry; a break landing mid-write is caught below and
        # surfaced as the plan's typed error, never silent corruption
        with self._submit_lock:
            self._check_alive()
            seq = self._seq
            self._seq += 1
            fut._plan_seq = seq
            fut._plan_t0 = time.time()
            try:
                for write in self._entry_writes:
                    write(seq, payload)
            except BaseException as exc:  # noqa: BLE001 — broke/tore down under us
                err = self._error
                if err is None and isinstance(exc, (ChannelClosed, TimeoutError)):
                    # the entry channel itself died before the death sweep
                    # ran: the plan cannot execute again: break it NOW with
                    # the typed error instead of leaking a transport exception
                    self._mark_broken(
                        WorkerCrashedError(f"plan entry channel failed: {exc}")
                    )
                    err = self._error
                if err is not None:
                    raise raised_copy(err) from None
                raise
            self._pending.put(fut)
        return fut

    def _drain_loop(self) -> None:
        from ray_tpu_torch.observability import metric_defs, tracing

        while True:
            fut = self._pending.get()
            if fut is None:
                return
            try:
                # drain EVERY output channel before deciding ok/error: one
                # errored leaf must not leave sibling channels holding this
                # iteration's values, or every later iteration reads stale
                # slots (outputs permanently desynced from futures)
                outs = []
                err: Optional[BaseException] = None
                # rt-lint: disable=lock-discipline -- the drainer is the
                # sole fabric reader between repair epochs: repair waits
                # for _pending to drain (our reads fail fast off closed
                # channels) before swapping _out_channels under _repair_lock
                for ch in self._out_channels:
                    _seq, value, is_err = ch.read()
                    if is_err and err is None:
                        err = value if isinstance(value, BaseException) else RuntimeError(
                            str(value)
                        )
                    outs.append(value)
                if err is not None:
                    # raised_copy: the error object may be shared (one
                    # instance forwarded down several channels) — raising
                    # it raw would graft a traceback per raise (PR 2 bug)
                    raise raised_copy(err)
            except BaseException as exc:  # noqa: BLE001
                if isinstance(exc, _SYSTEM_ERRORS):
                    # actor/node death: the plan is permanently broken
                    self._mark_broken(exc)
                self._failed += 1
                metric_defs.COMPILED_PLAN_EXECUTIONS.inc(tags={"state": "error"})
                _set_future(fut, exc=exc)
                continue
            self._completed += 1
            metric_defs.COMPILED_PLAN_EXECUTIONS.inc(tags={"state": "ok"})
            if tracing.enabled():
                tracing.emit_span(
                    f"plan::{self.name}", self._trace_id, None,
                    getattr(fut, "_plan_t0", time.time()), time.time(),
                    attrs={"seq": str(getattr(fut, "_plan_seq", -1))},
                )
            _set_future(fut, outs if self._multi_output else outs[0])

    # ------------------------------------------------------------------
    # failure + lifecycle
    # ------------------------------------------------------------------
    def _record_transition(self, src: str, dst: str) -> None:
        """History for the chaos sweep's READY→BROKEN→READY audit — the
        cluster-level log outlives torn-down plans."""
        self.state_history.append(dst)
        try:
            self._cluster.plan_transitions.append((self.plan_id, src, dst))
        except Exception:  # noqa: BLE001 — bookkeeping must not block failure paths
            pass

    def _mark_broken(self, error: BaseException, upgrade: bool = False) -> None:
        with self._state_lock:
            if self._state != "READY":
                if (
                    upgrade and self._state == "BROKEN"
                    and not isinstance(self._error, RayTpuError)
                ):
                    # a stage loop's RAW transport error (a channel error
                    # out of the dying stage) won the race against
                    # this death notice: upgrade the stored error to the
                    # typed cause callers are promised (ActorDiedError /
                    # WorkerCrashedError), keeping the transport detail
                    # chained for the curious
                    error.__cause__ = self._error
                    self._error = error
                return
            self._state = "BROKEN"
            self._error = error
            self._record_transition("READY", "BROKEN")
        # flight-record the break: the postmortem needs the error and the
        # last served requests, captured before repair rewrites the fabric
        try:
            from ray_tpu_torch.observability import reqtrace

            reqtrace.flight_record(
                "plan_broken",
                f"compiled plan {self.plan_id[:8]} BROKEN: {error!r}",
                severity="ERROR",
                state={"plan_id": self.plan_id, "auto_repair": self._auto_repair},
            )
        except Exception:  # noqa: BLE001 — recording must not block the break
            pass
        # closing the channels wakes the drainer (pending futures fail with
        # the typed error) and every stage thread
        self._manager.break_plan(self.plan_id, error)
        if self._auto_repair:
            threading.Thread(
                target=self._auto_repair_loop,
                name=f"plan-{self.plan_id[:8]}-repair", daemon=True,
            ).start()

    def _auto_repair_loop(self) -> None:
        from ray_tpu_torch.core.config import get_config

        try:
            self.repair(timeout=get_config().compiled_plan_repair_timeout_s)
        except BaseException:  # noqa: BLE001 — the plan stays BROKEN with
            pass               # the original typed error for introspection

    def _release_fabric_locked(self) -> None:
        """Drop the channel fabric.  Caller holds ``_repair_lock``; the
        release tolerates already-released."""
        self._entry_writes = []
        self._out_channels = []
        self._manager.release_plan(self.plan_id)

    def repair(self, timeout: float = 30.0) -> None:
        """Rebuild a BROKEN plan onto its restarted stage actors.

        The actor restart FSM owns bringing dead stage actors back (they
        must be restartable: ``max_restarts`` budget left); repair waits
        for every stage actor to be ALIVE again, releases the broken
        channel fabric and stage threads, re-runs placement against the
        actors' NEW nodes, and reinstalls, then flips the plan back to
        READY.  Raises (and leaves
        the plan BROKEN) if any stage actor is permanently DEAD or never
        comes back within ``timeout``."""
        from ray_tpu_torch.observability import metric_defs

        with self._repair_lock:
            with self._state_lock:
                if self._state == "READY":
                    return  # nothing to repair (or a racing repair won)
                if self._state != "BROKEN":
                    raise RuntimeError(f"cannot repair a {self._state} plan")
            try:
                # 1. every stage actor back ALIVE, on its (possibly new)
                # node — ONE deadline for the whole pass, so `timeout`
                # bounds the repair wait, not timeout-per-stage
                deadline = time.monotonic() + timeout
                self._node_ids = set()
                for draft in self._stages:
                    if draft.group is not None:
                        # every gang member must come back, still co-hosted
                        member_nodes = [
                            self._wait_stage_actor_live(a._actor_id, deadline)
                            for a in draft.group.actors
                        ]
                        procs = {self._proc_key(nid) for nid in member_nodes}
                        if len(procs) != 1:
                            raise WorkerCrashedError(
                                f"stage group {draft.name!r} members restarted "
                                f"across processes {sorted(procs)}"
                            )
                        draft.node_id = member_nodes[0]
                        draft.proc = procs.pop()
                        self._node_ids.update(member_nodes)
                    else:
                        draft.node_id = self._wait_stage_actor_live(
                            draft.actor_id, deadline
                        )
                        draft.proc = self._proc_key(draft.node_id)
                        self._node_ids.add(draft.node_id)
                # 2. release the broken fabric: the executor and the channel
                # registrations.  The
                # drainer has already failed every pending future (the
                # break closed its channels); it survives and will read the
                # NEW output channels after reinstall.
                if self._executor is not None:
                    self._executor.stop()
                    self._executor = None
                # let the drainer finish failing the broken epoch's pending
                # futures (its reads raise instantly off the closed
                # channels) BEFORE the swap — a stale future must never
                # block on a fresh channel's first iteration
                deadline = time.monotonic() + 5.0
                while not self._pending.empty() and time.monotonic() < deadline:
                    time.sleep(0.005)
                time.sleep(0.02)  # settle: a just-popped future finishes its read
                self._release_fabric_locked()
                # 3. reinstall on the replacements (fresh channels/streams)
                self._install()
            except BaseException:
                metric_defs.PLAN_REPAIRS.inc(tags={"outcome": "failed"})
                raise
            with self._state_lock:
                resurrected = self._state == "BROKEN"
                if resurrected:
                    self._error = None
                    self._state = "READY"
                    self._record_transition("BROKEN", "READY")
            if not resurrected:
                # torn down while we rebuilt: stay torn down: a repair must
                # never resurrect a released plan.  The racing teardown ran
                # against the fabric step 2 had already released, so the
                # FRESH executor and channels just installed are released
                # here or they leak
                if self._executor is not None:
                    self._executor.stop()
                    self._executor = None
                self._release_fabric_locked()
                metric_defs.PLAN_REPAIRS.inc(tags={"outcome": "failed"})
                return
        metric_defs.PLAN_REPAIRS.inc(tags={"outcome": "ok"})
        try:
            from ray_tpu_torch.observability import reqtrace

            reqtrace.flight_record(
                "plan_repaired",
                f"compiled plan {self.plan_id[:8]} repaired: BROKEN -> READY",
                severity="INFO",
                state={"plan_id": self.plan_id},
            )
        except Exception:  # noqa: BLE001
            pass
        # deaths that landed while state was BROKEN were ignored by the
        # hooks — re-check so a mid-repair casualty re-breaks immediately
        # instead of surfacing as a hang on the next execute
        from ray_tpu_torch.runtime.control import ActorState

        for draft in self._stages:
            members = (
                [a._actor_id for a in draft.group.actors]
                if draft.group is not None else [draft.actor_id]
            )
            for actor_id in members:
                info = self._cluster.control.actors.get(actor_id)
                if info is None or info.state is ActorState.DEAD:
                    self._mark_broken(
                        ActorDiedError(actor_id, "stage actor died during repair")
                    )
                    return

    def on_actor_dead(self, actor_id, cause: str = "") -> None:
        """Cluster hook: a stage actor died — flip BROKEN even with no
        iteration in flight."""
        if actor_id in self._actor_ids:
            self._mark_broken(
                ActorDiedError(actor_id, f"plan stage actor died: {cause or 'killed'}"),
                upgrade=True,
            )

    def on_node_dead(self, node_id) -> None:
        """Cluster hook: a node hosting plan stages died."""
        # rt-lint: disable=lock-discipline -- atomic whole-set rebind:
        # repair replaces _node_ids in one store; a death that races the
        # swap is re-checked by repair's own post-install death sweep
        if node_id in self._node_ids:
            self._mark_broken(
                WorkerCrashedError(f"node {node_id.hex()[:8]} died mid-plan"),
                upgrade=True,
            )

    # rt-lint: disable=lock-discipline -- runs after the TORN_DOWN flip
    # (under _state_lock): new entries fail _check_alive, and a concurrent
    # repair observes TORN_DOWN and releases its own fresh fabric, so the
    # objects read here are the last epoch's; every release is idempotent
    def teardown(self) -> None:
        """Release the plan's channels and stage threads. Idempotent."""
        with self._state_lock:
            if self._state == "TORN_DOWN":
                return
            prev = self._state
            self._state = "TORN_DOWN"
            self._record_transition(prev, "TORN_DOWN")
        self._cluster.compiled_plans.pop(self.plan_id, None)
        if self._executor is not None:
            self._executor.stop()
        self._manager.release_plan(self.plan_id)
        self._pending.put(None)

    # ------------------------------------------------------------------
    # observability (the reference's GET /api/plans and `rt plans` read it)
    # ------------------------------------------------------------------
    # rt-lint: disable=lock-discipline -- observability snapshot: torn
    # reads only skew the dashboard for one poll, never plan execution
    def snapshot(self) -> dict:
        return {
            "plan": self.plan_id[:12],
            "name": self.name,
            "state": self._state,
            "auto_repair": self._auto_repair,
            "history": list(self.state_history),
            "executions": self._completed,
            "failed": self._failed,
            "inflight": max(0, self._seq - self._completed - self._failed),
            "stages": [
                {
                    "stage": d.stage_id,
                    "method": d.name,
                    "actor": d.actor_id.hex()[:8],
                    "node": d.node_id.hex()[:8],
                    "proc": "driver" if d.proc == "driver" else "agent",
                    "group": len(d.group.actors) if d.group is not None else 0,
                }
                for d in sorted(self._stages, key=lambda d: d.stage_id)
            ],
            "channels": sorted(
                {c for d in self._stages for c in d.outs}
                | {d.inchan for d in self._stages if d.inchan}
            ),
            "channel_kinds": dict(getattr(self, "_chan_kinds", {})),
            "error": repr(self._error) if self._error is not None else None,
        }
