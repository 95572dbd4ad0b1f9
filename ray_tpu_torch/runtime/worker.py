"""CoreWorker: the per-driver runtime object.

The port's copy of ``ray_tpu/runtime/worker.py``.  A task's ``runtime_env``
is validated at submit, as in the JAX package; a task that holds a GPU share
and has one runs in a process worker that sees the card
(``runtime/worker_pool.py``).

Parity with the reference's ``CoreWorker``
(``src/ray/core_worker/core_worker.h:292``): Put/Get/Wait, task and actor
submission, ownership bookkeeping (every object submitted/created by this
driver is owned here: refcount, lineage, locations — the NSDI'21 ownership
invariant), and task-commit callbacks that release argument references.

TPU-first delta: submission is a function call into the in-process fabric,
not a Cython→C++→gRPC lease round trip (SURVEY §3.2 steps 2-5 collapse into
``Cluster.submit``), which is where the ~100× task-throughput headroom over
the reference's 971 tasks/s comes from.
"""

from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future
# py3.10: futures.TimeoutError is NOT the builtin (unified only in 3.11) —
# catching bare TimeoutError lets Future.result timeouts leak past the
# GetTimeoutError translation
from concurrent.futures import TimeoutError as _FutureTimeoutError
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.ids import ActorID, JobID, ObjectID, TaskID
from ray_tpu_torch.core.object_ref import ObjectRef, hooks
from ray_tpu_torch.core.refcount import ReferenceCounter
from ray_tpu_torch.core.resources import ResourceSet
from ray_tpu_torch.core.serialization import get_context
from ray_tpu_torch.exceptions import GetTimeoutError, raised_copy
from ray_tpu_torch.observability import metric_defs, tracing
from ray_tpu_torch.runtime.context import task_context
from ray_tpu_torch.runtime.control import ActorInfo
from ray_tpu_torch.runtime.placement import bundle_demands
from ray_tpu_torch.runtime.scheduler import TaskSpec




class CoreWorker:
    def __init__(self, cluster, job_id: JobID):
        self.cluster = cluster
        self.job_id = job_id
        self.driver_task_id = TaskID.for_driver(job_id)
        self.ref_counter = ReferenceCounter(self._on_object_out_of_scope)
        self._put_counter = itertools.count(1)
        hooks.ref_counter = self.ref_counter
        hooks.serialization_ctx = get_context()
        cluster.core_worker = self
        # per-caller in-flight task cap (overload survival, ISSUE 9):
        # submissions past max_inflight_tasks_per_caller block or shed with
        # a typed OverloadedError; released on every terminal commit
        from ray_tpu_torch.runtime.admission import AdmissionGate

        self.admission_gate = AdmissionGate()
        # memory pressure frees dead objects before anything spills (a tight
        # put loop outruns the deferred-decref drainer thread); every
        # in-process store gets the hook, and add_node wires later joiners
        for node in list(cluster.nodes.values()):
            store = getattr(node, "store", None)
            if store is not None:
                store.pressure_callback = self.ref_counter.drain_deferred

    # ------------------------------------------------------------------
    @property
    def head_node(self):
        return self.cluster.head_node

    def _current_task_id(self) -> TaskID:
        current = task_context.current()
        return current[0] if current is not None else self.driver_task_id

    # ------------------------------------------------------------------ put
    def mint_put_oid(self) -> ObjectID:
        """Mint + register ownership for a put object whose BYTES live
        elsewhere (agent-local nested puts); the caller records location."""
        oid = ObjectID.for_put(self._current_task_id(), next(self._put_counter))
        self.ref_counter.add_owned_object(oid)
        return oid

    def put(self, value: Any) -> ObjectRef:
        from ray_tpu_torch.runtime import failpoints

        if failpoints.ARMED:
            # chaos: a put fault surfaces HERE, before any state is minted —
            # the caller sees FailpointInjected loudly, nothing half-commits
            failpoints.fp("object_store.put")
        oid = self.mint_put_oid()
        node = self.head_node
        node.store.put(oid, value)
        # size/tier ride into the directory so the locality stage can score
        # nodes by local dependency bytes for tasks consuming this put
        self.cluster.commit_location(node, oid)
        return ObjectRef(oid)

    # --------------------------------------------------------------- submit
    def submit_task(
        self,
        func,
        args: Tuple,
        kwargs: dict,
        *,
        name: str,
        num_returns: int = 1,
        resources: Optional[Dict[str, float]] = None,
        max_retries: Optional[int] = None,
        retry_exceptions: bool = False,
        execution: str = "auto",
        scheduling_strategy: Any = None,
        runtime_env: Optional[dict] = None,
        deadline_s: Optional[float] = None,
        hedge_after_s: Optional[float] = None,
        _inherited_deadline_ts: Optional[float] = None,
        _task_id: Optional[bytes] = None,
    ) -> List[ObjectRef]:
        cfg = get_config()
        if runtime_env:
            # fail malformed envs HERE with the plugin's own error, not as
            # an opaque RayTaskError from inside a worker
            from ray_tpu_torch.runtime_env.plugin import validate_runtime_env

            validate_runtime_env(runtime_env)
        # _task_id: a worker minted the id locally (fire-and-forget nested
        # submission) — use it so its locally-built refs resolve here
        task_id = TaskID(_task_id) if _task_id is not None else TaskID.for_normal_task(self.job_id)
        streaming = num_returns == "streaming"
        if streaming:
            return_ids = []  # item refs materialize as the generator yields
        else:
            return_ids = [ObjectID.for_task_return(task_id, i + 1) for i in range(num_returns)]
        deps = _collect_deps(args, kwargs)
        spec = TaskSpec(
            task_id=task_id,
            name=name,
            func=func,
            args=args,
            kwargs=kwargs,
            dependencies=[r.id() for r in deps],
            num_returns=num_returns,
            return_ids=return_ids,
            resources=_interned_resource_set(bundle_demands(resources, scheduling_strategy)),
            max_retries=cfg.task_max_retries if max_retries is None else max_retries,
            execution=execution,
            scheduling_strategy=scheduling_strategy,
            runtime_env=runtime_env,
        )
        spec._retry_exceptions = retry_exceptions
        spec.trace_ctx = tracing.task_trace_context()
        # end-to-end deadline: own budget min'd with the inherited parent
        # budget (nested calls never outlive their parent's deadline).  The
        # inherited value arrives explicitly from worker relays, or from
        # the in-process deadline context for same-process nesting.
        watchdog = self.cluster.watchdog
        if (
            deadline_s is not None or hedge_after_s is not None
            or _inherited_deadline_ts is not None or watchdog.auto_on
        ):
            if deadline_s is not None and deadline_s <= 0:
                raise ValueError("deadline_s must be > 0")
            if hedge_after_s is not None and hedge_after_s <= 0:
                raise ValueError("hedge_after_s must be > 0")
            if streaming and (deadline_s is not None or hedge_after_s is not None):
                # EXPLICIT options only: an inherited parent deadline must
                # not make a nested streaming submission crash — it is
                # silently unenforced for streams (already-yielded items
                # cannot be un-delivered)
                raise ValueError(
                    "deadline_s / hedge_after_s are not supported for "
                    "num_returns='streaming' tasks (already-yielded items "
                    "cannot be un-delivered)"
                )
            if not streaming:
                deadline_ts = None if deadline_s is None else time.time() + deadline_s
                inherited = _inherited_deadline_ts
                if inherited is None:
                    from ray_tpu_torch.runtime.context import current_deadline_ts

                    inherited = current_deadline_ts()
                if inherited is not None:
                    deadline_ts = inherited if deadline_ts is None else min(deadline_ts, inherited)
                spec.deadline_ts = deadline_ts
                if deadline_ts is not None:
                    spec.deadline_s = (
                        deadline_s if deadline_s is not None
                        else max(0.0, deadline_ts - time.time())
                    )
                spec.hedge_after_s = hedge_after_s
        if not streaming and cfg.max_inflight_tasks_per_caller > 0:
            # per-caller in-flight cap: block-or-shed BEFORE any ownership
            # state is minted, so a shed submission leaves nothing behind.
            # (Streaming tasks are exempt — their terminal path does not
            # release through on_task_committed; actor calls are bounded by
            # the per-actor queue instead.)
            budget = (
                None if spec.deadline_ts is None
                else max(0.0, spec.deadline_ts - time.time())
            )
            self.admission_gate.admit(
                self._current_task_id().binary(), task_id.binary(), budget
            )
        metric_defs.TASKS_SUBMITTED.inc(tags=_NORMAL_TASK_TAGS)
        for oid in return_ids:
            self.ref_counter.add_owned_object(oid)
        self.ref_counter.add_submitted_task_references([r.id() for r in deps])
        spec.submit_time = time.time()
        if streaming:
            from ray_tpu_torch.core.generator import ObjectRefGenerator

            gen = ObjectRefGenerator(task_id)
            self.cluster.register_stream(spec, gen)
            self.cluster.task_manager.add_pending(spec)
            self.cluster.submit(spec)
            return gen
        self.cluster.task_manager.add_pending(spec)
        if spec.deadline_ts is not None or spec.hedge_after_s is not None or watchdog.auto_on:
            # tracked BEFORE submission so a deadline firing while the task
            # parks on the demand queue is already enforced
            watchdog.maybe_track(spec)
        self.cluster.submit(spec)
        return [ObjectRef(oid) for oid in return_ids]

    # --------------------------------------------------------------- actors
    def create_actor(
        self,
        cls,
        args: Tuple,
        kwargs: dict,
        *,
        name: Optional[str] = None,
        namespace: str = "default",
        class_name: str = "",
        resources: Optional[Dict[str, float]] = None,
        max_restarts: int = 0,
        max_task_retries: int = 0,
        max_concurrency: int = 1,
        mode: str = "process",
        scheduling_strategy: Any = None,
    ) -> ActorID:
        actor_id = ActorID.of(self.job_id)
        task_id = TaskID.for_actor_creation(actor_id)
        deps = _collect_deps(args, kwargs)
        demands = bundle_demands(resources, scheduling_strategy)
        spec = TaskSpec(
            task_id=task_id,
            name=f"{class_name}.__init__",
            func=cls,
            args=args,
            kwargs=kwargs,
            dependencies=[r.id() for r in deps],
            num_returns=0,
            return_ids=[],
            resources=ResourceSet({"CPU": 1} if demands is None else demands),
            actor_id=actor_id,
            scheduling_strategy=scheduling_strategy,
            is_actor_creation=True,
        )
        self.ref_counter.add_submitted_task_references([r.id() for r in deps])
        info = ActorInfo(actor_id, name, max_restarts, self.job_id, class_name)
        self.cluster.create_actor(
            spec, mode, max_concurrency, info,
            namespace=namespace, max_task_retries=max_task_retries,
        )
        return actor_id

    def submit_actor_task(
        self,
        actor_id: ActorID,
        method_name: str,
        args: Tuple,
        kwargs: dict,
        *,
        num_returns: int = 1,
        name: str = "",
        _task_id: Optional[bytes] = None,
    ) -> List[ObjectRef]:
        if num_returns == "streaming":
            raise ValueError(
                "num_returns='streaming' is not supported for actor tasks "
                "(supported for @remote functions only)"
            )
        task_id = TaskID(_task_id) if _task_id is not None else TaskID.for_actor_task(actor_id)
        return_ids = [ObjectID.for_task_return(task_id, i + 1) for i in range(num_returns)]
        deps = _collect_deps(args, kwargs)
        spec = TaskSpec(
            task_id=task_id,
            name=name or method_name,
            func=None,
            args=args,
            kwargs=kwargs,
            dependencies=[r.id() for r in deps],
            num_returns=num_returns,
            return_ids=return_ids,
            resources=ResourceSet({}),
            actor_id=actor_id,
            actor_method=method_name,
        )
        spec.trace_ctx = tracing.task_trace_context()
        metric_defs.TASKS_SUBMITTED.inc(tags=_ACTOR_TASK_TAGS)
        metric_defs.ACTOR_CALLS_SUBMITTED.inc()
        for oid in return_ids:
            self.ref_counter.add_owned_object(oid)
        self.ref_counter.add_submitted_task_references([r.id() for r in deps])
        spec.submit_time = time.time()
        self.cluster.task_manager.add_pending(spec)
        self.cluster.submit_actor_task(spec)
        return [ObjectRef(oid) for oid in return_ids]

    # ------------------------------------------------------------------ get
    def get_async(self, ref: ObjectRef) -> Future:
        fut: Future = Future()
        node = self.head_node

        def on_local():
            try:
                value = node.store.get(ref.id(), timeout=0.001)
            except Exception as exc:  # noqa: BLE001
                if not fut.done():
                    fut.set_exception(exc)
                return
            info = node.store.entry_info(ref.id())
            if info and info["is_error"] and isinstance(value, BaseException):
                if not fut.done():
                    # never raise the STORED object: the traceback it would
                    # accumulate pins this frame (and the caller's refs) for
                    # the lifetime of the store entry
                    fut.set_exception(raised_copy(value))
            else:
                if not fut.done():
                    fut.set_result(value)

        self.cluster.pull_object(ref.id(), node, on_local)
        return fut

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        if not single:
            for r in ref_list:
                if not isinstance(r, ObjectRef):
                    raise TypeError(
                        f"ray_tpu_torch.get expects ObjectRef(s), got {type(r).__name__} "
                        "(a task arg passed at top level arrives already resolved)"
                    )
        deadline = None if timeout is None else time.monotonic() + timeout
        # Sync fast path: if the (single) awaited object's producing task is
        # inflight in the local process-worker pool, take the result handoff
        # on THIS thread — unpickle + commit run here instead of on the pool
        # reader, saving a GIL handoff and ~30us of reader-held GIL per task.
        node = self.head_node
        # Work stealing: any awaited object whose inproc task is still
        # queued gets executed inline on THIS thread — no handoffs at all
        # on the sync path. Skipped when a timeout is set: inline execution
        # is not interruptible, and a stolen task could overrun the budget.
        if timeout is None:
            for r in ref_list:
                oid = r.id()
                if not node.store.contains(oid):
                    node.steal_task(oid.task_id().binary())
        if single:
            oid = ref_list[0].id()
            if not node.store.contains(oid):
                pool = node.worker_pool
                task_bin = oid.task_id().binary()
                slot = pool.register_direct_waiter(task_bin)
                if slot is not None:
                    if slot.event.wait(timeout):
                        slot.run()
                    else:
                        pool.cancel_direct_waiter(task_bin, slot)
                        slot.run()  # reader may have delivered concurrently
            if node.store.contains(oid):
                # local value (possibly just committed inline above):
                # return it without future machinery
                value = node.store.get(oid)
                info = node.store.entry_info(oid)
                if info and info["is_error"] and isinstance(value, BaseException):
                    raise raised_copy(value)
                return value
        futures = [self.get_async(r) for r in ref_list]
        values = []
        for fut in futures:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            try:
                values.append(fut.result(remaining))
            except (TimeoutError, _FutureTimeoutError):
                raise GetTimeoutError("ray_tpu_torch.get timed out")
        return values[0] if single else values

    # ----------------------------------------------------------------- wait
    def wait(
        self,
        refs: Sequence[ObjectRef],
        num_returns: int = 1,
        timeout: Optional[float] = None,
    ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        if num_returns > len(refs):
            raise ValueError("num_returns exceeds the number of refs")
        done_event = threading.Event()
        done_flags = [False] * len(refs)
        lock = threading.Lock()
        count = 0

        def make_cb(i):
            def cb(_fut):
                nonlocal count
                with lock:
                    done_flags[i] = True
                    count += 1
                    if count >= num_returns:
                        done_event.set()

            return cb

        for i, r in enumerate(refs):
            fut = self.get_async(r)
            fut.add_done_callback(make_cb(i))
        done_event.wait(timeout)
        # Contract parity: ready never exceeds num_returns even if more
        # objects completed; the surplus stays in not_ready.
        ready: List[ObjectRef] = []
        not_ready: List[ObjectRef] = []
        with lock:
            flags = list(done_flags)
        for r, f in zip(refs, flags):
            if f and len(ready) < num_returns:
                ready.append(r)
            else:
                not_ready.append(r)
        return ready, not_ready

    # ------------------------------------------------------------- internal
    def on_task_committed(self, spec: TaskSpec) -> None:
        # idempotent (keyed by task id): a hedge twin committing for its
        # primary releases the one admission slot exactly once
        self.admission_gate.release(spec.task_id.binary())
        self.ref_counter.remove_submitted_task_references(spec.dependencies)

    def _on_object_out_of_scope(self, oid: ObjectID) -> None:
        for node_id in self.cluster.directory.locations(oid):
            node = self.cluster.nodes.get(node_id)
            if node is not None:
                node.store.delete(oid)
        self.cluster.directory.forget(oid)


# prebuilt tag dicts: the submit hot path must not allocate them per call
_NORMAL_TASK_TAGS = {"type": "normal"}
_ACTOR_TASK_TAGS = {"type": "actor"}

_RESOURCE_SET_CACHE: dict = {}


def _interned_resource_set(resources: Optional[Dict[str, float]]) -> ResourceSet:
    """ResourceSets are read-only once built; intern the common shapes
    ({"CPU": 1} etc.) so the hot submit path skips dict->fixed conversion."""
    if resources is None:
        resources = {"CPU": 1.0}
    key = tuple(sorted(resources.items()))
    cached = _RESOURCE_SET_CACHE.get(key)
    if cached is None:
        if len(_RESOURCE_SET_CACHE) > 512:
            _RESOURCE_SET_CACHE.clear()
        cached = ResourceSet(resources)
        _RESOURCE_SET_CACHE[key] = cached
    return cached


def _collect_deps(args: Tuple, kwargs: dict) -> List[ObjectRef]:
    deps = [a for a in args if isinstance(a, ObjectRef)]
    deps.extend(v for v in kwargs.values() if isinstance(v, ObjectRef))
    return deps


# --------------------------------------------------------------------------
_global_worker: Optional[CoreWorker] = None


def global_worker() -> CoreWorker:
    if _global_worker is None:
        raise RuntimeError("ray_tpu has not been initialized; call ray_tpu_torch.init() first.")
    return _global_worker


def set_global_worker(worker: Optional[CoreWorker]) -> None:
    global _global_worker
    _global_worker = worker
