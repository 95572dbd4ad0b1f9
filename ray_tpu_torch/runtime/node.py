"""Per-node runtime: the raylet equivalent.

The port's copy of ``ray_tpu/runtime/node.py``.  Deltas: a task given a CUDA
tensor (directly or as a ref to a device-tier object) runs in process, as a
``jax.Array`` task does there; function blobs go through
``serialization.dumps_by_value`` (cloudpickle where installed, else by
reference).

Parity with the reference's ``src/ray/raylet/`` ``NodeManager``: owns the
node's resource pool, local scheduler, worker pool, hosted actors, and the
local object-store tier; participates in object transfer (object_manager
Push/Pull parity) through the in-process cluster fabric.

TPU-first deltas (SURVEY §3.2 hot-path note): there is no lease protocol and
no per-task RPC — dispatch puts the task straight onto an executor:

  * **device/thread tasks** run on an in-process thread pool; a task that
    launches kernels returns CUDA tensors as soon as they are queued on the
    stream, so the thread is free as soon as dispatch completes (the device
    command queue IS the queue the raylet used to be).  Device tasks share
    the default stream across threads, so a returned tensor is ordered before
    any later use of it; a task that uses a side stream must
    ``record_stream`` what it hands back,
  * **process tasks** (pure-Python CPU work) go to the process worker pool,
    Ray-style, with shm-backed zero-copy args.
"""

from __future__ import annotations

import pickle
import queue
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.ids import ActorID, NodeID, ObjectID
from ray_tpu_torch.core.object_store import ObjectStore
from ray_tpu_torch.core.sync import join_threads, when_all
from ray_tpu_torch.core.resources import ResourcePool, ResourceSet
from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    RayActorError,
    RayTaskError,
    WorkerCrashedError,
)
from ray_tpu_torch.observability import metric_defs, tracing
from ray_tpu_torch.runtime import failpoints, protocol
from ray_tpu_torch.runtime.scheduler import LocalScheduler, TaskSpec
from ray_tpu_torch.runtime.worker_pool import ProcessWorkerPool, WorkerHandle

# prebuilt tag dict for the leased-dispatch hot path
_INPROC_PUSH_TAGS = {"transport": "inproc"}


class CachedThreadPool:
    """Demand-grown thread pool with a persistent core and reaped extras.

    The in-process executor runs tasks that may block on child tasks
    (nested ``rt.get``); a fixed-size pool would deadlock once a dependency
    chain exceeds its width, so idle-or-grow semantics are load-bearing,
    not an optimization (reference analogue: the raylet spawns workers on
    demand past the prestart pool, ``worker_pool.h:169``)."""

    def __init__(self, core: int, max_threads: int = 512, name: str = "inproc"):
        self._tasks: "queue.SimpleQueue" = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._idle = 0
        self._starting = 0   # spawned but not yet in the idle count
        self._threads = 0
        self._core = core
        self._max = max_threads
        self._name = name
        self._shutdown = False
        # Growth happens on a dedicated spawner thread: Thread.start() can
        # cost tens of ms on a loaded box, and paying it inline (under the
        # pool lock, on the submitting thread) stalls async submission
        # bursts — measured ~0.65s of submitter time per 5k-task burst.
        self._spawn_requests: "queue.SimpleQueue" = queue.SimpleQueue()
        self._spawner_started = False

    def _maybe_spawn_locked(self) -> None:
        # _starting gates growth: a just-spawned thread takes a while to
        # reach its first queue.get, and every submit in that window would
        # otherwise spawn yet another thread.
        if (
            self._idle == 0
            and self._starting == 0
            and self._threads < self._max
            and not self._shutdown
        ):
            self._threads += 1
            self._starting += 1
            if not self._spawner_started:
                self._spawner_started = True
                threading.Thread(
                    target=self._spawner_loop, name=f"{self._name}-spawner", daemon=True
                ).start()
            self._spawn_requests.put(self._threads > self._core)

    def _spawner_loop(self) -> None:
        while True:
            is_extra = self._spawn_requests.get()
            if is_extra is None:
                return
            # honor real requests even if shutdown raced in: the counters
            # were already incremented under the lock, and the new thread
            # exits promptly via the shutdown sentinels
            threading.Thread(
                target=self._run, args=(is_extra,), name=f"{self._name}-exec", daemon=True
            ).start()

    def submit(self, fn: Callable, *args) -> None:
        self._tasks.put((fn, args))
        with self._lock:
            self._maybe_spawn_locked()

    def _run(self, is_extra: bool) -> None:
        first = True
        while True:
            with self._lock:
                self._idle += 1
                if first:
                    self._starting -= 1
                    first = False
            try:
                item = self._tasks.get(timeout=30.0) if is_extra else self._tasks.get()
            except queue.Empty:
                with self._lock:
                    self._idle -= 1
                    # Exit race: a submit may have queued work after the
                    # timeout fired but before this lock, seeing us idle
                    # and skipping growth — recheck before standing down.
                    if not self._tasks.empty():
                        continue  # loop top re-increments _idle
                    self._threads -= 1
                return
            with self._lock:
                self._idle -= 1
                # About to go busy (the task may block indefinitely on
                # children): if work remains queued and nobody is free to
                # take it, grow — otherwise a queued task starves behind
                # this one until it finishes.
                if not self._tasks.empty():
                    self._maybe_spawn_locked()
            if item is None or self._shutdown:
                with self._lock:
                    self._threads -= 1
                return
            fn, args = item
            try:
                fn(*args)
            except BaseException:  # noqa: BLE001 — executor threads never die
                pass
            # drop the finished task before waiting for the next: an idle
            # thread must not hold its last task's arguments (a CUDA tensor
            # would stay in device memory until the thread's next task)
            item = fn = args = None

    def shutdown(self, wait: bool = False) -> None:
        self._shutdown = True
        self._spawn_requests.put(None)
        with self._lock:
            n = self._threads
        for _ in range(n):
            self._tasks.put(None)


class ActorInstance:
    """An actor hosted on this node: either a dedicated worker process or an
    in-process thread (device actors holding jax state)."""

    def __init__(self, actor_id: ActorID, mode: str, max_concurrency: int = 1):
        self.actor_id = actor_id
        self.mode = mode                      # "process" | "inproc"
        self.max_concurrency = max_concurrency
        self.worker: Optional[WorkerHandle] = None      # process mode
        self.instance: Any = None                        # inproc mode
        self.thread: Optional[threading.Thread] = None
        self.threads: list = []               # inproc, max_concurrency > 1
        self.call_queue: "queue.Queue" = queue.Queue()
        self.created = threading.Event()      # gates methods behind __init__
        self.creation_spec = None
        self.dead = False
        # death notification: futures waiting on queued direct calls
        # (compiled DAG / plan fast path) register here so a kill surfaces
        # ActorDiedError IMMEDIATELY instead of at the next poll tick
        self._death_lock = threading.Lock()
        self._death_cbs: list = []

    def on_death(self, cb) -> None:
        with self._death_lock:
            if not self.dead:
                self._death_cbs.append(cb)
                return
        cb()  # already dead: fire inline

    def remove_death_callback(self, cb) -> None:
        with self._death_lock:
            try:
                self._death_cbs.remove(cb)
            except ValueError:
                pass

    def mark_dead(self) -> None:
        with self._death_lock:
            if self.dead:
                return
            self.dead = True
            cbs, self._death_cbs = self._death_cbs, []
        for cb in cbs:
            try:
                cb()
            except Exception:  # noqa: BLE001 — one waiter must not mask the rest
                pass


class Node:
    def __init__(
        self,
        node_id: NodeID,
        resources: Dict[str, float],
        cluster,                       # runtime/cluster.Cluster (fabric)
        shm_store=None,
        labels: Optional[dict] = None,
        num_inproc_threads: int = 8,
        data_ip: str = "",
        head_ip: str = "",
    ):
        cfg = get_config()
        self.node_id = node_id
        self.cluster = cluster
        self.labels = labels or {}
        self.pool = ResourcePool(resources)
        self.store = ObjectStore(shm_store=shm_store)
        self.store.set_metrics_tags({"node": node_id.hex()[:8]})
        self.scheduler = LocalScheduler(
            self.pool, self.store, self._dispatch,
            metrics_tags={"node": node_id.hex()[:8]},
        )
        # One pool serves both "thread" CPU-light tasks and device tasks; XLA
        # dispatch is async so device tasks occupy a thread only briefly.
        # Demand-grown (not fixed-size): nested inproc tasks blocking on
        # children must never exhaust the pool, or a dependency chain deeper
        # than the thread count would deadlock.
        self.executor = CachedThreadPool(
            core=num_inproc_threads, name=f"node-{node_id.hex()[:6]}"
        )
        self.worker_pool = ProcessWorkerPool(
            shm_name=shm_store.name if shm_store is not None else "",
            # Size by the node's declared CPU resource, not the container's
            # cpu_count — ray_tpu_torch.init(num_cpus=N) must yield N-way task
            # parallelism even on cgroup-limited hosts.
            max_workers=int(resources.get("CPU", 0)) or None,
            session_dir=cluster.session_dir,
        )
        # before prestart: spawned workers read these from env at spawn time
        self.worker_pool.data_ip = data_ip
        self.worker_pool.head_ip = head_ip
        self.worker_pool.node_hex = node_id.hex()
        self.worker_pool.set_on_worker_death(self._on_worker_death)
        self.worker_pool.api_handler = self._handle_worker_api
        self.worker_pool.serve_inline_sync = hasattr(self.cluster, "core_worker")
        # Prestart a warm worker off-thread (reference: WorkerPool prestart,
        # worker_pool.h:169-193) so the first task doesn't pay the ~200ms
        # child-interpreter startup; further growth is demand-driven and
        # also off the submitting thread (_maybe_grow_async).
        self._prestart_thread: Optional[threading.Thread] = None
        if cfg.num_prestart_workers > 0:
            self._prestart_thread = threading.Thread(
                target=self.worker_pool.prestart,
                args=(cfg.num_prestart_workers,),
                name="worker-prestart",
                daemon=True,
            )
            self._prestart_thread.start()
        self.actors: Dict[ActorID, ActorInstance] = {}
        self._actor_worker_index: Dict[int, ActorID] = {}  # pid -> actor
        self._proc_specs: Dict[bytes, TaskSpec] = {}  # running in process workers
        # Adaptive tiering state: per-function (count, total_wall_s). Keyed
        # by id(func) — stable for the life of the decorated function object.
        self._fn_profile: Dict[int, list] = {}
        # Queued-but-not-started inproc tasks, stealable by waiters
        # (work stealing: a blocked rt.get executes the task it waits on
        # inline — zero thread/process switches on the sync path).
        self._inproc_pending: Dict[bytes, TaskSpec] = {}
        self._inproc_lock = threading.Lock()
        # chaos straggler injection (`slow_node` schedule kind / the hedging
        # bench): every dispatch on this node sleeps this long ON AN
        # EXECUTOR THREAD first.  A fixed deterministic delay — no failpoint
        # decisions consumed, so seeded fault logs are unaffected.
        self._chaos_delay_s = 0.0
        self.dead = False

    # ------------------------------------------------------------------
    # submission entry (from cluster fabric after node selection)
    # ------------------------------------------------------------------
    def submit(self, spec: TaskSpec) -> None:
        spec.owner_node = self.node_id
        # Dependencies may live on other nodes: route waits through the
        # fabric's pull path instead of the raw local store.
        deps = [d for d in spec.dependencies if not self.store.contains(d)]
        if deps:
            spec._stage = "pulling"  # deadline attribution while deps move
        when_all(
            deps,
            lambda dep, done: self.cluster.pull_object(dep, self, done),
            lambda: self.scheduler.submit_ready(spec),
        )

    def submit_leased(self, spec: TaskSpec) -> None:
        """Lease fast path: a repeat-shape, dependency-free task dispatched
        straight into this node's local scheduler — the cached lease IS the
        placement decision, so there is no cluster-level hop and no
        dependency stage.  Raises ConnectionError on a dead node so the
        caller revokes the lease and falls back to the scheduled path."""
        if self.dead:
            raise ConnectionError("leased node is dead")
        spec.owner_node = self.node_id
        spec._leased = True
        metric_defs.DIRECT_PUSHES.inc(tags=_INPROC_PUSH_TAGS)
        self.scheduler.submit_ready(spec)

    # ------------------------------------------------------------------
    # dispatch (deps local, resources held)
    # ------------------------------------------------------------------
    def _dispatch(self, spec: TaskSpec) -> None:
        spec.start_time = time.time()
        spec._stage = "executing"
        if failpoints.ARMED:
            # chaos: a dispatch fault surfaces as a system error so the
            # normal retry machinery (should_retry, is_system_error=True)
            # owns recovery — exactly what a raylet crash mid-dispatch does
            try:
                action = failpoints.fp("scheduler.dispatch")
            except failpoints.FailpointInjected as exc:
                action = str(exc)
            if action is not None:
                self._commit(
                    spec, None,
                    WorkerCrashedError(f"failpoint scheduler.dispatch: {action}"),
                )
                return
        if spec._cancelled:
            from ray_tpu_torch.exceptions import TaskCancelledError

            self._commit(spec, None, TaskCancelledError(spec.task_id))
            return
        if self._chaos_delay_s > 0.0:
            # slow-node chaos: park on an executor thread (the submitting
            # thread must never sleep), then resume the normal dispatch
            self.executor.submit(self._delayed_dispatch, spec, self._chaos_delay_s)
            return
        self._dispatch_modes(spec)

    def _delayed_dispatch(self, spec: TaskSpec, delay: float) -> None:
        time.sleep(delay)
        if spec._cancelled:
            from ray_tpu_torch.exceptions import TaskCancelledError

            self._commit(spec, None, TaskCancelledError(spec.task_id))
            return
        self._dispatch_modes(spec)

    def _dispatch_modes(self, spec: TaskSpec) -> None:
        if spec.num_returns == "streaming":
            # streaming generators run on the in-process executor: items
            # commit through direct calls into the owner's stream, which a
            # worker process can't make (the reference streams item reports
            # over its RPC channel; our process protocol is one-shot)
            self.executor.submit(self._run_streaming, spec)
            return
        mode = self._execution_mode(spec)
        if mode == "process":
            self._dispatch_process(spec)
        else:
            with self._inproc_lock:
                self._inproc_pending[spec.task_id.binary()] = spec
            self.executor.submit(self._run_inproc_claimed, spec)

    def _claim_inproc(self, task_bin: bytes) -> Optional[TaskSpec]:
        with self._inproc_lock:
            return self._inproc_pending.pop(task_bin, None)

    def _run_inproc_claimed(self, spec: TaskSpec) -> None:
        # Brief defer before claiming: a sync waiter's inline steal is far
        # cheaper than running here (no thread handoff back to the waiter),
        # so give it a head start. sleep() parks this thread without
        # holding the GIL; an async-only caller pays at most the delay.
        delay = get_config().inproc_claim_delay_s
        if delay > 0:
            time.sleep(delay)
        if self._claim_inproc(spec.task_id.binary()) is None:
            return  # stolen by a waiter
        self._run_inproc(spec)

    def cancel_task(self, spec: TaskSpec, force: bool = False) -> None:
        """Running-task cancellation.  A queued inproc task is claimed and
        committed cancelled immediately; a resource-queued task is pulled
        straight out of the local scheduler (its resources were never
        acquired, so no release); with ``force`` a task running in a
        process worker has its worker killed (the commit path maps the
        death to TaskCancelledError / DeadlineExceededError via the spec
        flags)."""
        task_bin = spec.task_id.binary()
        claimed = self._claim_inproc(task_bin)
        if claimed is not None:
            from ray_tpu_torch.exceptions import TaskCancelledError

            self._commit(claimed, None, TaskCancelledError(claimed.task_id))
            return
        if self.scheduler.cancel_queued(spec):
            from ray_tpu_torch.exceptions import TaskCancelledError

            # never dispatched: no resources to release — commit directly
            self.cluster.on_task_finished(
                self, spec, None, TaskCancelledError(spec.task_id)
            )
            return
        if force and task_bin in self._proc_specs:
            self.worker_pool.kill_task_worker(task_bin)

    def steal_task(self, task_bin: bytes) -> bool:
        """A waiter executes the queued inproc task inline on its own
        thread. Returns True if the task was run here."""
        spec = self._claim_inproc(task_bin)
        if spec is None:
            return False
        self._run_inproc(spec)
        return True

    def _execution_mode(self, spec: TaskSpec) -> str:
        if spec.execution != "auto":
            return spec.execution
        if spec.runtime_env:
            # body-scoped runtime_env (env_vars/profiling) is applied by
            # PROCESS workers; auto-tier migration in-process would
            # silently drop it mid-stream
            return "process"
        func = spec.func
        if getattr(func, "_rt_device", False):
            return "thread"
        # CUDA-tensor args, given directly or as refs to device-tier
        # objects, execute in-process next to the device (the JAX package
        # does the same for jax.Array args, and for jitted functions: the
        # port has no compiled-function type to recognize)
        torch = sys.modules.get("torch")
        if torch is not None:
            for a in (*spec.args, *spec.kwargs.values()):
                if isinstance(a, torch.Tensor) and a.is_cuda:
                    return "thread"
                if isinstance(a, ObjectRef):
                    info = self.store.entry_info(a.id())
                    if info is not None and info["tier"] == "device":
                        return "thread"
        # Adaptive tiering (TPU-first delta; no reference equivalent — Ray
        # MUST isolate Python workers per-process, our single-process
        # runtime need not): unknown functions run isolated in process
        # workers, which report the function body's wall time; once two
        # samples show the function is fast, it migrates to the zero-IPC
        # in-process executor (~4x lower latency). Heavy functions stay in
        # process workers, where the GIL stops mattering. Trial-in-worker
        # ordering means a function is only ever colocated with the driver
        # AFTER it has run to completion elsewhere — an os._exit or a
        # segfault in unknown user code kills a worker, not the driver.
        # execution="process"/"thread" overrides the policy per task.
        threshold = get_config().inproc_task_threshold_s
        if threshold <= 0:
            return "process"
        prof = self._fn_profile.get(id(func))
        if prof is None or prof[2] is not func or prof[0] < 2:
            return "process"
        return "process" if prof[1] / prof[0] > threshold else "thread"

    def _profile_task(self, func, dt: float) -> None:
        # The entry pins func so its id() cannot be recycled by a different
        # function object inheriting a stale "fast" verdict (which would
        # colocate untrialed code with the driver).
        prof = self._fn_profile.get(id(func))
        if prof is None or prof[2] is not func:
            if len(self._fn_profile) >= 4096:
                self._fn_profile.clear()
            prof = self._fn_profile[id(func)] = [0, 0.0, func]
        prof[0] += 1
        prof[1] += dt
        if prof[0] >= 4096:     # keep the window fresh for drifting tasks
            prof[0] //= 2
            prof[1] /= 2.0

    def _resolve_args(self, spec: TaskSpec):
        def resolve(v):
            if not isinstance(v, ObjectRef):
                return v
            value = self.store.get(v.id())
            info = self.store.entry_info(v.id())
            if info is not None and info["is_error"] and isinstance(value, BaseException):
                # Upstream failure propagates to this task's returns
                # (reference: dependent tasks inherit RayTaskError).  A
                # COPY is raised — raising the stored object would graft
                # this frame onto it, pinning the frame for the entry's
                # lifetime (see exceptions.raised_copy).
                from ray_tpu_torch.exceptions import raised_copy

                raise raised_copy(value)
            return value

        args = tuple(resolve(a) for a in spec.args)
        kwargs = {k: resolve(v) for k, v in spec.kwargs.items()}
        return args, kwargs

    def _run_inproc(self, spec: TaskSpec) -> None:
        from ray_tpu_torch.runtime.context import pop_deadline, push_deadline, task_context

        try:
            args, kwargs = self._resolve_args(spec)
            # propagate the executing task id for nested submissions/puts,
            # and the deadline so nested calls inherit the remaining budget
            token = task_context.push(spec.task_id, self.node_id)
            dtoken = push_deadline(spec.deadline_ts)
            t0 = time.perf_counter()
            try:
                with tracing.task_span(f"execute::{spec.name}", spec.trace_ctx):
                    result = spec.func(*args, **kwargs)
            finally:
                pop_deadline(dtoken)
                task_context.pop(token)
                if spec.execution == "auto":
                    self._profile_task(spec.func, time.perf_counter() - t0)
            self._commit(spec, result, None)
        except BaseException as exc:  # noqa: BLE001
            error = exc if isinstance(exc, RayTaskError) else RayTaskError.from_exception(spec.name, exc)
            self._commit(spec, None, error)

    def _run_streaming(self, spec: TaskSpec) -> None:
        """Execute a streaming-generator task: each yielded item commits as
        its own return object immediately; an exception commits as the next
        (errored) item and ends the stream (reference semantics)."""
        from ray_tpu_torch.runtime.context import task_context

        error: Optional[BaseException] = None
        index = 0
        try:
            args, kwargs = self._resolve_args(spec)
            token = task_context.push(spec.task_id, self.node_id)
            try:
                for item in spec.func(*args, **kwargs):
                    self.cluster.on_stream_item(self, spec, index, item)
                    index += 1
            finally:
                task_context.pop(token)
        except BaseException as exc:  # noqa: BLE001
            error = exc if isinstance(exc, RayTaskError) else RayTaskError.from_exception(spec.name, exc)
        self.scheduler.on_task_done(spec)
        self.cluster.on_stream_done(self, spec, index, error)

    _EMPTY_ARGS_BLOB = pickle.dumps(((), {}), protocol=5)

    def _dispatch_process(self, spec: TaskSpec) -> None:
        try:
            args, kwargs = self._resolve_args(spec)
        except BaseException as exc:  # noqa: BLE001
            self._commit(spec, None, RayTaskError.from_exception(spec.name, exc))
            return
        shm = self.store._shm
        try:
            fn_id, fn_blob = self._function_blob(spec.func)
            if not args and not kwargs:
                args_blob = self._EMPTY_ARGS_BLOB
            else:
                args_blob = self._encode_args(args, kwargs, shm)
        except BaseException as exc:  # noqa: BLE001
            self._commit(spec, None, RayTaskError.from_exception(spec.name, exc))
            return

        def on_result(value, error, exec_s=None):
            self._proc_specs.pop(spec.task_id.binary(), None)
            if spec.execution == "auto" and exec_s is not None:
                # worker-reported wall time of the function body alone —
                # the clean signal for the tiering decision
                self._profile_task(spec.func, exec_s)
            if error is not None:
                if spec._oom_killed:
                    # consume the flag: a later retry of this same spec that
                    # fails for its own reasons must NOT be relabeled OOM
                    spec._oom_killed = False
                    from ray_tpu_torch.exceptions import OutOfMemoryError

                    error = OutOfMemoryError(
                        f"Task {spec.name} was killed by the memory monitor "
                        f"under host memory pressure ({error})"
                    )
                self._commit(spec, None, error)
            else:
                value = protocol.decode_value(value, shm)
                self._commit(spec, value, None)

        self._proc_specs[spec.task_id.binary()] = spec
        self.worker_pool.submit(
            spec.task_id.binary(), spec.name, fn_id, fn_blob, args_blob, on_result,
            runtime_env=spec.runtime_env,
            trace=spec.trace_ctx[:2] if spec.trace_ctx is not None else None,
            # leased shapes pin a warm worker (keyed by function identity)
            # so repeat dispatches hit a hot process without pool churn
            lease_key=fn_id if spec._leased else None,
            # the worker installs the deadline around execution so nested
            # submissions from inside the task inherit the remaining budget
            deadline_ts=spec.deadline_ts,
            # a GPU share with a runtime_env: a worker that sees the card
            sees_card=bool(spec.runtime_env) and spec.resources.get("GPU") > 0,
        )

    def _handle_worker_api(self, task_bin, blob: bytes, op: str = "", worker_key=None) -> bytes:
        """A worker process made a nested runtime API call (worker_api.py).

        Blocking ops release the calling task's resources for the duration
        (reference: a worker blocked in ray.get releases its CPU via the
        raylet, NotifyUnblocked) so nested children can schedule; the
        resources are force-reacquired on wake (transient oversubscription
        instead of a deadlock)."""
        from ray_tpu_torch.runtime import worker_api

        spec = self._proc_specs.get(task_bin) if task_bin else None
        op = op or worker_api.peek_op(blob)
        blocking = spec is not None and op in worker_api.BLOCKING_OPS
        if blocking:
            self.scheduler.release_blocked(spec)
        # a put inside a PUSHED task mints a ref that travels back on the
        # owner-routed DATA-plane reply — nothing orders that against this
        # node's control frames, so its registration must be synchronous.
        # In-proc specs aren't in _proc_specs; the agent fabric remembers
        # them (head-side cluster has no lookup_spec — pushed stays False
        # there, correctly: head-local results never leave the process).
        if spec is None and task_bin:
            lookup = getattr(self.cluster, "lookup_spec", None)
            spec = lookup(task_bin) if lookup is not None else None
        pushed = spec is not None and getattr(spec, "_push_reply", None) is not None
        try:
            return self.cluster.handle_worker_api(
                blob, op=op, worker_key=worker_key, pushed=pushed
            )
        finally:
            if blocking and task_bin in self._proc_specs:
                # reacquire ONLY if the task is still in flight: its worker
                # may have died/been cancelled while we waited, in which
                # case the death path already settled the accounting and a
                # forced reacquire would leak capacity forever
                self.scheduler.reacquire_blocked(spec)

    def kill_candidates(self):
        """Killable process tasks for the memory monitor (OOM policies)."""
        from ray_tpu_torch.runtime.memory_monitor import KillCandidate

        out = []
        for task_id, _pid, start in self.worker_pool.inflight_tasks():
            spec = self._proc_specs.get(task_id)
            if spec is None:
                continue

            def make_kill(s=spec, tid=task_id):
                def kill():
                    s._oom_killed = True
                    if not self.worker_pool.kill_task_worker(tid):
                        s._oom_killed = False  # task already finished/moved

                return kill

            out.append(
                KillCandidate(
                    task_id=spec.task_id,
                    owner_id=spec.owner_node,
                    start_time=start,
                    retriable=spec.retries_left > 0,
                    kill_fn=make_kill(),
                )
            )
        return out

    @staticmethod
    def _encode_args(args, kwargs, shm) -> bytes:
        """Frame task args for a worker process.  Plain pickle first (fast
        path); cloudpickle for closures/local classes — its stream is still
        plain-``pickle.loads``-loadable on the worker side (without
        cloudpickle, ``serialization.dumps_by_value`` pickles by reference)."""
        enc_args = tuple(protocol.encode_value(a, shm, _shm_id) for a in args)
        enc_kwargs = {k: protocol.encode_value(v, shm, _shm_id) for k, v in kwargs.items()}
        try:
            return serialization.dumps((enc_args, enc_kwargs))
        except (AttributeError, TypeError, pickle.PicklingError):
            return serialization.dumps_by_value((enc_args, enc_kwargs))

    def _function_blob(self, func) -> tuple:
        cached = getattr(func, "_rt_fn_blob", None)
        if cached is not None:
            return cached
        blob = serialization.dumps_by_value(func)
        fn_id = _hash_blob(blob)
        try:
            func._rt_fn_blob = (fn_id, blob)
        except AttributeError:
            pass
        return fn_id, blob

    # ------------------------------------------------------------------
    def _commit(self, spec: TaskSpec, result: Any, error: Optional[BaseException]) -> None:
        self.scheduler.on_task_done(spec)
        self.cluster.on_task_finished(self, spec, result, error)

    # ------------------------------------------------------------------
    # actors
    # ------------------------------------------------------------------
    def create_actor(self, spec: TaskSpec, mode: str, max_concurrency: int = 1) -> None:
        inst = ActorInstance(spec.actor_id, mode, max_concurrency)
        inst.creation_spec = spec
        self.actors[spec.actor_id] = inst
        if mode == "inproc":
            # max_concurrency > 1: a pool of method threads shares the call
            # queue (reference: threaded actors / concurrency groups,
            # transport/concurrency_group_manager).  Ordering is guaranteed
            # only for max_concurrency == 1, matching the reference.
            n_threads = max(1, max_concurrency)
            for i in range(n_threads):
                t = threading.Thread(
                    target=self._actor_thread_loop,
                    args=(inst,),
                    name=f"actor-{spec.actor_id.hex()[:8]}-{i}",
                    daemon=True,
                )
                inst.threads.append(t)
                t.start()
            inst.thread = inst.threads[0]
            inst.call_queue.put(("__create__", spec))
        else:
            try:
                # a process actor holding a GPU share sees the card
                worker = self.worker_pool.allocate_actor_worker(
                    sees_card=spec.resources.get("GPU") > 0)
            except RuntimeError as exc:
                self.cluster.on_actor_creation_failed(spec, RayActorError(spec.actor_id, f"worker spawn failed: {exc}"))
                return
            inst.worker = worker
            self._actor_worker_index[worker.pid] = spec.actor_id
            try:
                args, kwargs = self._resolve_args(spec)
                enc = self._encode_args(args, kwargs, self.store._shm)
                fn_id, fn_blob = self._function_blob(spec.func)
            except BaseException as exc:  # noqa: BLE001
                self.cluster.on_actor_creation_failed(spec, RayTaskError.from_exception(spec.name, exc))
                return

            def on_result(value, err, exec_s=None):
                if err is not None:
                    self.cluster.on_actor_creation_failed(spec, err)
                else:
                    self.cluster.on_actor_created(self, spec)

            self.worker_pool.submit_to_worker(
                worker,
                "actor_create",
                spec.task_id.binary(),
                {"args_blob": enc, "name": spec.name, "max_concurrency": max_concurrency},
                on_result,
                fn_blob=fn_blob,
                fn_id=fn_id,
            )

    def submit_actor_task(self, spec: TaskSpec) -> None:
        inst = self.actors.get(spec.actor_id)
        if inst is None or inst.dead:
            self._commit_actor_error(spec, ActorDiedError(spec.actor_id))
            return
        if inst.mode == "inproc":
            inst.call_queue.put(("__call__", spec))
        else:
            shm = self.store._shm
            try:
                args, kwargs = self._resolve_args(spec)
                enc = self._encode_args(args, kwargs, shm)
            except BaseException as exc:  # noqa: BLE001
                self._commit_actor_error(spec, RayTaskError.from_exception(spec.name, exc))
                return

            def on_result(value, err, exec_s=None):
                if err is not None:
                    self.cluster.on_task_finished(self, spec, None, err if isinstance(err, (RayTaskError, RayActorError, WorkerCrashedError)) else RayTaskError.from_exception(spec.name, err))
                else:
                    value = protocol.decode_value(value, shm)
                    self.cluster.on_task_finished(self, spec, value, None)

            payload = {"method": spec.actor_method, "args_blob": enc, "name": spec.name}
            if spec.trace_ctx is not None:
                payload["trace"] = spec.trace_ctx[:2]
            self.worker_pool.submit_to_worker(
                inst.worker,
                "actor_call",
                spec.task_id.binary(),
                payload,
                on_result,
            )

    def submit_actor_task_batch(self, specs) -> None:
        """Contiguous ready calls for ONE actor, submitted as a single IPC
        frame when the actor lives in a process worker (order preserved —
        one frame, executed in sequence by the worker's exec loop)."""
        if len(specs) == 1:
            self.submit_actor_task(specs[0])
            return
        inst = self.actors.get(specs[0].actor_id)
        if inst is None or inst.dead or inst.mode == "inproc" or inst.worker is None:
            for spec in specs:
                self.submit_actor_task(spec)
            return
        shm = self.store._shm
        calls, cbs = [], []
        for spec in specs:
            try:
                args, kwargs = self._resolve_args(spec)
                enc = self._encode_args(args, kwargs, shm)
            except BaseException as exc:  # noqa: BLE001
                self._commit_actor_error(spec, RayTaskError.from_exception(spec.name, exc))
                continue

            def make_on_result(spec=spec):
                def on_result(value, err, exec_s=None):
                    if err is not None:
                        self.cluster.on_task_finished(
                            self, spec, None,
                            err if isinstance(err, (RayTaskError, RayActorError, WorkerCrashedError))
                            else RayTaskError.from_exception(spec.name, err),
                        )
                    else:
                        self.cluster.on_task_finished(
                            self, spec, protocol.decode_value(value, shm), None
                        )

                return on_result

            call = {
                "task_id": spec.task_id.binary(),
                "method": spec.actor_method,
                "args_blob": enc,
                "name": spec.name,
            }
            if spec.trace_ctx is not None:
                call["trace"] = spec.trace_ctx[:2]
            calls.append(call)
            cbs.append((spec.task_id.binary(), make_on_result()))
        if calls:
            self.worker_pool.submit_batch_to_worker(inst.worker, calls, cbs)

    def _actor_thread_loop(self, inst: ActorInstance) -> None:
        from ray_tpu_torch.runtime.context import task_context

        while True:
            kind, spec = inst.call_queue.get()
            if kind == "__stop__":
                # propagate the sentinel so every pool thread exits
                inst.call_queue.put(("__stop__", None))
                return
            if kind != "__create__" and not inst.created.is_set():
                # methods must not outrun __init__ on a sibling thread
                inst.created.wait()
            if kind == "__direct__":
                # compiled-DAG/plan fast path: (method, args, kwargs, future)
                # with no TaskSpec — still serialized through this thread so
                # the single-threaded actor guarantee holds (dag/compiled.py).
                # set_* guarded: a death notification may have resolved the
                # future already (kill raced a queued call).
                method, args, kwargs, fut = spec
                try:
                    result = getattr(inst.instance, method)(*args, **kwargs)
                except BaseException as exc:  # noqa: BLE001
                    try:
                        fut.set_exception(exc)
                    except BaseException:  # noqa: BLE001 — already resolved
                        pass
                    continue
                try:
                    fut.set_result(result)
                except BaseException:  # noqa: BLE001 — already resolved
                    pass
                continue
            try:
                args, kwargs = self._resolve_args(spec)
                token = task_context.push(spec.task_id, self.node_id)
                try:
                    if kind == "__create__":
                        inst.instance = spec.func(*args, **kwargs)
                        inst.created.set()
                        self.cluster.on_actor_created(self, spec)
                        continue
                    with tracing.task_span(f"execute::{spec.name}", spec.trace_ctx):
                        result = getattr(inst.instance, spec.actor_method)(*args, **kwargs)
                finally:
                    task_context.pop(token)
                self.cluster.on_task_finished(self, spec, result, None)
            except BaseException as exc:  # noqa: BLE001
                if kind == "__create__":
                    inst.created.set()  # unblock method threads; calls will fail fast
                    self.cluster.on_actor_creation_failed(spec, RayTaskError.from_exception(spec.name, exc))
                else:
                    self.cluster.on_task_finished(self, spec, None, RayTaskError.from_exception(spec.name, exc))

    def kill_actor(self, actor_id: ActorID, restart: bool = False) -> None:
        inst = self.actors.pop(actor_id, None)
        if inst is None:
            return
        inst.mark_dead()  # fires death-notified direct-call futures NOW
        if inst.mode == "inproc":
            inst.call_queue.put(("__stop__", None))
        elif inst.worker is not None:
            self._actor_worker_index.pop(inst.worker.pid, None)
            self.worker_pool.release_actor_worker(inst.worker)

    def _commit_actor_error(self, spec: TaskSpec, error: BaseException) -> None:
        self.cluster.on_task_finished(self, spec, None, error)

    def _on_worker_death(self, worker: WorkerHandle) -> None:
        actor_id = self._actor_worker_index.pop(worker.pid, None)
        if actor_id is not None:
            inst = self.actors.pop(actor_id, None)
            if inst is not None:
                inst.mark_dead()
            self.cluster.on_actor_process_died(self, actor_id)
        # a dead worker's borrower ledger can never report again — drop its
        # per-worker ref pins (head pools release directly; agent fabrics
        # relay a worker_died notice to the head, which owns the ledger)
        on_died = getattr(self.cluster, "on_worker_process_died", None)
        if on_died is not None:
            on_died(worker.pid)

    # ------------------------------------------------------------------
    def shutdown(self) -> None:
        self.dead = True
        actor_threads = [t for inst in self.actors.values() for t in inst.threads]
        for actor_id in list(self.actors):
            self.kill_actor(actor_id)
        self.executor.shutdown(wait=False)
        self.worker_pool.shutdown()
        # in-process actor threads and the prestarter are bound to this node
        # (and so to the cluster): bounded wait for them to unwind
        if self._prestart_thread is not None:
            actor_threads.append(self._prestart_thread)
        join_threads(actor_threads)


def _hash_blob(blob: bytes) -> bytes:
    import hashlib

    return hashlib.blake2b(blob, digest_size=16).digest()


_shm_counter = threading.local()


def _shm_id() -> bytes:
    import os

    return os.urandom(20)
