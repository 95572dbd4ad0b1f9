"""Public API: init/shutdown, @remote, get/put/wait, actors.

The port's copy of ``ray_tpu/api.py``: the same signatures (``init`` also
names ``num_gpus``, which the JAX package takes and ignores), the same
results and errors.  ``init`` detects the node's CUDA devices
(``accelerators/gpu.py``) as its ``"GPU"`` resource; an actor that asks for
a GPU (``num_gpus`` or ``resources={"GPU": ...}``) lives in process next to
the card, as a TPU actor does in the JAX package.  ``include_dashboard``
starts the dashboard head (``dashboard/head.py``: REST, jobs, workflow
events); a task's ``runtime_env`` is validated at submit; ``head_port=``
opens the multi-host head service for node agents
(``runtime/remote_node.py``).  A thin client drives this API from another
process through ``util.connect`` (``util/client/``).

Parity with the reference's Python frontend
(``python/ray/_private/worker.py:1214,2509,2641,2706``,
``python/ray/remote_function.py:40``, ``python/ray/actor.py:566``): the same
surface — ``init``, ``@remote`` on functions and classes, ``.remote()`` /
``.options()`` call styles, ``get``/``put``/``wait``/``kill``/``get_actor`` —
re-implemented over the in-process TPU-native fabric.
"""

from __future__ import annotations

import functools
import os
import sys
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch.core.config import Config, get_config, reset_config, set_config
from ray_tpu_torch.core.ids import ActorID, JobID
from ray_tpu_torch.core.object_ref import ObjectRef, hooks
from ray_tpu_torch.core import serialization
from ray_tpu_torch.exceptions import RayTpuError
from ray_tpu_torch.runtime.cluster import Cluster
from ray_tpu_torch.runtime.context import RuntimeContext
from ray_tpu_torch.runtime.worker import CoreWorker, global_worker, set_global_worker

_init_lock = threading.RLock()
_cluster: Optional[Cluster] = None
_prev_switch_interval: Optional[float] = None
_prev_gc_threshold: Optional[tuple] = None


def is_initialized() -> bool:
    return _cluster is not None


def init(
    *,
    num_cpus: Optional[int] = None,
    num_tpus: Optional[int] = None,
    num_gpus: Optional[int] = None,
    resources: Optional[Dict[str, float]] = None,
    labels: Optional[dict] = None,
    _system_config: Optional[dict] = None,
    ignore_reinit_error: bool = False,
    include_dashboard: bool = False,
    dashboard_port: int = 0,
    head_port: Optional[int] = None,
    **_compat,
):
    """Start the single-host runtime (head node + driver).

    Reference parity: ``ray.init`` (``python/ray/_private/worker.py:1214``) —
    but instead of exec'ing gcs_server/raylet binaries (``node.py:1371``),
    the control service, scheduler and object store come up in-process;
    worker processes spawn lazily.
    """
    global _cluster, _prev_switch_interval
    with _init_lock:
        if _cluster is not None:
            if ignore_reinit_error:
                return _cluster
            raise RuntimeError("ray_tpu_torch.init() called twice; use shutdown() first.")
        if _system_config:
            cfg = Config().apply_env_overrides()
            cfg.apply_dict(_system_config)
            set_config(cfg)
        if get_config().failpoints:
            # deterministic chaos: arm the configured failpoints for this
            # session (disarmed again at shutdown); agents adopt the same
            # spec+seed at registration, workers via the inherited env var
            from ray_tpu_torch.runtime import failpoints

            failpoints.arm(
                get_config().failpoints, seed=get_config().failpoint_seed
            )
        node_resources = dict(resources or {})
        node_resources["CPU"] = num_cpus if num_cpus is not None else (os.cpu_count() or 4)
        if "TPU" not in node_resources:
            # no TPU is visible to torch: TPU work is infeasible here
            node_resources["TPU"] = num_tpus if num_tpus is not None else 0
        if "GPU" not in node_resources:
            if num_gpus is not None:
                node_resources["GPU"] = num_gpus
            else:
                # auto-detect the visible CUDA devices (accelerators/gpu.py)
                from ray_tpu_torch.accelerators import gpu_resources

                node_resources["GPU"] = gpu_resources().get("GPU", 0)
        cluster = Cluster()
        cluster.add_node(node_resources, labels=labels)
        job_id = JobID.next()
        worker = CoreWorker(cluster, job_id)
        set_global_worker(worker)
        from ray_tpu_torch.runtime.control import JobInfo

        cluster.control.jobs.add(JobInfo(job_id, entrypoint="driver"))
        if head_port is not None:
            # open the multi-host control plane; agents join with
            # ``rt start --address=<this address>``
            cluster.start_head_service(host="0.0.0.0", port=head_port)
        # finished tracing spans (driver-side and those harvested from
        # worker result payloads) land in the control service's span store,
        # where timeline() merges them with task events
        from ray_tpu_torch.observability import tracing

        tracing.set_span_sink(cluster.control.spans.add)
        if include_dashboard:
            from ray_tpu_torch.dashboard import DashboardHead

            cluster.dashboard = DashboardHead(cluster, port=dashboard_port)
        _cluster = cluster
        # The default 5ms GIL switch interval lets a busy driver thread
        # starve the pool reader threads for whole scheduling quanta,
        # collapsing async submission throughput ~20x. 2ms measured best
        # for both sync RTT and async burst submit on this runtime. Set
        # only after a successful bring-up; save the original once so a
        # re-init can't clobber it with our own value.
        if _prev_switch_interval is None:
            _prev_switch_interval = sys.getswitchinterval()
        sys.setswitchinterval(0.002)
        # GC collections triggered every 700 allocations stall the submit
        # path for whole batches (measured: periodic 3x throughput
        # collapses on the async rows).  Raising the thresholds amortizes
        # collections over bursts — cycles are still collected, just less
        # often.  Measured equal to gc.freeze()-based tuning WITHOUT
        # freeze's side effect of permanently exempting the embedding
        # application's pre-init objects from cycle collection.  Restored
        # at shutdown; opt out with gc_tune_on_init=False.  (The
        # reference's drivers avoid this by keeping the hot path in C++,
        # outside the Python GC entirely.)
        if get_config().gc_tune_on_init:
            import gc

            global _prev_gc_threshold
            if _prev_gc_threshold is None:
                _prev_gc_threshold = gc.get_threshold()
            gc.set_threshold(10_000, 20, 20)
        return cluster


def shutdown() -> None:
    global _cluster, _prev_switch_interval, _prev_gc_threshold
    with _init_lock:
        if _cluster is None:
            return
        data_iterator = sys.modules.get("ray_tpu_torch.data.iterator")
        if data_iterator is not None:
            # the data library's pumps call get(): stop them while the
            # runtime is up, or a late get() would start a new one
            data_iterator.stop_pumps()
        try:
            _cluster.shutdown()
        finally:
            from ray_tpu_torch.observability import tracing
            from ray_tpu_torch.runtime import failpoints

            # chaos is per-session: a spec armed for this runtime must not
            # leak faults into the next init in this process
            failpoints.disarm()
            tracing.set_span_sink(None)
            if _cluster.core_worker is not None:
                _cluster.core_worker.ref_counter.stop()
            _cluster = None
            set_global_worker(None)
            hooks.ref_counter = None
            reset_config()
            if _prev_switch_interval is not None:
                sys.setswitchinterval(_prev_switch_interval)
                _prev_switch_interval = None
            if _prev_gc_threshold is not None:
                import gc

                gc.set_threshold(*_prev_gc_threshold)
                _prev_gc_threshold = None


def get_cluster() -> Cluster:
    if _cluster is None:
        from ray_tpu_torch.runtime.worker import _global_worker

        if _global_worker is not None:
            # inside a worker process: the cluster object lives in the
            # driver — this operation has no worker-side routing (yet)
            raise RuntimeError(
                "this operation is not supported from inside worker "
                "processes (get/put/wait/@remote tasks and actors are; "
                "run cluster-introspection calls on the driver)"
            )
        raise RuntimeError("ray_tpu is not initialized")
    return _cluster


def _auto_init() -> None:
    if _cluster is None:
        # inside a worker process a WorkerApiClient is installed as the
        # global worker: API calls route to the owning driver — starting a
        # second runtime here would be wrong, not just wasteful
        from ray_tpu_torch.runtime.worker import _global_worker

        if _global_worker is None:
            init()


# --------------------------------------------------------------------------
# core calls
# --------------------------------------------------------------------------
def put(value: Any) -> ObjectRef:
    _auto_init()
    return global_worker().put(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]], *, timeout: Optional[float] = None):
    _auto_init()
    return global_worker().get(refs, timeout=timeout)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
):
    _auto_init()
    return global_worker().wait(refs, num_returns=num_returns, timeout=timeout)


def kill(actor: "ActorHandle", *, no_restart: bool = True) -> None:
    get_cluster().kill_actor(actor._actor_id, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False) -> None:
    """Cancel the task that produces ``ref``.

    Non-force: queued tasks are dropped at dispatch time (the dispatch path
    checks the flag and commits TaskCancelledError); running tasks finish.
    ``force=True`` additionally kills the worker process hosting an
    already-running task (reference ``CancelTask`` force_kill,
    src/ray/protobuf/core_worker.proto:441-502). O(1): the spec is found via
    the TaskID embedded in the ObjectID, not a pending scan."""
    cluster = get_cluster()
    spec = cluster.task_manager.get_pending(ref.id().task_id())
    if spec is None:
        return
    spec._cancelled = True
    cluster.cancel_task(spec, force=force)


def get_actor(name: str, namespace: str = "default") -> "ActorHandle":
    info = get_cluster().control.actors.get_by_name(name, namespace)
    if info is None:
        raise ValueError(f"Failed to look up actor with name '{name}'")
    return ActorHandle(info.actor_id, info.class_name, _methods=None)


def get_runtime_context() -> RuntimeContext:
    _auto_init()
    return RuntimeContext(global_worker())


def cluster_resources() -> Dict[str, float]:
    total: Dict[str, float] = {}
    for node in get_cluster().nodes.values():
        if node.dead:
            continue
        for k, v in node.pool.total.to_dict().items():
            total[k] = total.get(k, 0) + v
    return total


def available_resources() -> Dict[str, float]:
    avail: Dict[str, float] = {}
    for node in get_cluster().nodes.values():
        if node.dead:
            continue
        for k, v in node.pool.available.to_dict().items():
            avail[k] = avail.get(k, 0) + v
    return avail


def nodes() -> List[dict]:
    out = []
    for info in get_cluster().control.nodes.all_nodes():
        out.append(
            {
                "NodeID": info.node_id.hex(),
                "Alive": info.state.value == "ALIVE",
                "Resources": info.resources_total,
                "Labels": info.labels,
            }
        )
    return out


def timeline(filename: Optional[str] = None) -> List[dict]:
    """Task events + tracing spans (``ray.timeline`` parity). With
    ``filename``, writes chrome://tracing JSON there and returns the
    converted events; without, returns the raw records — task-state dicts
    plus span dicts (``type == "span"``) from the tracing layer."""
    control = get_cluster().control
    events = control.task_events.list_events()
    events = events + control.spans.list_events(limit=100_000)
    if filename is not None:
        from ray_tpu_torch.observability.timeline import chrome_trace

        trace = chrome_trace(events)
        import json as _json

        with open(filename, "w") as f:
            _json.dump(trace, f)
        return trace
    return events


# --------------------------------------------------------------------------
# options normalization
# --------------------------------------------------------------------------
_TASK_OPTION_KEYS = {
    "num_cpus", "num_gpus", "num_tpus", "resources", "num_returns",
    "max_retries", "retry_exceptions", "name", "scheduling_strategy",
    "runtime_env", "execution", "max_calls", "_metadata",
    # gray-failure knobs (ISSUE 8): end-to-end deadline budget (seconds,
    # enforced at every lifecycle stage, never retried) and the hedged
    # straggler-retry threshold (second attempt on a different node)
    "deadline_s", "hedge_after_s",
}
_ACTOR_OPTION_KEYS = {
    "num_cpus", "num_gpus", "num_tpus", "resources", "name", "namespace",
    "max_restarts", "max_task_retries", "max_concurrency", "lifetime",
    "scheduling_strategy", "runtime_env", "execution", "max_pending_calls",
    "_metadata",
}


def _resource_dict(opts: dict, default_cpus: float = 1.0) -> Dict[str, float]:
    resources = dict(opts.get("resources") or {})
    cpus = opts.get("num_cpus")
    resources["CPU"] = default_cpus if cpus is None else cpus
    if opts.get("num_tpus"):
        resources["TPU"] = opts["num_tpus"]
    if opts.get("num_gpus"):
        resources["GPU"] = opts["num_gpus"]
    return {k: v for k, v in resources.items() if v}


# --------------------------------------------------------------------------
# remote functions
# --------------------------------------------------------------------------
class RemoteFunction:
    """Parity: python/ray/remote_function.py:40 (RemoteFunction._remote)."""

    def __init__(self, func, options: Optional[dict] = None):
        self._function = func
        self._options = options or {}
        functools.update_wrapper(self, func)
        # resolve per-call-invariant options once (hot path: .remote() in a
        # tight loop must not rebuild these dicts every call)
        opts = self._options
        self._num_returns = opts.get("num_returns", 1)
        self._name = opts.get("name") or getattr(func, "__name__", "anonymous")
        self._resources = _resource_dict(opts)
        self._max_retries = opts.get("max_retries")
        self._retry_exceptions = bool(opts.get("retry_exceptions", False))
        self._execution = opts.get("execution", "auto")
        self._scheduling_strategy = opts.get("scheduling_strategy")
        self._runtime_env = opts.get("runtime_env")
        self._deadline_s = opts.get("deadline_s")
        self._hedge_after_s = opts.get("hedge_after_s")
        self._picklable_checked = False

    def remote(self, *args, **kwargs) -> Union[ObjectRef, List[ObjectRef]]:
        _auto_init()
        if not self._picklable_checked:
            # without cloudpickle a worker imports the function by name
            if not getattr(self._function, "_rt_device", False):
                serialization.check_by_reference(self._function)
            self._picklable_checked = True
        refs = global_worker().submit_task(
            self._function,
            args,
            kwargs,
            name=self._name,
            num_returns=self._num_returns,
            resources=self._resources,
            max_retries=self._max_retries,
            retry_exceptions=self._retry_exceptions,
            execution=self._execution,
            scheduling_strategy=self._scheduling_strategy,
            runtime_env=self._runtime_env,
            deadline_s=self._deadline_s,
            hedge_after_s=self._hedge_after_s,
        )
        if self._num_returns == "streaming":
            return refs  # a single ObjectRefGenerator
        return refs[0] if self._num_returns == 1 else refs

    def options(self, **new_options) -> "RemoteFunction":
        # `_metadata` carries layer-specific options (the reference threads
        # workflow options through it: `f.options(**workflow.options(...))`)
        # — kept off the task-option surface and re-attached to the clone.
        metadata = new_options.pop("_metadata", None)
        unknown = set(new_options) - _TASK_OPTION_KEYS
        if unknown:
            raise ValueError(f"Unknown task options: {unknown}")
        merged = {**self._options, **new_options}
        clone = RemoteFunction(self._function, merged)
        if metadata is not None:
            clone._metadata = dict(getattr(self, "_metadata", {}) or {})
            clone._metadata.update(metadata)
        elif getattr(self, "_metadata", None):
            clone._metadata = dict(self._metadata)
        return clone

    def bind(self, *args, **kwargs):
        """Lazy DAG construction (reference: dag_node.py bind)."""
        from ray_tpu_torch.dag.dag_node import FunctionNode

        return FunctionNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self._function.__name__}' cannot be called directly; "
            f"use '{self._function.__name__}.remote()'."
        )


# --------------------------------------------------------------------------
# actors
# --------------------------------------------------------------------------
class ActorMethod:
    """Parity: python/ray/actor.py:116."""

    def __init__(self, handle: "ActorHandle", method_name: str, num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def remote(self, *args, **kwargs):
        refs = global_worker().submit_actor_task(
            self._handle._actor_id,
            self._method_name,
            args,
            kwargs,
            num_returns=self._num_returns,
            name=f"{self._handle._class_name}.{self._method_name}",
        )
        return refs[0] if self._num_returns == 1 else refs

    def options(self, num_returns: int = 1, **_ignored) -> "ActorMethod":
        return ActorMethod(self._handle, self._method_name, num_returns)

    def bind(self, *args, **kwargs):
        """Lazy DAG construction (reference: dag_node.py bind)."""
        from ray_tpu_torch.dag.dag_node import ClassMethodNode

        return ClassMethodNode(self, args, kwargs)


class ActorHandle:
    """Parity: python/ray/actor.py:1226."""

    def __init__(
        self,
        actor_id: ActorID,
        class_name: str,
        _methods: Optional[set] = None,
        _method_num_returns: Optional[Dict[str, int]] = None,
    ):
        self._actor_id = actor_id
        self._class_name = class_name
        self._methods = _methods
        self._method_num_returns = _method_num_returns or {}

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        if self._methods is not None and name not in self._methods:
            raise AttributeError(f"Actor {self._class_name} has no method {name!r}")
        return ActorMethod(self, name, self._method_num_returns.get(name, 1))

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._class_name, self._methods, self._method_num_returns))


class ActorClass:
    """Parity: python/ray/actor.py:566."""

    def __init__(self, cls, options: Optional[dict] = None):
        self._cls = cls
        self._options = options or {}

    def remote(self, *args, **kwargs) -> ActorHandle:
        _auto_init()
        opts = self._options
        mode = self._pick_mode(opts)
        if mode == "process":
            # without cloudpickle a worker imports the class by name
            serialization.check_by_reference(self._cls)
        actor_id = global_worker().create_actor(
            self._cls,
            args,
            kwargs,
            name=opts.get("name"),
            namespace=opts.get("namespace", "default"),
            class_name=self._cls.__name__,
            resources=_resource_dict(opts),
            max_restarts=opts.get("max_restarts", 0),
            max_task_retries=opts.get("max_task_retries", 0),
            max_concurrency=opts.get("max_concurrency", 1),
            mode=mode,
            scheduling_strategy=opts.get("scheduling_strategy"),
        )
        methods = {n for n in dir(self._cls) if not n.startswith("_") and callable(getattr(self._cls, n))}
        num_returns_map = {
            n: getattr(getattr(self._cls, n), "_rt_num_returns", 1)
            for n in methods
            if getattr(getattr(self._cls, n), "_rt_num_returns", 1) != 1
        }
        return ActorHandle(actor_id, self._cls.__name__, _methods=methods, _method_num_returns=num_returns_map)

    def _pick_mode(self, opts: dict) -> str:
        if opts.get("execution") in ("inproc", "thread"):
            return "inproc"
        if opts.get("execution") == "process":
            return "process"
        # device actors (GPU or TPU resources, or device-marked classes) live
        # in-process next to the device; pure-Python actors get their own
        # process.
        resources = opts.get("resources") or {}
        if opts.get("num_gpus") or resources.get("GPU"):
            return "inproc"
        if opts.get("num_tpus") or resources.get("TPU"):
            return "inproc"
        if getattr(self._cls, "_rt_device", False):
            return "inproc"
        return "process"

    def options(self, **new_options) -> "ActorClass":
        unknown = set(new_options) - _ACTOR_OPTION_KEYS
        if unknown:
            raise ValueError(f"Unknown actor options: {unknown}")
        return ActorClass(self._cls, {**self._options, **new_options})

    def __call__(self, *args, **kwargs):
        raise TypeError(f"Actor class {self._cls.__name__} cannot be instantiated directly; use .remote().")


# --------------------------------------------------------------------------
# @remote
# --------------------------------------------------------------------------
def remote(*args, **kwargs):
    """``@remote`` / ``@remote(**options)`` on a function or class."""
    if len(args) == 1 and not kwargs and (callable(args[0]) or isinstance(args[0], type)):
        target = args[0]
        if isinstance(target, type):
            return ActorClass(target)
        return RemoteFunction(target)

    valid = _TASK_OPTION_KEYS | _ACTOR_OPTION_KEYS
    unknown = set(kwargs) - valid
    if unknown:
        raise ValueError(f"Unknown options to @remote: {unknown}")

    def decorator(target):
        if isinstance(target, type):
            return ActorClass(target, kwargs)
        return RemoteFunction(target, kwargs)

    return decorator


def method(*, num_returns: int = 1):
    """Parity: @ray.method — per-method num_returns annotation."""

    def decorator(fn):
        fn._rt_num_returns = num_returns
        return fn

    return decorator
