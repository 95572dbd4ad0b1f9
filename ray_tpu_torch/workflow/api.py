"""Workflow executor + public API.

The port's copy of ``ray_tpu/workflow/api.py``, over the port's
``dag/dag_node.py``.  A step's durable value is pickled as the JAX package
pickles it: a CUDA tensor keeps its device (loading it where no card is
raises), so GPU steps return host values (tokens as lists or numpy).

Parity: ``python/ray/workflow/workflow_executor.py:32`` + ``api.py`` —
``workflow.run(dag, workflow_id=...)`` executes a ``ray_tpu_torch.dag`` graph with
every node's result checkpointed; ``resume`` replays the persisted DAG,
skipping steps whose results are already durable.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.dag.dag_node import DAGNode
from ray_tpu_torch.workflow.exceptions import (
    WorkflowCancellationError,
    WorkflowError,
    WorkflowExecutionError,
)
from ray_tpu_torch.workflow.storage import WorkflowStorage

RUNNING = "RUNNING"
SUCCESSFUL = "SUCCESSFUL"
FAILED = "FAILED"
CANCELED = "CANCELED"

_storage: Optional[WorkflowStorage] = None
_cancel_flags: Dict[str, threading.Event] = {}
# workflow ids executing in THIS process right now — resume_all must not
# start a second concurrent execution of one of them (the store says
# RUNNING for both a crashed driver's orphan and a live in-flight run)
_active_workflows: set = set()
_active_lock = threading.Lock()


def init(storage_dir: Optional[str] = None) -> None:
    global _storage
    _storage = WorkflowStorage(storage_dir)


def _store() -> WorkflowStorage:
    global _storage
    if _storage is None:
        _storage = WorkflowStorage()
    return _storage


# --------------------------------------------------------------- executor
def _execute_dag(dag: DAGNode, workflow_id: str, store: WorkflowStorage, prefix: str = "") -> Any:
    """Topological replay: durable steps load from storage; the rest are
    submitted eagerly with upstream REFS as args — independent branches run
    in parallel and the fabric chains dependents — then results are fetched
    and checkpointed in topological order (at-least-once replay: a crash
    between a step finishing and its checkpoint just reruns that step).

    ``prefix`` namespaces step keys for continuations: a step returning a
    DAGNode (``workflow.continuation``) tail-calls into a fresh sub-plan
    whose steps checkpoint under ``<parent-step>/``."""
    order = dag.topological()
    cancel_flag = _cancel_flags.setdefault(workflow_id, threading.Event())
    results: Dict[int, Any] = {}   # node id -> ObjectRef or durable value
    durable: Dict[int, bool] = {}
    wf_options: Dict[int, dict] = {}  # per-step workflow.options
    keys: Dict[int, str] = {}
    for i, node in enumerate(order):
        # Step key = topological index → stable across replays of the same
        # persisted DAG object (DAGNode.topological is deterministic).
        keys[id(node)] = f"{prefix}step_{i:04d}"

    for node in order:
        if cancel_flag.is_set():
            store.set_status(workflow_id, CANCELED)
            raise WorkflowCancellationError(f"workflow {workflow_id} canceled")
        key = keys[id(node)]
        if store.has_step(workflow_id, key):
            results[id(node)] = store.load_step(workflow_id, key)
            durable[id(node)] = True
            continue
        func = getattr(node, "func", None)
        if func is None:
            # Non-task nodes (InputNode etc.) are not supported in durable mode
            raise TypeError(f"workflow DAGs must be built from task bind()s, got {type(node)}")
        args = tuple(results[id(a)] if isinstance(a, DAGNode) else a for a in node._bound_args)
        kwargs = {k: (results[id(v)] if isinstance(v, DAGNode) else v) for k, v in node._bound_kwargs.items()}
        # submit through the node's own RemoteFunction so bind-time options
        # (execution mode, resources, retries) survive the replay
        remote_fn = getattr(node, "_remote_function", None) or ray_tpu_torch.remote(func)
        wf_options[id(node)] = (getattr(remote_fn, "_metadata", None) or {}).get(
            "workflow.io/options", {}
        )
        results[id(node)] = remote_fn.remote(*args, **kwargs)
        durable[id(node)] = False

    for node in order:
        # The fetch loop is where the wall-clock goes — cancel() must be
        # honored here, not just at submission.
        if cancel_flag.is_set():
            store.set_status(workflow_id, CANCELED)
            raise WorkflowCancellationError(f"workflow {workflow_id} canceled")
        if not durable[id(node)]:
            opts = wf_options.get(id(node), {})

            def fetch_and_continue(ref, key=keys[id(node)]):
                value = ray_tpu_torch.get(ref)
                if isinstance(value, DAGNode):
                    # continuation: the step's durable value is the
                    # sub-plan's final result; its steps checkpoint under
                    # this step's key
                    value = _execute_dag(value, workflow_id, store, prefix=f"{key}/")
                return value

            if opts.get("catch_exceptions"):
                # durable value becomes (result, exception) — the step's
                # failure is data, not a workflow failure; a continuation's
                # failure is the step's failure too, so it runs inside the
                # catch
                try:
                    value = (fetch_and_continue(results[id(node)]), None)
                except WorkflowCancellationError:
                    raise  # cancellation is never "data"
                except Exception as exc:  # noqa: BLE001
                    value = (None, exc)
            else:
                value = fetch_and_continue(results[id(node)])
            if opts.get("checkpoint", True):
                store.save_step(workflow_id, keys[id(node)], value)
            results[id(node)] = value
    if cancel_flag.is_set():
        store.set_status(workflow_id, CANCELED)
        raise WorkflowCancellationError(f"workflow {workflow_id} canceled")
    return results[id(order[-1])]


def run(dag: DAGNode, *, workflow_id: Optional[str] = None) -> Any:
    workflow_id = workflow_id or f"wf_{uuid.uuid4().hex[:10]}"
    store = _store()
    import cloudpickle

    # Atomic check-and-add BEFORE any durable write: anyone who reads
    # RUNNING is guaranteed to find the id in _active_workflows (or find a
    # terminal status later) — the invariant resume()/resume_all() lean on.
    # The check also refuses two run() calls racing on one explicit id,
    # which would replay steps concurrently, race the step-file writes, and
    # (were save_dag hoisted above this check) clobber the running
    # workflow's durable DAG with the refused caller's.
    with _active_lock:
        if workflow_id in _active_workflows:
            raise WorkflowExecutionError(
                f"workflow {workflow_id!r} is already executing in this process"
            )
        _active_workflows.add(workflow_id)
        # A fresh run revokes any cancel left over from a prior execution of
        # this id — the stale flag would abort step 0 (same rule as resume).
        flag = _cancel_flags.get(workflow_id)
        if flag is not None:
            flag.clear()
    try:
        # durable writes live INSIDE the try: a storage error must not leak
        # the id in the active set (the finally below owns the discard).
        # run() is a FRESH execution — prior checkpoints under this id
        # belong to whatever DAG ran before (step keys are topological
        # indices, so a different DAG's steps would collide); resume() is
        # the replay path.
        store.clear_steps(workflow_id)
        store.save_dag(workflow_id, cloudpickle.dumps(dag))
        store.set_status(workflow_id, RUNNING)
        result = _execute_dag(dag, workflow_id, store)
        # terminal status writes happen BEFORE the active-set discard: a
        # resume_all() racing this window must see either "active" or a
        # terminal status, never RUNNING+inactive (double execution)
        store.save_step(workflow_id, "__output__", result)
        store.set_status(workflow_id, SUCCESSFUL)
    except BaseException:
        if store.get_status(workflow_id) != CANCELED:
            store.set_status(workflow_id, FAILED)
        raise
    finally:
        with _active_lock:
            _active_workflows.discard(workflow_id)
    return result


def run_async(dag: DAGNode, *, workflow_id: Optional[str] = None):
    """Returns an ObjectRef-like future via a background thread."""
    from concurrent.futures import Future

    workflow_id = workflow_id or f"wf_{uuid.uuid4().hex[:10]}"
    fut: Future = Future()

    def target():
        try:
            fut.set_result(run(dag, workflow_id=workflow_id))
        except BaseException as exc:  # noqa: BLE001
            fut.set_exception(exc)

    threading.Thread(target=target, daemon=True, name=f"workflow-{workflow_id}").start()
    return fut


def resume(workflow_id: str) -> Any:
    """Replay a persisted workflow; durable steps are skipped."""
    store = _store()
    import pickle

    # Atomic check-and-add BEFORE touching the durable DAG: a resume racing
    # a concurrent run()/resume() of the same id must hit this clean
    # refusal, not whatever state the other execution is mid-writing.  The
    # cancel-flag clear lives INSIDE the lock, after the check — clearing
    # before the refusal would silently un-cancel a running workflow.
    with _active_lock:
        if workflow_id in _active_workflows:
            raise WorkflowExecutionError(
                f"workflow {workflow_id!r} is already executing in this process"
            )
        _active_workflows.add(workflow_id)
        # Resuming revokes any prior cancel — otherwise the stale flag
        # aborts step 0 and resume-after-cancel (a core durability
        # feature) never works.
        flag = _cancel_flags.get(workflow_id)
        if flag is not None:
            flag.clear()
    try:
        dag = pickle.loads(store.load_dag(workflow_id))
        # set_status lives INSIDE the try: a storage error must not leak the
        # id in the active set (the finally below owns the discard).
        store.set_status(workflow_id, RUNNING)
        result = _execute_dag(dag, workflow_id, store)
        # terminal status writes happen BEFORE the active-set discard: a
        # resume_all() racing this window must see either "active" or a
        # terminal status, never RUNNING+inactive (double execution)
        store.save_step(workflow_id, "__output__", result)
        store.set_status(workflow_id, SUCCESSFUL)
    except BaseException:
        # don't mint a FAILED status for an id that was never persisted
        # (load_dag on an unknown workflow raises before anything ran)
        if store.get_status(workflow_id) not in (None, CANCELED):
            store.set_status(workflow_id, FAILED)
        raise
    finally:
        with _active_lock:
            _active_workflows.discard(workflow_id)
    return result


def get_output(workflow_id: str) -> Any:
    store = _store()
    if store.has_step(workflow_id, "__output__"):
        return store.load_step(workflow_id, "__output__")
    raise KeyError(f"workflow {workflow_id} has no durable output (status={store.get_status(workflow_id)})")


def get_status(workflow_id: str) -> Optional[str]:
    return _store().get_status(workflow_id)


def list_all(status_filter: Optional[str] = None) -> List[Dict[str, Any]]:
    wfs = _store().list_workflows()
    if status_filter:
        wfs = [w for w in wfs if w["status"] == status_filter]
    return wfs


def cancel(workflow_id: str) -> None:
    _cancel_flags.setdefault(workflow_id, threading.Event()).set()
    _store().set_status(workflow_id, CANCELED)


def delete(workflow_id: str) -> None:
    _store().delete(workflow_id)
    _cancel_flags.pop(workflow_id, None)


def resume_async(workflow_id: str):
    """resume() on a background thread; returns a Future
    (parity: workflow.resume_async)."""
    from concurrent.futures import Future

    fut: Future = Future()

    def target():
        try:
            fut.set_result(resume(workflow_id))
        except BaseException as exc:  # noqa: BLE001
            fut.set_exception(exc)

    threading.Thread(target=target, daemon=True, name=f"workflow-resume-{workflow_id}").start()
    return fut


def resume_all() -> List[tuple]:
    """Resume every workflow persisted in RESUMABLE/FAILED/RUNNING state
    (parity: workflow.resume_all — RUNNING covers a crashed driver whose
    workflows never reached a terminal status).  Returns
    ``[(workflow_id, future), ...]``."""
    # Snapshot the active set BEFORE listing: a workflow that *finishes*
    # between the reads writes its terminal status before the active-set
    # discard, so the list either shows it terminal (skipped by status) or
    # RUNNING while still in the snapshot (skipped as active).  The inverse
    # race — one that *starts* between the reads — is caught by resume()'s
    # atomic refusal, since run()/resume() add to the active set before
    # writing RUNNING.
    with _active_lock:
        active = set(_active_workflows)
    listed = list_all()
    out = []
    for wf in listed:
        if wf["workflow_id"] in active:
            continue  # executing in this process right now — not an orphan
        if wf["status"] in (RUNNING, FAILED, "RESUMABLE"):
            out.append((wf["workflow_id"], resume_async(wf["workflow_id"])))
    return out


def get_output_async(workflow_id: str):
    """Future for a workflow's durable output, waiting for completion if
    it is still running (parity: workflow.get_output_async)."""
    from concurrent.futures import Future

    fut: Future = Future()
    if _store().get_status(workflow_id) is None:
        fut.set_exception(KeyError(f"no workflow {workflow_id!r}"))
        return fut

    def target():
        try:
            # no deadline of our own: a workflow may legitimately run for
            # hours — the caller's fut.result(timeout=...) owns the budget
            while True:
                status = get_status(workflow_id)
                if status == SUCCESSFUL:
                    fut.set_result(get_output(workflow_id))
                    return
                if status in (FAILED, CANCELED):
                    fut.set_exception(
                        WorkflowExecutionError(f"workflow {workflow_id} ended {status}")
                    )
                    return
                time.sleep(0.2)
        except BaseException as exc:  # noqa: BLE001
            fut.set_exception(exc)

    threading.Thread(target=target, daemon=True, name=f"workflow-output-{workflow_id}").start()
    return fut


def get_metadata(workflow_id: str) -> Dict[str, Any]:
    """Status + per-step durable-record summary
    (parity: workflow.get_metadata)."""
    store = _store()
    status = store.get_status(workflow_id)
    if status is None:
        raise KeyError(f"no workflow {workflow_id!r}")
    steps = store.list_steps(workflow_id) if hasattr(store, "list_steps") else []
    return {
        "workflow_id": workflow_id,
        "status": status,
        "stats": {"steps_recorded": len(steps)},
        "step_names": steps,
    }


def sleep(duration_s: float):
    """A durable sleep step: delays once, replays instantly
    (parity: workflow.sleep — the wake time persists with the step, so a
    resumed workflow doesn't re-wait)."""
    import ray_tpu_torch

    @ray_tpu_torch.remote
    def _sleep(wake_at_monotonic_anchor: float, duration: float) -> float:
        remaining = duration - (time.time() - wake_at_monotonic_anchor)
        if remaining > 0:
            time.sleep(remaining)
        return duration

    return _sleep.bind(time.time(), duration_s)


def continuation(dag_node):
    """Mark a DAG returned from a step as the workflow's continuation
    (parity: workflow.continuation).  The executor tail-calls any DAGNode a
    step returns — sub-steps checkpoint under the parent step's key — so
    this is the explicit spelling of that contract."""
    return dag_node


_WORKFLOW_OPTION_KEYS = {"task_id", "metadata", "catch_exceptions", "checkpoint"}


class options:
    """Per-step workflow options, usable as a decorator or via
    ``f.options(**workflow.options(...))`` (parity: workflow.api.options).

    Honored by the executor: ``checkpoint=False`` skips the step's durable
    record (it recomputes on replay); ``catch_exceptions=True`` makes the
    step's durable value a ``(result, exception)`` pair instead of failing
    the workflow.  ``task_id``/``metadata`` are recorded for bookkeeping.
    """

    def __init__(self, **workflow_options: Any):
        invalid = set(workflow_options) - _WORKFLOW_OPTION_KEYS
        if invalid:
            raise ValueError(
                f"Invalid workflow option keywords {invalid}; valid ones are "
                f"{_WORKFLOW_OPTION_KEYS}"
            )
        self.options = {"_metadata": {"workflow.io/options": dict(workflow_options)}}

    # mapping protocol: `f.options(**workflow.options(...))`
    def keys(self):
        return ("_metadata",)

    def __getitem__(self, key):
        return self.options[key]

    def __call__(self, f):
        from ray_tpu_torch.api import RemoteFunction

        if not isinstance(f, RemoteFunction):
            raise ValueError("workflow.options applies to remote functions")
        return f.options(**self)
