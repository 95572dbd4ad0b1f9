"""Nested runtime API from inside worker processes.

The port's copy of ``ray_tpu/runtime/worker_api.py``; blobs plain pickle
refuses go through ``serialization.dumps_by_value``.

The reference embeds a full CoreWorker in every worker process, so task code
can call ``ray.get``/``.remote``/``ray.put`` anywhere (SURVEY §1 layer 4).
Here workers stay thin: a :class:`WorkerApiClient` forwards API calls as
``api_request`` frames over the existing pool socket; the node routes them
to the DRIVER's CoreWorker (directly on the head, over the node transport
from agents), which owns every object and task exactly as before — the
ownership invariant keeps a single owner per object instead of
per-submitter ownership.

Blocking semantics match the reference's "blocked worker releases its CPU"
rule (``raylet NotifyUnblocked``): while a worker waits in a nested
``get``/``wait``, its task's resources are returned to the local scheduler
so child tasks can run — otherwise a fan-out of nested parents deadlocks
the pool — and re-acquired (forced: transient oversubscription, bounded by
pool width) when the wait resolves.

Not supported from workers (clear errors, not hangs):
``num_returns="streaming"`` and detached lifetime actors.
"""

from __future__ import annotations

import itertools
import pickle
import threading
from concurrent.futures import Future
# py3.10: futures.TimeoutError is NOT the builtin TimeoutError (unified in
# 3.11) — catching the wrong one lets Future.result timeouts escape
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Any, Dict, Optional

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.config import get_config

#: ops whose handler may block awaiting other tasks -> release resources
BLOCKING_OPS = ("get", "wait")


def _dumps(obj) -> bytes:
    try:
        return serialization.dumps(obj)
    except (AttributeError, TypeError, pickle.PicklingError):
        return serialization.dumps_by_value(obj)


def peek_op(blob: bytes) -> str:
    """Cheap op sniff without a full unpickle: the tuple's first element.
    Falls back to a full load on any surprise."""
    try:
        return pickle.loads(blob)[0]
    except Exception:  # noqa: BLE001
        return "?"


# ---------------------------------------------------------------------------
# server side (runs in the DRIVER process against its CoreWorker)
# ---------------------------------------------------------------------------
def execute(core_worker, blob: bytes, decoded=None, worker_key=None) -> bytes:
    """Run one worker API call; returns pickled ("ok", result) / ("err", exc).

    ``decoded`` short-circuits the unpickle when the caller already loaded
    the frame (the shm-marker put path: re-pickling a resolved bulk array
    just to re-load it here would cost two full copies per put).
    ``worker_key`` identifies the calling worker process for pin
    accounting (see _pin_refs / release_refs)."""
    try:
        op, kw = pickle.loads(blob) if decoded is None else decoded
        if op == "release_refs":
            _drop_pins(core_worker, worker_key, kw["released"])
            return _dumps(("ok", None))
        if op in ("submit_task_async", "submit_actor_task_async"):
            _execute_async_submit(core_worker, op, kw, worker_key)
            return _dumps(("ok", None))
        if op in ("put_async", "register_put_async"):
            _execute_async_put(core_worker, op, kw, worker_key)
            return _dumps(("ok", None))
        if op == "put":
            result = core_worker.put(kw["value"])
        elif op == "get":
            result = core_worker.get(kw["refs"], timeout=kw.get("timeout"))
        elif op == "wait":
            result = core_worker.wait(
                kw["refs"], num_returns=kw.get("num_returns", 1), timeout=kw.get("timeout")
            )
        elif op == "submit_task":
            if kw.get("num_returns") == "streaming":
                raise NotImplementedError(
                    "num_returns='streaming' is not supported from inside "
                    "worker processes (call it from the driver)"
                )
            result = core_worker.submit_task(
                kw["func"], kw["args"], kw["kwargs"],
                name=kw["name"], num_returns=kw.get("num_returns", 1),
                resources=kw.get("resources"),
                max_retries=kw.get("max_retries"),
                retry_exceptions=kw.get("retry_exceptions", False),
                execution=kw.get("execution", "auto"),
                scheduling_strategy=kw.get("scheduling_strategy"),
                runtime_env=kw.get("runtime_env"),
                deadline_s=kw.get("deadline_s"),
                hedge_after_s=kw.get("hedge_after_s"),
                _inherited_deadline_ts=kw.get("_inherited_deadline_ts"),
            )
        elif op == "create_actor":
            result = core_worker.create_actor(
                kw["cls"], kw["args"], kw["kwargs"],
                name=kw.get("name"), namespace=kw.get("namespace", "default"),
                class_name=kw.get("class_name", ""),
                resources=kw.get("resources"),
                max_restarts=kw.get("max_restarts", get_config().actor_max_restarts),
                max_task_retries=kw.get("max_task_retries", 0),
                max_concurrency=kw.get("max_concurrency", 1),
                mode=kw.get("mode", "process"),
                scheduling_strategy=kw.get("scheduling_strategy"),
            )
        elif op == "submit_actor_task":
            result = core_worker.submit_actor_task(
                kw["actor_id"], kw["method_name"], kw["args"], kw["kwargs"],
                num_returns=kw.get("num_returns", 1), name=kw.get("name", ""),
            )
        elif op == "kv_put":
            _control_kv().put(kw["key"], kw["value"])
            result = None
        elif op == "kv_get":
            result = _control_kv().get(kw["key"])
        elif op == "kv_del":
            _control_kv().delete(kw["key"])
            result = None
        else:
            raise ValueError(f"unknown worker api op {op!r}")
        # Serialize with ref capture: every ObjectRef occurrence pickled
        # into the reply (at ANY depth — __reduce__ fires per occurrence)
        # gets a counted pin matching the construction the worker's
        # unpickle will perform.
        from ray_tpu_torch.core.object_ref import hooks as _hooks

        ctx = _hooks.serialization_ctx
        if ctx is not None and hasattr(ctx, "start_capture_refs"):
            ctx.start_capture_refs()
            try:
                blob = _dumps(("ok", result))
            finally:
                captured = ctx.stop_capture_refs()
            _pin_captured(core_worker, worker_key, captured)
            return blob
        return _dumps(("ok", result))
    except BaseException as exc:  # noqa: BLE001 — errors cross the socket
        try:
            return _dumps(("err", exc))
        except BaseException:
            return _dumps(("err", RuntimeError(f"{type(exc).__name__}: {exc}")))


#: ops that are fire-and-forget notifications — processed INLINE on the
#: pool reader thread (cheap, never blocking) so per-worker frame order is
#: preserved (actor-call ordering; submit-before-release for minted refs)
ASYNC_OPS = (
    "submit_task_async", "submit_actor_task_async", "put_async",
    "register_put_async", "release_refs",
)

#: request/reply ops that are still cheap and non-blocking: also served
#: inline on the reader thread — spawning a thread per call costs more
#: than the handler itself (measured: the put rate tripled)
INLINE_SYNC_OPS = ("put", "kv_put", "kv_get", "kv_del", "submit_task", "submit_actor_task")


def _execute_async_submit(core_worker, op: str, kw: dict, worker_key) -> None:
    """Process a worker's fire-and-forget submission (it already minted the
    task id and built its ObjectRefs).  Pin the return refs for the worker;
    a submission error can't raise back, so it materializes as an error
    object under the minted return ids — the worker's get() surfaces it."""
    from ray_tpu_torch.core.ids import ObjectID, TaskID

    task_id = TaskID(kw["task_id"])
    num_returns = kw.get("num_returns", 1)
    return_ids = [ObjectID.for_task_return(task_id, i + 1) for i in range(num_returns)]
    try:
        if op == "submit_task_async":
            refs = core_worker.submit_task(
                kw["func"], kw["args"], kw["kwargs"],
                name=kw.get("name", ""), num_returns=num_returns,
                resources=kw.get("resources"),
                max_retries=kw.get("max_retries"),
                retry_exceptions=kw.get("retry_exceptions", False),
                execution=kw.get("execution", "auto"),
                scheduling_strategy=kw.get("scheduling_strategy"),
                runtime_env=kw.get("runtime_env"),
                deadline_s=kw.get("deadline_s"),
                hedge_after_s=kw.get("hedge_after_s"),
                _inherited_deadline_ts=kw.get("_inherited_deadline_ts"),
                _task_id=kw["task_id"],
            )
        else:
            refs = core_worker.submit_actor_task(
                kw["actor_id"], kw["method_name"], kw["args"], kw["kwargs"],
                num_returns=num_returns, name=kw.get("name", ""),
                _task_id=kw["task_id"],
            )
        _pin_captured(core_worker, worker_key, refs)
    except BaseException as exc:  # noqa: BLE001 — surface at the worker's get
        from ray_tpu_torch import api

        cluster = api.get_cluster()
        for oid in return_ids:
            try:
                core_worker.ref_counter.add_owned_object(oid)
            except Exception:  # noqa: BLE001
                pass
            cluster.head_node.store.put(oid, exc, is_error=True)
            cluster.directory.add_location(oid, cluster.head_node.node_id)


def _execute_async_put(core_worker, op: str, kw: dict, worker_key) -> None:
    """A worker's fire-and-forget put with a locally-minted oid.

    ``put_async`` carries the value (the bytes land in the owner's store);
    ``register_put_async`` is the agent-relayed variant where the bytes
    stayed in the agent's store; ownership, the worker pin, AND the
    placement (size/device piggybacked on the notice) are recorded here.
    Identical oids from a retried attempt overwrite idempotently — the
    reference's put-id convention."""
    from ray_tpu_torch import api
    from ray_tpu_torch.core.ids import ObjectID
    from ray_tpu_torch.core.object_ref import ObjectRef

    oid = ObjectID(kw["oid"])
    core_worker.ref_counter.add_owned_object(oid)
    ref = ObjectRef(oid)
    cluster = api.get_cluster()
    if op == "put_async":
        node = cluster.head_node
        node.store.put(oid, kw["value"])
        cluster.commit_location(node, oid)
    else:
        # register_put_async: the bytes stayed in the agent's store and
        # placement rode inside this notice — commit it here so the
        # location can never trail the ownership record (the worker_key's
        # first element is the relaying agent's node id)
        node_id = worker_key[0] if isinstance(worker_key, tuple) else None
        if node_id is not None:
            cluster.directory.commit_placement(
                oid, node_id, kw.get("size"), bool(kw.get("device"))
            )
    _pin_captured(core_worker, worker_key, [ref])


def _control_kv():
    """The cluster KV, reached from the process executing worker API calls
    (the driver).  Workers use it for collective rank-address registration
    and group records — tiny metadata, never payloads."""
    from ray_tpu_torch import api

    return api.get_cluster().control.kv


def _pins_of(core_worker) -> dict:
    pins = getattr(core_worker, "_worker_api_pins", None)
    if pins is None:
        pins = core_worker._worker_api_pins = {}
    return pins


def _pin_captured(core_worker, worker_key, refs) -> None:
    """Refs serialized into a worker-bound reply must outlive the send: the
    worker holds them, so the driver pins them keyed (worker, oid) with a
    DELIVERY COUNT, until the worker's reference ledger reports the last
    local ref dead (release_refs) or the worker dies (release_worker_pins).

    The count makes the protocol race-free: each pickled ref occurrence
    becomes exactly one ObjectRef construction on the worker's unpickle
    (pickler memoization on both sides), the worker's release reports how
    many deliveries that holding-epoch consumed, and the pin drops only
    when every delivery is accounted — so a release racing a reply that
    re-delivers the same oid can never strand the worker's live ref."""
    pins = _pins_of(core_worker)
    for ref in refs:
        key = (worker_key, ref.id())
        entry = pins.get(key)
        if entry is None:
            pins[key] = [ref, 1]
        else:
            entry[1] += 1


def _drop_pins(core_worker, worker_key, released) -> None:
    """``released``: [(oid_binary, delivered_count), ...] from the worker's
    ledger.  Decrement by the reported deliveries; pop at zero."""
    from ray_tpu_torch.core.ids import ObjectID

    pins = _pins_of(core_worker)
    for b, k in released:
        if k <= 0:
            continue  # arg-only ref: never pinned here
        key = (worker_key, ObjectID(b))
        entry = pins.get(key)
        if entry is None:
            continue
        entry[1] -= k
        if entry[1] <= 0:
            pins.pop(key, None)


def release_worker_pins(core_worker, worker_key) -> None:
    """A worker process died: every pin it held dies with it (its borrower
    ledger can no longer report)."""
    if core_worker is None:
        return
    pins = getattr(core_worker, "_worker_api_pins", None)
    if not pins:
        return
    for key in [k for k in pins if k[0] == worker_key]:
        pins.pop(key, None)


# ---------------------------------------------------------------------------
# client side (runs in the worker process)
# ---------------------------------------------------------------------------
class WorkerApiClient:
    """CoreWorker-surface shim: every method is one round trip to the owner.

    Installed as the worker process's global worker, so
    ``rt.get/put/wait/@remote`` work unchanged inside tasks and actors."""

    def __init__(self, send_request, current_task_fn, shm_store=None, shm_id_factory=None):
        # send_request(rid, blob): write an api_request frame (thread-safe)
        self._send = send_request
        self._current_task = current_task_fn
        self._rid = itertools.count(1)
        self._pending: Dict[int, Future] = {}
        self._put_counters: Dict[bytes, Any] = {}
        self._lock = threading.Lock()
        # bulk put payloads ride the node's shm arena, not in-band pickle
        self._shm = shm_store
        self._shm_id = shm_id_factory

    # -- plumbing ----------------------------------------------------------
    def _call(self, op: str, **kw) -> Any:
        rid = next(self._rid)
        fut: Future = Future()
        with self._lock:
            self._pending[rid] = fut
        # op rides beside the blob so the node's blocking-op check never
        # needs to deserialize the (possibly huge) payload
        self._send(rid, _dumps((op, kw)), self._current_task(), op)
        # deadline-bearing tasks bound their blocking control calls by the
        # REMAINING budget (plus slack so the owner-side enforcement — the
        # typed DeadlineExceededError — normally wins the race) instead of
        # waiting forever on a reply the deadline already doomed
        from ray_tpu_torch.runtime.context import remaining_budget

        budget = remaining_budget(None)
        if budget is None:
            blob = fut.result()
        else:
            try:
                blob = fut.result(budget + 2.0)
            except FuturesTimeoutError:
                with self._lock:
                    self._pending.pop(rid, None)
                from ray_tpu_torch.runtime.rpc import ControlPlaneTimeout

                raise ControlPlaneTimeout(op, budget + 2.0) from None
        # unpickle under reply capture: ObjectRef constructions here are
        # owner-pinned deliveries the release protocol must account for
        from ray_tpu_torch.core.object_ref import hooks as _hooks

        ctr = _hooks.ref_counter
        if ctr is not None and hasattr(ctr, "reply_capture"):
            with ctr.reply_capture():
                status, result = pickle.loads(blob)
        else:
            status, result = pickle.loads(blob)
        if status == "err":
            raise result
        return result

    def on_reply(self, rid: int, blob: bytes) -> None:
        with self._lock:
            fut = self._pending.pop(rid, None)
        if fut is not None:
            fut.set_result(blob)

    def fail_all(self, error: BaseException) -> None:
        with self._lock:
            pending, self._pending = self._pending, {}
        for fut in pending.values():
            try:
                fut.set_result(_dumps(("err", error)))
            except Exception:  # noqa: BLE001
                pass

    # -- CoreWorker surface (what ray_tpu/api.py calls) --------------------
    def _task_put_index(self, task_bin: bytes) -> int:
        """Deterministic per-task put index (reference convention: put oids
        derive from the task id + a per-execution counter, so a retried
        attempt re-mints the SAME oids and its puts overwrite idempotently)."""
        with self._lock:
            ctr = self._put_counters.get(task_bin)
            if ctr is None:
                if len(self._put_counters) > 1024:
                    self._put_counters.clear()  # finished tasks' counters
                ctr = self._put_counters[task_bin] = itertools.count(1)
            return next(ctr)

    def put(self, value):
        if self._shm is not None and self._shm_id is not None:
            from ray_tpu_torch.runtime import protocol

            value = protocol.encode_value(value, self._shm, self._shm_id)
        task_bin = self._current_task()
        if task_bin is not None:
            # fire-and-forget: mint the put oid locally and notify the
            # owner — one ordered socket write instead of a round trip
            from ray_tpu_torch.core.ids import ObjectID, TaskID

            oid = ObjectID.for_put(TaskID(task_bin), self._task_put_index(task_bin))
            rid = next(self._rid)
            self._send(
                rid,
                _dumps(("put_async", {"oid": oid.binary(), "value": value})),
                task_bin, "put_async",
            )
            return self._mark_minted_refs([oid])[0]
        return self._call("put", value=value)

    def get(self, refs, timeout: Optional[float] = None):
        return self._call("get", refs=refs, timeout=timeout)

    def wait(self, refs, num_returns: int = 1, timeout: Optional[float] = None):
        return self._call("wait", refs=list(refs), num_returns=num_returns, timeout=timeout)

    def _mark_minted_refs(self, return_ids) -> list:
        """Build local ObjectRefs for worker-minted return ids and record
        them as owner-pinned deliveries in the ledger (the owner creates
        the matching counted pin when it processes the async submit — the
        frames travel the same ordered socket, so the pin always lands
        before any release for it can)."""
        from ray_tpu_torch.core.object_ref import ObjectRef, hooks as _hooks

        ctr = _hooks.ref_counter
        refs = []
        for oid in return_ids:
            if ctr is not None and hasattr(ctr, "reply_capture"):
                with ctr.reply_capture():
                    refs.append(ObjectRef(oid))
            else:
                refs.append(ObjectRef(oid))
        return refs

    def submit_task(self, func, args, kwargs, **opts):
        num_returns = opts.get("num_returns", 1)
        task_bin = self._current_task()
        if "_inherited_deadline_ts" not in opts:
            # nested submission from a deadline-bearing task: ship the
            # REMAINING budget to the owner (the deadline context was
            # installed by worker_main around this task's execution)
            from ray_tpu_torch.runtime.context import current_deadline_ts

            inherited = current_deadline_ts()
            if inherited is not None:
                opts["_inherited_deadline_ts"] = inherited
        if num_returns != "streaming" and task_bin is not None:
            # Fire-and-forget fast path: mint the task id HERE (ids are
            # random-unique — ownership stays with the driver), send the
            # submit as a notification, and return locally-built refs.
            # One socket write instead of a full round trip per nested
            # submit (reference role: Ray workers own their submissions,
            # core_worker.cc SubmitTask is local).  A later rt.get blocks
            # until the owner has processed the ordered submit frame.
            from ray_tpu_torch.core.ids import ObjectID, TaskID

            task_id = TaskID.for_normal_task(TaskID(task_bin).job_id())
            return_ids = [
                ObjectID.for_task_return(task_id, i + 1) for i in range(num_returns)
            ]
            rid = next(self._rid)
            self._send(
                rid,
                _dumps(("submit_task_async",
                        {"func": func, "args": args, "kwargs": kwargs,
                         "task_id": task_id.binary(), **opts})),
                task_bin, "submit_task_async",
            )
            return self._mark_minted_refs(return_ids)
        return self._call("submit_task", func=func, args=args, kwargs=kwargs, **opts)

    def create_actor(self, cls, args, kwargs, **opts):
        return self._call("create_actor", cls=cls, args=args, kwargs=kwargs, **opts)

    def submit_actor_task(self, actor_id, method_name, args, kwargs, **opts):
        num_returns = opts.get("num_returns", 1)
        if isinstance(num_returns, int):
            # same fire-and-forget fast path as submit_task; actor-call
            # ORDER is preserved because async submits are processed inline
            # on the pool's reader thread, in frame order
            from ray_tpu_torch.core.ids import ObjectID, TaskID

            task_id = TaskID.for_actor_task(actor_id)
            return_ids = [
                ObjectID.for_task_return(task_id, i + 1) for i in range(num_returns)
            ]
            rid = next(self._rid)
            self._send(
                rid,
                _dumps(("submit_actor_task_async",
                        {"actor_id": actor_id, "method_name": method_name,
                         "args": args, "kwargs": kwargs,
                         "task_id": task_id.binary(), **opts})),
                self._current_task(), "submit_actor_task_async",
            )
            return self._mark_minted_refs(return_ids)
        return self._call(
            "submit_actor_task",
            actor_id=actor_id, method_name=method_name, args=args, kwargs=kwargs, **opts,
        )

    def release_refs(self, released: list) -> None:
        """Fire-and-forget: tell the owner the last local refs for these
        oids died — ``released`` is [(oid_binary, delivered_count), ...].
        No future is registered; the reply (if any) is discarded by
        on_reply."""
        rid = next(self._rid)
        self._send(rid, _dumps(("release_refs", {"released": released})), None, "release_refs")

    # -- cluster KV (collective rank registration from worker processes) ---
    def kv_put(self, key: bytes, value: bytes) -> None:
        self._call("kv_put", key=key, value=value)

    def kv_get(self, key: bytes) -> Optional[bytes]:
        return self._call("kv_get", key=key)

    def kv_del(self, key: bytes) -> None:
        self._call("kv_del", key=key)

    def get_async(self, ref):
        """Future-producing get (ObjectRef.future / await support)."""
        fut: Future = Future()

        def run():
            try:
                fut.set_result(self.get(ref))
            except BaseException as exc:  # noqa: BLE001
                fut.set_exception(exc)

        threading.Thread(target=run, name="worker-api-get", daemon=True).start()
        return fut
