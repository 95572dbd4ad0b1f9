"""Entry point for CPU worker processes.

The port's copy of ``ray_tpu/runtime/worker_main.py``.  The process hides
every CUDA device; torch is imported only if a task or a tensor argument
needs it.

Parity with the reference's ``python/ray/_private/workers/default_worker.py`` +
the worker ``main_loop`` (``worker.py:866``): connect back to the node's
worker pool, then loop executing tasks.  Functions arrive pickled once and are
cached by function id (FunctionManager parity); large array args/results move
through the native shm store, zero-copy on the read side.

Workers also host **actors**: an ``actor_create`` message instantiates the
class; subsequent ``actor_call`` messages run methods in receive order
(the pool serializes per-actor ordering — ActorSchedulingQueue parity).
Async actors run methods on an asyncio loop with ``max_concurrency``.
"""

from __future__ import annotations

import asyncio
import os
import pickle
import socket
import sys
import threading
import traceback
from typing import Optional

from ray_tpu_torch.core import serialization


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--addr", required=True)
    parser.add_argument("--shm", default="")
    args = parser.parse_args()

    # chaos: a RAY_TPU_FAILPOINTS spec exported on the driver (spawn passes
    # the environment through) arms the same failpoints in this worker
    from ray_tpu_torch.runtime import failpoints

    failpoints.arm_from_env()

    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        sock.connect(args.addr)
    except OSError:
        return  # pool already shut down (teardown race): exit quietly

    shm_store = None
    if args.shm:
        from ray_tpu_torch.native.shm_store import ShmObjectStore

        shm_store = ShmObjectStore(args.shm, create=False)

    try:
        Worker(sock, shm_store).run()
    except ConnectionError:
        return  # the pool closed its end before registration (teardown race)


class _TaskEnv:
    """Apply a per-TASK runtime_env (env_vars + profiling — the
    body-scoped plugins) around one execution and restore after.  The
    exec loop is single-threaded, so mutate-and-restore is race-free."""

    def __init__(self, runtime_env):
        self._env = runtime_env or {}
        self._saved: dict = {}

    def __enter__(self):
        changes = dict(self._env.get("env_vars") or {})
        prof = self._env.get("profiling")
        if prof:
            from ray_tpu_torch.runtime_env.plugin import PROFILE_DIR

            out_dir = prof.get("dir") if isinstance(prof, dict) else None
            out_dir = out_dir or PROFILE_DIR
            os.makedirs(out_dir, exist_ok=True)
            changes["RAY_TPU_TASK_PROFILING"] = out_dir
        for k, v in changes.items():
            self._saved[k] = os.environ.get(k)
            os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, old in self._saved.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
        return False


def _maybe_profile(name, task_id_bin, fn, args, kwargs, runtime_env=None, gpu_share=False):
    """cProfile wrapper for ProfilingPlugin; one getenv when off.  A task
    that holds a GPU share (``gpu_share``) first checks, under its env,
    that it sees the card."""
    with _TaskEnv(runtime_env):
        if gpu_share:
            refuse_without_card(name)
        if not os.environ.get("RAY_TPU_TASK_PROFILING"):
            return fn(*args, **kwargs)
        from ray_tpu_torch.runtime_env.plugin import maybe_profile

        hexid = task_id_bin.hex() if isinstance(task_id_bin, bytes) else str(task_id_bin)
        return maybe_profile(name, hexid, fn, args, kwargs)


def refuse_without_card(name: str) -> None:
    """Raise before a GPU-share task's body runs if this process does not
    see a CUDA device: its ``env_vars`` hide the card, or the host has none.
    Such a task runs in a worker spawned to see the card
    (``worker_pool.py``); it never runs on the CPU in the card's place."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None and visible.strip() in ("", "-1"):
        why = f"its environment hides the card (CUDA_VISIBLE_DEVICES={visible!r})"
    else:
        import torch

        if torch.cuda.is_available():
            return
        why = "no CUDA device is available"
    raise RuntimeError(
        f"task {name} holds a GPU share and {why}; a GPU task does not run on the CPU"
    )


def _format_stacks() -> str:
    from ray_tpu_torch.runtime.stack import format_thread_stacks

    return format_thread_stacks()


class _WorkerRefCounter:
    """Minimal per-process reference ledger for worker processes.

    Tracks live ObjectRef instances by oid, and separately how many of them
    were DELIVERED in api replies (counted during the reply unpickle via
    ``reply_capture``).  When an oid's instance count hits zero, the ledger
    queues ``(oid, delivered)`` and a daemon flusher sends a
    fire-and-forget ``release_refs`` frame to the owner, which decrements
    this worker's counted pin by exactly those deliveries
    (worker_api._pin_captured / _drop_pins) — so a release racing a reply
    that re-delivers the same oid can never strand a live ref.  Role
    parity: the reference's borrower protocol — a borrower reports to the
    owner when its local refs are gone (reference_count.h
    WaitForRefRemoved)."""

    _FLUSH_EVERY_S = 0.2
    _FLUSH_AT = 128

    def __init__(self, api_client):
        self._api = api_client
        self._counts: dict = {}
        self._delivered: dict = {}
        self._pending: list = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._capturing = threading.local()
        threading.Thread(target=self._flush_loop, name="worker-ref-flush", daemon=True).start()

    def reply_capture(self):
        """Context manager marking this thread's ObjectRef constructions as
        reply deliveries (owner-pinned)."""
        counter = self

        class _Cap:
            def __enter__(self):
                counter._capturing.active = True

            def __exit__(self, *exc):
                counter._capturing.active = False

        return _Cap()

    def add_local_reference(self, oid) -> None:
        with self._lock:
            self._counts[oid] = self._counts.get(oid, 0) + 1
            if getattr(self._capturing, "active", False):
                self._delivered[oid] = self._delivered.get(oid, 0) + 1

    def enqueue_local_ref_removal(self, oid) -> None:
        # called from __del__ — must stay allocation-light and never raise
        with self._lock:
            n = self._counts.get(oid, 0) - 1
            if n > 0:
                self._counts[oid] = n
                return
            self._counts.pop(oid, None)
            delivered = self._delivered.pop(oid, 0)
            self._pending.append((oid.binary(), delivered))
            if len(self._pending) >= self._FLUSH_AT:
                self._wake.set()

    def _flush_loop(self) -> None:
        while True:
            self._wake.wait(self._FLUSH_EVERY_S)
            self._wake.clear()
            with self._lock:
                batch, self._pending = self._pending, []
            if not batch:
                continue
            try:
                self._api.release_refs(batch)
            except Exception:  # noqa: BLE001 — pool gone: exit quietly
                return


class Worker:
    def __init__(self, sock: socket.socket, shm_store):
        import queue as _q

        from ray_tpu_torch.runtime import protocol

        self._protocol = protocol
        self._sock = sock
        self._shm = shm_store
        self._fn_cache: dict = {}
        self._actor = None
        self._actor_loop: asyncio.AbstractEventLoop | None = None
        self._send_lock = threading.Lock()
        self._put_counter = 0
        self._exec_queue: "_q.SimpleQueue" = _q.SimpleQueue()
        # per-THREAD current task: an async actor's loop thread must not
        # observe (and release resources for) the exec thread's task
        self._current = threading.local()
        self._api = None  # WorkerApiClient, installed lazily on first use
        self._flush_cv = None  # result flusher, started on first batch call
        self._flush_buf: list = []

    # ------------------------------------------------------------------
    def _install_api(self) -> None:
        """Make rt.get/put/wait/@remote work inside this worker: a
        WorkerApiClient (one round trip per call to the owner over the pool
        socket) becomes the process's global worker."""
        from ray_tpu_torch.runtime.worker import set_global_worker
        from ray_tpu_torch.runtime.worker_api import WorkerApiClient

        def send_request(rid: int, blob: bytes, task_id, op: str) -> None:
            self._reply(
                "api_request", {"rid": rid, "blob": blob, "task_id": task_id, "op": op}
            )

        self._api = WorkerApiClient(
            send_request, lambda: getattr(self._current, "task", None),
            shm_store=self._shm, shm_id_factory=self._next_shm_id,
        )
        set_global_worker(self._api)
        # Worker-side reference counting: when the last local ObjectRef for
        # an oid dies, tell the owner so it can drop this worker's pin
        # (without this, every ref a worker ever held stays pinned for the
        # job's lifetime and bulk put churn fills the arena forever).
        from ray_tpu_torch.core.object_ref import hooks

        hooks.ref_counter = _WorkerRefCounter(self._api)

    def run(self) -> None:
        p = self._protocol
        p.send_msg(self._sock, "register", {"pid": os.getpid()})
        self._install_api()
        # Execution runs on the MAIN thread; the socket reader gets its own
        # thread so api_reply frames still arrive while a task blocks in a
        # nested rt.get (single exec thread: one task at a time, actor-call
        # order preserved — ActorSchedulingQueue parity as before).
        # Main-thread exec matters for throughput: glibc serves a non-main
        # thread's >64 MB allocations by mmap/munmap regardless of
        # MALLOC_MMAP_THRESHOLD_ (per-thread heaps cap at HEAP_MAX_SIZE), so
        # a task allocating a bulk array every call would page-fault the
        # whole buffer in each time; the main arena reuses its top chunk.
        reader_thread = threading.Thread(
            target=self._reader_loop, name="worker-reader", daemon=True
        )
        reader_thread.start()
        self._exec_loop()

    def _reader_loop(self) -> None:
        p = self._protocol
        reader = p.FrameReader(self._sock)
        while True:
            try:
                msg_type, payload = reader.recv()
            except (ConnectionError, ValueError):
                # ValueError = corrupt frame header; treat as a lost pool
                break
            if msg_type == "shutdown":
                break
            if msg_type == "api_reply":
                self._api.on_reply(payload["rid"], payload["blob"])
            elif msg_type == "dump_stacks":
                # READER thread: must answer even when the exec thread is
                # wedged — that is the whole point of `rt stack`
                self._reply(
                    "stacks_reply",
                    {"token": payload.get("token"), "stacks": _format_stacks()},
                )
            elif msg_type == "fail_group":
                # handled on the READER thread: the exec thread may be the
                # one blocked inside the collective wait being failed
                from ray_tpu_torch.runtime import p2p

                for g in payload["groups"]:
                    p2p.fail_group(g, payload["reason"])
            else:
                self._exec_queue.put((msg_type, payload))
        self._exec_queue.put(None)
        if self._api is not None:
            self._api.fail_all(ConnectionError("worker pool connection closed"))
        if self._shm is not None:
            self._shm.close()

    def _exec_loop(self) -> None:
        while True:
            item = self._exec_queue.get()
            if item is None:
                return
            msg_type, payload = item
            if msg_type == "exec":
                self._handle_exec(payload)
            elif msg_type == "actor_create":
                self._handle_actor_create(payload)
            elif msg_type == "actor_call":
                self._handle_actor_call(payload)
            elif msg_type == "actor_call_batch":
                # k calls in ONE IPC frame; each result is handed to the
                # flusher thread which sends AS SOON AS IT CAN, naturally
                # coalescing into result_batch frames while the exec thread
                # keeps running.  Results are never withheld — a call whose
                # completion the driver must observe before a later call can
                # proceed (external coordination) still flows immediately.
                for call in payload["calls"]:
                    self._handle_actor_call(call, collect=self._emit_result)
            elif msg_type == "ping":
                self._reply("pong", {})

    def _reply(self, msg_type: str, payload: dict) -> None:
        with self._send_lock:
            self._protocol.send_msg(self._sock, msg_type, payload)

    def _next_shm_id(self) -> bytes:
        self._put_counter += 1
        return os.urandom(16) + self._put_counter.to_bytes(4, "little")

    # ------------------------------------------------------------------
    def _get_function(self, payload: dict):
        fn_id = payload["fn_id"]
        fn = self._fn_cache.get(fn_id)
        if fn is None:
            fn = pickle.loads(payload["fn_blob"])
            self._fn_cache[fn_id] = fn
        return fn

    def _decode_args(self, payload: dict):
        args, kwargs = pickle.loads(payload["args_blob"])
        p = self._protocol
        args = tuple(p.decode_value(a, self._shm) for a in args)
        kwargs = {k: p.decode_value(v, self._shm) for k, v in kwargs.items()}
        return args, kwargs

    def _encode_result(self, value):
        p = self._protocol
        encoded = p.encode_value(value, self._shm, self._next_shm_id)
        try:
            return serialization.dumps(encoded)
        except (AttributeError, TypeError, pickle.PicklingError):
            # results can carry closures (e.g. a workflow continuation DAG
            # returned from a step) — same fallback policy as dumps_value
            return serialization.dumps_by_value(encoded)

    def _push_task_context(self, task_id: bytes):
        """Worker-side task context: TaskIDs are lineage-embedded (actor
        tasks carry their ActorID), so pushing the id here makes
        ``get_runtime_context()`` and the declarative collective-rank
        inference (util/collective._rank_from_actor_context) work inside
        process workers exactly as they do in-process."""
        from ray_tpu_torch.core.ids import NodeID, TaskID
        from ray_tpu_torch.runtime.context import task_context

        try:
            return task_context, task_context.push(TaskID(task_id), NodeID.nil())
        except Exception:  # noqa: BLE001 — opaque ids: context stays unset
            return task_context, None

    def _handle_exec(self, payload: dict) -> None:
        import time

        from ray_tpu_torch.observability import tracing

        task_id = payload["task_id"]
        name = payload.get("name", "task")
        self._current.task = task_id
        ctx, token = self._push_task_context(task_id)
        # end-to-end deadline: installed around execution so nested
        # submissions from inside the task inherit the remaining budget
        from ray_tpu_torch.runtime.context import pop_deadline, push_deadline

        dtoken = push_deadline(payload.get("deadline_ts"))
        try:
            fn = self._get_function(payload)
            args, kwargs = self._decode_args(payload)
            t0 = time.perf_counter()
            # adopt the driver's propagated trace context: the execute span
            # (and any spans the task body opens) parent to the task span
            # minted at .remote() time in the submitting process
            with tracing.task_span(f"execute::{name}", payload.get("trace")):
                result = _maybe_profile(
                    name, task_id, fn, args, kwargs,
                    runtime_env=payload.get("runtime_env"),
                    gpu_share=payload.get("gpu_share", False),
                )
            exec_s = time.perf_counter() - t0
            reply = {"task_id": task_id, "value_blob": self._encode_result(result), "exec_s": exec_s}
            spans = tracing.drain_span_events()
            if spans:
                reply["spans"] = spans
            self._reply("result", reply)
        except BaseException as exc:  # noqa: BLE001 — task errors become objects
            reply = {
                "task_id": task_id,
                "error_blob": pickle.dumps(_make_task_error(name, exc)),
            }
            spans = tracing.drain_span_events()
            if spans:
                reply["spans"] = spans
            self._reply("result", reply)
        finally:
            pop_deadline(dtoken)
            self._current.task = None
            if token is not None:
                ctx.pop(token)

    # ------------------------------------------------------------------
    def _handle_actor_create(self, payload: dict) -> None:
        task_id = payload["task_id"]
        try:
            cls = self._get_function(payload)
            args, kwargs = self._decode_args(payload)
            self._actor = cls(*args, **kwargs)
            max_concurrency = payload.get("max_concurrency", 1)
            if _has_async_methods(cls) or max_concurrency > 1:
                self._start_actor_loop()
            self._reply("result", {"task_id": task_id, "value_blob": pickle.dumps(None)})
        except BaseException as exc:  # noqa: BLE001
            self._reply(
                "result",
                {"task_id": task_id, "error_blob": pickle.dumps(_make_task_error(payload.get("name", "actor.__init__"), exc))},
            )

    def _emit_result(self, result_payload: dict) -> None:
        """Queue a result for the flusher thread: it drains whatever has
        accumulated into ONE result_batch frame per send — syscall
        amortization under burst with zero added latency when idle."""
        if self._flush_cv is None:
            import threading as _t

            self._flush_cv = _t.Condition()
            # rt-lint: disable=lock-discipline -- lazy init, single-threaded:
            # only the worker's task loop calls _emit_result, and the buffer
            # exists before the flusher thread it hands off to starts
            self._flush_buf = []
            _t.Thread(target=self._flush_loop, name="result-flush", daemon=True).start()
        with self._flush_cv:
            self._flush_buf.append(result_payload)
            self._flush_cv.notify()

    def _flush_loop(self) -> None:
        while True:
            with self._flush_cv:
                while not self._flush_buf:
                    self._flush_cv.wait()
                batch, self._flush_buf = self._flush_buf, []
            if len(batch) == 1:
                self._reply("result", batch[0])
            else:
                self._reply("result_batch", {"results": batch})

    def _handle_actor_call(self, payload: dict, collect=None) -> None:
        from ray_tpu_torch.observability import tracing

        task_id = payload["task_id"]
        method_name = payload["method"]
        trace = payload.get("trace")

        def emit(result_payload: dict) -> None:
            spans = tracing.drain_span_events()
            if spans:
                result_payload["spans"] = spans
            if collect is not None:
                collect(result_payload)
            else:
                self._reply("result", result_payload)

        try:
            method = getattr(self._actor, method_name)
            args, kwargs = self._decode_args(payload)
            if asyncio.iscoroutinefunction(method) and self._actor_loop is not None:
                # async actors: schedule on the loop, reply on completion
                # (never coalesced — completion order is the loop's).
                # The task context is pushed INSIDE the coroutine: each
                # asyncio Task runs in its own contextvars copy, so
                # interleaved methods keep their own task ids.
                async def _run_with_context():
                    ctx, token = self._push_task_context(task_id)
                    try:
                        with tracing.task_span(f"execute::{method_name}", trace):
                            return await method(*args, **kwargs)
                    finally:
                        if token is not None:
                            ctx.pop(token)

                fut = asyncio.run_coroutine_threadsafe(_run_with_context(), self._actor_loop)

                def done(f):
                    try:
                        self._reply("result", {"task_id": task_id, "value_blob": self._encode_result(f.result())})
                    except BaseException as exc:  # noqa: BLE001
                        self._reply("result", {"task_id": task_id, "error_blob": pickle.dumps(_make_task_error(method_name, exc))})

                fut.add_done_callback(done)
                return
            self._current.task = task_id
            ctx, token = self._push_task_context(task_id)
            try:
                with tracing.task_span(f"execute::{method_name}", trace):
                    result = _maybe_profile(method_name, task_id, method, args, kwargs)
            finally:
                self._current.task = None
                if token is not None:
                    ctx.pop(token)
            emit({"task_id": task_id, "value_blob": self._encode_result(result)})
        except BaseException as exc:  # noqa: BLE001
            emit({"task_id": task_id, "error_blob": pickle.dumps(_make_task_error(method_name, exc))})

    def _start_actor_loop(self) -> None:
        loop = asyncio.new_event_loop()
        self._actor_loop = loop
        threading.Thread(target=loop.run_forever, name="actor-asyncio", daemon=True).start()


def _has_async_methods(cls) -> bool:
    return any(asyncio.iscoroutinefunction(getattr(cls, n, None)) for n in dir(cls) if not n.startswith("__"))


def _make_task_error(name: str, exc: BaseException):
    from ray_tpu_torch.exceptions import RayTaskError

    if isinstance(exc, RayTaskError):
        return exc
    tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
    return RayTaskError(name, tb, exc)


if __name__ == "__main__":
    main()
