"""Process worker pool.

The port's copy of ``ray_tpu/runtime/worker_pool.py``.  Workers start as
``python -S -m ray_tpu_torch.runtime.worker_main`` with the driver's
``sys.path`` and ``CUDA_VISIBLE_DEVICES=""``: they never touch the card.
The exceptions hold a GPU share: a process actor (a ``TorchTrainer`` rank
on the card), and a task with a ``runtime_env`` (which must run in a
process worker, where the env applies).  Each gets a fresh worker of its
own that keeps the driver's ``CUDA_VISIBLE_DEVICES``, spawned like every
worker, never forked; the task's worker is retired when the task ends, and
checks before the body runs that it sees the card
(``worker_main.refuse_without_card``).  The spawn environment is the one
place that decides.

Parity with the reference's ``WorkerPool`` (``src/ray/raylet/worker_pool.h:159``):
spawns Python worker processes, prestarts a warm pool, hands idle workers to
dispatched tasks, reaps idle workers past a cap, and dedicates workers to
actors.  Transport is a unix socket per worker carrying framed pickle control
messages; bulk arrays ride the native shm store (zero-copy reads worker-side).

Sync-actor ordering: messages to one worker are written in submission order
and the worker executes them sequentially off one socket — this IS the
ActorSchedulingQueue (``transport/actor_scheduling_queue``): ordering falls
out of the transport instead of sequence numbers, because a single host needs
no reordering layer.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.sync import join_threads
from ray_tpu_torch.exceptions import WorkerCrashedError
from ray_tpu_torch.observability import metric_defs, tracing
from ray_tpu_torch.runtime import failpoints, protocol

# prebuilt gauge tag dicts (hot-path allocations)
_IDLE_TAGS = {"state": "idle"}
_BUSY_TAGS = {"state": "busy"}


class WorkerHandle:
    def __init__(self, sock: socket.socket, proc: subprocess.Popen, pid: int):
        self.sock = sock
        self.proc = proc
        self.pid = pid
        self.known_fns: set = set()
        self.dedicated = False      # owned by an actor
        self.lease_key = None       # pinned to a worker lease's task shape
        self.lease_busy = False     # leased worker currently executing
        self.alive = True
        # set once the death handler has finished notifying (actor FSM
        # updated); orphaned-callback paths sequence behind it
        self.death_done = threading.Event()
        self.last_idle_time = time.monotonic()
        self.send_lock = threading.Lock()
        # outbound coalescing (see ProcessWorkerPool._sender_loop): a tight
        # async submit loop naturally accumulates frames while the sender
        # writes, so runs of actor calls collapse into actor_call_batch
        # frames — the submit-side mirror of the worker's result flusher
        self.send_cv = threading.Condition()
        self.sendq: deque = deque()
        self.sender_started = False

    def send(self, msg_type: str, payload: dict) -> None:
        with self.send_lock:
            protocol.send_msg(self.sock, msg_type, payload)


class _DirectSlot:
    """Handoff cell for a sync waiter: the reader thread parks the raw
    result payload here and wakes the waiter, which unpickles and runs the
    commit chain on its own thread. Halves the reader's GIL-holding window,
    so the waiter wakes ~30us sooner on the sync round-trip path."""

    __slots__ = ("event", "payload", "callback")

    def __init__(self):
        self.event = threading.Event()
        self.payload: Optional[dict] = None
        self.callback: Optional[Callable] = None

    def run(self) -> None:
        payload, callback = self.payload, self.callback
        if payload is None or callback is None:
            return
        try:
            if "error_blob" in payload:
                callback(None, pickle.loads(payload["error_blob"]), payload.get("exec_s"))
            else:
                callback(pickle.loads(payload["value_blob"]), None, payload.get("exec_s"))
        except BaseException as exc:  # noqa: BLE001
            try:
                callback(None, exc, None)
            except BaseException:
                pass


class ProcessWorkerPool:
    def __init__(self, shm_name: str = "", max_workers: int = 0, session_dir: str = "/tmp"):
        cfg = get_config()
        self._shm_name = shm_name
        self._max_workers = max_workers or (os.cpu_count() or 4)
        self._idle_cap = cfg.idle_worker_cap
        # timeout reaping never shrinks the pool below the prestarted warm
        # set the operator asked for (prestart() raises the floor)
        self._prestart_floor = 0
        self._lock = threading.RLock()
        # every thread the pool starts, joined (bounded) by shutdown: a
        # per-worker thread still unwinding would hold the pool, and through
        # its handlers the node and the cluster, past the runtime's shutdown
        self._threads: list = []
        self._threads_lock = threading.Lock()  # a leaf lock: taken under any other
        self._idle: deque[WorkerHandle] = deque()
        self._backlog: deque = deque()
        self._all: Dict[int, WorkerHandle] = {}
        self._inflight: Dict[bytes, Callable[[Any, Optional[BaseException]], None]] = {}
        self._inflight_worker: Dict[bytes, WorkerHandle] = {}
        self._inflight_start: Dict[bytes, float] = {}
        # worker-lease pins: lease key (fn id) -> warm worker reserved for
        # that task shape.  Pinned workers skip the idle-deque churn on the
        # leased dispatch path, never reap while the lease is live, and
        # return to the pool on lease expiry/revocation (unpin_lease) or
        # after sitting idle past the lease timeout (stale-pin sweep).
        self._lease_pins: Dict[bytes, WorkerHandle] = {}
        self._direct: Dict[bytes, _DirectSlot] = {}   # sync waiters by task id
        self._stack_waiters: Dict[str, dict] = {}     # dump_stacks tokens
        self._on_worker_death: Optional[Callable[[WorkerHandle], None]] = None
        self._listen_path = os.path.join(session_dir, f"rt_pool_{os.getpid()}_{id(self):x}.sock")
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self._listen_path)
        self._listener.listen(128)
        # a one-way latch, set under _spawn_cv; readers elsewhere only need
        # to see it eventually, so they read the event without a lock
        self._stopped = threading.Event()
        self._spawning = 0           # spawns in flight (async growth)
        # every spawn in flight (prestart, growth, actors): shutdown waits
        # for them, so no worker process outlives it
        self._spawns_in_flight = 0
        self._spawn_cv = threading.Condition()
        self._spawn_lock = threading.Lock()  # serializes listener.accept
        # Advertised to workers at spawn so their lazy p2p endpoints carry a
        # dialable host: data_ip = this node's reachable IP (agents set it
        # from the head connection), head_ip = the head's IP as seen from
        # this node (wildcard-address rewrites in processes with no head
        # connection of their own).  Empty on head-host pools: loopback /
        # peer-side rewrite is correct there.
        self.data_ip: str = ""
        self.head_ip: str = ""
        # hosting node id (hex) — workers publish it beside collective rank
        # registrations so node-death notices can find their groups
        self.node_hex: str = ""

    # ------------------------------------------------------------------
    def set_on_worker_death(self, cb: Callable[[WorkerHandle], None]) -> None:
        self._on_worker_death = cb

    def prestart(self, count: int) -> None:
        self._prestart_floor = max(self._prestart_floor, count)
        for _ in range(count):
            try:
                self._spawn()
            except failpoints.FailpointInjected:
                continue  # chaos: prestart is best-effort warm-up — demand
                # growth recovers; a thread-crash traceback here reads as a
                # real failure
            except (RuntimeError, OSError):
                if self._stopped.is_set():
                    return  # pool torn down mid-prestart: stand down quietly
                raise

    def _spawn(self, to_idle: bool = True, sees_card: bool = False) -> WorkerHandle:
        with self._spawn_cv:
            if self._stopped.is_set():
                raise RuntimeError("pool shut down")
            self._spawns_in_flight += 1
        try:
            return self._spawn_worker(to_idle, sees_card)
        finally:
            with self._spawn_cv:
                self._spawns_in_flight -= 1
                self._spawn_cv.notify_all()

    def _spawn_worker(self, to_idle: bool, sees_card: bool = False) -> WorkerHandle:
        chaos_kill = False
        if failpoints.ARMED:
            # chaos: "raise" fails the spawn outright (the growth/backlog
            # machinery owns recovery); "kill" lets the worker register and
            # then kills it — an early worker crash, surfaced through the
            # normal death handling on first contact
            action = failpoints.fp("worker_pool.spawn")
            if action == "kill":
                chaos_kill = True
            elif action is not None:
                raise RuntimeError(f"failpoint worker_pool.spawn: {action}")
        # Hand the child the driver's full sys.path and start it with -S:
        # site processing re-runs any sitecustomize, which can initialize a
        # device runtime — seconds of CPU burned per worker and (on small
        # hosts) stolen from the driver. The explicit path covers
        # site-packages and the repo, so torch and this package resolve.
        import ray_tpu_torch

        pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(ray_tpu_torch.__file__)))
        paths = [pkg_parent] + [p for p in sys.path if p]
        seen: set = set()
        pythonpath = os.pathsep.join(
            p for p in paths if not (p in seen or seen.add(p))
        )
        with self._spawn_lock:
            proc = subprocess.Popen(
                [sys.executable, "-S", "-m", "ray_tpu_torch.runtime.worker_main", "--addr", self._listen_path]
                + (["--shm", self._shm_name] if self._shm_name else []),
                env={
                    **os.environ,
                    # workers never touch the card: torch in a worker sees
                    # no CUDA device and creates no CUDA context (a GPU
                    # process actor's worker keeps the driver's devices)
                    **({} if sees_card else {"CUDA_VISIBLE_DEVICES": ""}),
                    "PYTHONPATH": pythonpath,
                    # pipes are block-buffered; prints must reach the driver live
                    "PYTHONUNBUFFERED": "1",
                    # Keep glibc from mmap'ing (and on free, munmap'ing)
                    # bulk allocations: a task allocating a few-hundred-MB
                    # array every call would otherwise page-fault the full
                    # buffer in each time (~5x slower than reused hot
                    # pages). Users can override either knob.
                    "MALLOC_MMAP_THRESHOLD_": os.environ.get(
                        "MALLOC_MMAP_THRESHOLD_", str(512 * 1024 * 1024)
                    ),
                    "MALLOC_TRIM_THRESHOLD_": os.environ.get(
                        "MALLOC_TRIM_THRESHOLD_", str(512 * 1024 * 1024)
                    ),
                    **({"RT_DATA_IP": self.data_ip} if self.data_ip else {}),
                    **({"RT_HEAD_IP": self.head_ip} if self.head_ip else {}),
                    **({"RT_NODE_ID": self.node_hex} if self.node_hex else {}),
                },
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
                errors="replace",
            )
            # Stream worker output to the driver with a pid prefix (parity:
            # log_monitor.py tailing worker logs into the driver, the
            # "(pid=...)" lines) — user prints inside tasks stay visible.
            self._start_thread(self._pump_logs, f"worker-logs-{proc.pid}", proc)
            try:
                self._listener.settimeout(30.0)
                sock, _ = self._listener.accept()
            except (socket.timeout, OSError):
                proc.kill()
                proc.wait()  # reaped: a killed child leaves no zombie
                if self._stopped.is_set():
                    raise RuntimeError("pool shut down during worker spawn")
                raise RuntimeError("worker process failed to register within 30s")
            finally:
                try:
                    self._listener.settimeout(None)
                except OSError:
                    pass
        msg_type, payload = protocol.recv_msg(sock)
        assert msg_type == "register", msg_type
        handle = WorkerHandle(sock, proc, payload["pid"])
        with self._lock:
            # a spawn that registers after shutdown took its snapshot of
            # _all would never be killed: it stands down here instead
            # (shutdown sets the flag before it takes this lock)
            stale = self._stopped.is_set()
            if not stale:
                self._all[handle.pid] = handle
                if to_idle:
                    self._idle.append(handle)
        if stale:
            proc.kill()
            proc.wait()
            sock.close()
            raise RuntimeError("pool shut down during worker spawn")
        metric_defs.WORKER_POOL_SPAWNED.inc()
        self._update_worker_gauges()
        self._watch_worker(handle)
        if chaos_kill:
            try:
                proc.kill()
            except OSError:
                pass
        return handle

    def _update_worker_gauges(self) -> None:
        # racy reads on purpose: gauges are approximate and the counts are
        # plain len()s — no lock needed on this path
        idle = len(self._idle)
        total = len(self._all)
        metric_defs.WORKER_POOL_WORKERS.set(idle, _IDLE_TAGS)
        metric_defs.WORKER_POOL_WORKERS.set(max(0, total - idle), _BUSY_TAGS)

    #: optional redirect for worker log lines (fn(line_with_prefix)); node
    #: agents point this at the head connection so task prints land on the
    #: DRIVER's stderr across hosts (log_monitor-to-driver parity)
    log_sink: Optional[Callable[[str], None]] = None

    def _start_thread(self, target: Callable, name: str, *args) -> None:
        t = threading.Thread(target=target, args=args, name=name, daemon=True)
        with self._threads_lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
        t.start()

    def _pump_logs(self, proc: subprocess.Popen) -> None:
        # merged worker stdout+stderr goes to the DRIVER'S STDERR (reference
        # log_monitor behavior): parsed driver stdout stays clean, and the
        # pump must never die early or the 64KB pipe fills and blocks the
        # worker mid-task (decode errors are already 'replace'd).
        try:
            for line in proc.stdout:
                sink = self.log_sink
                if sink is not None:
                    try:
                        sink(f"(worker pid={proc.pid}) {line.rstrip()}")
                        continue
                    except Exception:  # noqa: BLE001 — fall back to local stderr
                        pass
                sys.stderr.write(f"(worker pid={proc.pid}) {line}")
                sys.stderr.flush()
        except (ValueError, OSError):
            pass  # stream closed at shutdown

    def _maybe_grow_async(self) -> None:
        """Spawn a worker on a background thread when the backlog has work
        and the pool is under its cap. Submitting threads never block on the
        ~200ms child-interpreter startup."""
        with self._lock:
            if self._stopped.is_set() or not self._backlog:
                return
            shared = sum(1 for w in self._all.values() if w.alive and not w.dedicated)
            if shared + self._spawning >= self._max_workers or self._spawning >= len(self._backlog):
                return
            self._spawning += 1
        self._start_thread(self._grow_one, "pool-spawner")

    def _grow_one(self) -> None:
        try:
            worker = self._spawn(to_idle=False)
        except Exception as exc:
            failed = []
            with self._lock:
                self._spawning -= 1
                # If no worker can ever pick the backlog up, fail it now —
                # swallowing the spawn error would leave getters hanging.
                alive = any(w.alive and not w.dedicated for w in self._all.values())
                if not alive and self._spawning == 0 and not self._stopped.is_set():
                    while self._backlog:
                        failed.append(self._backlog.popleft())
            for item in failed:
                callback = item[5]  # (task_id, name, fn_id, fn_blob, args_blob, callback, runtime_env, trace)
                try:
                    callback(None, WorkerCrashedError(f"worker spawn failed: {exc}"), None)
                except BaseException:
                    pass
            return
        with self._lock:
            self._spawning -= 1
        self._release_worker(worker)
        self._maybe_grow_async()

    # ------------------------------------------------------------------
    def _acquire_idle(self) -> Optional[WorkerHandle]:
        with self._lock:
            while self._idle:
                # LIFO: reuse the most recently released worker so a sync
                # submit loop keeps hitting one hot process (warm caches,
                # fn already known) instead of rotating through the pool
                w = self._idle.pop()
                if w.alive:
                    return w
        return None

    def _acquire_worker(self) -> Optional[WorkerHandle]:
        """Idle worker, or a blocking spawn (actor allocation path only)."""
        worker = self._acquire_idle()
        if worker is not None:
            return worker
        with self._lock:
            # Dedicated (actor-owned) workers don't count against the
            # stateless-task cap, or actors would starve normal tasks.
            shared = sum(1 for w in self._all.values() if w.alive and not w.dedicated)
            if shared + self._spawning >= self._max_workers:
                return None
        return self._spawn(to_idle=False)

    def _release_worker(self, worker: WorkerHandle) -> None:
        backlog_item = None
        with self._lock:
            if worker.alive and not worker.dedicated:
                if self._backlog:
                    # pinned or not, an idle process serves waiting work —
                    # a lease reserves warmth, never capacity
                    backlog_item = self._backlog.popleft()
                elif worker.lease_key is not None:
                    # stays pinned to its lease: not reapable, instantly
                    # reusable by the next leased dispatch of the shape
                    worker.lease_busy = False
                    worker.last_idle_time = time.monotonic()
                    self._unpin_stale_locked()
                else:
                    worker.last_idle_time = time.monotonic()
                    self._idle.append(worker)
                    self._maybe_reap_locked()
        self._update_worker_gauges()
        if backlog_item is not None:
            self._send_exec(worker, *backlog_item)

    def _maybe_reap_locked(self) -> None:
        while len(self._idle) > self._idle_cap:
            w = self._idle.popleft()
            self._kill_worker(w)
        # idle-timeout reaping (idle_worker_timeout_s; 0 disables): the
        # deque is ordered by idle-entry time (appends stamp last_idle_time,
        # reuse pops from the right), so the coldest worker is leftmost
        timeout = get_config().idle_worker_timeout_s
        if timeout <= 0:
            return
        cutoff = time.monotonic() - timeout
        while (
            len(self._idle) > self._prestart_floor
            and self._idle[0].last_idle_time < cutoff
        ):
            w = self._idle.popleft()
            self._kill_worker(w)

    # -- worker-lease pins ----------------------------------------------
    def _take_lease_worker(self, lease_key: bytes) -> Optional[WorkerHandle]:
        """The pinned worker for this shape if it is free — pinning one
        from the idle set on first use.  None falls back to the normal
        acquire/backlog path (pinned-but-busy, or nothing idle to pin)."""
        with self._lock:
            worker = self._lease_pins.get(lease_key)
            if worker is not None:
                if not worker.alive:
                    del self._lease_pins[lease_key]
                elif not worker.lease_busy:
                    worker.lease_busy = True
                    return worker
                return None  # busy: overflow onto the shared pool
            while self._idle:
                cand = self._idle.pop()
                if cand.alive:
                    cand.lease_key = lease_key
                    cand.lease_busy = True
                    self._lease_pins[lease_key] = cand
                    return cand
        return None

    def _steal_free_pin_locked(self) -> Optional[WorkerHandle]:
        """Unpin and return any free lease-pinned worker.  A pin reserves
        WARMTH, never capacity: when the shared pool is exhausted and work
        would otherwise backlog behind idle-but-pinned processes (the
        many-shapes deadlock — every worker pinned, none ever completing
        anything again), the pin loses."""
        for key, worker in list(self._lease_pins.items()):
            if worker.alive and not worker.lease_busy:
                del self._lease_pins[key]
                worker.lease_key = None
                return worker
        return None

    def unpin_lease(self, lease_key: bytes) -> None:
        """Lease returned/revoked: the pinned worker rejoins the idle set
        (normal idle reaping applies again)."""
        with self._lock:
            worker = self._lease_pins.pop(lease_key, None)
            if worker is None or not worker.alive:
                return
            worker.lease_key = None
            if not worker.lease_busy:
                worker.last_idle_time = time.monotonic()
                self._idle.append(worker)
                self._maybe_reap_locked()
            # busy: _release_worker routes it to the idle set on completion
        self._update_worker_gauges()

    def sweep_stale_pins(self) -> None:
        """Periodic entry point (agent report loop): on remote agents the
        head's lease expiry only reaches a no-op pool stub, and the
        release-time sweep can't see its OWN pin as stale — without this a
        pinned worker whose shape went quiet stays out of the idle set
        (and out of reaping) forever."""
        with self._lock:
            self._unpin_stale_locked()
            # also the periodic trigger for idle-timeout reaping: without
            # it a pool that goes fully quiet never revisits the deque
            self._maybe_reap_locked()
        self._update_worker_gauges()

    def _unpin_stale_locked(self) -> None:
        """Agent-side safety net (no head LeaseManager runs here): pins
        whose worker sat idle past the lease timeout return to the pool."""
        if not self._lease_pins:
            return
        cutoff = time.monotonic() - get_config().lease_idle_timeout_s
        for key, worker in list(self._lease_pins.items()):
            if not worker.lease_busy and worker.last_idle_time < cutoff:
                del self._lease_pins[key]
                worker.lease_key = None
                if worker.alive:
                    self._idle.append(worker)
        self._maybe_reap_locked()

    # ------------------------------------------------------------------
    def submit(
        self,
        task_id: bytes,
        name: str,
        fn_id: bytes,
        fn_blob: bytes,
        args_blob: bytes,
        callback: Callable[[Any, Optional[BaseException]], None],
        runtime_env: Optional[dict] = None,
        trace: Optional[tuple] = None,
        lease_key: Optional[bytes] = None,
        deadline_ts: Optional[float] = None,
        sees_card: bool = False,
    ) -> bool:
        """Run a stateless task on an idle worker; queues when saturated.
        Never blocks: pool growth happens on a spawner thread.  A task that
        must see the card (``sees_card``) gets a worker of its own, spawned
        on a thread and retired after the task."""
        metric_defs.WORKER_POOL_TASKS.inc()
        if sees_card:
            self._start_thread(
                self._run_card_task, f"card-task-{task_id.hex()[:8]}",
                task_id, name, fn_id, fn_blob, args_blob, callback, runtime_env, trace,
                deadline_ts,
            )
            return True
        worker = None
        if lease_key is not None:
            worker = self._take_lease_worker(lease_key)
        if worker is None:
            worker = self._acquire_idle()
        if worker is None:
            # nothing idle: a FREE pinned worker serves rather than letting
            # this task backlog behind processes that may never run again
            with self._lock:
                worker = self._steal_free_pin_locked()
        if worker is None:
            with self._lock:
                self._backlog.append(
                    (task_id, name, fn_id, fn_blob, args_blob, callback,
                     runtime_env, trace, deadline_ts)
                )
            self._maybe_grow_async()
            return True
        self._send_exec(
            worker, task_id, name, fn_id, fn_blob, args_blob, callback,
            runtime_env, trace, deadline_ts,
        )
        return True

    def _run_card_task(self, task_id, name, fn_id, fn_blob, args_blob, callback,
                       runtime_env, trace, deadline_ts) -> None:
        """One GPU-share task on a fresh worker that sees the card; the
        worker is killed once the task's result (or error) is delivered."""
        try:
            worker = self._spawn(to_idle=False, sees_card=True)
        except RuntimeError as exc:
            callback(None, WorkerCrashedError(f"worker spawn failed: {exc}"), None)
            return
        worker.dedicated = True

        def retire(*result):
            try:
                callback(*result)
            finally:
                self._kill_worker(worker)

        self._send_exec(worker, task_id, name, fn_id, fn_blob, args_blob, retire,
                        runtime_env, trace, deadline_ts, gpu_share=True)

    def _send_exec(self, worker, task_id, name, fn_id, fn_blob, args_blob, callback,
                   runtime_env: Optional[dict] = None, trace: Optional[tuple] = None,
                   deadline_ts: Optional[float] = None, gpu_share: bool = False) -> None:
        payload = {"task_id": task_id, "name": name, "fn_id": fn_id, "args_blob": args_blob}
        if gpu_share:
            payload["gpu_share"] = True
        if trace is not None:
            payload["trace"] = trace
        if deadline_ts is not None:
            # the worker re-installs the deadline around execution so
            # nested submissions inherit the remaining budget
            payload["deadline_ts"] = deadline_ts
        if runtime_env:
            # per-TASK runtime env: only the body-scoped keys travel —
            # process-level plugins (pip, conda, container, working_dir)
            # need a job/worker scope and stay job-level
            body_env = {k: runtime_env[k] for k in ("env_vars", "profiling") if k in runtime_env}
            if body_env:
                payload["runtime_env"] = body_env
        if fn_id not in worker.known_fns:
            payload["fn_blob"] = fn_blob
            worker.known_fns.add(fn_id)
        with self._lock:
            self._inflight[task_id] = callback
            self._inflight_worker[task_id] = worker
            self._inflight_start[task_id] = time.time()
        try:
            worker.send("exec", payload)
        except OSError:
            self._handle_worker_death(worker)

    # -- actors ---------------------------------------------------------
    def allocate_actor_worker(self, sees_card: bool = False) -> Optional[WorkerHandle]:
        """Dedicate a worker to an actor; spawns beyond the stateless-task
        cap if needed (dedicated workers don't count against it — actor
        concurrency is limited by actor resources, not pool size).  An actor
        that holds a GPU share (``sees_card``) gets a fresh worker that sees
        the card."""
        worker = None if sees_card else self._acquire_worker()
        if worker is None:
            worker = self._spawn(to_idle=False, sees_card=sees_card)
        worker.dedicated = True
        return worker

    def submit_to_worker(
        self,
        worker: WorkerHandle,
        msg_type: str,
        task_id: bytes,
        payload: dict,
        callback: Callable[[Any, Optional[BaseException]], None],
        fn_blob: Optional[bytes] = None,
        fn_id: Optional[bytes] = None,
    ) -> None:
        if not worker.alive:
            # The worker died and its death was already handled: a late
            # submission must fail fast, not register a callback nobody will
            # ever drain (reachable when an actor call races the worker's
            # death notification).  Deferred to a fresh thread: the caller
            # may hold the per-actor queue lock, and the error path re-enters
            # the queue pump (synchronous delivery self-deadlocks).
            _defer_error(callback, WorkerCrashedError(f"worker {worker.pid} is dead"), after=worker.death_done)
            return
        payload = dict(payload)
        payload["task_id"] = task_id
        if fn_id is not None:
            payload["fn_id"] = fn_id
            if fn_id not in worker.known_fns and fn_blob is not None:
                payload["fn_blob"] = fn_blob
                worker.known_fns.add(fn_id)
        with self._lock:
            self._inflight[task_id] = callback
            self._inflight_worker[task_id] = worker
        # async, order-preserving enqueue: a send failure surfaces through
        # the sender loop's death handling, which fails every inflight
        # callback (same path a mid-flight worker crash already takes)
        self._send_async(worker, msg_type, payload)
        if not worker.alive:
            # death handler may have drained _inflight BEFORE we registered
            # (check-register race): our callback would be orphaned and the
            # caller would hang forever — fail it ourselves. pop returns
            # None when the handler DID see it, so exactly one side fires.
            with self._lock:
                cb = self._inflight.pop(task_id, None)
                self._inflight_worker.pop(task_id, None)
                self._inflight_start.pop(task_id, None)
            if cb is not None:
                _defer_error(cb, WorkerCrashedError(f"worker {worker.pid} died"), after=worker.death_done)

    def _send_async(self, worker: WorkerHandle, msg_type: str, payload: dict) -> None:
        with worker.send_cv:
            worker.sendq.append((msg_type, payload))
            if not worker.sender_started:
                worker.sender_started = True
                self._start_thread(self._sender_loop, f"worker-send-{worker.pid}", worker)
            worker.send_cv.notify()

    def _sender_loop(self, worker: WorkerHandle) -> None:
        """Per-worker outbound writer.  Drains whatever accumulated since
        the last write in ONE pass and collapses runs of consecutive
        actor_call frames into actor_call_batch — tight async submitters
        pay ~one pickle+syscall per BURST instead of per call, with zero
        added latency when idle (lone frames flush immediately).  Total
        frame order is preserved: everything rides this queue."""
        while worker.alive:
            with worker.send_cv:
                while not worker.sendq:
                    worker.send_cv.wait(timeout=1.0)
                    if not worker.alive:
                        return
                batch = list(worker.sendq)
                worker.sendq.clear()
            try:
                run: list = []
                for msg_type, payload in batch:
                    if msg_type == "actor_call":
                        run.append(payload)
                        continue
                    self._flush_call_run(worker, run)
                    run = []
                    worker.send(msg_type, payload)
                self._flush_call_run(worker, run)
            except Exception:  # noqa: BLE001 — not just OSError: ANY send
                # failure (pickling error mid-frame included) may have left
                # the stream half-written; the connection is unusable and a
                # silently-dead sender would hang every future call
                self._handle_worker_death(worker)
                return

    def _flush_call_run(self, worker: WorkerHandle, run: list) -> None:
        if not run:
            return
        if len(run) == 1:
            worker.send("actor_call", run[0])
        else:
            worker.send("actor_call_batch", {"calls": run})

    def submit_batch_to_worker(self, worker: WorkerHandle, calls: list, cbs: list) -> None:
        """k actor calls in one IPC frame (``calls`` carry their task_ids;
        ``cbs`` is [(task_id, callback)]).  Collapses the per-call
        pickle+syscall submit cost that dominates the async actor path."""
        if not worker.alive:
            for _tid, cb in cbs:
                _defer_error(cb, WorkerCrashedError(f"worker {worker.pid} is dead"), after=worker.death_done)
            return
        with self._lock:
            for tid, cb in cbs:
                self._inflight[tid] = cb
                self._inflight_worker[tid] = worker
        # same ordered queue as single calls — a direct write here could
        # overtake queued singles for the same actor and invert call order
        self._send_async(worker, "actor_call_batch", {"calls": calls})
        if not worker.alive:
            # same check-register race as submit_to_worker
            with self._lock:
                orphans = [(tid, self._inflight.pop(tid, None)) for tid, _cb in cbs]
                for tid, _cb in cbs:
                    self._inflight_worker.pop(tid, None)
                    self._inflight_start.pop(tid, None)
            for _tid, cb in orphans:
                if cb is not None:
                    _defer_error(cb, WorkerCrashedError(f"worker {worker.pid} died"), after=worker.death_done)

    def release_actor_worker(self, worker: WorkerHandle) -> None:
        """Actor died/removed: kill its dedicated process."""
        self._kill_worker(worker)

    # ------------------------------------------------------------------
    # One reader thread per worker socket. (A single selector-based reader
    # for all sockets was measured strictly worse here — the select+wake
    # syscalls per message cost more than the GIL handoffs they avoid, and
    # it serializes the commit chains of concurrent workers.)
    # ------------------------------------------------------------------
    def _watch_worker(self, worker: WorkerHandle) -> None:
        self._start_thread(self._reader_loop, f"pool-reader-{worker.pid}", worker)

    #: nested-API dispatcher set by the owning Node:
    #: fn(task_bin, blob) -> reply_blob (may block awaiting other tasks)
    api_handler: Optional[Callable[[Optional[bytes], bytes], bytes]] = None
    #: True when the api handler resolves LOCALLY (head-host pools):
    #: cheap sync ops then run inline on the reader thread.  Agent pools
    #: relay to the head — a blocking relay must never hold the reader.
    serve_inline_sync: bool = False

    def _serve_api_request(self, worker: WorkerHandle, payload: dict) -> None:
        """Run one worker API call on its own thread (it may block in a
        nested get) and push the reply frame back.  Fire-and-forget ops
        (async submits, ref releases) run INLINE on the reader thread:
        they are cheap and non-blocking, and inline processing preserves
        per-worker frame order — actor-call ordering and the
        submit-before-release invariant for worker-minted refs depend on
        it."""
        handler = self.api_handler
        from ray_tpu_torch.runtime.worker_api import ASYNC_OPS, INLINE_SYNC_OPS

        op = payload.get("op")
        if op in ASYNC_OPS:
            try:
                if handler is not None:
                    handler(
                        payload.get("task_id"), payload["blob"],
                        op, worker.pid,
                    )
            except Exception:  # noqa: BLE001 — notification: nothing to reply to
                pass
            return
        if op in INLINE_SYNC_OPS and handler is not None and self.serve_inline_sync:
            # cheap non-blocking request: serve on the reader thread — a
            # thread spawn per call costs more than the handler
            try:
                blob = handler(payload.get("task_id"), payload["blob"], op, worker.pid)
            except BaseException as exc:  # noqa: BLE001
                import pickle as _p

                blob = _p.dumps(("err", RuntimeError(f"worker api failed: {exc}")))
            try:
                worker.send("api_reply", {"rid": payload["rid"], "blob": blob})
            except OSError:
                pass
            return

        def run():
            try:
                if handler is None:
                    raise RuntimeError("nested runtime API is not available on this node")
                blob = handler(
                    payload.get("task_id"), payload["blob"], payload.get("op", ""),
                    worker.pid,
                )
            except BaseException as exc:  # noqa: BLE001
                import pickle as _p

                blob = _p.dumps(("err", RuntimeError(f"worker api failed: {exc}")))
            try:
                worker.send("api_reply", {"rid": payload["rid"], "blob": blob})
            except OSError:
                pass  # worker died while we worked; its death path handles it

        self._start_thread(run, f"worker-api-{worker.pid}")

    def _reader_loop(self, worker: WorkerHandle) -> None:
        reader = protocol.FrameReader(worker.sock)
        while True:
            try:
                msg_type, payload = reader.recv()
            except (ConnectionError, OSError, ValueError):
                # ValueError = corrupt frame header (over the codec cap):
                # the stream is unrecoverable, same as a death
                self._handle_worker_death(worker)
                return
            if msg_type == "api_request":
                self._serve_api_request(worker, payload)
                continue
            if msg_type == "result_batch":
                # coalesced replies from an actor_call_batch: one frame, k
                # results (the per-result recv+unpickle syscall tax was the
                # other half of the async actor path's cost)
                for result_payload in payload["results"]:
                    self._deliver_result(worker, result_payload)
                continue
            if msg_type == "stacks_reply":
                waiter = self._stack_waiters.pop(payload.get("token"), None)
                if waiter is not None:
                    waiter["stacks"] = payload.get("stacks", "")
                    waiter["event"].set()
                continue
            if msg_type == "result":
                self._deliver_result(worker, payload)

    # ------------------------------------------------------------------
    def dump_worker_stacks(self, timeout: float = 5.0) -> Dict[int, str]:
        """Live thread stacks from every pool worker (reference: `ray
        stack`'s py-spy dump of workers, scripts.py:1830).  Served on each
        worker's reader thread, so a wedged exec thread still answers —
        which is exactly when this is needed."""
        import os as _os

        waiters = []
        with self._lock:
            workers = [w for w in self._all.values() if w.alive]
        seen = set()
        for w in workers:
            if w.pid in seen:
                continue
            seen.add(w.pid)
            token = _os.urandom(8).hex()
            waiter = {"event": threading.Event(), "stacks": None, "pid": w.pid, "token": token}
            self._stack_waiters[token] = waiter
            try:
                w.send("dump_stacks", {"token": token})
                waiters.append(waiter)
            except OSError:
                self._stack_waiters.pop(token, None)
        deadline = time.monotonic() + timeout
        out: Dict[int, str] = {}
        for waiter in waiters:
            waiter["event"].wait(max(0.0, deadline - time.monotonic()))
            if waiter["stacks"] is not None:
                out[waiter["pid"]] = waiter["stacks"]
            else:
                out[waiter["pid"]] = "<no response within timeout — process wedged or dead>"
                # reap the token, or every dump against a wedged worker
                # leaks one waiter entry forever
                self._stack_waiters.pop(waiter["token"], None)
        return out

    def _deliver_result(self, worker: WorkerHandle, payload: dict) -> None:
        spans = payload.get("spans")
        if spans:
            # worker-side finished spans (execute phase + any user spans)
            # ride the result payload home; on the head host the tracing
            # sink lands them in the control service's span store
            tracing.record_span_events(spans)
        task_id = payload["task_id"]
        with self._lock:
            callback = self._inflight.pop(task_id, None)
            self._inflight_start.pop(task_id, None)
            self._inflight_worker.pop(task_id, None)
            slot = self._direct.pop(task_id, None)
        if callback is None:
            return
        if not worker.dedicated:
            self._release_worker(worker)
        if slot is not None:
            # sync waiter present: hand off the raw payload; the
            # waiter's thread unpickles + commits
            slot.payload = payload
            slot.callback = callback
            slot.event.set()
            return
        try:
            if "error_blob" in payload:
                callback(None, pickle.loads(payload["error_blob"]), payload.get("exec_s"))
            else:
                callback(pickle.loads(payload["value_blob"]), None, payload.get("exec_s"))
        except BaseException as exc:  # noqa: BLE001 — keep the reader alive
            try:
                callback(None, exc, None)
            except BaseException:
                pass

    def _handle_worker_death(self, worker: WorkerHandle) -> None:
        if not worker.alive:
            return
        worker.alive = False
        with worker.send_cv:
            worker.sendq.clear()
            worker.send_cv.notify_all()  # release the sender loop
        dead_tasks = []
        with self._lock:
            self._all.pop(worker.pid, None)
            try:
                self._idle.remove(worker)
            except ValueError:
                pass
            if worker.lease_key is not None:
                if self._lease_pins.get(worker.lease_key) is worker:
                    del self._lease_pins[worker.lease_key]
                worker.lease_key = None
            for task_id, w in list(self._inflight_worker.items()):
                if w is worker:
                    dead_tasks.append(
                        (task_id, self._inflight.pop(task_id, None), self._direct.pop(task_id, None))
                    )
                    del self._inflight_worker[task_id]
                    self._inflight_start.pop(task_id, None)
        # Death notification FIRST (marks a hosted actor RESTARTING/DEAD and
        # closes its queue), THEN the per-call error callbacks: a retry fired
        # from a callback must see the post-death actor state and buffer for
        # the restart — the reverse order burns max_task_retries against the
        # corpse.
        if self._on_worker_death is not None and not self._stopped.is_set():
            self._on_worker_death(worker)
        # unblock orphaned-callback paths (check-register races) that
        # sequence behind the notification above
        worker.death_done.set()
        metric_defs.WORKER_POOL_DEATHS.inc()
        self._update_worker_gauges()
        for task_id, callback, slot in dead_tasks:
            if callback is not None:
                callback(None, WorkerCrashedError(f"worker {worker.pid} died"), None)
            if slot is not None:
                slot.event.set()  # empty slot: waiter falls through to the future

    def _kill_worker(self, worker: WorkerHandle, only_if_running: Optional[bytes] = None) -> bool:
        # Fail any in-flight tasks first — the reader loop's death handler
        # will early-return once alive=False, so this is the only chance to
        # fire their callbacks.
        dead_tasks = []
        with self._lock:
            if (
                only_if_running is not None
                and self._inflight_worker.get(only_if_running) is not worker
            ):
                # target task finished and the worker may host someone else
                # now — do not kill an innocent (checked under the same lock
                # that reassigns workers)
                return False
            for task_id, w in list(self._inflight_worker.items()):
                if w is worker:
                    dead_tasks.append(
                        (task_id, self._inflight.pop(task_id, None), self._direct.pop(task_id, None))
                    )
                    del self._inflight_worker[task_id]
                    self._inflight_start.pop(task_id, None)
        for task_id, callback, slot in dead_tasks:
            if callback is not None:
                try:
                    callback(None, WorkerCrashedError(f"worker {worker.pid} was killed"), None)
                except BaseException:
                    pass
            if slot is not None:
                slot.event.set()  # empty slot: waiter falls through to the future
        worker.alive = False
        # deliberate kill: there is no death notification to wait for
        worker.death_done.set()
        with self._lock:
            self._all.pop(worker.pid, None)
            try:
                self._idle.remove(worker)
            except ValueError:
                pass
            # unpin HERE: the reader thread's death handler early-returns on
            # alive=False, so this path (memory-monitor OOM kill, force
            # cancel) is the only one that can release the lease pin — a
            # leaked pin kept a dead worker as the shape's "warm" worker
            # until the next leased dispatch stumbled over it (ISSUE 8
            # satellite: memory-kill / lease interaction)
            if worker.lease_key is not None:
                if self._lease_pins.get(worker.lease_key) is worker:
                    del self._lease_pins[worker.lease_key]
                worker.lease_key = None
        metric_defs.WORKER_POOL_DEATHS.inc()
        self._update_worker_gauges()
        try:
            worker.send("shutdown", {})
        except OSError:
            pass
        try:
            worker.proc.terminate()
        except OSError:
            pass
        return True

    # ------------------------------------------------------------------
    def register_direct_waiter(self, task_id: bytes) -> Optional[_DirectSlot]:
        """If task_id is inflight here, register a sync-waiter handoff slot.
        Returns None when the task isn't running in this pool (already done,
        inproc, backlogged, or elsewhere)."""
        with self._lock:
            if task_id not in self._inflight:
                return None
            slot = _DirectSlot()
            self._direct[task_id] = slot
            return slot

    def cancel_direct_waiter(self, task_id: bytes, slot: _DirectSlot) -> None:
        """Give up on inline handling. If the reader already delivered into
        the slot, the caller must still slot.run() (the reader won't)."""
        with self._lock:
            if self._direct.get(task_id) is slot:
                del self._direct[task_id]

    # ------------------------------------------------------------------
    def inflight_tasks(self):
        """[(task_id, pid, start_time)] of tasks running in process workers
        (memory-monitor kill candidates)."""
        with self._lock:
            return [
                (tid, w.pid, self._inflight_start.get(tid, 0.0))
                for tid, w in self._inflight_worker.items()
                if w.alive
            ]

    def kill_task_worker(self, task_id: bytes) -> bool:
        """Kill the worker process hosting task_id (OOM-killer hook)."""
        with self._lock:
            worker = self._inflight_worker.get(task_id)
        if worker is None or not worker.alive:
            return False
        return self._kill_worker(worker, only_if_running=task_id)

    # ------------------------------------------------------------------
    def broadcast_fail_group(self, groups, reason: str) -> None:
        """Relay a collective death notice to every live worker (their
        reader threads invoke p2p.fail_group locally — a worker blocked in
        a collective wait can't be reached through the exec queue)."""
        with self._lock:
            workers = [w for w in self._all.values() if w.alive]
        for w in workers:
            try:
                w.send("fail_group", {"groups": list(groups), "reason": reason})
            except Exception:  # noqa: BLE001 — dying worker: its waits die with it
                pass

    def has_process_participants(self) -> bool:
        """True when code that could join a collective is running in a
        spawned worker right now: an actor-dedicated worker exists, or a
        process task is in flight.  Idle/prestarted workers don't count —
        they host nobody (used by kv_client.is_multiprocess to route
        driver-side collectives)."""
        with self._lock:
            if self._inflight_worker:
                return True
            return any(w.alive and w.dedicated for w in self._all.values())

    def num_workers(self) -> int:
        with self._lock:
            return len(self._all)

    def num_idle(self) -> int:
        with self._lock:
            return len(self._idle)

    def shutdown(self) -> None:
        with self._spawn_cv:
            self._stopped.set()
        with self._lock:
            workers = list(self._all.values())
        for w in workers:
            self._kill_worker(w)
        for w in workers:
            try:
                w.proc.wait(timeout=2)
            except subprocess.TimeoutExpired:
                w.proc.kill()
        # an accept in flight fails, and its spawn kills the child: close()
        # alone does not wake a thread blocked in accept() on Linux (it
        # would sit out its 30 s timeout), shutdown() does
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._listener.close()
        with self._spawn_cv:
            self._spawn_cv.wait_for(lambda: self._spawns_in_flight == 0, timeout=35.0)
        try:
            os.unlink(self._listen_path)
        except OSError:
            pass
        with self._threads_lock:
            threads = list(self._threads)
        join_threads(threads)


def _defer_error(callback, error, after=None) -> None:
    """Deliver an error callback on its own thread (rare failure path).
    Synchronous delivery can self-deadlock: submit paths run under the
    per-actor queue lock and error handling re-enters the queue pump.

    ``after`` (an Event) sequences the callback behind the worker's death
    notification: a retry fired from the callback must observe the
    post-death actor state (RESTARTING + closed queue), or it burns
    max_task_retries against the corpse.  Bounded wait — a stuck death
    handler must not orphan the error forever."""

    def run():
        if after is not None:
            after.wait(timeout=10.0)
        callback(None, error, None)

    threading.Thread(target=run, name="deferred-error", daemon=True).start()
