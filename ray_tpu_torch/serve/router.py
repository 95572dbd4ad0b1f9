"""Router + DeploymentHandle: request routing with power-of-two-choices.

The port's copy of ``ray_tpu/serve/router.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``; ``clear_router_cache`` (called by ``serve.shutdown``)
also stops each router's long-poll watcher and dispatch pool.

Parity: ``python/ray/serve/_private/router.py:312`` and
``replica_scheduler/pow_2_scheduler.py:49`` — the handle's router samples
two replicas and sends to the one with fewer in-flight requests (tracked
locally, optimistically), giving near-least-loaded balancing without a
global queue view.  ``DeploymentResponse`` is the future-like result
(parity: handle.py DeploymentResponse) and can be passed straight into
another handle call (composition without materializing).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.sync import join_threads
from ray_tpu_torch.observability import metric_defs



def _is_system_failure(exc: BaseException) -> bool:
    """System-level failures the router may fail over; application
    exceptions propagate untouched (parity: the reference router only
    retries system errors)."""
    from ray_tpu_torch.exceptions import (
        ObjectLostError,
        RayActorError,
        WorkerCrashedError,
    )

    return isinstance(exc, (RayActorError, WorkerCrashedError, ObjectLostError))


class DeploymentResponse:
    """Future-like result. The replica's in-flight count is settled by a
    completion callback the Router attached to the underlying ref, so a
    `result(timeout=...)` that times out (request still occupying the
    replica) or an abandoned response cannot skew pow-2 balancing.

    Replica-death failover: a request that raced a dying replica (the
    window between the kill and the controller's health-check replacement)
    reports the dead replica to the router (local prune — the controller's
    snapshot may still list it for ~a health-check period), waits for
    usable membership within the caller's deadline, and re-routes.  The
    retry replays the ORIGINAL request (nested DeploymentResponses
    included, so a lost upstream result can itself fail over) — but ONLY
    for deployments declared ``idempotent=True``: the dead replica may
    have executed its side effects before dying, so replaying a
    side-effecting deployment could execute it twice.  Non-idempotent
    deployments (the default) surface the typed actor error instead."""

    def __init__(self, ref, router=None, request=None, replica=None):
        self._ref = ref
        self._router = router
        self._request = request  # (method, args, kwargs) PRE-resolution
        self._replica = replica  # the actor handle this attempt targets

    def result(self, timeout: Optional[float] = None, *, timeout_s: Optional[float] = None) -> Any:
        # timeout_s: the reference's spelling (serve.handle.DeploymentResponse)
        import time as _time

        budget = timeout_s if timeout_s is not None else timeout
        deadline = None if budget is None else _time.monotonic() + budget
        while True:
            try:
                remaining = None if deadline is None else max(0.01, deadline - _time.monotonic())
                value = ray_tpu_torch.get(self._ref, timeout=remaining)
                # retries are pointless after success: drop the replay
                # payload so the response doesn't pin args/router forever
                self._router = self._request = self._replica = None
                return value
            except Exception as exc:  # noqa: BLE001 — filtered below
                from ray_tpu_torch.exceptions import (
                    DeadlineExceededError,
                    OverloadedError,
                    StoreFullError,
                    raised_copy,
                )
                from ray_tpu_torch.runtime.admission import unwrap

                cause = unwrap(exc)
                if cause is not exc and isinstance(
                    cause, (OverloadedError, DeadlineExceededError, StoreFullError)
                ):
                    # typed admission/deadline signals raised INSIDE a
                    # replica cross the actor boundary wrapped in
                    # RayTaskError; the handle contract is the typed error
                    # itself (the proxy maps it to 429/503/504)
                    raise raised_copy(cause) from None
                if (
                    self._router is None
                    or self._request is None
                    or not _is_system_failure(exc)
                    or not self._router._idempotent
                    or (deadline is not None and _time.monotonic() >= deadline)
                ):
                    raise
                if self._replica is not None:
                    self._router.report_dead(self._replica)
                    self._replica = None
                method, args, kwargs = self._request
                retry = self._router.route_within(
                    method, args, kwargs,
                    deadline=deadline if deadline is not None else _time.monotonic() + 30.0,
                )
                if retry is None:
                    raise  # no usable membership before the deadline
                self._ref, self._replica = retry._ref, retry._replica

    def _to_object_ref(self):
        return self._ref


class _DisaggResponse:
    """Future-like response for the disaggregated path: the dispatcher
    drives prefill → migration → decode on a router worker thread; this
    wraps its future with the DeploymentResponse surface (``result()`` with
    the reference's ``timeout_s`` spelling, typed admission errors
    unwrapped, ``_to_object_ref`` for composition)."""

    def __init__(self, fut):
        self._fut = fut

    def result(self, timeout: Optional[float] = None, *,
               timeout_s: Optional[float] = None) -> Any:
        budget = timeout_s if timeout_s is not None else timeout
        try:
            return self._fut.result(budget)
        except Exception as exc:  # noqa: BLE001 — filtered below
            from ray_tpu_torch.exceptions import (
                DeadlineExceededError,
                OverloadedError,
                StoreFullError,
                raised_copy,
            )
            from ray_tpu_torch.runtime.admission import unwrap

            cause = unwrap(exc)
            if cause is not exc and isinstance(
                cause, (OverloadedError, DeadlineExceededError, StoreFullError)
            ):
                raise raised_copy(cause) from None
            raise

    def _to_object_ref(self):
        return ray_tpu_torch.put(self.result())


class Router:
    def __init__(self, deployment_name: str, controller_handle):
        self.deployment_name = deployment_name
        self.controller = controller_handle
        self._replicas: List[Any] = []
        self._inflight: Dict[int, int] = {}
        self._lock = threading.Lock()
        # bounded router queue (max_queued_requests >= 0): requests beyond
        # the replicas' aggregate concurrency WAIT here for a replica to
        # free (notified by completions/membership), bounded by the queue
        # cap — replicas are never overcommitted, overflow sheds typed
        self._cv = threading.Condition(self._lock)
        self._queue_waiters = 0
        self._version = -1
        self._rng = random.Random()
        self._reqs_since_push = 0
        self._watching = False
        self._metric_tags = {"deployment": deployment_name}
        # per-deployment series: two bounded deployments must not
        # clobber each other's admission-depth gauge
        self._depth_tags = {"layer": "router", "deployment": deployment_name}
        # per-deployment admission/retry knobs (controller.get_deployment
        # _meta), refreshed on membership changes — never per request
        self._max_ongoing = 100
        self._max_queued = -1
        self._idempotent = False
        self._meta_version = None
        # disaggregated prefill/decode (serve/disagg.py): roles declared by
        # the deployment, the per-replica role list (index-aligned with
        # _replicas per membership version), and the lazily-built dispatcher
        # + its dispatch pool (dispatcher calls block on prefill AND decode,
        # so they run off the caller's thread to keep .remote() non-blocking)
        self._roles: Optional[Dict[str, int]] = None
        self._replica_roles: List[str] = []
        self._disagg = None
        self._disagg_pool = None
        # teardown (clear_router_cache): stops the long-poll watcher, which
        # the JAX package leaves to notice the dead controller on its own
        self._stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ updates
    def _apply_snapshot(self, version: int, replicas: List[Any]) -> None:
        with self._lock:
            if version != self._version:
                self._version = version
                self._replicas = replicas
                # identity-keyed: surviving replicas KEEP their in-flight
                # counts across membership changes — zeroing (or index
                # shifts) would let the bounded-admission path over-dispatch
                # onto still-saturated survivors after a replica death
                self._inflight = {
                    id(r): self._inflight.get(id(r), 0) for r in replicas
                }
                self._cv.notify_all()  # queued requests re-evaluate membership

    def _refresh(self, force: bool = False) -> None:
        # Membership updates arrive via a long-poll watcher (parity:
        # LongPollHost, serve/_private/long_poll.py); the synchronous pull
        # only runs before the first snapshot lands.
        # rt-lint: disable=lock-discipline -- double-checked lazy start:
        # the unlocked read is a fast path; the decision re-runs under
        # _lock before the watcher thread is spawned
        if not self._watching:
            with self._lock:
                if self._watching:
                    return
                self._watching = True
            self._watch_thread = threading.Thread(
                target=self._watch_loop, daemon=True, name=f"serve-watch-{self.deployment_name}"
            )
            self._watch_thread.start()
        # rt-lint: disable=lock-discipline -- bootstrap emptiness probe: a
        # stale read costs one redundant pull; _apply_snapshot is
        # version-gated so a racing watcher update always wins
        if force or not self._replicas:
            version, replicas = ray_tpu_torch.get(self.controller.get_replicas.remote(self.deployment_name))
            self._apply_snapshot(version, replicas)
            self._refresh_meta()

    def _refresh_meta(self) -> None:
        """Pull the deployment's admission/retry knobs once per membership
        version (a redeploy may change them; requests must not)."""
        with self._lock:
            if self._meta_version == self._version:
                return
            version = self._version
        try:
            meta = ray_tpu_torch.get(
                self.controller.get_deployment_meta.remote(self.deployment_name),
                timeout=10,
            )
        except Exception:  # noqa: BLE001 — keep the last-known knobs
            return
        with self._lock:
            if meta:
                self._max_ongoing = int(meta.get("max_ongoing_requests", 100))
                self._max_queued = int(meta.get("max_queued_requests", -1))
                self._idempotent = bool(meta.get("idempotent", False))
                self._roles = meta.get("roles") or None
                self._replica_roles = list(meta.get("replica_roles") or ())
            self._meta_version = version

    def _watch_loop(self) -> None:
        import time

        failures = 0
        while failures < 3 and not self._stop.is_set():
            try:
                # rt-lint: disable=lock-discipline -- a stale _version just
                # long-polls with an old cursor: the reply is re-applied
                # through the version-gated _apply_snapshot, a no-op repeat
                version, replicas = ray_tpu_torch.get(
                    self.controller.poll_replicas.remote(self.deployment_name, self._version, 5.0),
                    timeout=30,
                )
                failures = 0
                self._apply_snapshot(version, replicas)
                self._refresh_meta()
            except Exception:
                failures += 1
                self._stop.wait(0.5)
        # controller unreachable: stand down; the next route() restarts us
        with self._lock:
            self._watching = False

    # ------------------------------------------------------------ routing
    def report_dead(self, replica) -> None:
        """A caller observed this replica fail: prune it locally NOW — the
        controller's snapshot keeps listing it for up to a health-check
        period, and re-routing onto it just burns the retry."""
        with self._lock:
            if replica in self._replicas:
                # prune the role entry at the same index so _replica_roles
                # stays aligned until the controller's replacement snapshot
                idx = next(
                    i for i, r in enumerate(self._replicas) if r is replica
                )
                if idx < len(self._replica_roles):
                    self._replica_roles = (
                        self._replica_roles[:idx] + self._replica_roles[idx + 1:]
                    )
                self._replicas = [r for r in self._replicas if r is not replica]
                self._inflight = {
                    id(r): self._inflight.get(id(r), 0) for r in self._replicas
                }
                self._cv.notify_all()

    def route_within(self, method: str, args: tuple, kwargs: dict, *, deadline: float):
        """route(), but wait for usable membership (a live replica) up to
        ``deadline`` instead of failing fast; None if none appeared."""
        import time as _time

        while True:
            try:
                return self.route(method, args, kwargs)
            except RuntimeError:
                if _time.monotonic() >= deadline:
                    return None
                _time.sleep(0.1)
                self._refresh(force=True)

    def _load_locked(self, idx: int) -> int:
        return self._inflight.get(id(self._replicas[idx]), 0)

    def _pick_free_locked(self) -> Optional[int]:
        """Pow-2 choice restricted to replicas below ``max_ongoing``; falls
        back to the global minimum when the sample is saturated.  None =
        every replica is at capacity (the caller queues or sheds)."""
        n = len(self._replicas)
        if n == 0:
            return None
        cap = max(1, self._max_ongoing)
        if n == 1:
            idx = 0
        else:
            a, b = self._rng.sample(range(n), 2)
            idx = a if self._load_locked(a) <= self._load_locked(b) else b
        if self._load_locked(idx) >= cap:
            idx = min(range(n), key=self._load_locked)
            if self._load_locked(idx) >= cap:
                return None
        return idx

    def _admit_bounded_locked(self) -> int:
        """Bounded-queue admission (max_queued_requests >= 0, reference
        ``max_queued_requests`` parity): replicas are never dispatched past
        ``max_ongoing`` — a request arriving with every replica saturated
        WAITS here (counted as the router queue, gauge-visible) until a
        completion frees a slot; arrivals beyond the queue bound shed with
        the typed 429 signal.  Called under ``self._lock``."""
        # newcomers defer to already-queued requests: a fresh arrival must
        # not barge past waiters onto a just-freed slot (CPython Condition
        # wakes waiters in arrival order, so with this gate admission is
        # near-FIFO and a long-waiting request cannot be starved into its
        # queue_timeout by a stream of later arrivals)
        if self._queue_waiters == 0:
            idx = self._pick_free_locked()
            if idx is not None:
                return idx
        if self._queue_waiters >= self._max_queued:
            from ray_tpu_torch.runtime import admission

            raise admission.shed(
                "router", "queue_full",
                message=(
                    f"deployment {self.deployment_name!r}: every replica at "
                    f"max_ongoing_requests ({self._max_ongoing}) and "
                    f"{self._queue_waiters} requests already queued "
                    f"(max_queued_requests {self._max_queued})"
                ),
            )
        self._queue_waiters += 1
        metric_defs.ADMISSION_QUEUE_DEPTH.set(self._queue_waiters, self._depth_tags)
        from ray_tpu_torch.core.config import get_config

        deadline = time.monotonic() + get_config().router_queue_wait_timeout_s
        try:
            while True:
                # short timed waits so membership flaps can't strand us.
                # Transiently-EMPTY membership (replica died, controller
                # replacing it) keeps waiting within the budget — the rest
                # of the failover machinery (route_within) does the same;
                # failing every queued request the instant a replica dies
                # would turn a ~1s replacement into a burst of 500s.
                self._cv.wait(0.05)
                if self._replicas:
                    idx = self._pick_free_locked()
                    if idx is not None:
                        return idx
                if time.monotonic() >= deadline:
                    if not self._replicas:
                        raise RuntimeError(
                            f"deployment {self.deployment_name!r} has no replicas"
                        )
                    # a wedged replica must cost a typed 429, not a handle
                    # call that never returns
                    from ray_tpu_torch.runtime import admission

                    raise admission.shed(
                        "router", "queue_timeout",
                        message=(
                            f"deployment {self.deployment_name!r}: no "
                            "replica slot freed within "
                            "router_queue_wait_timeout_s"
                        ),
                    )
        finally:
            self._queue_waiters -= 1
            metric_defs.ADMISSION_QUEUE_DEPTH.set(
                self._queue_waiters, self._depth_tags
            )

    # --------------------------------------------- disaggregated dispatch
    def call_replica(self, deployment: str, index: int, method: str,
                     args: tuple, tenant=None, trace=None, *,
                     timeout: Optional[float] = None):
        """Call ONE replica by index and block for its result (the disagg
        dispatcher's primitive: migrations target a specific replica pair,
        so pow-2 sampling happens in pick_role_replica, not here).  The
        in-flight count still settles through the completion hook so the
        queue-depth signal sees dispatcher traffic too."""
        with self._lock:
            if index < 0 or index >= len(self._replicas):
                raise RuntimeError(
                    f"deployment {deployment!r} replica #{index} left the "
                    "membership (died or scaled away)"
                )
            replica = self._replicas[index]
            rkey = id(replica)
            self._inflight[rkey] = self._inflight.get(rkey, 0) + 1
        ref = replica.handle_request.remote(
            method, tuple(args), {}, tenant, trace
        )
        from ray_tpu_torch.api import get_cluster

        get_cluster().directory.wait_for(
            ref.id(), lambda _node, k=rkey: self._request_finished(k)
        )
        return ray_tpu_torch.get(ref, timeout=timeout)

    def pick_role_replica(self, deployment: str, role: str,
                          signal: str = "queue") -> int:
        """Pick a replica index from one role's pool.  ``signal="queue"``
        (prefill): pow-2 over locally-tracked in-flight counts — prefill is
        compute-bound, so queue depth is the contended resource.
        ``signal="kv_free"`` (decode): probe free KV pages on a pow-2
        sample and take the roomier replica — decode is HBM-bound, and a
        migration landing on a page-starved replica just sheds."""
        self._refresh()
        with self._lock:
            if len(self._replica_roles) != len(self._replicas):
                aligned = False
            else:
                aligned = True
            roles = list(self._replica_roles)
            n = len(self._replicas)
        if not aligned:
            self._refresh(force=True)
            with self._lock:
                roles = list(self._replica_roles)
                n = len(self._replicas)
        idxs = [i for i, r in enumerate(roles[:n]) if r == role]
        if not idxs:
            raise RuntimeError(
                f"deployment {deployment!r} has no live {role!r} replicas"
            )
        if len(idxs) == 1:
            return idxs[0]
        with self._lock:
            a, b = self._rng.sample(idxs, 2)
        if signal == "kv_free":
            best, best_free = a, -1
            for i in (a, b):
                try:
                    free = int(self.call_replica(
                        deployment, i, "kv_free_blocks", (), timeout=5.0
                    ))
                except Exception:  # noqa: BLE001 — probe failure = skip
                    continue
                if free > best_free:
                    best, best_free = i, free
            return best
        with self._lock:
            return a if self._load_locked(a) <= self._load_locked(b) else b

    def _route_disagg(self, args: tuple, kwargs: dict) -> "_DisaggResponse":
        """Delegate a ``__call__`` on a roles deployment to the disagg
        dispatcher (prefill pool → KV migration → decode pool) on a worker
        thread, so ``.remote()`` stays non-blocking like ordinary dispatch."""
        from concurrent.futures import ThreadPoolExecutor

        from ray_tpu_torch.runtime.context import current_request_trace, current_tenant
        from ray_tpu_torch.serve.disagg import DisaggDispatcher

        trace = current_request_trace()
        if trace is not None:
            trace.mark("router_in")
            if not trace.deployment:
                trace.deployment = self.deployment_name
        request = args[0] if args else kwargs.get("request")
        if not isinstance(request, dict):
            raise TypeError(
                f"disaggregated deployment {self.deployment_name!r} takes a "
                "single request dict"
            )
        tenant = current_tenant()
        with self._lock:
            if self._disagg is None:
                self._disagg = DisaggDispatcher(self, self.deployment_name)
            if self._disagg_pool is None:
                self._disagg_pool = ThreadPoolExecutor(
                    max_workers=32,
                    thread_name_prefix=f"disagg-{self.deployment_name}",
                )
            disp, pool = self._disagg, self._disagg_pool
        metric_defs.SERVE_ROUTER_REQUESTS.inc(tags=self._metric_tags)
        if trace is not None:
            trace.mark("router_dequeue")
        return _DisaggResponse(pool.submit(disp.route, request, tenant, trace))

    def disagg_snapshot(self) -> Optional[dict]:
        """Per-role dispatch/migration counters for rt llm / /api/overload
        (None until the first disaggregated request)."""
        with self._lock:
            disp = self._disagg
        return None if disp is None else disp.snapshot()

    def route(self, method: str, args: tuple, kwargs: dict) -> DeploymentResponse:
        from ray_tpu_torch.runtime.context import current_request_trace, current_tenant

        t_start = time.perf_counter()
        trace = current_request_trace()
        if trace is not None:
            trace.mark("router_in")
            if not trace.deployment:
                trace.deployment = self.deployment_name
        # rt-lint: disable=lock-discipline -- emptiness fast-path only: it
        # decides refresh-or-fail; replica SELECTION below holds _lock
        if not self._replicas:
            self._refresh()
        if not self._replicas:  # rt-lint: disable=lock-discipline -- same
            raise RuntimeError(f"deployment {self.deployment_name!r} has no replicas")
        # rt-lint: disable=lock-discipline -- meta-gated delegation: _roles
        # only transitions None->dict at meta refresh; a stale None routes
        # one early request homogeneously, never corrupts state
        if self._roles and method == "__call__":
            # roles deployment: __call__ takes the disaggregated path
            # (prefill pool -> KV migration -> decode pool); other methods
            # (stats, reconfigure hooks) still dispatch normally below
            return self._route_disagg(args, kwargs)
        original_request = (method, args, kwargs)  # PRE-resolution, for replay
        tenant = current_tenant()
        with self._lock:
            if self._max_queued >= 0:
                idx = self._admit_bounded_locked()
            elif len(self._replicas) == 1:
                idx = 0
            else:
                # power of two choices over locally-tracked in-flight counts
                a, b = self._rng.sample(range(len(self._replicas)), 2)
                idx = a if self._load_locked(a) <= self._load_locked(b) else b
            replica = self._replicas[idx]
            rkey = id(replica)
            self._inflight[rkey] = self._inflight.get(rkey, 0) + 1
            total_inflight = sum(self._inflight.values())
            self._reqs_since_push += 1
            push = self._reqs_since_push >= 10
            if push:
                self._reqs_since_push = 0
        metric_defs.SERVE_ROUTER_REQUESTS.inc(tags=self._metric_tags)
        metric_defs.SERVE_ROUTER_INFLIGHT.set(total_inflight, self._metric_tags)
        from ray_tpu_torch.runtime.admission import tenant_tags

        metric_defs.TENANT_ADMISSIONS.inc(tags=tenant_tags(tenant))
        metric_defs.SERVE_ROUTER_QUEUE_WAIT.observe(
            time.perf_counter() - t_start, tags=self._metric_tags
        )
        if trace is not None:
            trace.mark("router_dequeue")
        # Resolve nested DeploymentResponses: pass their refs so the fabric
        # chains the calls without blocking here (model composition).
        args = tuple(a._to_object_ref() if isinstance(a, DeploymentResponse) else a for a in args)
        kwargs = {k: (v._to_object_ref() if isinstance(v, DeploymentResponse) else v) for k, v in kwargs.items()}
        # the trace rides as an explicit argument, like the tenant —
        # contextvars do not survive the actor-call boundary (replicas run
        # requests on pool threads)
        ref = replica.handle_request.remote(method, args, kwargs, tenant, trace)
        # Ready-hook, not ref.future(): a future would pull every response
        # onto the router's node; the directory callback fires when the
        # result is committed anywhere, without materializing it here.
        from ray_tpu_torch.api import get_cluster

        get_cluster().directory.wait_for(
            ref.id(), lambda _node, k=rkey: self._request_finished(k)
        )
        if push:
            self._push_metrics()
        return DeploymentResponse(ref, router=self, request=original_request, replica=replica)

    def _push_metrics(self) -> None:
        try:
            # rt-lint: disable=lock-discipline -- metrics snapshot: the
            # copy races membership swaps by design; a rare mid-resize
            # RuntimeError lands in the except and drops one push
            self.controller.record_request_metrics.remote(
                self.deployment_name, dict(self._inflight)
            )
        except Exception:
            pass

    def _request_finished(self, rkey: int) -> None:
        with self._lock:
            if rkey in self._inflight and self._inflight[rkey] > 0:
                self._inflight[rkey] -= 1
            total_inflight = sum(self._inflight.values())
            drained = not total_inflight
            if self._queue_waiters:
                self._cv.notify()  # a queued request can dispatch now
        metric_defs.SERVE_ROUTER_INFLIGHT.set(total_inflight, self._metric_tags)
        if drained:
            # without this push the controller's last snapshot would show
            # ongoing requests forever and it would never scale down
            self._push_metrics()

    def stale(self) -> bool:
        return True

    def stop(self) -> None:
        """End the watcher and the dispatch pool (``serve.shutdown``): no
        ``serve-watch-*`` thread outlives the Serve instance."""
        self._stop.set()
        with self._lock:
            pool, watcher = self._disagg_pool, self._watch_thread
            self._disagg_pool = None
        if pool is not None:
            pool.shutdown(wait=False)
        if watcher is not None:
            join_threads([watcher])


# One Router (and thus one long-poll watcher thread) per deployment per
# controller — handles are created freely (serve.run makes one per
# sub-deployment per call) and must not each spawn a watcher.
_router_cache: Dict[tuple, "Router"] = {}
_router_cache_lock = threading.Lock()


def _shared_router(deployment_name: str, controller_handle) -> "Router":
    key = (id(controller_handle), deployment_name)
    with _router_cache_lock:
        router = _router_cache.get(key)
        if router is None:
            router = _router_cache[key] = Router(deployment_name, controller_handle)
        return router


def clear_router_cache() -> None:
    """Called on serve.shutdown so stale watchers drain and a new serve
    instance gets fresh routers."""
    with _router_cache_lock:
        routers = list(_router_cache.values())
        _router_cache.clear()
    for router in routers:
        router.stop()


class DeploymentHandle:
    """What users (and the proxy) call (parity: serve DeploymentHandle)."""

    def __init__(self, deployment_name: str, controller_handle):
        self.deployment_name = deployment_name
        self._router = _shared_router(deployment_name, controller_handle)
        self._method = "__call__"

    def options(self, *, method_name: Optional[str] = None) -> "DeploymentHandle":
        h = DeploymentHandle.__new__(DeploymentHandle)
        h.deployment_name = self.deployment_name
        h._router = self._router
        h._method = method_name or self._method
        return h

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        self._router._refresh()
        return self._router.route(self._method, args, kwargs)

    def __getattr__(self, name: str) -> "_MethodCaller":
        if name.startswith("_"):
            raise AttributeError(name)
        return _MethodCaller(self, name)


class _MethodCaller:
    def __init__(self, handle: DeploymentHandle, method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        self._handle._router._refresh()
        return self._handle._router.route(self._method, args, kwargs)
