"""ServeController: the reconciling control loop.

The port's copy of ``ray_tpu/serve/controller.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``, and ``num_gpus`` forwarded to the replica actors;
``shutdown`` also waits for the control loop to end.

Parity: ``python/ray/serve/_private/controller.py:86`` (singleton controller
actor reconciling target vs running replicas per deployment,
``deployment_state.py:1226``) and ``autoscaling_state.py`` (queue-depth
autoscaling between min/max replicas).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.serve.deployment import AutoscalingConfig, Deployment
from ray_tpu_torch.serve.replica import ReplicaActor

#: ``ray_actor_options`` a replica actor takes over. The JAX package forwards
#: ``num_cpus``, ``num_tpus`` and ``resources``; the port adds ``num_gpus``, how
#: a replica asks for the card. Such a replica is an in-process GPU actor; on
#: a node without a GPU it is infeasible, never moved to the CPU.
_REPLICA_RESOURCE_OPTIONS = ("num_cpus", "num_gpus", "num_tpus", "resources")


class _DeploymentState:
    def __init__(self, deployment: Deployment, init_args: tuple, init_kwargs: dict):
        self.deployment = deployment
        self.init_args = init_args
        self.init_kwargs = init_kwargs
        self.replicas: List[Any] = []
        self.version = 0
        # disaggregated prefill/decode (serve/disagg.py): per-role replica
        # targets + the role list index-aligned with `replicas` (the router
        # reads it through get_deployment_meta per membership version)
        self.roles: Optional[Dict[str, int]] = (
            dict(deployment.roles) if deployment.roles else None
        )
        self.replica_roles: List[str] = []
        self.role_targets: Dict[str, int] = dict(self.roles or {})
        # decode-pool KV pressure (id(replica) -> free fraction), refreshed
        # by the health-check-cadence probe — the decode pool's autoscaling
        # signal (free pages, not queue depth)
        self.kv_free_frac: Dict[int, float] = {}
        if deployment.autoscaling_config is not None:
            if self.roles is not None:
                self.target_replicas = sum(self.role_targets.values())
            else:
                self.target_replicas = deployment.autoscaling_config.min_replicas
        else:
            self.target_replicas = int(deployment.num_replicas)
        self.last_inflight: Dict[int, int] = {}
        self.last_scale_time = 0.0
        self.health: Dict[int, dict] = {}    # id(replica) -> {fails, born}


@ray_tpu_torch.remote
class ServeControllerActor:
    """Runs in-process; reconcile loop on a background thread."""

    def __init__(self):
        self._deployments: Dict[str, _DeploymentState] = {}
        self._apps: Dict[str, str] = {}  # route_prefix -> ingress deployment
        self._lock = threading.RLock()
        self._changed = threading.Condition(self._lock)  # long-poll wakeups
        self._running = True
        self._stopped = threading.Event()  # wakes the control loop at shutdown
        # register on the cluster so chaos hooks (kill_decode_replica) can
        # find live controllers (mirrors cluster.train_controllers)
        try:
            from ray_tpu_torch.runtime.worker import global_worker

            global_worker().cluster.serve_controllers[id(self)] = self
        except Exception:  # noqa: BLE001 — controller driven without rt.init
            pass
        self._reconcile_thread = threading.Thread(target=self._loop, daemon=True, name="serve-reconcile")
        self._reconcile_thread.start()

    # ----------------------------------------------------------- deploys
    def deploy(self, deployment: Deployment, init_args: tuple, init_kwargs: dict) -> None:
        # deploy-time role validation: zero-replica pools or a dense KV
        # cache fail HERE with a typed ValueError, not at the first
        # migration (serve/disagg.py)
        if deployment.roles is not None:
            from ray_tpu_torch.serve.disagg import validate_roles

            validate_roles(deployment.roles, init_kwargs)
        with self._lock:
            old = self._deployments.get(deployment.name)
            state = _DeploymentState(deployment, init_args, init_kwargs)
            if old is not None:
                state.version = old.version
                self._scale_down_locked(old, 0)
            self._deployments[deployment.name] = state
            self._reconcile_locked(state)
            self._changed.notify_all()

    def delete_deployment(self, name: str) -> None:
        with self._lock:
            state = self._deployments.pop(name, None)
            if state is not None:
                self._scale_down_locked(state, 0)
            self._changed.notify_all()

    def set_ingress(self, route_prefix: str, deployment_name: str) -> None:
        with self._lock:
            self._apps[route_prefix] = deployment_name

    def get_ingress_map(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._apps)

    # ----------------------------------------------------------- queries
    def get_replicas(self, name: str) -> Tuple[int, List[Any]]:
        with self._lock:
            state = self._deployments.get(name)
            if state is None:
                return (-1, [])
            return (state.version, list(state.replicas))

    def poll_replicas(self, name: str, known_version: int, timeout_s: float = 10.0) -> Tuple[int, List[Any]]:
        """Long-poll (parity: LongPollHost, serve/_private/long_poll.py):
        blocks until the replica set's version moves past known_version or
        the timeout lapses, then returns the current snapshot. Routers keep
        one of these outstanding instead of re-pulling on a timer."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while self._running:
                state = self._deployments.get(name)
                current = state.version if state is not None else -1
                if current != known_version:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._changed.wait(remaining):
                    break
            state = self._deployments.get(name)
            if state is None:
                return (-1, [])
            return (state.version, list(state.replicas))

    def list_deployments(self) -> Dict[str, dict]:
        with self._lock:
            return {
                name: {
                    "num_replicas": len(s.replicas),
                    "target_replicas": s.target_replicas,
                    "version": s.deployment.version,
                }
                for name, s in self._deployments.items()
            }

    def get_deployment_meta(self, name: str) -> Dict[str, Any]:
        """Admission/retry knobs the router enforces per deployment
        (fetched on membership changes, not per request)."""
        with self._lock:
            state = self._deployments.get(name)
            if state is None:
                return {}
            d = state.deployment
            return {
                "max_ongoing_requests": d.max_ongoing_requests,
                "max_queued_requests": d.max_queued_requests,
                "idempotent": d.idempotent,
                # disagg: declared role targets + the per-replica role list,
                # index-aligned with this version's get_replicas snapshot
                "roles": dict(state.roles) if state.roles else None,
                "replica_roles": list(state.replica_roles),
            }

    def record_request_metrics(self, name: str, inflight: Dict[int, int]) -> None:
        with self._lock:
            state = self._deployments.get(name)
            if state is not None:
                state.last_inflight = dict(inflight)

    # ------------------------------------------------------- reconciling
    def _reconcile_locked(self, state: _DeploymentState) -> None:
        before = state.version
        self._reconcile_inner_locked(state)
        if state.version != before:
            # wake long-pollers only on real membership change — an
            # unconditional notify would turn the 0.2s reconcile tick into
            # a busy-poll for every watcher
            self._changed.notify_all()

    def _reconcile_inner_locked(self, state: _DeploymentState) -> None:
        if state.roles is not None:
            self._reconcile_roles_locked(state)
            return
        d = state.deployment
        while len(state.replicas) < state.target_replicas:
            is_function = not isinstance(d.func_or_class, type)
            # the replica-level backstop (handle_request shedding past
            # max_ongoing_requests, +2 concurrency headroom so it is
            # reachable) arms only for deployments that OPTED INTO bounding
            # (max_queued_requests >= 0) — the unbounded default keeps the
            # historical queue-at-the-actor behavior, never a surprise 429
            bounded = d.max_queued_requests >= 0
            replica = ReplicaActor.options(
                execution="inproc",
                max_concurrency=max(2, d.max_ongoing_requests + (2 if bounded else 0)),
                **{k: v for k, v in d.ray_actor_options.items() if k in _REPLICA_RESOURCE_OPTIONS},
            ).remote(
                d.func_or_class, state.init_args, state.init_kwargs, d.user_config, is_function,
                deployment=d.name,
                replica_tag=f"{d.name}#{state.version}",
                max_ongoing_requests=d.max_ongoing_requests if bounded else 0,
            )
            state.replicas.append(replica)
            state.version += 1
        if len(state.replicas) > state.target_replicas:
            self._scale_down_locked(state, state.target_replicas)

    def _reconcile_roles_locked(self, state: _DeploymentState) -> None:
        """Reconcile a disaggregated deployment's TWO pools independently:
        each role's replica count converges on its target, and every new
        replica gets ``init_kwargs["role"]`` so the LLM engine knows which
        half of the migration it serves.  Role order is sorted — replica
        creation order (and thus versions and tags) is deterministic."""
        d = state.deployment
        bounded = d.max_queued_requests >= 0
        is_function = not isinstance(d.func_or_class, type)
        for role in sorted(state.role_targets):
            target = max(0, int(state.role_targets[role]))
            count = state.replica_roles.count(role)
            while count < target:
                kwargs = dict(state.init_kwargs)
                kwargs["role"] = role
                replica = ReplicaActor.options(
                    execution="inproc",
                    max_concurrency=max(2, d.max_ongoing_requests + (2 if bounded else 0)),
                    **{k: v for k, v in d.ray_actor_options.items() if k in _REPLICA_RESOURCE_OPTIONS},
                ).remote(
                    d.func_or_class, state.init_args, kwargs, d.user_config, is_function,
                    deployment=d.name,
                    replica_tag=f"{d.name}:{role}#{state.version}",
                    max_ongoing_requests=d.max_ongoing_requests if bounded else 0,
                )
                state.replicas.append(replica)
                state.replica_roles.append(role)
                state.version += 1
                count += 1
            while count > target:
                idx = max(
                    i for i, rr in enumerate(state.replica_roles) if rr == role
                )
                replica = state.replicas.pop(idx)
                state.replica_roles.pop(idx)
                state.health.pop(id(replica), None)
                try:
                    ray_tpu_torch.kill(replica)
                except Exception:
                    pass
                state.version += 1
                count -= 1
        state.target_replicas = sum(state.role_targets.values())

    def _scale_down_locked(self, state: _DeploymentState, target: int) -> None:
        while len(state.replicas) > target:
            replica = state.replicas.pop()
            if state.replica_roles:
                state.replica_roles.pop()
            try:
                ray_tpu_torch.kill(replica)
            except Exception:
                pass
            state.version += 1
        if state.roles is not None and target == 0:
            state.role_targets = {r: 0 for r in state.role_targets}

    HEALTH_CHECK_TIMEOUT_S = 5.0
    HEALTH_CHECK_FAILS = 3       # consecutive failures before replacement
    HEALTH_GRACE_S = 15.0        # startup grace before failures count

    def _loop(self) -> None:
        ticks = 0
        # rt-lint: disable=lock-discipline -- one-way stop flag: a stale
        # read costs at most one extra 0.2s control-loop tick
        while self._running:
            if self._stopped.wait(0.2):
                return
            ticks += 1
            if ticks % 5 == 0:  # ~1s health-check cadence, outside the lock
                self._health_check()
            if ticks % 5 == 0:
                self._probe_kv_pressure()
            with self._lock:
                for state in list(self._deployments.values()):
                    cfg = state.deployment.autoscaling_config
                    if cfg is not None:
                        if state.roles is not None:
                            self._autoscale_roles_locked(state, cfg)
                        else:
                            self._autoscale_locked(state, cfg)
                    self._reconcile_locked(state)
                    if state.roles is not None and ticks % 5 == 0:
                        self._publish_role_gauges_locked(state)

    def _health_check(self) -> None:
        """Replace replicas that fail HEALTH_CHECK_FAILS consecutive probes
        (parity: DeploymentState replica health checks). Probes run OUTSIDE
        the controller lock — a hung replica must not stall deploys or
        long-pollers — and a startup grace period keeps slow __init__s
        (method calls queue behind them) from being killed mid-load."""
        with self._lock:
            snapshot = {name: list(st.replicas) for name, st in self._deployments.items()}
        refs = {}
        for name, reps in snapshot.items():
            for r in reps:
                try:
                    refs[(name, id(r))] = r.check_health.remote()
                except Exception:
                    refs[(name, id(r))] = None
        from ray_tpu_torch.exceptions import GetTimeoutError

        deadline = time.monotonic() + self.HEALTH_CHECK_TIMEOUT_S
        # "ok" / "slow" (probe timed out: maybe busy or initializing) /
        # "dead" (actor gone: no threshold needed, it can never recover)
        verdicts: Dict[tuple, str] = {}
        for key, ref in refs.items():
            if ref is None:
                verdicts[key] = "dead"
                continue
            try:
                ray_tpu_torch.get(ref, timeout=max(0.1, deadline - time.monotonic()))
                verdicts[key] = "ok"
            except GetTimeoutError:
                verdicts[key] = "slow"
            except Exception:
                verdicts[key] = "dead"
        now = time.monotonic()
        with self._lock:
            for name, reps in snapshot.items():
                state = self._deployments.get(name)
                if state is None:
                    continue
                changed = False
                for r in reps:
                    verdict = verdicts.get((name, id(r)), "ok")
                    rec = state.health.setdefault(
                        id(r), {"fails": 0, "born": now, "ready": False}
                    )
                    if verdict == "ok":
                        rec["fails"] = 0
                        rec["ready"] = True
                        continue
                    rec["fails"] += 1
                    # startup grace ends once the replica has EVER passed a
                    # probe; a dead actor skips the threshold entirely
                    in_grace = not rec["ready"] and now - rec["born"] < self.HEALTH_GRACE_S
                    should_remove = verdict == "dead" or (
                        rec["fails"] >= self.HEALTH_CHECK_FAILS and not in_grace
                    )
                    if should_remove and r in state.replicas:
                        idx = state.replicas.index(r)
                        state.replicas.pop(idx)
                        if idx < len(state.replica_roles):
                            state.replica_roles.pop(idx)
                        state.health.pop(id(r), None)
                        state.kv_free_frac.pop(id(r), None)
                        state.version += 1
                        changed = True
                        try:
                            ray_tpu_torch.kill(r)
                        except Exception:
                            pass
                        # flight-record the death with the last requests:
                        # which traffic preceded the failed probes is the
                        # first postmortem question
                        try:
                            from ray_tpu_torch.observability import reqtrace

                            reqtrace.flight_record(
                                "replica_died",
                                f"deployment {name!r} replica removed "
                                f"(verdict: {verdict})",
                                severity="WARNING",
                                state={
                                    "deployment": name,
                                    "verdict": verdict,
                                    "fails": rec["fails"],
                                    "replicas_left": len(state.replicas),
                                },
                            )
                        except Exception:  # noqa: BLE001
                            pass
                if changed:
                    self._changed.notify_all()  # routers drop dead replicas now

    def _autoscale_locked(self, state: _DeploymentState, cfg: AutoscalingConfig) -> None:
        """Queue-depth autoscaling (parity: autoscaling_policy.py
        _calculate_desired_num_replicas): desired = ceil(total_ongoing /
        target_ongoing_requests), clamped to [min, max], rate-limited."""
        now = time.monotonic()
        total_ongoing = sum(state.last_inflight.values())
        n = max(1, len(state.replicas))
        desired = math.ceil(total_ongoing / max(cfg.target_ongoing_requests, 1e-9))
        desired = max(cfg.min_replicas, min(cfg.max_replicas, desired))
        if desired > state.target_replicas and now - state.last_scale_time >= cfg.upscale_delay_s:
            state.target_replicas = desired
            state.last_scale_time = now
        elif desired < state.target_replicas and now - state.last_scale_time >= cfg.downscale_delay_s:
            state.target_replicas = desired
            state.last_scale_time = now

    # decode pool scales up below this free-page fraction and back down
    # above the high-water (hysteresis gap absorbs admission churn)
    KV_LOW_WATER = 0.2
    KV_HIGH_WATER = 0.8

    def _probe_kv_pressure(self) -> None:
        """Refresh each decode replica's free-KV-page fraction (its pool's
        autoscaling signal).  Probes run OUTSIDE the lock like health
        checks — a busy engine must not stall the control loop."""
        with self._lock:
            targets = []
            for name, state in self._deployments.items():
                if state.roles is None:
                    continue
                for i, r in enumerate(state.replicas):
                    if i < len(state.replica_roles) and state.replica_roles[i] == "decode":
                        targets.append((name, r))
        if not targets:
            return
        results: Dict[tuple, float] = {}
        for name, r in targets:
            try:
                st = ray_tpu_torch.get(
                    r.handle_request.remote("stats", (), {}, None, None),
                    timeout=5.0,
                )
                pool = int(st.get("kv_block_pool_size", 0))
                if pool > 0:
                    results[(name, id(r))] = 1.0 - int(st.get("kv_blocks_in_use", 0)) / pool
            except Exception:  # noqa: BLE001 — probe failure = keep last
                continue
        with self._lock:
            for (name, rid), frac in results.items():
                state = self._deployments.get(name)
                if state is not None:
                    state.kv_free_frac[rid] = frac

    def _autoscale_roles_locked(self, state: _DeploymentState, cfg: AutoscalingConfig) -> None:
        """Per-role autoscaling for a disaggregated deployment: the
        prefill pool scales on queue depth (ongoing requests — prefill is
        compute-bound), the decode pool on free KV pages (decode is
        HBM-bound: a full pool sheds migrations long before its queue
        grows).  Each pool is clamped to [declared count, max_replicas]
        and rate-limited like homogeneous autoscaling."""
        now = time.monotonic()
        declared = state.roles or {}
        ongoing: Dict[str, int] = {}
        for i, r in enumerate(state.replicas):
            role = state.replica_roles[i] if i < len(state.replica_roles) else ""
            ongoing[role] = ongoing.get(role, 0) + state.last_inflight.get(id(r), 0)
        desired: Dict[str, int] = {}
        # prefill: queue-depth signal
        p_min = max(1, int(declared.get("prefill", 1)))
        desired["prefill"] = max(p_min, min(
            max(p_min, cfg.max_replicas),
            math.ceil(ongoing.get("prefill", 0) / max(cfg.target_ongoing_requests, 1e-9)),
        ))
        # decode: free-KV-page signal with hysteresis
        d_min = max(1, int(declared.get("decode", 1)))
        d_max = max(d_min, cfg.max_replicas)
        d_count = state.replica_roles.count("decode")
        fracs = [
            state.kv_free_frac[id(r)]
            for i, r in enumerate(state.replicas)
            if i < len(state.replica_roles)
            and state.replica_roles[i] == "decode"
            and id(r) in state.kv_free_frac
        ]
        d_desired = d_count
        if fracs:
            avg_free = sum(fracs) / len(fracs)
            if avg_free < self.KV_LOW_WATER:
                d_desired = d_count + 1
            elif avg_free > self.KV_HIGH_WATER:
                d_desired = d_count - 1
        desired["decode"] = max(d_min, min(d_max, d_desired))
        for role, want in desired.items():
            cur = state.role_targets.get(role, want)
            if want > cur and now - state.last_scale_time >= cfg.upscale_delay_s:
                state.role_targets[role] = want
                state.last_scale_time = now
            elif want < cur and now - state.last_scale_time >= cfg.downscale_delay_s:
                state.role_targets[role] = want
                state.last_scale_time = now
        state.target_replicas = sum(state.role_targets.values())

    def _publish_role_gauges_locked(self, state: _DeploymentState) -> None:
        from ray_tpu_torch.observability import metric_defs

        name = state.deployment.name
        for role in sorted(state.role_targets):
            count = state.replica_roles.count(role)
            ongoing = sum(
                state.last_inflight.get(id(r), 0)
                for i, r in enumerate(state.replicas)
                if i < len(state.replica_roles) and state.replica_roles[i] == role
            )
            tags = {"deployment": name, "role": role}
            metric_defs.SERVE_POOL_REPLICAS.set(count, tags)
            metric_defs.SERVE_POOL_ONGOING.set(ongoing, tags)

    def pool_status(self) -> Dict[str, dict]:
        """Per-role pool lines for rt llm / GET /api/overload: replica
        count, target, ongoing requests, and (decode) free-KV fraction."""
        with self._lock:
            out: Dict[str, dict] = {}
            for name, state in self._deployments.items():
                if state.roles is None:
                    continue
                pools: Dict[str, dict] = {}
                for role in sorted(state.role_targets):
                    idxs = [
                        i for i, rr in enumerate(state.replica_roles)
                        if rr == role and i < len(state.replicas)
                    ]
                    row = {
                        "replicas": len(idxs),
                        "target": int(state.role_targets.get(role, 0)),
                        "ongoing": sum(
                            state.last_inflight.get(id(state.replicas[i]), 0)
                            for i in idxs
                        ),
                    }
                    if role == "decode":
                        fracs = [
                            state.kv_free_frac[id(state.replicas[i])]
                            for i in idxs
                            if id(state.replicas[i]) in state.kv_free_frac
                        ]
                        if fracs:
                            row["kv_free_frac"] = round(sum(fracs) / len(fracs), 3)
                    pools[role] = row
                out[name] = pools
            return out

    def chaos_kill_replica(self, deployment: str, role: str = "decode",
                           index: int = 0) -> bool:
        """Chaos hook (`kill_decode_replica` schedule kind): kill the
        ``index``-th replica of ``role`` deterministically (list order, no
        randomness — fault logs must be byte-identical across same-seed
        replays).  The reconcile loop replaces it on the next tick."""
        with self._lock:
            state = self._deployments.get(deployment)
            if state is None:
                # default target: the first roles deployment, sorted by
                # name — deterministic, never random
                for name in sorted(self._deployments):
                    if self._deployments[name].roles is not None:
                        state = self._deployments[name]
                        break
            if state is None or state.roles is None:
                return False
            idxs = [
                i for i, rr in enumerate(state.replica_roles)
                if rr == role and i < len(state.replicas)
            ]
            if index >= len(idxs):
                return False
            idx = idxs[index]
            replica = state.replicas.pop(idx)
            state.replica_roles.pop(idx)
            state.health.pop(id(replica), None)
            state.kv_free_frac.pop(id(replica), None)
            state.version += 1
            self._changed.notify_all()
        try:
            ray_tpu_torch.kill(replica)
        except Exception:  # noqa: BLE001 — already dead is fine
            pass
        return True

    # ------------------------------------------------------------- admin
    def shutdown(self) -> None:
        try:
            from ray_tpu_torch.runtime.worker import global_worker

            global_worker().cluster.serve_controllers.pop(id(self), None)
        except Exception:  # noqa: BLE001
            pass
        with self._lock:
            self._running = False
            self._stopped.set()
            for state in self._deployments.values():
                self._scale_down_locked(state, 0)
            self._deployments.clear()
            self._apps.clear()
            self._changed.notify_all()
        # the control loop may be mid health-check (bounded by its probe
        # timeout): no serve-reconcile thread outlives the Serve instance
        if self._reconcile_thread is not threading.current_thread():
            self._reconcile_thread.join(timeout=self.HEALTH_CHECK_TIMEOUT_S + 1.0)

    def ping(self) -> str:
        return "ok"
