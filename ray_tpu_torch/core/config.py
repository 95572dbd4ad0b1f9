"""Runtime configuration knobs, every one overridable via environment variable.

The port's copy of ``ray_tpu/core/config.py``: the same knobs, defaults and
``RAY_TPU_<NAME>`` overrides, so one environment configures both packages
(``tests/test_torch_observability.py`` holds the two field by field).

Parity with the reference's ``RAY_CONFIG`` macro system
(``src/ray/common/ray_config_def.h`` — 218 env-overridable knobs): each field
declared on :class:`Config` can be overridden with ``RAY_TPU_<NAME>`` in the
environment, or programmatically via the ``_system_config`` dict passed to
``ray_tpu_torch.init``.  Unlike the reference there is no C++/Python split to keep in
sync — one dataclass is the single source of truth.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict

_ENV_PREFIX = "RAY_TPU_"


@dataclasses.dataclass
class Config:
    # ---- object store ----------------------------------------------------
    # Max bytes of HBM the object table may pin before spilling to host.
    # 0 = auto (fraction of device memory).
    object_store_hbm_bytes: int = 0
    # Fraction of per-device HBM usable by the object store when auto.
    object_store_hbm_fraction: float = 0.35
    # Host-RAM tier capacity before spilling to the native shm store / disk.
    object_store_host_bytes: int = 8 * 1024**3
    # Chunk size for inter-host object transfer (reference: 5MiB chunks,
    # ray_config_def.h:352).
    object_transfer_chunk_bytes: int = 8 * 1024 * 1024
    # Directory for disk spill (last tier).
    spill_dir: str = "/tmp/ray_tpu_spill"

    # ---- scheduler -------------------------------------------------------
    # Hybrid policy spread threshold (reference hybrid_scheduling_policy.cc:48).
    scheduler_spread_threshold: float = 0.5
    # Top-k random choice among best nodes.
    scheduler_top_k_fraction: float = 0.2
    # Locality-aware placement (reference: locality_with_output /
    # LocalityAwareLeasePolicy, lease_policy.cc): for the default and SPREAD
    # strategies, a task is steered onto the node already holding the most
    # of its dependency bytes when that node leads the runner-up by at
    # least this margin.  0 disables the locality stage.
    scheduler_locality_threshold_bytes: int = 1024 * 1024

    # ---- workers ---------------------------------------------------------
    # CPU-task worker processes prestarted (off-thread) at node start; the
    # pool grows on demand past this, also without blocking submitters.
    num_prestart_workers: int = 1
    # Soft cap on idle workers kept alive per runtime env.
    idle_worker_cap: int = 8
    # Seconds before an idle worker process is reaped.
    idle_worker_timeout_s: float = 60.0

    # ---- control-plane persistence (GCS-with-Redis parity) --------------
    # When set, durable control state (KV, jobs, task events) snapshots to
    # this file periodically and reloads on the next init.
    control_snapshot_path: str = ""
    control_snapshot_interval_s: float = 10.0

    # ---- tasks / fault tolerance ----------------------------------------
    # Adaptive tiering: "auto" tasks whose observed mean wall time exceeds
    # this run in process workers (GIL-free parallelism); faster ones stay
    # on the zero-IPC in-process executor.
    inproc_task_threshold_s: float = 0.002
    # Optional defer before the inproc executor claims a queued task, giving
    # a sync waiter time to steal it inline. 0 (default): claim immediately
    # — stealing usually wins the race anyway and the delay throttles
    # async-burst drains.
    inproc_claim_delay_s: float = 0.0
    # Default max retries for normal tasks (reference default 3).
    task_max_retries: int = 3
    # Default max restarts for actors.
    actor_max_restarts: int = 0
    # Max bytes of lineage kept per worker (reference max_lineage_bytes).
    max_lineage_bytes: int = 1024**3
    # Health-check period / failure threshold.  Tolerance matches the
    # reference's GCS defaults (ray_config_def.h health_check_*_ms):
    # period * threshold of report silence.  (The JAX package's remote-node
    # ping budget, health_check_ping_timeout_s, comes with the multi-node
    # runtime, ROADMAP item 10, as do control_port, resource_sync_period_s,
    # data_plane_inline_bytes, location_commit_flush_* and rpc_retry_*:
    # nothing in the one-node port reads them.)
    health_check_period_s: float = 3.0
    health_check_failure_threshold: int = 5
    # How long an unschedulable task waits for capacity (e.g. autoscaler
    # scale-up) before failing as infeasible.
    infeasible_task_timeout_s: float = 30.0
    # Host-memory OOM guard (reference memory_monitor_refresh_ms /
    # memory_usage_threshold, ray_config_def.h). 0 disables the monitor.
    memory_monitor_refresh_ms: int = 250
    memory_usage_threshold: float = 0.95

    # Raise the cyclic-GC thresholds at init (restored at shutdown).
    # Measured: removes periodic 3x submit-throughput collapses caused by
    # collections firing every 700 allocations mid-burst.  Cycles are
    # still collected — just amortized over bursts.
    gc_tune_on_init: bool = True

    # ---- failpoints / chaos ----------------------------------------------
    # Deterministic fault-injection spec (runtime/failpoints.py), e.g.
    # "data_plane.send_frame=drop(0.05);rpc.call=delay(0.2,0.5)".  Empty =
    # everything disarmed (the near-zero-cost default).  The env form
    # (RAY_TPU_FAILPOINTS) is inherited by worker processes and the config
    # form propagates to node agents at registration, so one spec covers
    # the whole fabric.
    failpoints: str = ""
    # Seed of the failpoint decision stream: same (seed, spec, workload) ->
    # byte-for-byte identical fault log (failpoints.fault_log()).
    failpoint_seed: int = 0

    # ---- events / tracing ------------------------------------------------
    task_events_enabled: bool = True
    # Bounded task-event store size (reference GcsTaskManager eviction).
    task_events_max_entries: int = 100_000
    # Distributed task tracing: trace-context propagation through task specs
    # and per-phase spans (submit/schedule/execute/commit) merged into
    # ray_tpu_torch.timeline().  Cheap (a few dict builds per task); disable to
    # shave the last microseconds off the submit hot path.
    tracing_enabled: bool = True

    # ---- distributed -----------------------------------------------------
    # Admission control: concurrent bulk transfers served/issued per process
    # (reference: PullManager admission, pull_manager.h:52).
    max_concurrent_object_transfers: int = 4
    # PullManager admission: total bytes of in-flight dependency pulls the
    # fabric allows before further pulls queue (reference:
    # pull_manager.h:52 num_bytes_available_).  Pulls of unknown-size
    # objects are admitted without charging the budget.
    pull_manager_max_inflight_bytes: int = 1 << 30
    # First retry delay after a failed pull source (doubles per attempt,
    # capped at ~2s); the failed location is purged before re-resolving.
    pull_manager_retry_backoff_s: float = 0.05
    # Broadcast: concurrent pulls of ONE object to >= 2 destinations
    # coalesce into a bounded-fanout spanning tree (Cornet/Orchestra-style
    # cooperative broadcast) — the source serves at most this many direct
    # children; every completed destination relays further copies.  0
    # disables the planner (every pull goes straight to a replica).
    broadcast_fanout: int = 2
    # Serve-side frame cache on each data server: N consumers of one bulk
    # object cost one serialization, not N.  Entry count, 0 disables.
    data_server_frame_cache_entries: int = 4
    # Worker results/args decoded from the shm arena stay as READ-ONLY
    # zero-copy views pinned until garbage-collected (plasma Get semantics,
    # plasma/client.h:62) instead of being copied out. Disable for owned,
    # writable arrays at one extra memcpy per bulk value.
    zero_copy_shm_values: bool = True
    # Same-host peers hand bulk objects through the native shm arena
    # (one memcpy, zero socket bytes) instead of loopback TCP — plasma's
    # zero-copy local sharing role (reference: plasma/store.h:55, fd
    # passing fling.cc). Disable to force every transfer onto sockets.
    same_host_shm_transfer: bool = True
    # Compiled execution plans (dag/plan.py): per-frame timeout of the
    # persistent chan_push channel streams AND the inbound-slot delivery
    # wait.  A full consumer slot stalls the producer's ack this long
    # before the stream (and the plan) is declared wedged.
    compiled_plan_channel_timeout_s: float = 300.0
    # Channel kind for compiled-plan edges.  "auto" (and its alias
    # "device"): an edge whose payload is a jax array stays HBM-resident —
    # co-located handoffs are reference moves, cross-host frames carry a
    # control-only header with the payload bypassing pickle entirely
    # (device-to-device pull when a transfer server is up, raw host-staged
    # bytes otherwise); non-array payloads fall back to the pickle path
    # per-edge, per-seq.  "pickle" forces every edge onto the original
    # pickle-5 frame path.
    plan_channel_kind: str = "auto"
    # Producer-side staging depth for cross-host device edges: True keeps
    # the last TWO seqs' arrays staged for pull (seq-parity slots), so a
    # late or retried consumer pull can still fetch seq N-1 while seq N
    # stages — the double-buffering of the mutable-channel design.  False
    # stages one seq at a time.
    device_channel_double_buffer: bool = True
    # Upper bound on SPMD stage-group fan-out (members per gang stage).
    # Each iteration dispatches one member step per gang slot from the
    # stage executor's pool; compile rejects larger groups.
    plan_stage_group_max_members: int = 64
    # Default timeout for one actor-collective round (rendezvous + reduce).
    # Callers waiting on a collective result (rt.get) should budget MORE
    # than this so the collective's own timeout fires first with the
    # precise error, not the outer get's generic one.
    collective_timeout_s: float = 120.0
    # Head fault tolerance: how long a node agent keeps retrying the head
    # after a disconnect before giving up and exiting (reference: raylets
    # reconnect to a restarted GCS — core_worker.proto:443
    # RayletNotifyGCSRestart). 0 restores the round-2 exit-on-disconnect.
    agent_reconnect_timeout_s: float = 60.0
    # Graceful node drain (Cluster.drain_node, DrainRaylet parity): budget
    # for evacuating sole-replica objects AND for the node's in-flight
    # tasks to finish before the terminate lands anyway.
    drain_node_timeout_s: float = 30.0
    # Compiled-plan self-healing: how long repair() (and the auto-repair
    # thread of plans compiled with auto_repair=True) waits for each dead
    # stage actor to come back ALIVE through the restart FSM.
    compiled_plan_repair_timeout_s: float = 30.0

    # ---- worker leases / direct dispatch (runtime/scheduler.LeaseManager,
    # reference: cached RequestWorkerLease reuse per SchedulingKey,
    # direct_task_transport.cc:409) -----------------------------------------
    # How long an unused lease survives before it is returned (its pinned
    # worker goes back to the pool and the next submit re-grants). 0
    # disables lease caching entirely — every task takes the scheduled path.
    lease_idle_timeout_s: float = 10.0
    # Max cached leases (distinct nodes) per scheduling key; spillback
    # grants beyond this replace the most-saturated lease instead.
    max_leases_per_key: int = 2
    # Local-scheduler queue depth on a leased node that triggers a
    # spillback re-grant (raylet spillback parity) when another node could
    # take the work.  1 = any resource queueing spills (evaluated at most
    # every 50ms per lease, so a throughput burst pays ~20 scheduling
    # decisions/s, not one per task). 0 disables spillback — leases only
    # rotate on expiry.
    lease_spillback_queue_depth: int = 1

    # ---- gray failures: deadlines, hedging, control-plane retries --------
    # End-to-end task deadlines (.options(deadline_s=...)): after the
    # deadline fires the task is cancelled cooperatively; if it has not
    # committed a terminal state within this grace window the hosting
    # worker is force-killed (CancelTask force_kill parity).
    task_deadline_grace_s: float = 2.0
    # Poll period of the owner-side watchdog that enforces deadlines and
    # fires hedged retries.  Deadline/hedge latency is bounded by one tick.
    watchdog_poll_period_s: float = 0.02
    # Opt-in automatic hedging: when enabled, dep-free retryable tasks of a
    # SchedulingKey with a settled latency EWMA hedge once their attempt
    # outlives ewma * hedge_auto_multiplier (never below hedge_auto_min_s).
    hedge_auto_enabled: bool = False
    hedge_auto_multiplier: float = 3.0
    hedge_auto_min_samples: int = 10
    hedge_auto_min_s: float = 0.05

    # ---- overload survival: admission control + load shedding (ISSUE 9) --
    # Every waiting list between the ingress and the object store is
    # bounded; offered load beyond a bound SHEDS with a typed
    # OverloadedError carrying retry_after_s instead of growing a queue
    # until something OOMs.  See docs/fault_tolerance.md "Overload &
    # backpressure".
    #
    # Bound on the scheduler's parked demand queue (currently-infeasible
    # tasks/actor creations waiting for capacity).  Parks beyond it shed.
    demand_queue_max_entries: int = 4096
    # Per-caller cap on in-flight (submitted, not yet terminal) normal
    # tasks.  0 disables.  At the cap, submission follows
    # task_submit_overload_policy: "block" waits (bounded by
    # task_submit_block_timeout_s and the caller's remaining deadline
    # budget) then sheds; "shed" rejects immediately.
    max_inflight_tasks_per_caller: int = 0
    task_submit_overload_policy: str = "block"
    task_submit_block_timeout_s: float = 30.0
    # Bounded spill tier: max bytes of disk the object store's spill tier
    # may hold.  0 = unbounded (the pre-ISSUE-9 behavior).  When bounded, a
    # put that cannot fit in host + disk budgets backpressures up to
    # store_put_backpressure_timeout_s for deletions to free room, then
    # raises a typed StoreFullError (it never half-commits).
    object_store_max_disk_bytes: int = 0
    store_put_backpressure_timeout_s: float = 5.0
    # Default retry-after hint stamped on OverloadedError when a layer has
    # no better estimate of when capacity frees up.
    overload_retry_after_s: float = 1.0
    # Max seconds a request may WAIT in the serve router's bounded queue
    # (max_queued_requests >= 0) for a replica slot before shedding — a
    # wedged replica must cost a typed 429, not a handle call that never
    # returns.
    router_queue_wait_timeout_s: float = 30.0

    # ---- LLM serving engine: paged KV + chunked prefill -------------------
    # KV cache layout of serve.llm.LLMEngine: "paged" (default) allocates
    # fixed-size HBM pages per request through a block table — capacity
    # proportional to tokens actually cached; "dense" preallocates one
    # [L, B, Hkv, max_len, Dh] buffer (one full-length row per slot).
    # Engines under a mesh auto-fall back to dense (GSPMD paged scatter is
    # not wired yet).  See docs/tpu_design.md "Paged KV + chunked prefill".
    llm_cache_kind: str = "paged"
    # Tokens per KV page.  Smaller = finer-grained allocation (less slack
    # per request), larger = fewer pages to stream per decode step.  On
    # real TPUs keep it a multiple of the sublane tile (8 for f32, 16 for
    # bf16) so Pallas page blocks stay tileable.
    kv_block_size: int = 16
    # Total pages in the pool (one is reserved as the garbage page).
    # 0 = auto: max_batch_size * ceil(max_seq_len / kv_block_size) + 1,
    # i.e. dense-equivalent capacity; set it LOWER than auto to serve more
    # slots than dense could back at the same HBM budget.
    kv_num_blocks: int = 0
    # Chunked prefill (Sarathi-style bounded per-iteration prefill budget):
    # prompts longer than this prefill in fixed-size chunks interleaved
    # between decode steps, so running decodes never stall more than one
    # chunk's forward.  0 = one-shot (whole prompt, power-of-2 bucketed).
    prefill_chunk_tokens: int = 0
    # Prefix-aware KV reuse (paged engines only): finished requests publish
    # the full blocks of prompt+completion into a radix prefix cache
    # (serve/prefix_cache.py) and new requests share() the longest cached
    # prefix straight into their block table — zero prefill compute for the
    # hit region, refcounted pages, copy-on-write on divergence.
    llm_prefix_cache: bool = True
    # Max full blocks the prefix cache may pin (0 = bounded only by the
    # pool).  When the pool runs short, unreferenced cached leaves are
    # LRU-evicted before admission holds or sheds either way.
    prefix_cache_max_blocks: int = 0
    # Disaggregated prefill/decode serving (serve/disagg.py): attempts per
    # request on the migration fallback ladder.  Attempt 1 migrates the
    # prefill replica's KV blocks to a decode replica (device pull, then
    # host-staged fallback); each later attempt re-prefills from scratch on
    # a fresh prefill/decode pair.  Exhausting the ladder raises the typed
    # KVMigrationError to the caller.
    kv_migration_attempts: int = 2
    # Seconds the decode side waits for one staged KV block to arrive over
    # the device plane before treating the pull as refused and dropping to
    # the host-staged rung.
    kv_migration_pull_timeout_s: float = 30.0

    # ---- elastic gang-scheduled training (train/controller.py) -----------
    # Steps between TrainController step checkpoints (optimizer/step/RNG
    # state, digest-framed).  Repair-and-resume restores from the latest
    # one, so the period bounds recomputed work after a gang-member death.
    train_checkpoint_period_steps: int = 10
    # Floor on gang size: shrink recovery (a permanently-dead or preempted
    # member) and elastic resize never drop the gang below this many
    # members; below it the typed failure surfaces to the caller instead.
    train_gang_min_members: int = 1
    # Register the training gang with the admission machinery as a
    # preemptible background tenant: a serving burst may preempt members
    # (checkpoint -> shrink -> continue) and training absorbs spare
    # capacity.  Off = the gang holds its members like any foreground job.
    train_preemptible: bool = False

    # ---- request-scope serving observability -----------------------------
    # Lifecycle traces for serve requests (observability/reqtrace.py): a
    # RequestTrace born at the HTTP proxy rides the request through
    # router -> replica -> engine collecting phase-attributed timestamps,
    # kept in bounded rings and served by GET /api/requests + `rt requests`.
    # Pure wall-clock bookkeeping: consumes zero failpoint decisions, so
    # same-seed chaos fault logs stay byte-identical on or off.
    serve_request_trace: bool = True
    # Trace 1-in-N proxy requests (1 = every request).  Sampling bounds the
    # per-request overhead at high QPS; engine-side SLO sketches (TTFT,
    # inter-token) are unaffected — they observe every request regardless.
    serve_request_trace_sample_n: int = 1
    # Completed-trace ring capacity (recent + the slowest-N derive from it).
    serve_request_trace_ring: int = 512

    def apply_env_overrides(self) -> "Config":
        for f in dataclasses.fields(self):
            env_key = _ENV_PREFIX + f.name.upper()
            if env_key in os.environ:
                raw = os.environ[env_key]
                setattr(self, f.name, _coerce(raw, f.type))
        return self

    def apply_dict(self, overrides: Dict[str, Any]) -> "Config":
        for key, value in overrides.items():
            if not hasattr(self, key):
                raise ValueError(f"Unknown config key: {key}")
            setattr(self, key, value)
        return self


def _coerce(raw: str, annot: Any) -> Any:
    annot = str(annot)
    if "bool" in annot:
        return raw.lower() in ("1", "true", "yes")
    if "int" in annot:
        return int(raw)
    if "float" in annot:
        return float(raw)
    if "str" in annot:
        return raw
    return json.loads(raw)


_global_config: Config | None = None


def get_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config().apply_env_overrides()
    return _global_config


def set_config(config: Config) -> None:
    global _global_config
    _global_config = config


def reset_config() -> None:
    global _global_config
    _global_config = None
