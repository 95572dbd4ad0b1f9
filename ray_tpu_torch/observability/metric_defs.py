"""Predefined core-runtime metrics (parity: ``src/ray/stats/metric_defs.cc``).

The port's copy of ``ray_tpu/observability/metric_defs.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

The reference pre-declares ~100 runtime metrics in one translation unit so
every component records into a shared, centrally-documented catalog.  Same
idea here: every default metric family the runtime emits is defined in this
module, registered on the global registry at import, and wired into the hot
paths of ``runtime/scheduler.py``, ``core/object_store.py``,
``runtime/worker_pool.py``, ``runtime/data_plane.py``, ``serve/router.py``
and the cluster fabric's task-commit path.  ``MetricsRegistry.
render_prometheus()`` (and thus the dashboard's ``/metrics`` scrape
endpoint) exposes them with no extra plumbing.

Naming follows Prometheus conventions: ``_total`` counters, ``_s`` /
``_bytes`` units, and the registry adds the ``ray_tpu_`` prefix at render
time.  ``ALL_METRICS`` lists every family for the exposition-validity test
in ``tests/test_tracing.py``.
"""

from __future__ import annotations

from ray_tpu_torch.observability.metrics import global_registry

_reg = global_registry()

# Latency boundaries: sub-millisecond placement decisions up to minute-scale
# task bodies.  Placement gets its own finer grid — the in-process scheduler
# decides in microseconds and the default buckets would collapse it into one.
_PLACEMENT_BOUNDS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0)
_LATENCY_BOUNDS = (1e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0, 120.0)

# ---- tasks ---------------------------------------------------------------
TASKS_SUBMITTED = _reg.counter(
    "tasks_submitted_total", "Tasks submitted by this driver, by type (normal/actor)."
)
TASKS_TERMINAL = _reg.counter(
    "tasks_terminal_total", "Terminal task states by outcome"
)
TASK_QUEUE_WAIT = _reg.histogram(
    "task_submit_to_start_s",
    "Latency from .remote() submission to execution start (scheduling + queueing).",
    "s",
    boundaries=_LATENCY_BOUNDS,
)
TASK_EXEC_TIME = _reg.histogram(
    "task_start_to_finish_s",
    "Latency from execution start to the terminal commit.",
    "s",
    boundaries=_LATENCY_BOUNDS,
)

# ---- scheduler -----------------------------------------------------------
SCHEDULER_QUEUE_DEPTH = _reg.gauge(
    "scheduler_queue_depth", "Tasks waiting on resources in a node's local scheduler.", "tasks"
)
SCHEDULER_PLACEMENT_LATENCY = _reg.histogram(
    "scheduler_placement_latency_s",
    "Wall time of the cluster-level node-selection decision per task.",
    "s",
    boundaries=_PLACEMENT_BOUNDS,
)
SCHEDULER_TASKS_DISPATCHED = _reg.counter(
    "scheduler_tasks_dispatched_total", "Tasks handed to an executor by a local scheduler."
)
SCHEDULER_LOCALITY_BYTES = _reg.counter(
    "scheduler_locality_bytes_total",
    "Dependency bytes of placed tasks, by result (hit = already local on the "
    "chosen node, miss = must transfer). Multi-node default/SPREAD decisions only.",
    "By",
)

# ---- object store --------------------------------------------------------
OBJECT_STORE_PUTS = _reg.counter(
    "object_store_puts_total", "Objects committed into a node's object store."
)
OBJECT_STORE_GETS = _reg.counter(
    "object_store_gets_total",
    "Object store lookups, by result (hit = value already local, miss = waiter parked).",
)
OBJECT_STORE_BYTES_PUT = _reg.counter(
    "object_store_bytes_put_total", "Accounted payload bytes committed into object stores.", "By"
)
OBJECT_STORE_BYTES_GOT = _reg.counter(
    "object_store_bytes_got_total", "Accounted payload bytes served by object-store hits.", "By"
)
OBJECT_STORE_SPILLS = _reg.counter(
    "object_store_spills_total",
    "Objects demoted a tier under memory pressure (device->host, host->shm/disk), by target tier.",
)
OBJECT_STORE_RESTORES = _reg.counter(
    "object_store_restores_total", "Objects promoted back to the host tier on access."
)
OBJECT_STORE_OBJECTS = _reg.gauge(
    "object_store_objects", "Live entries in a node's object store.", "objects"
)
OBJECT_STORE_USED_BYTES = _reg.gauge(
    "object_store_used_bytes", "Accounted bytes held per tier (hbm/host) in a node's store.", "By"
)

# ---- worker pool ---------------------------------------------------------
WORKER_POOL_WORKERS = _reg.gauge(
    "worker_pool_workers", "Process workers per pool, by state (idle/busy).", "workers"
)
WORKER_POOL_TASKS = _reg.counter(
    "worker_pool_tasks_total", "Stateless tasks submitted to process worker pools."
)
WORKER_POOL_SPAWNED = _reg.counter(
    "worker_pool_spawned_total", "Worker processes spawned."
)
WORKER_POOL_DEATHS = _reg.counter(
    "worker_pool_worker_deaths_total", "Worker processes that died or were killed."
)

# ---- actors --------------------------------------------------------------
ACTOR_CALLS_SUBMITTED = _reg.counter(
    "actor_calls_submitted_total", "Actor method calls submitted by this driver."
)

# ---- worker leases / direct dispatch -------------------------------------
LEASE_GRANTS = _reg.counter(
    "lease_grants_total",
    "Worker leases granted by the head scheduler, by reason (miss = first "
    "task of a scheduling key, spillback = leased node saturated). Each "
    "grant is ONE head scheduling decision amortized over every reuse.",
)
LEASE_REUSE_HITS = _reg.counter(
    "lease_reuse_hits_total",
    "Tasks routed through an already-granted worker lease — repeat-shape "
    "submissions that skipped the head's per-task scheduling decision.",
)
DIRECT_PUSHES = _reg.counter(
    "direct_pushes_total",
    "Tasks pushed straight to their leased executor, by transport (inproc "
    "= same-process local scheduler, data_plane = peer-to-peer push_task "
    "frame to an agent, actor_direct = cached actor route).",
)
HEAD_RPCS_AVOIDED = _reg.counter(
    "head_rpcs_avoided_total",
    "Head-side scheduling/dispatch hops avoided by lease reuse and direct "
    "actor routes — the head's steady-state work is O(lease churn), not "
    "O(tasks).",
)

# ---- data plane ----------------------------------------------------------
DATA_PLANE_BYTES = _reg.counter(
    "data_plane_transfer_bytes_total",
    "Bulk object bytes moved on the peer-to-peer data plane, by direction.",
    "By",
)
DATA_PLANE_TRANSFERS = _reg.counter(
    "data_plane_transfers_total", "Data-plane operations, by kind (pull/push/shm handoff)."
)
DATA_PLANE_LATENCY = _reg.histogram(
    "data_plane_transfer_latency_s",
    "Wall time of one client-side data-plane transfer (pull or push).",
    "s",
    boundaries=_LATENCY_BOUNDS,
)

# ---- pull manager --------------------------------------------------------
PULL_MANAGER_QUEUE_DEPTH = _reg.gauge(
    "pull_manager_queue_depth",
    "Dependency pulls waiting for in-flight-byte admission.",
    "pulls",
)
PULL_MANAGER_INFLIGHT_BYTES = _reg.gauge(
    "pull_manager_inflight_bytes",
    "Known bytes of admitted, not-yet-completed dependency pulls.",
    "By",
)
PULL_MANAGER_DEDUP_HITS = _reg.counter(
    "pull_manager_dedup_hits_total",
    "Pull requests coalesced onto an already-in-flight transfer of the same "
    "(object, destination).",
)
PULL_MANAGER_RETRIES = _reg.counter(
    "pull_manager_retries_total",
    "Pull attempts retried after a failed/stale source (the location is "
    "purged before re-resolving).",
)

# ---- broadcast (spanning-tree object fan-out) ----------------------------
BROADCAST_PLANS = _reg.counter(
    "broadcast_plans_total",
    "Broadcast plans built: concurrent pulls of one object to >= 2 "
    "destinations coalesced into a bounded-fanout spanning tree.",
)
BROADCAST_RELAY_BYTES = _reg.counter(
    "broadcast_relay_bytes_total",
    "Object bytes moved over relay tree edges (served by an interior "
    "destination, not the root source) — bytes the root did NOT have to send.",
    "By",
)
PULL_SOURCE_SELECTED = _reg.counter(
    "pull_source_selected_total",
    "Pull source decisions, by kind (sole = one replica existed, balanced = "
    "chosen round-robin among replicas, relay = an in-flight destination "
    "assigned as a chained/tree parent).",
)

# ---- compiled execution plans (dag/plan.py + runtime/channel_manager.py) -
COMPILED_PLAN_EXECUTIONS = _reg.counter(
    "compiled_plan_executions_total",
    "Iterations executed through installed compiled plans, by outcome "
    "(ok / error) — each one a full pipeline pass with zero TaskSpecs, "
    "scheduler hops, or ObjectRefs.",
)
COMPILED_CHANNEL_BYTES = _reg.counter(
    "compiled_channel_bytes_total",
    "Bytes moved over cross-process compiled-plan channel streams "
    "(chan_push frames), by direction.",
    "By",
)
COMPILED_CHANNEL_OCCUPANCY = _reg.gauge(
    "compiled_channel_occupancy",
    "Compiled-plan channel slots currently holding a value in this process "
    "(single-slot channels: occupancy == iterations buffered between stages).",
    "slots",
)
COMPILED_DEVICE_CHANNEL_BYTES = _reg.counter(
    "compiled_device_channel_bytes_total",
    "Array payload bytes moved over DEVICE-kind compiled-plan edges, by "
    "direction (sent / received).  These bytes bypassed pickle entirely: "
    "the chan_push frame was control-only (dtype/shape header) and the "
    "payload rode a device-to-device pull or raw host-staged buffers.",
    "By",
)
PLAN_STAGE_GROUP_EXECUTIONS = _reg.counter(
    "plan_stage_group_executions_total",
    "SPMD stage-group iterations executed through installed plans — one per "
    "gang dispatch (split args -> member jit step x N -> reassemble output).",
)

# ---- serve router --------------------------------------------------------
SERVE_ROUTER_REQUESTS = _reg.counter(
    "serve_router_requests_total", "Requests routed to replicas, by deployment."
)
SERVE_ROUTER_QUEUE_WAIT = _reg.histogram(
    "serve_router_queue_wait_s",
    "Time a request spends in the router before reaching a replica "
    "(replica choice + membership waits).",
    "s",
    boundaries=_LATENCY_BOUNDS,
)
SERVE_ROUTER_INFLIGHT = _reg.gauge(
    "serve_router_inflight", "Requests in flight to replicas, by deployment.", "requests"
)

# ---- chaos / fault injection ---------------------------------------------
CHAOS_FAULTS_INJECTED = _reg.counter(
    "chaos_faults_injected_total",
    "Faults injected by armed failpoints, by failpoint name and action.",
)

# ---- elasticity: drains, head failover, plan self-healing ----------------
NODE_DRAINS = _reg.counter(
    "node_drains_total",
    "Graceful node drains (Cluster.drain_node), by outcome (ok = evacuated "
    "and quiesced in budget, timeout = terminated with work/objects still "
    "in flight, noop = node already gone).",
)
DRAIN_EVACUATED_BYTES = _reg.counter(
    "drain_evacuated_bytes_total",
    "Bytes of sole-replica objects copied off draining nodes to survivors "
    "before termination.",
    "By",
)
HEAD_RESTARTS = _reg.counter(
    "head_restarts_total",
    "Head control-service restarts that restored durable state from the "
    "snapshot and re-adopted live nodes/actors.",
)
PLAN_REPAIRS = _reg.counter(
    "plan_repairs_total",
    "Compiled-plan repair attempts (ExecutionPlan.repair / auto-repair), "
    "by outcome (ok = plan returned to READY on restarted stage actors, "
    "failed = a stage actor never came back).",
)

# ---- elastic gang-scheduled training (train/controller.py) ---------------
TRAIN_STEPS = _reg.counter(
    "train_steps_total",
    "Optimizer steps completed by TrainController gang jobs (each step is "
    "one StageGroup dispatch: per-member grad shards assembled and summed "
    "in fixed member order, then one jit'd optimizer update).",
)
TRAIN_GANG_RESIZES = _reg.counter(
    "train_gang_resizes_total",
    "Elastic gang resizes, by reason (scale_up = capacity grew and the "
    "step re-traced at the larger mesh, scale_down = graceful drain of "
    "departing members, preempt = a serving burst or chaos event took "
    "members and the gang shrank to continue).",
)
TRAIN_REPAIRS = _reg.counter(
    "train_repairs_total",
    "Gang repair-and-resume recoveries, by outcome (repaired = repair() "
    "restored the same gang on restarted members, shrunk = a permanently "
    "dead member forced a rebuild at a smaller size, failed = recovery "
    "was impossible and the typed error surfaced to the caller).",
)
TRAIN_CHECKPOINT_SECONDS = _reg.histogram(
    "train_checkpoint_seconds",
    "Wall time of one digest-framed step-state checkpoint write "
    "(tmp+fsync+rename with .prev rotation) — the synchronous pause the "
    "train loop pays every train_checkpoint_period_steps.",
    "s",
    boundaries=_LATENCY_BOUNDS,
)

# ---- gray failures: fencing, deadlines, hedging --------------------------
FENCED_FRAMES = _reg.counter(
    "fenced_frames_total",
    "Control/data-plane frames rejected because they carried a stale node "
    "incarnation (a partitioned-but-alive agent outliving its death "
    "declaration), by frame kind (task_finished / object_location / "
    "resource_report / push_result / chan_push / register / ...).",
)
NODE_REJOINS = _reg.counter(
    "node_rejoins_total",
    "Fenced agents that self-fenced (killed workers, dropped their store, "
    "cleared lease pins) and re-registered as a FRESH node after a "
    "partition healed.",
)
TASK_DEADLINE_EXCEEDED = _reg.counter(
    "task_deadline_exceeded_total",
    "Tasks failed with DeadlineExceededError, by the lifecycle stage the "
    "deadline fired in (parked / queued / pulling / executing).",
)
TASK_HEDGES = _reg.counter(
    "task_hedges_total",
    "Hedged straggler retries, by outcome: won = the hedge attempt "
    "committed first, lost = the primary beat its hedge (the hedge was "
    "cancelled and its commits discarded by attempt fencing).",
)

# ---- overload survival: admission control + load shedding (ISSUE 9) ------
REQUESTS_SHED = _reg.counter(
    "requests_shed_total",
    "Requests rejected by a bounded admission queue, by layer (router / "
    "replica / engine / submission / demand_queue / store) and reason "
    "(queue_full / token_budget / inflight_cap / block_timeout / "
    "deadline_expired / disconnect) — every one carried a typed "
    "OverloadedError (or the deadline/store equivalent) with retry_after_s.",
)
ADMISSION_QUEUE_DEPTH = _reg.gauge(
    "admission_queue_depth",
    "Current depth of a bounded admission queue, by layer — under overload "
    "these saturate at their configured bounds instead of growing.",
    "requests",
)
TENANT_ADMISSIONS = _reg.counter(
    "tenant_admissions_total",
    "Requests admitted past an admission boundary, by tenant — the "
    "weighted-fairness witness (two competing tenants' admission rates "
    "track their configured weights).",
)
STORE_PUT_BACKPRESSURE = _reg.histogram(
    "store_put_backpressure_seconds",
    "Time object-store puts spent blocked on a full host+spill tier "
    "waiting for deletions to free room (bounded by "
    "store_put_backpressure_timeout_s, then StoreFullError).",
    "s",
    boundaries=_LATENCY_BOUNDS,
)
LLM_SLOTS_EVICTED = _reg.counter(
    "llm_slots_evicted_total",
    "LLM engine decode slots freed before stop/length, by reason "
    "(disconnect = the streaming consumer went away; its slot returns to "
    "the batch instead of decoding for nobody).",
)
LLM_KV_BLOCK_POOL_SIZE = _reg.gauge(
    "llm_kv_block_pool_size",
    "Usable pages in the LLM engine's paged KV block pool (excludes the "
    "reserved garbage page; 0 = dense cache).",
    "blocks",
)
LLM_KV_BLOCKS_IN_USE = _reg.gauge(
    "llm_kv_blocks_in_use",
    "KV pool pages currently held by admitted requests. in_use/pool_size "
    "is the real HBM occupancy of serving — the paged analog of "
    "active_slots/max_batch_size.",
    "blocks",
)
LLM_PREFILL_CHUNKS = _reg.counter(
    "llm_prefill_chunks_total",
    "Prefill chunks executed by the LLM engine (Sarathi-style chunked "
    "prefill: one prompt = ceil(len/prefill_chunk_tokens) chunks "
    "interleaved between decode steps).",
)
LLM_DECODE_STALL = _reg.histogram(
    "llm_decode_stall_seconds",
    "Time running decodes stalled waiting on prefill work admitted between "
    "decode steps. Chunked prefill bounds each observation to one chunk's "
    "forward instead of a whole prompt's.",
    "s",
    boundaries=_LATENCY_BOUNDS,
)
LLM_PREFIX_CACHE_HITS = _reg.counter(
    "llm_prefix_cache_hits_total",
    "Admitted LLM requests by prefix-cache outcome: result=hit (every full "
    "prompt block was cached), partial (some leading blocks), miss. Hit "
    "regions skip prefill compute entirely — the hit rate is the fraction "
    "of traffic whose TTFT is decoupled from prompt length.",
)
LLM_PREFIX_CACHE_BLOCKS = _reg.gauge(
    "llm_prefix_cache_blocks",
    "KV pool pages currently pinned by the prefix cache (one reference per "
    "cached full block). These pages are reclaimable: an LRU sweep evicts "
    "unreferenced leaves whenever admission runs short of pages.",
    "blocks",
)
LLM_KV_BLOCKS_SHARED = _reg.gauge(
    "llm_kv_blocks_shared",
    "KV pool pages with more than one reference (cache + live requests, or "
    "several requests on one shared prefix). Each extra reference is a "
    "page of HBM the pool did NOT have to spend — the capacity "
    "multiplication of prefix sharing.",
    "blocks",
)
LLM_PREFIX_EVICTIONS = _reg.counter(
    "llm_prefix_evictions_total",
    "Prefix-cache entries LRU-evicted (deterministic insertion-ordered "
    "tie-break) to return pages to a short pool or to respect "
    "prefix_cache_max_blocks.",
)

# Serving SLO families (request-scope observability): ms-scale boundaries
# matching observability/sketch.py SERVING_LATENCY_BOUNDS — the coarse
# _LATENCY_BOUNDS grid would collapse a 20 ms vs 80 ms TTFT regression
# into one bucket.  Keep the two grids in sync.
_SERVING_BOUNDS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)
LLM_TTFT = _reg.histogram(
    "llm_ttft_seconds",
    "Time to first token: engine submission to the first sampled token "
    "(prefill queue wait + KV-block wait + prefill compute). The SLO the "
    "prefix cache and chunked prefill exist to move.",
    "s",
    boundaries=_SERVING_BOUNDS,
)
LLM_INTER_TOKEN = _reg.histogram(
    "llm_inter_token_seconds",
    "Gap between consecutive streamed tokens of one request. The p99 is "
    "the running-stream stall a user feels when prefills or pool pressure "
    "preempt decode.",
    "s",
    boundaries=_SERVING_BOUNDS,
)
SERVE_REQUEST_PHASE = _reg.histogram(
    "serve_request_phase_seconds",
    "Per-phase time of traced serve requests, tagged phase= (proxy, "
    "router_queue, dispatch, replica, engine_queue, kv_block_wait, "
    "prefill, kv_migrate, decode, handler). Phases partition the request "
    "timeline: summed across phases they reproduce end-to-end latency.",
    "s",
    boundaries=_SERVING_BOUNDS,
)
LLM_KV_MIGRATIONS = _reg.counter(
    "llm_kv_migrations_total",
    "Disaggregated prefill->decode KV-block migrations by outcome= "
    "(device = pulled device-to-device through the transfer server, host = "
    "host-staged fallback after a refused pull, reprefill = decode-side "
    "failure fell back to re-prefilling on another replica, failed = the "
    "fallback ladder was exhausted).",
)
LLM_KV_MIGRATION_SECONDS = _reg.histogram(
    "llm_kv_migration_seconds",
    "Wall time of one KV-block migration: prefill-done to the decode "
    "replica holding every block (staging + pulls + adoption). Must "
    "amortize below one prefill chunk's latency or disaggregation is "
    "paying more than the interference it removes.",
    "s",
    boundaries=_SERVING_BOUNDS,
)
SERVE_POOL_REPLICAS = _reg.gauge(
    "serve_pool_replicas",
    "Replicas per deployment role pool, tagged role= (prefill/decode for "
    "disaggregated LLM deployments). Each role autoscales on its own "
    "bottleneck signal: prefill by ongoing requests, decode by free KV "
    "pages.",
    "replicas",
)
SERVE_POOL_ONGOING = _reg.gauge(
    "serve_pool_ongoing",
    "In-flight requests per deployment role pool, tagged role=. The "
    "per-role numerator of the queue-depth autoscaler.",
    "requests",
)

# ---- node utilization (dashboard reporter samples) -----------------------
NODE_CPU_PERCENT = _reg.gauge(
    "node_cpu_percent", "Host CPU utilization sampled by the node reporter.", "percent"
)
NODE_MEM_USED_BYTES = _reg.gauge(
    "node_mem_used_bytes", "Host memory in use sampled by the node reporter.", "By"
)
NODE_TPU_MEM_USED_BYTES = _reg.gauge(
    "node_tpu_mem_used_bytes", "Device HBM in use sampled by the node reporter.", "By"
)

#: every predefined family, for catalog tests and docs
ALL_METRICS = [
    TASKS_SUBMITTED,
    TASKS_TERMINAL,
    TASK_QUEUE_WAIT,
    TASK_EXEC_TIME,
    SCHEDULER_QUEUE_DEPTH,
    SCHEDULER_PLACEMENT_LATENCY,
    SCHEDULER_TASKS_DISPATCHED,
    SCHEDULER_LOCALITY_BYTES,
    OBJECT_STORE_PUTS,
    OBJECT_STORE_GETS,
    OBJECT_STORE_BYTES_PUT,
    OBJECT_STORE_BYTES_GOT,
    OBJECT_STORE_SPILLS,
    OBJECT_STORE_RESTORES,
    OBJECT_STORE_OBJECTS,
    OBJECT_STORE_USED_BYTES,
    WORKER_POOL_WORKERS,
    WORKER_POOL_TASKS,
    WORKER_POOL_SPAWNED,
    WORKER_POOL_DEATHS,
    ACTOR_CALLS_SUBMITTED,
    LEASE_GRANTS,
    LEASE_REUSE_HITS,
    DIRECT_PUSHES,
    HEAD_RPCS_AVOIDED,
    DATA_PLANE_BYTES,
    DATA_PLANE_TRANSFERS,
    DATA_PLANE_LATENCY,
    PULL_MANAGER_QUEUE_DEPTH,
    PULL_MANAGER_INFLIGHT_BYTES,
    PULL_MANAGER_DEDUP_HITS,
    PULL_MANAGER_RETRIES,
    BROADCAST_PLANS,
    BROADCAST_RELAY_BYTES,
    PULL_SOURCE_SELECTED,
    COMPILED_PLAN_EXECUTIONS,
    COMPILED_CHANNEL_BYTES,
    COMPILED_CHANNEL_OCCUPANCY,
    COMPILED_DEVICE_CHANNEL_BYTES,
    PLAN_STAGE_GROUP_EXECUTIONS,
    SERVE_ROUTER_REQUESTS,
    SERVE_ROUTER_QUEUE_WAIT,
    SERVE_ROUTER_INFLIGHT,
    CHAOS_FAULTS_INJECTED,
    NODE_DRAINS,
    DRAIN_EVACUATED_BYTES,
    HEAD_RESTARTS,
    PLAN_REPAIRS,
    TRAIN_STEPS,
    TRAIN_GANG_RESIZES,
    TRAIN_REPAIRS,
    TRAIN_CHECKPOINT_SECONDS,
    FENCED_FRAMES,
    NODE_REJOINS,
    TASK_DEADLINE_EXCEEDED,
    TASK_HEDGES,
    REQUESTS_SHED,
    ADMISSION_QUEUE_DEPTH,
    TENANT_ADMISSIONS,
    STORE_PUT_BACKPRESSURE,
    LLM_SLOTS_EVICTED,
    LLM_KV_BLOCK_POOL_SIZE,
    LLM_KV_BLOCKS_IN_USE,
    LLM_PREFILL_CHUNKS,
    LLM_DECODE_STALL,
    LLM_PREFIX_CACHE_HITS,
    LLM_PREFIX_CACHE_BLOCKS,
    LLM_KV_BLOCKS_SHARED,
    LLM_PREFIX_EVICTIONS,
    LLM_TTFT,
    LLM_INTER_TOKEN,
    SERVE_REQUEST_PHASE,
    LLM_KV_MIGRATIONS,
    LLM_KV_MIGRATION_SECONDS,
    SERVE_POOL_REPLICAS,
    SERVE_POOL_ONGOING,
    NODE_CPU_PERCENT,
    NODE_MEM_USED_BYTES,
    NODE_TPU_MEM_USED_BYTES,
]
