"""The metric families of the serving path, on the global registry.

The port's own copy of the part of ``ray_tpu/observability/metric_defs.py``
that its engine, admission control, request traces and disaggregated serving
record into: the ``LLM_*``, ``ADMISSION_*``, ``TENANT_*`` and
``SERVE_POOL_*`` families, with the shed and request-phase families they
feed.  Names, help strings and bucket boundaries are the JAX package's, so
the two expose the same series.  The registry adds the ``ray_tpu_`` prefix
at render time.  ``ALL_METRICS`` lists every family defined here.
"""

from __future__ import annotations

from ray_tpu_torch.observability.metrics import global_registry

_reg = global_registry()

_LATENCY_BOUNDS = (1e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0, 120.0)

# ---- admission control + load shedding -----------------------------------
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

# ---- LLM engine ----------------------------------------------------------
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

# Serving SLO families: ms-scale boundaries matching
# observability/sketch.py SERVING_LATENCY_BOUNDS.  Keep the two grids in sync.
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

#: every family defined here, for catalog tests and docs
ALL_METRICS = [
    REQUESTS_SHED,
    ADMISSION_QUEUE_DEPTH,
    TENANT_ADMISSIONS,
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
]
