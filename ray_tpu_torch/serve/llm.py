"""LLM serving: continuous batching over a shared KV cache, on the GPU.

Counterpart of ``ray_tpu/serve/llm.py`` (``LLMEngine``), with the same
scheduling, admission and release semantics:

- **Fixed decode slots.** B = ``max_batch_size`` slots; every decode step
  runs all B rows (inactive rows compute masked garbage through all-zero
  block tables, i.e. into the garbage page 0).
- **Paged KV cache (default).** K/V live in a shared device pool of pages
  ``[L, num_blocks, block_size, Hkv, Dh]``; each slot names its pages in an
  ``int32[B, max_blocks_per_slot]`` block table. Admission reserves a
  request's whole page budget up front. ``cache_kind="dense"`` keeps one
  ``[L, B, Hkv, S, Dh]`` row per slot.
- **Chunked prefill** (``prefill_chunk_tokens``; 0 = one-shot, power-of-2
  bucketed), interleaved with decode steps.
- **Prefix-aware KV reuse** (paged): finished requests publish full blocks
  into a radix prefix cache; admission shares the longest cached prefix
  into the new block table, with copy-on-write for a page about to be
  written while shared.
- **Bounded, tenant-fair waiting queue**: past ``max_queued_requests`` or
  the prefill-token budget, ``submit`` sheds with a typed
  ``OverloadedError``; an expired ``deadline_ts`` sheds with
  ``DeadlineExceededError``.

Where the JAX engine donates its cache to jitted steps, this engine updates
its pool tensors in place; a step that raises mid-update still leaves the
engine serving (the loop fails every in-flight request and reallocates the
cache). The K-step decode ``lax.scan`` is a Python loop. Sampling draws from
one ``torch.Generator`` per engine. On a CUDA device every decode token runs
the decode kernel (paged or dense) and a dense engine's prefill runs the
flash kernel.

Int8 weight-only serving (``quantize=True``): the stacked layer linears of
at least ``quantize_min_size`` elements are stored int8 with per-channel f32
scales (``quantize_layers``, on the engine's device; norm gains and the
embedding stay float). Every forward of the engine passes the scales as
``layer_scales=``, so on a CUDA device the six linears of each layer whose
scales are per output column (``wq``, ``wk``, ``wv``, ``w1``, ``w3``,
``w2``) run the int8 matmul kernel, and ``wo`` is dequantized one layer at
a time, as the JAX engine does every leaf. A MoE config (``num_experts >
0``) serves the same way: ``wq``, ``wk`` and ``wv`` run the kernel, and
``wo``, the router and the experts (``we1``, ``we3``, ``we2``, quantized
along the expert axis, so their scales vary along the contracted axis) are
dequantized one layer at a time.

Observability, as the JAX engine's: ``tenant``, ``deadline_ts`` and the
request trace default to the request context (``runtime/context.py``); the
engine registers an admission source (:meth:`LLMEngine.admission_snapshot`),
keeps TTFT / inter-token / queue-wait / e2e latency sketches,
records the ``LLM_*``, ``ADMISSION_*`` and ``TENANT_*`` metric families, and
flight-records a crashed loop with its last finished requests.

Disaggregated prefill/decode (``serve/disagg.py``, ``role=``): a prefill
engine's :meth:`LLMEngine.prefill_export` stages the prompt's KV blocks as
copies and resolves to a header-only ticket; a decode engine's
:meth:`LLMEngine.adopt_migration` writes pulled blocks into its own pages
(on the engine loop, the only thread that writes the cache) and joins the
decode batch without prefilling.

:class:`LLMServer` wraps an engine as the class users deploy and call (token
ids or, with a tokenizer, text; streaming; the disaggregated halves), and
:class:`OpenAICompatLLMServer` answers OpenAI completion and chat bodies.
Both are plain classes: the Serve runtime that deploys them is not ported,
so the server is the ingress that starts and finishes a request's trace.

Not in this engine yet (ROADMAP): ``mesh=`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from types import GeneratorType
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.exceptions import DeadlineExceededError, OverloadedError
from ray_tpu_torch.models.generation import (
    copy_paged_page,
    decode_step,
    filter_top_k_top_p,
    forward_with_cache,
    init_cache,
    init_paged_cache,
    paged_decode_step,
    paged_forward_with_cache,
)
from ray_tpu_torch.models.common import default_device
from ray_tpu_torch.models.transformer import TransformerConfig
from ray_tpu_torch.observability import metric_defs, reqtrace
from ray_tpu_torch.observability.sketch import LatencySketch
from ray_tpu_torch.ops.quantization import quantize_layers
from ray_tpu_torch.runtime import admission, data_plane, device_plane
from ray_tpu_torch.runtime.context import (
    current_deadline_ts,
    current_request_trace,
    current_tenant,
    pop_request_trace,
    push_request_trace,
)
from ray_tpu_torch.serve import disagg
from ray_tpu_torch.serve.kv_blocks import BlockAllocator
from ray_tpu_torch.serve.prefix_cache import PrefixCache

_STREAM_END = object()

# prebuilt tag dicts for the per-request admission hot path
_EVICT_DISCONNECT_TAGS = {"reason": "disconnect"}
_PREFIX_RESULT_TAGS = {
    "hit": {"result": "hit"},
    "partial": {"result": "partial"},
    "miss": {"result": "miss"},
}


@dataclass
class GenRequest:
    prompt: List[int]
    max_tokens: int = 32
    temperature: float = 0.0
    eos_id: Optional[int] = None
    future: Future = field(default_factory=Future)
    stream_queue: Optional[Any] = None  # queue.Queue when streaming
    # admission metadata: the tenant (weighted fairness key) and the
    # deadline — an expired deadline sheds instead of taking a decode slot
    tenant: Optional[str] = None
    deadline_ts: Optional[float] = None
    # consumer-gone flag (streaming): the engine evicts the decode slot
    # instead of generating for nobody
    cancelled: bool = False
    # filled by the engine
    slot: int = -1
    generated: List[int] = field(default_factory=list)
    # chunked prefill progress: prompt tokens already cached (paged engine)
    prefill_pos: int = 0
    # request-scope observability: the lifecycle trace riding the request
    # context (None when tracing is off or the engine is driven directly),
    # and engine-side perf_counter stamps that feed the latency sketches
    trace: Optional[Any] = None
    t_submit: float = 0.0
    t_first: float = 0.0
    t_last_tok: float = 0.0
    # queue wait observed exactly once (a held head-of-line request passes
    # _pop_admissible again and must not count twice)
    wfq_popped: bool = False
    # disaggregated serving: an EXPORT request prefills, stages its block
    # set under this migration id and resolves with a ticket instead of
    # decoding; an IMPORT request carries the producer's ticket and pulled
    # blocks and joins the decode batch without prefilling
    export_mig_id: Optional[str] = None
    import_ticket: Optional[dict] = None
    import_arrays: Optional[Dict[int, Any]] = None

    def emit(self, tok: int) -> None:
        if self.stream_queue is not None:
            self.stream_queue.put(tok)


class _TokenStream:
    """Iterator over a streaming request's tokens whose ``close()`` (called
    explicitly, or via GC of an abandoned iterator) marks the request
    abandoned — the engine frees its decode slot (or its waiting-queue
    budget, if never admitted) instead of generating for nobody."""

    __slots__ = ("_gen", "_req", "_engine")

    def __init__(self, gen, req: GenRequest, engine: "LLMEngine"):
        self._gen = gen
        self._req = req
        self._engine = engine

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)

    def close(self) -> None:
        self._gen.close()
        if not self._req.future.done():
            self._engine._abandon_stream(self._req)

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — GC teardown must never raise
            pass


def _bucket(n: int, lo: int = 16, cap: Optional[int] = None) -> int:
    """Smallest power-of-2 bucket >= n (floored at ``lo``), clamped to
    ``cap``. A length past the cap raises."""
    if cap is not None and n > cap:
        raise ValueError(f"length {n} exceeds the cache capacity {cap}")
    b = lo
    while b < n:
        b *= 2
    return b if cap is None else min(b, cap)


class LLMEngine:
    """Continuous-batching decode engine for one model on one device.

    Thread model: callers enqueue via :meth:`submit` (thread-safe); one
    background loop admits requests and steps the batch, and is the only
    thread that touches the device cache."""

    def __init__(
        self,
        cfg: TransformerConfig,
        params: Any,
        *,
        device=None,
        max_batch_size: int = 8,
        max_seq_len: int = 512,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        quantize: bool = False,
        quantize_min_size: int = 4096,
        mesh: Optional[Any] = None,
        decode_chunk: int = 1,
        max_queued_requests: int = 256,
        max_queued_prefill_tokens: int = 0,
        tenant_weights: Optional[Dict[str, float]] = None,
        cache_kind: Optional[str] = None,
        kv_block_size: Optional[int] = None,
        kv_num_blocks: Optional[int] = None,
        prefill_chunk_tokens: Optional[int] = None,
        prefix_cache: Optional[bool] = None,
        prefix_cache_max_blocks: Optional[int] = None,
        role: Optional[str] = None,
    ):
        if mesh is not None:
            raise NotImplementedError("multi-device (mesh) serving is not ported yet")
        # disaggregated pool role ("prefill"/"decode", "" = co-located);
        # informational except for validation: either role runs either path
        if role not in (None, "", "prefill", "decode"):
            raise ValueError(f"role must be 'prefill' or 'decode', got {role!r}")
        self.role = role or ""
        # the cache knobs default to Config (RAY_TPU_<NAME> in the
        # environment); explicit arguments override them
        rc = get_config()
        kind = cache_kind if cache_kind is not None else rc.llm_cache_kind
        if kind not in ("dense", "paged"):
            raise ValueError(f"cache_kind must be 'dense' or 'paged', got {kind!r}")
        if self.role and kind != "paged":
            raise ValueError(
                f"role={self.role!r} requires the paged KV cache: a dense "
                "cache has no block table to migrate between replicas"
            )
        self.device = default_device(device, "LLMEngine")
        self.cfg = cfg
        self.B = max_batch_size
        self.S = max_seq_len
        self.cache_kind = kind
        self.kv_block_size = int(kv_block_size if kv_block_size is not None else rc.kv_block_size)
        if self.kv_block_size < 1:
            raise ValueError(f"kv_block_size must be >= 1, got {self.kv_block_size}")
        # static block-table width: enough logical blocks for a max-length
        # sequence — the table shape never depends on the allocation pattern
        self.max_blocks_per_slot = -(-self.S // self.kv_block_size)
        nb = int(kv_num_blocks if kv_num_blocks is not None else rc.kv_num_blocks)
        if nb <= 0:
            # auto: dense-equivalent capacity (+1 for the garbage page)
            nb = self.B * self.max_blocks_per_slot + 1
        self.kv_num_blocks = nb
        self.prefill_chunk_tokens = int(
            prefill_chunk_tokens if prefill_chunk_tokens is not None
            else rc.prefill_chunk_tokens
        )
        self._allocator = BlockAllocator(nb) if kind == "paged" else None
        use_prefix = prefix_cache if prefix_cache is not None else rc.llm_prefix_cache
        pcb = int(
            prefix_cache_max_blocks if prefix_cache_max_blocks is not None
            else rc.prefix_cache_max_blocks
        )
        self._prefix = (
            PrefixCache(self.kv_block_size, pcb) if (kind == "paged" and use_prefix) else None
        )
        self._prefix_results = {"hit": 0, "partial": 0, "miss": 0}
        self._prefix_tokens_reused = 0
        self._cow_count = 0
        # bounded waiting queue: past the request-count bound, or the
        # prefill-token budget (0 = unbounded), submit() sheds
        self._max_queued = max(0, int(max_queued_requests))
        self._max_queued_tokens = max(0, int(max_queued_prefill_tokens))
        self._queued_tokens = 0
        self.num_slots_evicted = 0
        self.num_shed = 0
        self._prefill_count = 0  # prompts fully prefilled
        # tokens generated per engine-loop round (1 = per-token stepping);
        # a request finishing mid-chunk discards the tail tokens
        self.decode_chunk = max(1, int(decode_chunk))
        self.top_k = top_k
        self.top_p = top_p
        # params keep their dtype (cast at use, as in the JAX forward)
        params = _to_device(params, self.device)
        self.quantized = quantize
        if quantize:
            # weight-only int8 on the stacked layer linears (norm gains and
            # the embedding stay full precision); the scales go to every
            # forward, which runs K6 or dequantizes one layer at a time
            q_layers, self._layer_scales = quantize_layers(
                params["layers"], min_size=quantize_min_size
            )
            params = {**params, "layers": q_layers}
        else:
            self._layer_scales = None
        self.params = params

        self._queue = admission.WeightedFairQueue(tenant_weights)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._admission_token = admission.register_admission_source(
            "llm_engine", self.admission_snapshot
        )
        # per-engine series (keyed by the registry token): two engines must
        # not clobber each other's gauges
        self._depth_tags = {"layer": "engine", "engine": str(self._admission_token)}
        # per-engine SLO latency sketches, fed from the engine's own request
        # stamps (so they exist with no trace riding the request); written
        # by the engine and request threads, read torn-tolerant
        self._sketches = {
            "ttft": LatencySketch(),
            "inter_token": LatencySketch(),
            "queue_wait": LatencySketch(),
            "e2e": LatencySketch(),
        }
        # bounded ring of recently terminated request summaries: the flight
        # recorder's material when the loop crashes
        self._finished_ring: deque = deque(maxlen=64)

        # slot state (host mirrors of what each step sends to the device)
        self._slots: List[Optional[GenRequest]] = [None] * self.B
        self._last_tok = np.zeros(self.B, np.int64)
        self._pos = np.zeros(self.B, np.int64)
        self._temps = np.zeros(self.B, np.float32)
        self._active = np.zeros(self.B, bool)
        self._block_tables = np.zeros((self.B, self.max_blocks_per_slot), np.int32)
        self._slot_blocks: List[List[int]] = [[] for _ in range(self.B)]
        # slots held by a request whose chunked prefill is still running
        self._reserved = np.zeros(self.B, bool)
        self._prefilling: List[GenRequest] = []
        # head-of-line request waiting for pages: held, not re-pushed (that
        # would break the fair order) until release paths free blocks
        self._held_req: Optional[GenRequest] = None
        self._prefill_chunk_count = 0
        # disaggregated serving: staged exports parked by migration id (the
        # staged block copies outlive the request's pool pages, which retire
        # into the prefix cache at export) and the migration counters
        self._staged: Dict[str, dict] = {}
        self.num_migrations_out = 0
        self.num_migrations_in = 0
        metric_defs.LLM_KV_BLOCK_POOL_SIZE.set(
            self._allocator.capacity if self._allocator is not None else 0, self._depth_tags
        )
        metric_defs.LLM_KV_BLOCKS_IN_USE.set(0, self._depth_tags)
        metric_defs.LLM_KV_BLOCKS_SHARED.set(0, self._depth_tags)
        metric_defs.LLM_PREFIX_CACHE_BLOCKS.set(0, self._depth_tags)

        self._reset_cache()
        # the engine's sampling stream (replaces a jax.random key)
        self._gen = torch.Generator(device=self.device)
        self._gen.seed()

        self._thread = threading.Thread(target=self._loop, daemon=True, name="llm-engine")
        self._thread.start()

    # -- device programs (the JAX engine's jitted callables) ----------------
    def _tensor(self, a, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype).to(self.device)

    def _sample_impl(self, logits: torch.Tensor, temps: np.ndarray) -> torch.Tensor:
        """Per-slot temperature; temp <= 0 means greedy. ``temps`` is the
        host copy, so an all-greedy batch never touches the generator."""
        greedy_tok = torch.argmax(logits, dim=-1)
        if not (temps > 0).any():
            return greedy_tok
        t = self._tensor(temps, torch.float32)
        greedy = t <= 0.0
        scaled = filter_top_k_top_p(
            logits / torch.where(greedy, 1.0, t)[:, None], self.top_k, self.top_p
        )
        sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1, generator=self._gen)[:, 0]
        return torch.where(greedy, greedy_tok, sampled)

    @torch.inference_mode()
    def _prefill_one(self, tokens: np.ndarray, length: int, slot: int) -> torch.Tensor:
        """tokens [1, Tb] (bucket-padded) prefilled from position 0 straight
        into ``slot``'s row of the dense cache (the JAX engine builds a row
        and inserts it; writing in place is the same bytes). Returns the
        last real token's logits [V]."""
        row = {kk: self._cache[kk][:, slot : slot + 1] for kk in ("k", "v")}
        toks = self._tensor(tokens)
        positions = torch.arange(toks.shape[1], device=self.device)[None, :]
        logits, _ = forward_with_cache(
            self.cfg, self.params, row, toks, positions, layer_scales=self._layer_scales,
            use_prefill_kernel=self.device.type == "cuda",  # positions start at 0
        )
        return logits[0, length - 1]

    @torch.inference_mode()
    def _decode_k(self, toks: np.ndarray, pos: np.ndarray, temps: np.ndarray) -> np.ndarray:
        """K = decode_chunk sequential decode+sample steps; returns [B, K]."""
        t, p = self._tensor(toks), self._tensor(pos)
        out = []
        for _ in range(self.decode_chunk):
            logits, _ = decode_step(self.cfg, self.params, self._cache, t, p,
                                    layer_scales=self._layer_scales)
            t = self._sample_impl(logits, temps)
            out.append(t)
            p = p + 1
        return torch.stack(out, dim=1).cpu().numpy()

    @torch.inference_mode()
    def _prefill_chunk(self, toks: np.ndarray, bt: np.ndarray, start: int, length: int) -> torch.Tensor:
        """toks [1, C] chunk-padded; bt [1, M]. Writes K/V for the chunk's
        ``length`` real tokens through the block table and returns the last
        real token's logits [V] (only the final chunk's are consumed)."""
        C = toks.shape[1]
        ar = torch.arange(C, device=self.device)
        positions = (start + ar)[None, :]
        valid = (ar < length)[None, :]
        logits, _ = paged_forward_with_cache(
            self.cfg, self.params, self._cache, self._tensor(bt, torch.int32),
            self._tensor(toks), positions, valid=valid, use_decode_kernel=False,
            layer_scales=self._layer_scales,
        )
        return logits[0, length - 1]

    @torch.inference_mode()
    def _decode_k_paged(self, toks, pos, temps, bt) -> np.ndarray:
        t, p = self._tensor(toks), self._tensor(pos)
        bt_t = self._tensor(bt, torch.int32)
        out = []
        for _ in range(self.decode_chunk):
            logits, _ = paged_decode_step(self.cfg, self.params, self._cache, t, p, bt_t,
                                          layer_scales=self._layer_scales)
            t = self._sample_impl(logits, temps)
            out.append(t)
            p = p + 1
        return torch.stack(out, dim=1).cpu().numpy()

    @torch.inference_mode()
    def _copy_page(self, src: int, dst: int) -> None:
        copy_paged_page(self._cache, src, dst)

    def _sample_first(self, logits: torch.Tensor, temperature: float) -> int:
        return int(self._sample_impl(logits[None, :], np.asarray([temperature], np.float32))[0])

    # -- public API ---------------------------------------------------------
    def submit(
        self,
        prompt: List[int],
        *,
        max_tokens: int = 32,
        temperature: float = 0.0,
        eos_id: Optional[int] = None,
        tenant: Optional[str] = None,
        deadline_ts: Optional[float] = None,
        _stream_queue=None,
    ) -> Future:
        """Enqueue one request; resolves to the generated token-id list.

        ``tenant`` (default: the request context's tenant) keys weighted
        fair queuing; ``deadline_ts`` (wall clock; default: the request
        context's deadline) sheds on arrival when already expired. Raises
        ``OverloadedError`` when the bounded waiting queue (count or
        prefill-token budget) is full."""
        return self._submit_req(
            prompt, max_tokens=max_tokens, temperature=temperature, eos_id=eos_id,
            tenant=tenant, deadline_ts=deadline_ts, _stream_queue=_stream_queue,
        ).future

    def _submit_req(
        self,
        prompt: List[int],
        *,
        max_tokens: int = 32,
        temperature: float = 0.0,
        eos_id: Optional[int] = None,
        tenant: Optional[str] = None,
        deadline_ts: Optional[float] = None,
        _stream_queue=None,
        _export_mig_id: Optional[str] = None,
        _import_ticket: Optional[dict] = None,
        _import_arrays: Optional[Dict[int, Any]] = None,
    ) -> GenRequest:
        if self._stop:
            raise RuntimeError("LLMEngine is shut down")
        if not prompt:
            raise ValueError("empty prompt")
        if max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
        if len(prompt) + max_tokens > self.S:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_tokens ({max_tokens}) exceeds "
                f"engine max_seq_len {self.S}"
            )
        if self._allocator is not None:
            # never-fits: a request needing more pages than the POOL holds
            # is a config/input error, not a retry-after-able overload
            needed = -(-(len(prompt) + max_tokens - 1) // self.kv_block_size)
            if needed > self._allocator.capacity:
                raise ValueError(
                    f"prompt ({len(prompt)}) + max_tokens ({max_tokens}) needs "
                    f"{needed} KV blocks but the pool only holds "
                    f"{self._allocator.capacity} and would never be admitted"
                )
        if self._max_queued_tokens and len(prompt) > self._max_queued_tokens:
            raise ValueError(
                f"prompt ({len(prompt)} tokens) exceeds the engine's "
                f"max_queued_prefill_tokens budget ({self._max_queued_tokens}) "
                "and would never be admitted"
            )
        if tenant is None:
            tenant = current_tenant()
        if deadline_ts is None:
            deadline_ts = current_deadline_ts()
        # stamp the engine-submit boundary before any shed, so a shed
        # request's trace still shows where it died
        trace = current_request_trace()
        if trace is not None:
            trace.mark("engine_submit")
        if deadline_ts is not None and time.time() >= deadline_ts:
            # shed-on-arrival: the answer would come too late to be used
            with self._lock:
                self.num_shed += 1
            admission.record_shed("engine", "deadline_expired")
            raise DeadlineExceededError("llm_request", "engine_admission", 0.0)
        with self._lock:
            depth = len(self._queue)
            if self._max_queued and depth >= self._max_queued:
                self.num_shed += 1
                raise admission.shed(
                    "engine", "queue_full",
                    message=f"engine waiting queue at its {self._max_queued}-request bound",
                )
            if (
                self._max_queued_tokens
                and self._queued_tokens + len(prompt) > self._max_queued_tokens
            ):
                self.num_shed += 1
                raise admission.shed(
                    "engine", "token_budget",
                    message=(
                        f"queued prefill tokens {self._queued_tokens} + "
                        f"{len(prompt)} exceed the {self._max_queued_tokens}-token budget"
                    ),
                )
            req = GenRequest(
                list(prompt), max_tokens, temperature, eos_id,
                stream_queue=_stream_queue, tenant=tenant, deadline_ts=deadline_ts,
                trace=trace, export_mig_id=_export_mig_id,
                import_ticket=_import_ticket, import_arrays=_import_arrays,
            )
            req.t_submit = time.perf_counter()
            self._queue.push(req, tenant)
            self._queued_tokens += len(prompt)
            depth += 1
        metric_defs.ADMISSION_QUEUE_DEPTH.set(depth, self._depth_tags)
        metric_defs.TENANT_ADMISSIONS.inc(tags=admission.tenant_tags(tenant))
        self._wake.set()
        return req

    def generate(self, prompt: List[int], **kw) -> List[int]:
        return self.submit(prompt, **kw).result()

    def submit_stream(self, prompt: List[int], *, token_timeout_s: float = 120.0, **kw):
        """Per-token streaming: an iterator yielding token ids as they are
        sampled. Validation errors raise here, not mid-stream; engine errors
        re-raise at the end of iteration; a stalled engine raises after
        ``token_timeout_s`` without a token."""
        import queue as _queue

        q: "_queue.Queue" = _queue.Queue()
        req = self._submit_req(prompt, _stream_queue=q, **kw)
        return _TokenStream(self._stream_iter(req, q, token_timeout_s), req, self)

    def _stream_iter(self, req: GenRequest, q, token_timeout_s: float = 120.0):
        import queue as _queue

        fut = req.future
        while True:
            try:
                tok = q.get(timeout=token_timeout_s)
            except _queue.Empty:
                raise RuntimeError(
                    f"no token for {token_timeout_s}s — engine stalled or overloaded"
                ) from None
            if tok is _STREAM_END:
                exc = fut.exception() if fut.done() else None
                if exc is not None:
                    raise exc
                return
            yield tok

    def _abandon_stream(self, req: GenRequest) -> None:
        """Consumer gone: a still-WAITING request leaves the queue now; one
        holding a decode slot is evicted at the next engine-loop tick."""
        req.cancelled = True
        with self._lock:
            removed = self._queue.remove(req)
            if removed:
                self._queued_tokens -= len(req.prompt)
                self.num_shed += 1
            depth = len(self._queue)
        if removed:
            metric_defs.ADMISSION_QUEUE_DEPTH.set(depth, self._depth_tags)
            admission.record_shed("engine", "disconnect")
            self._record_done(req, "disconnect", "stream abandoned while queued")
            if not req.future.done():
                req.future.set_exception(
                    RuntimeError("stream consumer disconnected before admission")
                )
        else:
            self._wake.set()

    # -- disaggregated prefill/decode (serve/disagg.py) ---------------------
    def prefill_export(
        self,
        prompt: List[int],
        *,
        mig_id: str,
        temperature: float = 0.0,
        eos_id: Optional[int] = None,
        tenant: Optional[str] = None,
        deadline_ts: Optional[float] = None,
    ) -> Future:
        """Prefill-pool entry point: chunked-prefill ``prompt`` into the
        paged pool, sample the first token, stage the prompt's blocks under
        ``mig_id`` and resolve with the migration ticket (header only, no KV
        bytes). The request reserves only the prompt's pages
        (``max_tokens=1``): decode never runs here."""
        if self.cache_kind != "paged":
            raise ValueError("prefill_export requires the paged KV cache")
        return self._submit_req(
            prompt, max_tokens=1, temperature=temperature, eos_id=eos_id,
            tenant=tenant, deadline_ts=deadline_ts, _export_mig_id=mig_id,
        ).future

    def adopt_migration(
        self,
        ticket: dict,
        arrays: Dict[int, Any],
        *,
        max_tokens: int = 32,
        temperature: float = 0.0,
        eos_id: Optional[int] = None,
        tenant: Optional[str] = None,
        deadline_ts: Optional[float] = None,
        _stream_queue=None,
    ) -> GenRequest:
        """Decode-pool entry point: join the continuous batch from a
        migrated block set. ``arrays`` maps prompt block index -> the pulled
        ``[2, L, block_size, Hkv, Dh]`` stack (the caller pulls on its own
        thread; only the engine loop writes the cache); block indices this
        engine's prefix cache covers may be omitted. Admission, block
        budget, COW and prefix-cache semantics are the normal paged path;
        only the prefill compute is skipped."""
        if self.cache_kind != "paged":
            raise ValueError("adopt_migration requires the paged KV cache")
        return self._submit_req(
            list(ticket["prompt"]), max_tokens=max_tokens,
            temperature=temperature, eos_id=eos_id, tenant=tenant,
            deadline_ts=deadline_ts, _stream_queue=_stream_queue,
            _import_ticket=dict(ticket), _import_arrays=dict(arrays),
        )

    def peek_prefix_match(self, prompt: List[int]) -> int:
        """Longest cached prefix (tokens) of ``prompt`` in this engine's
        prefix cache: the decode side probes before pulling, so a warm
        prefix is not migrated again. Advisory: admission matches again, and
        a shrink in between fails the request with ``KVMigrationError``."""
        if self._prefix is None:
            return 0
        with self._lock:
            _, matched = self._prefix.match(prompt)
        return matched

    def kv_free_blocks(self) -> int:
        """Free pages right now (the decode-pool routing signal)."""
        alloc = self._allocator
        if alloc is None:
            return 0
        with self._lock:
            return alloc.free_blocks

    def release_migration(self, mig_id: str) -> bool:
        """Drop a staged export: forget its block copies, unregister its
        in-process source and withdraw its unpulled device offers.
        Idempotent; True if the staging existed. The pool pages already
        retired into the prefix cache at export, so this never touches the
        pool."""
        with self._lock:
            entry = self._staged.pop(mig_id, None)
        if entry is None:
            return False
        self._unstage(mig_id, entry)
        return True

    def _unstage(self, mig_id: str, entry: dict) -> None:
        data_plane.unregister_kv_block_source(mig_id)
        for bidx in range(entry["n_blocks"]):
            device_plane.withdraw_device_pull(disagg.migration_uuid(mig_id, bidx))
        if self.device.type == "cuda":
            # blocks other processes pulled over CUDA IPC and let go of
            torch.cuda.ipc_collect()

    def fetch_staged_block(self, mig_id: str, block_idx: int):
        """One staged block, the staged tensor as it is."""
        with self._lock:
            entry = self._staged.get(mig_id)
        if entry is None:
            raise KeyError(f"no staged migration {mig_id!r}")
        return entry["arrays"][block_idx]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            alloc = self._allocator
            return {
                "role": self.role,
                "migrations_out": self.num_migrations_out,
                "migrations_in": self.num_migrations_in,
                "staged_migrations": len(self._staged),
                "active_slots": int(self._active.sum()),
                "max_batch_size": self.B,
                "queued": len(self._queue),
                "queued_prefill_tokens": self._queued_tokens,
                "prefill_forwards": self._prefill_count,
                "slots_evicted": self.num_slots_evicted,
                "shed": self.num_shed,
                "cache_kind": self.cache_kind,
                "kv_block_size": self.kv_block_size if alloc is not None else 0,
                "kv_block_pool_size": alloc.capacity if alloc is not None else 0,
                "kv_blocks_in_use": alloc.used_blocks if alloc is not None else 0,
                "kv_blocks_shared": alloc.shared_blocks if alloc is not None else 0,
                "prefilling": len(self._prefilling),
                "prefill_chunks": self._prefill_chunk_count,
                "prefix_cache_enabled": self._prefix is not None,
                "prefix_cache_blocks": len(self._prefix) if self._prefix is not None else 0,
                "prefix_cache_hits": self._prefix_results["hit"],
                "prefix_cache_partial": self._prefix_results["partial"],
                "prefix_cache_misses": self._prefix_results["miss"],
                "prefix_tokens_reused": self._prefix_tokens_reused,
                "prefix_evictions": self._prefix.evictions if self._prefix is not None else 0,
                "cow_copies": self._cow_count,
            }

    def admission_snapshot(self) -> Dict[str, Any]:
        """Bounds, depths and SLO percentiles (the admission source)."""
        with self._lock:
            alloc = self._allocator
            pool = alloc.capacity if alloc is not None else 0
            in_use = alloc.used_blocks if alloc is not None else 0
            probes = sum(self._prefix_results.values())
            useful = self._prefix_results["hit"] + self._prefix_results["partial"]
            return {
                "layer": "engine",
                "role": self.role,
                "migrations_out": self.num_migrations_out,
                "migrations_in": self.num_migrations_in,
                "staged_migrations": len(self._staged),
                "queued": len(self._queue),
                "queue_bound": self._max_queued,
                "queued_prefill_tokens": self._queued_tokens,
                "token_budget": self._max_queued_tokens,
                "active_slots": int(self._active.sum()),
                "slots": self.B,
                "by_tenant": self._queue.depth_by_tenant(),
                "slots_evicted": self.num_slots_evicted,
                "shed": self.num_shed,
                "cache_kind": self.cache_kind,
                "kv_block_size": self.kv_block_size if alloc is not None else 0,
                "kv_block_pool_size": pool,
                "kv_blocks_in_use": in_use,
                "kv_blocks_shared": alloc.shared_blocks if alloc is not None else 0,
                "kv_block_occupancy": (in_use / pool) if pool else 0.0,
                "prefilling": len(self._prefilling),
                "prefill_chunks": self._prefill_chunk_count,
                "waiting_for_blocks": 1 if self._held_req is not None else 0,
                "prefix_cache_enabled": self._prefix is not None,
                "prefix_cache_blocks": len(self._prefix) if self._prefix is not None else 0,
                "prefix_hit_rate": (useful / probes) if probes else 0.0,
                "prefix_tokens_reused": self._prefix_tokens_reused,
                "prefix_evictions": self._prefix.evictions if self._prefix is not None else 0,
                # SLO percentiles from the engine-side latency sketches
                # (ttft / inter_token / queue_wait / e2e, seconds)
                "latency": {name: sk.percentiles() for name, sk in self._sketches.items()},
            }

    def shutdown(self) -> None:
        # once only: the freed admission token goes to the next engine, so a
        # second call (an explicit shutdown, then LLMServer.__del__) would
        # unregister that engine's source and zero its gauge series
        with self._lock:
            if self._stop:
                return
            self._stop = True
        self._wake.set()
        self._thread.join(timeout=5)
        admission.unregister_admission_source(self._admission_token)
        # zero this engine's gauge series; the freed token (and so the
        # series label) goes to the next engine
        metric_defs.ADMISSION_QUEUE_DEPTH.set(0, self._depth_tags)
        if self._allocator is not None:
            metric_defs.LLM_KV_BLOCKS_IN_USE.set(0, self._depth_tags)
            metric_defs.LLM_KV_BLOCK_POOL_SIZE.set(0, self._depth_tags)
            metric_defs.LLM_KV_BLOCKS_SHARED.set(0, self._depth_tags)
            metric_defs.LLM_PREFIX_CACHE_BLOCKS.set(0, self._depth_tags)
        with self._lock:
            pending = [r for r in self._queue.items() if not r.future.done()]
            pending += [r for r in self._slots if r is not None and not r.future.done()]
            pending += [r for r in self._prefilling if not r.future.done()]
            self._prefilling.clear()
            if self._held_req is not None:
                if not self._held_req.future.done():
                    pending.append(self._held_req)
                self._held_req = None
            self._queue.drain()
            self._queued_tokens = 0
            staged, self._staged = self._staged, {}
        for mig_id, entry in staged.items():
            self._unstage(mig_id, entry)
        for r in pending:
            r.future.set_exception(RuntimeError("LLMEngine shut down"))
            if r.stream_queue is not None:
                r.stream_queue.put(_STREAM_END)

    def flush_prefix_cache(self) -> int:
        """Evict every prefix-cache entry not shared into a live request and
        return the number of pages freed (also the leak-check primitive: on
        a quiesced engine, ``kv_blocks_in_use`` equals
        ``prefix_cache_blocks`` and a flush takes both to zero)."""
        if self._prefix is None:
            return 0
        with self._lock:
            pages = self._prefix.evict(len(self._prefix), self._evictable)
            if pages:
                self._allocator.free(pages)
            gauges = self._pool_gauges_locked()
        if pages:
            metric_defs.LLM_PREFIX_EVICTIONS.inc(len(pages))
        self._publish_pool_gauges(*gauges)
        return len(pages)

    def _evictable(self, page: int) -> bool:
        """Only pages whose sole reference is the cache's own may be
        evicted. Caller holds ``self._lock``."""
        return self._allocator.refcount(page) == 1

    def _pool_gauges_locked(self):
        """(in_use, shared, cache_blocks) snapshot; caller holds the lock."""
        alloc = self._allocator
        return (
            alloc.used_blocks if alloc is not None else 0,
            alloc.shared_blocks if alloc is not None else 0,
            len(self._prefix) if self._prefix is not None else 0,
        )

    def _publish_pool_gauges(self, in_use: int, shared: int, cache_blocks: int) -> None:
        metric_defs.LLM_KV_BLOCKS_IN_USE.set(in_use, self._depth_tags)
        metric_defs.LLM_KV_BLOCKS_SHARED.set(shared, self._depth_tags)
        metric_defs.LLM_PREFIX_CACHE_BLOCKS.set(cache_blocks, self._depth_tags)

    # -- request-scope latency bookkeeping ----------------------------------
    def _note_first_token(self, req: GenRequest) -> None:
        """TTFT boundary: the first sampled token leaves the engine."""
        now = time.perf_counter()
        req.t_first = req.t_last_tok = now
        if req.t_submit:
            ttft = now - req.t_submit
            self._sketches["ttft"].observe(ttft)
            metric_defs.LLM_TTFT.observe(ttft, self._depth_tags)
        if req.trace is not None:
            req.trace.note_token(0.0)  # marks first_token on the trace

    def _note_next_token(self, req: GenRequest) -> None:
        """Inter-token gap: one decode token after the first."""
        now = time.perf_counter()
        gap = now - req.t_last_tok
        req.t_last_tok = now
        self._sketches["inter_token"].observe(gap)
        metric_defs.LLM_INTER_TOKEN.observe(gap, self._depth_tags)
        if req.trace is not None:
            req.trace.note_token(gap)

    def _note_stall(self) -> None:
        """A prefill forward just stalled every running decode slot: count it
        on each stalled request's trace. Engine-thread-owned: every _slots
        mutation runs on the engine loop."""
        for r in self._slots:
            if r is not None and r.trace is not None:
                r.trace.note_stall()

    def _record_done(self, req: GenRequest, outcome: str, detail: str = "") -> None:
        """Terminal bookkeeping of every exit path: feed the e2e sketch
        (successful finishes only) and push a summary onto the bounded ring
        the flight recorder snapshots. An abnormal terminal claims the trace
        outcome here, so a later generic outcome cannot mislabel it."""
        now = time.perf_counter()
        e2e = (now - req.t_submit) if req.t_submit else 0.0
        if outcome == "finish":
            self._sketches["e2e"].observe(e2e)
        elif req.trace is not None:
            req.trace.set_outcome(outcome, detail or f"engine:{outcome}")
        self._finished_ring.append({
            "outcome": outcome,
            "detail": detail,
            "tenant": req.tenant or "",
            "prompt_tokens": len(req.prompt),
            "generated": len(req.generated),
            "e2e_ms": round(e2e * 1000.0, 3),
            "ttft_ms": (
                round((req.t_first - req.t_submit) * 1000.0, 3)
                if req.t_first and req.t_submit else None
            ),
        })

    def _sync_if_cuda(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- engine loop --------------------------------------------------------
    def _admit(self) -> None:
        if self.cache_kind == "paged":
            self._admit_paged()
        else:
            self._admit_dense()

    def _pop_admissible(self):
        """Pop (or resume the held) next runnable request, shedding the
        cancelled and the expired on the way. Returns ``(req, free_slots)``
        or ``None`` when nothing is admissible right now."""
        while True:
            with self._lock:
                free = [
                    i for i in range(self.B)
                    if not self._active[i] and not self._reserved[i]
                ]
                if not free:
                    return None
                if self._held_req is not None:
                    req = self._held_req
                    self._held_req = None
                elif len(self._queue):
                    req = self._queue.pop()  # weighted fair order across tenants
                    self._queued_tokens -= len(req.prompt)
                else:
                    return None
                depth = len(self._queue)
            metric_defs.ADMISSION_QUEUE_DEPTH.set(depth, self._depth_tags)
            if req.cancelled:
                with self._lock:
                    self.num_shed += 1
                admission.record_shed("engine", "disconnect")
                self._record_done(req, "disconnect", "stream consumer gone before admission")
                if not req.future.done():
                    req.future.set_exception(
                        RuntimeError("stream consumer disconnected before admission")
                    )
                continue
            if req.deadline_ts is not None and time.time() >= req.deadline_ts:
                with self._lock:
                    self.num_shed += 1
                admission.record_shed("engine", "deadline_expired")
                self._record_done(req, "deadline", "deadline expired while queued")
                if not req.future.done():
                    req.future.set_exception(
                        DeadlineExceededError("llm_request", "engine_queue", 0.0)
                    )
                if req.stream_queue is not None:
                    req.stream_queue.put(_STREAM_END)
                continue
            if not req.wfq_popped:
                # queue wait ends at the FIRST pop; a held request resumed
                # later is waiting for blocks, not in the queue
                req.wfq_popped = True
                if req.t_submit:
                    self._sketches["queue_wait"].observe(time.perf_counter() - req.t_submit)
                if req.trace is not None:
                    req.trace.mark("wfq_pop")
            return req, free

    def _admit_dense(self) -> None:
        while True:
            popped = self._pop_admissible()
            if popped is None:
                return
            req, free = popped
            slot = free[0]
            if req.trace is not None:
                # dense admission is immediate: no kv_block_wait phase
                req.trace.mark("admitted")
            try:
                tp = len(req.prompt)
                bucket = _bucket(tp, cap=self.S)
                toks = np.zeros((1, bucket), np.int64)
                toks[0, :tp] = req.prompt
                stalled = bool(self._active.any())
                t0 = time.perf_counter()
                logits = self._prefill_one(toks, tp, slot)
                if stalled:
                    # decode slots sat idle for this whole one-shot prefill
                    self._sync_if_cuda()
                    metric_defs.LLM_DECODE_STALL.observe(time.perf_counter() - t0)
                    self._note_stall()
                with self._lock:
                    self._prefill_count += 1
                # the first output token comes straight from the prefill logits
                tok0 = self._sample_first(logits, req.temperature)
            except BaseException as exc:  # noqa: BLE001
                # the popped request is in neither queue nor slots — fail it
                # HERE or its caller hangs forever
                self._fail_admit(req, exc)
                continue
            req.slot = slot
            req.generated = [tok0]
            self._note_first_token(req)
            req.emit(tok0)
            with self._lock:
                self._slots[slot] = req
                self._active[slot] = True
                self._last_tok[slot] = tok0
                self._pos[slot] = tp
                self._temps[slot] = req.temperature
            self._maybe_finish(req, tok0)

    def _admit_paged(self) -> None:
        """Block-aware admission: reserve the request's whole page budget up
        front (``ceil((prompt + max_tokens - 1) / block_size)``), so an
        admitted request never hits a mid-decode pool OOM. Prefill runs
        later, chunk by chunk, from ``_prefill_tick``.

        With the prefix cache, the longest cached prefix is ``share()``d into
        the block table and only the uncached suffix reserves fresh pages. A
        full-prompt hit still recomputes the LAST prompt token (its logits
        seed sampling) and that write would land in a shared page, so the
        final matched block is copy-on-write."""
        bs = self.kv_block_size
        while True:
            popped = self._pop_admissible()
            if popped is None:
                return
            req, free = popped
            tp = len(req.prompt)
            total = -(-(tp + req.max_tokens - 1) // bs)
            with self._lock:
                pages: List[int] = []
                matched = 0
                if self._prefix is not None:
                    pages, matched = self._prefix.match(req.prompt)
                cow_src = -1
                if matched == tp:
                    # full-prompt hit: the tail block must be writable
                    cow_src = pages.pop()
                    matched -= bs
                # pin the hit region (and the COW source) FIRST: the
                # eviction sweep below must never free a page we matched
                pins = pages + ([cow_src] if cow_src >= 0 else [])
                if pins:
                    self._allocator.share(pins)
                needed = total - len(pages)
                short = needed - self._allocator.free_blocks
                evicted_n = 0
                if short > 0 and self._prefix is not None:
                    evicted = self._prefix.evict(short, self._evictable)
                    if evicted:
                        self._allocator.free(evicted)
                        evicted_n = len(evicted)
                if needed > self._allocator.free_blocks:
                    # head-of-line waits for release paths to return pages;
                    # drop the pins — it re-probes the cache on wake
                    if pins:
                        self._allocator.free(pins)
                    self._held_req = req
                    if evicted_n:
                        metric_defs.LLM_PREFIX_EVICTIONS.inc(evicted_n)
                    return
                blocks = pages + self._allocator.alloc(needed)
                slot = free[0]
                self._reserved[slot] = True
                self._slot_blocks[slot] = blocks
                self._block_tables[slot, :] = 0
                self._block_tables[slot, : len(blocks)] = blocks
                hit_tokens = matched + (bs if cow_src >= 0 else 0)
                if self._prefix is not None:
                    fb = (tp // bs) * bs  # the matchable (full-block) region
                    result = (
                        ("hit" if hit_tokens == fb else "partial")
                        if hit_tokens > 0
                        else "miss"
                    )
                    self._prefix_results[result] += 1
                    self._prefix_tokens_reused += tp - 1 if cow_src >= 0 else matched
                gauges = self._pool_gauges_locked()
            if evicted_n:
                metric_defs.LLM_PREFIX_EVICTIONS.inc(evicted_n)
            self._publish_pool_gauges(*gauges)
            if self._prefix is not None:
                metric_defs.LLM_PREFIX_CACHE_HITS.inc(tags=_PREFIX_RESULT_TAGS[result])
            req.slot = slot
            if req.trace is not None:
                # pages reserved: kv_block_wait (wfq_pop -> here) is over
                req.trace.mark("admitted")
            # chunked prefill resumes at the first token whose KV is not
            # already in the table (tp - 1 for a full hit: one recompute)
            req.prefill_pos = matched
            if cow_src >= 0:
                try:
                    self._copy_page(cow_src, blocks[len(pages)])
                    with self._lock:
                        self._allocator.free([cow_src])  # drop the copy pin
                        self._cow_count += 1
                except BaseException as exc:  # noqa: BLE001
                    with self._lock:
                        self._allocator.free([cow_src])
                    self._fail_admit(req, exc)
                    continue
                req.prefill_pos = tp - 1
            if req.import_arrays is not None:
                # migrated request: its blocks land from the pulled copies
                # (or this engine's own prefix cache), no prefill. One
                # adoption per admission pass, so a burst of migrations does
                # not stall the running streams' decode cadence
                self._adopt_admitted(req, had_cow=cow_src >= 0)
                return
            with self._lock:
                self._prefilling.append(req)

    def _finish_prefill(self, req: GenRequest, logits: torch.Tensor) -> None:
        """Prompt is fully in the paged cache: sample the first token and
        hand the slot to the decode batch (or, for an export request, stage
        the block set for migration instead)."""
        tp = len(req.prompt)
        tok0 = self._sample_first(logits, req.temperature)
        if req.export_mig_id is not None:
            self._export_staged(req, tok0)
            return
        req.generated = [tok0]
        self._note_first_token(req)
        req.emit(tok0)
        with self._lock:
            slot = req.slot
            self._slots[slot] = req
            self._active[slot] = True
            self._reserved[slot] = False
            self._last_tok[slot] = tok0
            self._pos[slot] = tp
            self._temps[slot] = req.temperature
        self._maybe_finish(req, tok0)

    def _adopt_admitted(self, req: GenRequest, *, had_cow: bool) -> None:
        """Activate an admitted IMPORT request: write the pulled blocks into
        its fresh pages (on the engine loop, the only thread that writes the
        cache), then join the decode batch at position ``len(prompt)`` with
        the producer's first token. A warm local prefix covers its blocks
        without any write; a block neither cached nor pulled (the prefix
        shrank between the caller's probe and now) fails the request with
        ``KVMigrationError``."""
        ticket = req.import_ticket or {}
        mig_id = ticket.get("mig_id", "?")
        tp = len(req.prompt)
        bs = self.kv_block_size
        n_blocks = -(-tp // bs)
        if not had_cow:
            # prefill_pos = matched tokens (a multiple of block_size); with
            # a full-hit COW every prompt position is already paged in
            writes = []
            for bidx in range(req.prefill_pos // bs, n_blocks):
                arr = (req.import_arrays or {}).get(bidx)
                if arr is None:
                    self._fail_admit(req, disagg.KVMigrationError(
                        mig_id, "pulled",
                        f"block {bidx} neither locally cached nor pulled "
                        f"(local prefix match shrank to {req.prefill_pos} "
                        "tokens after the probe)",
                    ))
                    return
                writes.append((arr, int(self._block_tables[req.slot, bidx])))
            if writes:
                try:
                    self._write_blocks(writes)
                except BaseException as exc:  # noqa: BLE001
                    self._fail_admit(req, exc)
                    return
        tok0 = int(ticket.get("tok0", 0))
        req.generated = [tok0]
        now = time.perf_counter()
        req.t_first = req.t_last_tok = now
        if req.trace is not None:
            # the migration phase ends here: first_token was marked on the
            # prefill engine, decode gaps accrue on this one
            req.trace.mark("kv_migrate")
        req.emit(tok0)
        with self._lock:
            slot = req.slot
            self._slots[slot] = req
            self._active[slot] = True
            self._reserved[slot] = False
            self._last_tok[slot] = tok0
            self._pos[slot] = tp
            self._temps[slot] = req.temperature
            self.num_migrations_in += 1
        self._maybe_finish(req, tok0)

    @torch.inference_mode()
    def _write_blocks(self, writes) -> None:
        """Land a migrated block set in the pool in one scatter a cache:
        ``writes`` holds ``([2, L, block_size, Hkv, Dh] block, page)`` pairs."""
        kvs = torch.stack([a.to(self.device) for a, _ in writes])  # [N, 2, L, bs, Hkv, Dh]
        pages = torch.tensor([p for _, p in writes], device=self.device)
        for i, kk in enumerate(("k", "v")):
            self._cache[kk][:, pages] = kvs[:, i].transpose(0, 1).to(self._cache[kk].dtype)

    def _export_staged(self, req: GenRequest, tok0: int) -> None:
        """Export terminal of a prefill-pool request: copy the prompt's
        blocks out of the pool, offer them for device pulls under
        deterministic ``(request, block)`` uuids, register the in-process
        source, retire the POOL pages into this engine's prefix cache (the
        staged copies migrate, not the pages) and resolve the future with
        the header-only ticket."""
        mig_id = req.export_mig_id
        tp = len(req.prompt)
        bs = self.kv_block_size
        n_blocks = -(-tp // bs)
        req.generated = [tok0]
        self._note_first_token(req)
        # copies, never views: the pages retire into the prefix cache below
        # and a later request may write into them (torch.stack copies)
        pages = [int(self._block_tables[req.slot, bidx]) for bidx in range(n_blocks)]
        arrays = [torch.stack([self._cache["k"][:, page], self._cache["v"][:, page]])
                  for page in pages]
        transfer_addr = device_plane.transfer_address()
        if transfer_addr is not None:
            for bidx, arr in enumerate(arrays):
                if not device_plane.offer_device_pull(disagg.migration_uuid(mig_id, bidx), arr):
                    # staging cap hit: advertise no device rung
                    transfer_addr = None
                    break

        def _fetch(idx: int, _arrays=arrays):
            return _arrays[idx]

        data_plane.register_kv_block_source(mig_id, _fetch)
        with self._lock:
            # the pool pages retire into the prefix cache now (cached tokens
            # = the prompt: tok0 was sampled, never written back)
            evicted_n = self._retire_blocks_locked(req)
            self._staged[mig_id] = {"arrays": arrays, "prompt": list(req.prompt),
                                    "n_blocks": n_blocks}
            self.num_migrations_out += 1
            gauges = self._pool_gauges_locked()
        if evicted_n:
            metric_defs.LLM_PREFIX_EVICTIONS.inc(evicted_n)
        self._publish_pool_gauges(*gauges)
        ticket = disagg.make_ticket(
            mig_id,
            prompt=req.prompt,
            tok0=tok0,
            n_blocks=n_blocks,
            block_size=bs,
            block_shape=tuple(arrays[0].shape) if arrays else (0,),
            block_dtype=_dtype_name(arrays[0].dtype) if arrays else "float32",
            transfer_addr=transfer_addr,
            data_addr=disagg.local_data_addr(),
            source=str(self._admission_token),
        )
        self._record_done(req, "finish", f"export {mig_id}")
        req.future.set_result(ticket)

    def _fail_admit(self, req: GenRequest, exc: BaseException) -> None:
        """A popped request is in neither queue nor slots — fail it HERE or
        its caller hangs forever; return any reserved pages to the pool.
        The in-place cache stays valid (a half-written prefill only touched
        this request's own pages or page 0), so other slots keep serving."""
        self._record_done(req, "crash", f"prefill failed: {exc!r}")
        if not req.future.done():
            req.future.set_exception(RuntimeError(f"prefill failed: {exc!r}"))
        if req.stream_queue is not None:
            req.stream_queue.put(_STREAM_END)
        if self._allocator is not None and req.slot >= 0:
            with self._lock:
                self._release_blocks_locked(req.slot)
                gauges = self._pool_gauges_locked()
            self._publish_pool_gauges(*gauges)

    def _release_blocks_locked(self, slot: int) -> None:
        """Drop a slot's page references (one per block-table entry, shared
        or not, so every release path is this same free). Caller holds
        ``self._lock``."""
        blocks = self._slot_blocks[slot]
        self._slot_blocks[slot] = []
        self._block_tables[slot, :] = 0
        self._reserved[slot] = False
        if blocks:
            self._allocator.free(blocks)

    def _retire_blocks_locked(self, req: GenRequest) -> int:
        """Finish path: publish the request's full KV blocks into the prefix
        cache (the request's reference TRANSFERS to the cache for newly
        adopted nodes) and free everything else. Returns the number of pages
        LRU-evicted to respect ``prefix_cache_max_blocks``. Caller holds the
        lock."""
        slot = req.slot
        blocks = self._slot_blocks[slot]
        self._slot_blocks[slot] = []
        self._block_tables[slot, :] = 0
        self._reserved[slot] = False
        if not blocks:
            return 0
        if self._prefix is None:
            self._allocator.free(blocks)
            return 0
        # the last sampled token was never written back to the KV cache;
        # every token before it was — cache exactly those full blocks
        cached = req.prompt + req.generated[:-1]
        adopted, evicted = self._prefix.insert(cached, blocks, self._evictable)
        if evicted:
            self._allocator.free(evicted)
        rest = [b for b in blocks if b not in adopted]
        if rest:
            self._allocator.free(rest)
        return len(evicted)

    def _cow_shared_writes(self, slot: int, start: int, n: int) -> None:
        """Copy-on-write guard for positions ``[start, start+n)`` of
        ``slot``: any page the write would touch that is still shared
        (refcount > 1) is replaced by a fresh copy and the block-table entry
        swapped, so shared pages are only ever READ. Admission never maps a
        to-be-written block to a shared page, so this is a safety net."""
        if n < 1 or self._allocator is None:
            return
        bs = self.kv_block_size
        lo = max(0, start // bs)
        # decode overshoot past the table scatters into page 0 — no COW
        hi = min((start + n - 1) // bs, self.max_blocks_per_slot - 1)
        for bidx in range(lo, hi + 1):
            with self._lock:
                old = int(self._block_tables[slot, bidx])
                if old == 0 or self._allocator.refcount(old) <= 1:
                    continue
                if self._allocator.free_blocks < 1 and self._prefix is not None:
                    evicted = self._prefix.evict(1, self._evictable)
                    if evicted:
                        self._allocator.free(evicted)
                new = self._allocator.alloc(1)[0]  # typed shed if truly none
            # the old page holds >= 2 refs (ours included), so it cannot be
            # reallocated while the copy reads it
            self._copy_page(old, new)
            with self._lock:
                bl = self._slot_blocks[slot]
                bl[bl.index(old)] = new
                self._block_tables[slot, bidx] = new
                self._allocator.free([old])
                self._cow_count += 1

    def _prefill_tick(self) -> bool:
        """Advance the head prefilling request by one chunk. Returns True if
        any device work ran (the loop then skips its idle wait)."""
        with self._lock:
            while self._prefilling and self._prefilling[0].cancelled:
                req = self._prefilling.pop(0)
                self._release_blocks_locked(req.slot)
                self.num_shed += 1
                admission.record_shed("engine", "disconnect")
                self._record_done(req, "disconnect", "stream consumer gone during prefill")
                if not req.future.done():
                    req.future.set_exception(
                        RuntimeError("stream consumer disconnected during prefill")
                    )
                if req.stream_queue is not None:
                    req.stream_queue.put(_STREAM_END)
            if not self._prefilling:
                return False
            req = self._prefilling[0]
            gauges = self._pool_gauges_locked()
        self._publish_pool_gauges(*gauges)
        tp = len(req.prompt)
        start = req.prefill_pos
        chunk = self.prefill_chunk_tokens
        # one-shot width buckets the UNCACHED suffix, not the whole prompt
        width = min(chunk, self.S) if chunk > 0 else _bucket(tp - start, cap=self.S)
        n = min(width, tp - start)
        toks = np.zeros((1, width), np.int64)
        toks[0, :n] = req.prompt[start : start + n]
        stalled = bool(self._active.any())
        t0 = time.perf_counter()
        try:
            self._cow_shared_writes(req.slot, start, n)
            logits = self._prefill_chunk(
                toks, self._block_tables[req.slot : req.slot + 1], start, n
            )
            if stalled:
                self._sync_if_cuda()  # the stall lasts until the chunk has run
        except BaseException as exc:  # noqa: BLE001
            with self._lock:
                self._prefilling.pop(0)
            self._fail_admit(req, exc)
            return True
        if stalled:
            # decode slots sat idle while this chunk ran; chunking bounds it
            metric_defs.LLM_DECODE_STALL.observe(time.perf_counter() - t0)
            self._note_stall()
        metric_defs.LLM_PREFILL_CHUNKS.inc()
        if req.trace is not None:
            req.trace.note_prefill_chunk()
        with self._lock:
            self._prefill_chunk_count += 1
        req.prefill_pos = start + n
        if req.prefill_pos < tp:
            return True
        with self._lock:
            self._prefilling.pop(0)
            self._prefill_count += 1
        try:
            self._finish_prefill(req, logits)
        except BaseException as exc:  # noqa: BLE001
            self._fail_admit(req, exc)
        return True

    def _maybe_finish(self, req: GenRequest, tok: int) -> bool:
        done = len(req.generated) >= req.max_tokens or (
            req.eos_id is not None and tok == req.eos_id
        )
        if done:
            evicted_n = 0
            with self._lock:
                self._active[req.slot] = False
                self._slots[req.slot] = None
                if self._allocator is not None:
                    evicted_n = self._retire_blocks_locked(req)
                    gauges = self._pool_gauges_locked()
            if self._allocator is not None:
                if evicted_n:
                    metric_defs.LLM_PREFIX_EVICTIONS.inc(evicted_n)
                self._publish_pool_gauges(*gauges)
            self._record_done(req, "finish")
            req.future.set_result(req.generated)
            if req.stream_queue is not None:
                req.stream_queue.put(_STREAM_END)
        return done

    def _step(self) -> None:
        if self.cache_kind == "paged":
            # copy-on-write net: a decode chunk writes positions
            # [pos, pos + K) — give a slot its own copy of a shared page first
            for i in range(self.B):
                if self._active[i]:
                    self._cow_shared_writes(i, int(self._pos[i]), self.decode_chunk)
            # inactive rows decode through all-zero tables -> garbage page 0,
            # so freed pages are never written after release
            bt = self._block_tables * self._active[:, None].astype(np.int32)
            sampled = self._decode_k_paged(self._last_tok, self._pos, self._temps, bt)
        else:
            sampled = self._decode_k(self._last_tok, self._pos, self._temps)
        for k in range(sampled.shape[1]):
            for i in range(self.B):
                req = self._slots[i]  # engine-thread-owned; _lock is for readers
                if req is None:
                    continue  # free, or finished earlier in this chunk
                tok = int(sampled[i, k])
                req.generated.append(tok)
                self._note_next_token(req)
                req.emit(tok)
                self._pos[i] += 1
                self._last_tok[i] = tok
                self._maybe_finish(req, tok)

    def _reset_cache(self) -> None:
        """(Re)allocate the device cache — also the recovery path after a
        step failed mid-update and left the pool in an unknown state."""
        if self.cache_kind == "paged":
            self._cache = init_paged_cache(
                self.cfg, self.kv_num_blocks, self.kv_block_size, device=self.device
            )
        else:
            self._cache = init_cache(self.cfg, self.B, self.S, device=self.device)

    def _fail_inflight(self, error: BaseException) -> None:
        """Fail every queued, prefilling, and in-slot request (loop-crash
        recovery): futures resolve with the error, stream iterators
        terminate, and every reserved KV page returns to the pool."""
        with self._lock:
            victims = self._queue.drain() + [r for r in self._slots if r is not None]
            victims += self._prefilling
            self._prefilling.clear()
            if self._held_req is not None:
                victims.append(self._held_req)
                self._held_req = None
            self._queued_tokens = 0
            self._slots = [None] * self.B
            self._active[:] = False
            if self._allocator is not None:
                for i in range(self.B):
                    self._release_blocks_locked(i)
                if self._prefix is not None:
                    # the pool is about to be reallocated; cached page
                    # CONTENTS die with it, so the index must too
                    stale = self._prefix.drain()
                    if stale:
                        self._allocator.free(stale)
        metric_defs.ADMISSION_QUEUE_DEPTH.set(0, self._depth_tags)
        if self._allocator is not None:
            self._publish_pool_gauges(0, 0, 0)
        for r in victims:
            self._record_done(r, "crash", str(error))
            if not r.future.done():
                r.future.set_exception(error)
            if r.stream_queue is not None:
                r.stream_queue.put(_STREAM_END)

    def _evict_cancelled(self) -> None:
        """Free decode slots whose streaming consumer went away: the slot
        (and its KV pages) returns to the batch now."""
        with self._lock:
            victims = [
                (i, r) for i, r in enumerate(self._slots)
                if r is not None and r.cancelled
            ]
            for i, _ in victims:
                self._slots[i] = None
                self._active[i] = False
                if self._allocator is not None:
                    self._release_blocks_locked(i)
            self.num_slots_evicted += len(victims)
            gauges = self._pool_gauges_locked()
        if victims and self._allocator is not None:
            self._publish_pool_gauges(*gauges)
        for _, r in victims:
            metric_defs.LLM_SLOTS_EVICTED.inc(tags=_EVICT_DISCONNECT_TAGS)
            self._record_done(r, "disconnect", "decode slot evicted mid-stream")
            if not r.future.done():
                r.future.set_exception(
                    RuntimeError("stream consumer disconnected; decode slot evicted")
                )

    def _loop(self) -> None:
        while not self._stop:
            try:
                self._evict_cancelled()
                self._admit()
                progressed = False
                if self.cache_kind == "paged":
                    progressed = self._prefill_tick()
                if self._active.any():
                    self._step()
                elif not progressed:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
            except BaseException as exc:  # noqa: BLE001 — a dead loop hangs every caller
                # flight-record the crash BEFORE recovery clears the
                # evidence: admission state and the last finished requests
                reqtrace.flight_record(
                    "engine_crash",
                    f"LLMEngine loop crashed: {exc!r}",
                    severity="ERROR",
                    state=self.admission_snapshot(),
                    requests=list(self._finished_ring)[-8:],
                    engine=str(self._admission_token),
                )
                self._fail_inflight(RuntimeError(f"LLMEngine step failed: {exc!r}"))
                # a step that failed mid-update left the pool in an unknown
                # state; reallocate so the engine keeps serving
                self._reset_cache()


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def _dtype_name(dtype: torch.dtype) -> str:
    """``"float32"``, ``"bfloat16"``: a dtype as both packages name it."""
    return str(dtype).removeprefix("torch.")


def _trace_outcome(exc: BaseException) -> tuple:
    """(outcome, detail) of a trace whose request raised ``exc``, in the
    flight recorder's vocabulary (the JAX package's proxy mapping, less the
    worker-death case: the port has no runtime)."""
    if isinstance(exc, OverloadedError):
        return "shed", f"{exc.layer}:{exc.reason}"
    if isinstance(exc, DeadlineExceededError):
        return "deadline", str(exc)
    return "error", f"{type(exc).__name__}: {exc}"


def _traced_stream(events, trace):
    """``events``, finishing ``trace`` when the stream ends: "ok" at its
    end, "disconnect" when the consumer closes it early, else the raised
    error's outcome (an engine-side claim made first wins)."""
    outcome, detail = "ok", ""
    try:
        yield from events
    except GeneratorExit:
        outcome, detail = "disconnect", "stream closed before its end"
        raise
    except Exception as exc:
        outcome, detail = _trace_outcome(exc)
        raise
    finally:
        reqtrace.finish_trace(trace, outcome, detail)


class LLMServer:
    """The serving class users call: one engine per instance.

    ``model_factory`` -> (cfg, params) or (cfg, params, tokenizer); called
    once, so the weights live where the engine runs. With a tokenizer
    (anything exposing ``encode(str) -> ids`` / ``decode(ids) -> str``),
    requests may pass ``text`` instead of ``prompt`` and responses carry
    decoded ``text``::

        srv = LLMServer(model_factory, max_batch_size=8)
        srv({"prompt": [1, 2, 3], "max_tokens": 16})
        srv({"text": "once upon", "max_tokens": 16})

    ``device`` goes to the engine (CUDA unless the caller asks for the CPU;
    with no CUDA and no ``device="cpu"`` the engine raises). A plain class:
    the Serve runtime that deploys it as replicas is not ported.
    """

    def __init__(
        self,
        model_factory: Callable[[], Any],
        *,
        device=None,
        max_batch_size: int = 8,
        max_seq_len: int = 512,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        quantize: bool = False,
        mesh: Optional[Any] = None,
        decode_chunk: int = 1,
        max_queued_requests: int = 256,
        max_queued_prefill_tokens: int = 0,
        tenant_weights: Optional[Dict[str, float]] = None,
        cache_kind: Optional[str] = None,
        kv_block_size: Optional[int] = None,
        kv_num_blocks: Optional[int] = None,
        prefill_chunk_tokens: Optional[int] = None,
        prefix_cache: Optional[bool] = None,
        prefix_cache_max_blocks: Optional[int] = None,
        role: Optional[str] = None,
    ):
        made = model_factory()
        cfg, params = made[0], made[1]
        self.tokenizer = made[2] if len(made) > 2 else None
        self.role = role or ""
        self.engine = LLMEngine(
            cfg,
            params,
            device=device,
            max_batch_size=max_batch_size,
            max_seq_len=max_seq_len,
            top_k=top_k,
            top_p=top_p,
            quantize=quantize,
            mesh=mesh,
            decode_chunk=decode_chunk,
            max_queued_requests=max_queued_requests,
            max_queued_prefill_tokens=max_queued_prefill_tokens,
            tenant_weights=tenant_weights,
            cache_kind=cache_kind,
            kv_block_size=kv_block_size,
            kv_num_blocks=kv_num_blocks,
            prefill_chunk_tokens=prefill_chunk_tokens,
            prefix_cache=prefix_cache,
            prefix_cache_max_blocks=prefix_cache_max_blocks,
            role=role,
        )

    def _encode(self, request: Dict[str, Any]) -> List[int]:
        if "prompt" in request:
            return request["prompt"]
        if "text" in request:
            if self.tokenizer is None:
                raise ValueError("this deployment has no tokenizer; send 'prompt' token ids")
            return list(self.tokenizer.encode(request["text"]))
        raise ValueError("request needs 'prompt' (token ids) or 'text'")

    def __call__(self, request: Dict[str, Any]):
        """Answer one request. The server is the port's ingress (the HTTP
        proxy that starts a request's trace in the JAX package is not
        ported): a request with no trace in its context gets one here, and
        it finishes when the answer, or the stream, ends."""
        if current_request_trace() is not None:
            return self._handle(request)
        trace = reqtrace.start_trace(deployment=type(self).__name__, tenant=current_tenant())
        if trace is None:  # tracing off, or this request not sampled
            return self._handle(request)
        token = push_request_trace(trace)
        try:
            result = self._handle(request)
        except Exception as exc:
            reqtrace.finish_trace(trace, *_trace_outcome(exc))
            raise
        finally:
            pop_request_trace(token)
        if isinstance(result, GeneratorType):
            return _traced_stream(result, trace)
        reqtrace.finish_trace(trace)
        return result

    def _handle(self, request: Dict[str, Any]):
        prompt = self._encode(request)
        kw = dict(
            max_tokens=int(request.get("max_tokens", 32)),
            temperature=float(request.get("temperature", 0.0)),
            eos_id=request.get("eos_id"),
        )
        if request.get("stream"):
            # submit EAGERLY so validation errors surface as a normal error
            # response, not mid-stream corruption after a 200 was sent;
            # the returned generator of per-token events reaches the proxy
            # by reference (in-proc replicas) and renders as SSE
            stream = self.engine.submit_stream(prompt, **kw)

            def events():
                n = 0
                for tok in stream:
                    n += 1
                    yield {"token": tok}
                yield {"done": True, "num_generated": n}

            return events()
        t0 = time.perf_counter()
        out = self.engine.generate(prompt, **kw)
        resp = {
            "tokens": out,
            "num_generated": len(out),
            "latency_s": round(time.perf_counter() - t0, 4),
        }
        if self.tokenizer is not None:
            resp["text"] = self.tokenizer.decode(out)
        return resp

    def stats(self) -> Dict[str, Any]:
        return self.engine.stats()

    # -- disaggregated prefill/decode (called by the router's dispatcher) --
    def disagg_prefill(self, request: Dict[str, Any], mig_id: str) -> dict:
        """Prefill-pool half of a disaggregated request: chunked prefill and
        staging, returning the header-only migration ticket."""
        prompt = self._encode(request)
        return self.engine.prefill_export(
            prompt,
            mig_id=mig_id,
            temperature=float(request.get("temperature", 0.0)),
            eos_id=request.get("eos_id"),
        ).result()

    def disagg_decode(self, request: Dict[str, Any], ticket: dict):
        """Decode-pool half: probe the local prefix cache, pull only the
        uncached-suffix blocks (the in-process copy, else a device pull),
        adopt into the continuous batch and run decode to completion.
        Migration failures return the typed-error envelope a dispatcher
        converts into KVMigrationError, not a crashed request."""
        prompt = list(ticket["prompt"])
        bs = self.engine.kv_block_size
        n_blocks = int(ticket["n_blocks"])
        matched = self.engine.peek_prefix_match(prompt)
        arrays: Dict[int, Any] = {}
        rung = "device"
        try:
            for bidx in range(matched // bs, n_blocks):
                arr, r = disagg.pull_block(ticket, bidx)
                if r != "device":
                    rung = r
                arrays[bidx] = arr
        except disagg.KVMigrationError as exc:
            return {"_kv_migration_error": True, "stage": exc.stage,
                    "message": str(exc)}
        kw = dict(
            max_tokens=int(request.get("max_tokens", 32)),
            temperature=float(request.get("temperature", 0.0)),
            eos_id=request.get("eos_id"),
        )
        if request.get("stream"):
            import queue as _queue

            q: "_queue.Queue" = _queue.Queue()
            req = self.engine.adopt_migration(
                ticket, arrays, _stream_queue=q, **kw
            )
            stream = _TokenStream(
                self.engine._stream_iter(req, q), req, self.engine
            )

            def events():
                n = 0
                for tok in stream:
                    n += 1
                    yield {"token": tok}
                yield {"done": True, "num_generated": n}

            return {"_stream": events(), "_migration_rung": rung}
        t0 = time.perf_counter()
        req = self.engine.adopt_migration(ticket, arrays, **kw)
        try:
            out = req.future.result()
        except disagg.KVMigrationError as exc:
            return {"_kv_migration_error": True, "stage": exc.stage,
                    "message": str(exc)}
        except RuntimeError as exc:
            cause = exc.__cause__
            if isinstance(cause, disagg.KVMigrationError):
                return {"_kv_migration_error": True, "stage": cause.stage,
                        "message": str(cause)}
            raise
        resp = {
            "tokens": out,
            "num_generated": len(out),
            "latency_s": round(time.perf_counter() - t0, 4),
            "_migration_rung": rung,
        }
        if self.tokenizer is not None:
            resp["text"] = self.tokenizer.decode(out)
        return resp

    def disagg_release(self, mig_id: str) -> bool:
        """Drop a staged export (called exactly once per migration, whatever
        the outcome)."""
        return self.engine.release_migration(mig_id)

    def kv_free_blocks(self) -> int:
        """Decode-pool routing signal (free KV pages)."""
        return self.engine.kv_free_blocks()

    def __del__(self):
        try:
            self.engine.shutdown()
        except Exception:  # noqa: BLE001 — GC teardown must never raise
            pass


class OpenAICompatLLMServer(LLMServer):
    """OpenAI-compatible request/response adapter over :class:`LLMServer`.

    Accepts the body shapes of ``POST /v1/completions`` (``model`` +
    ``prompt``) and ``POST /v1/chat/completions`` (``model`` +
    ``messages``) and answers in the matching OpenAI response envelopes,
    including streaming chunk events.  Dispatch is by body shape, so one
    instance serves both the native protocol and the OpenAI one.

    Text prompts/messages need the model_factory to supply a tokenizer;
    token-id prompts work without one.  ``stop`` supports a single token id
    (honored in-engine as eos) or, with a tokenizer, a string trimmed from
    the non-streaming response.
    """

    def _handle(self, request: Any):
        if isinstance(request, dict) and ("messages" in request or "model" in request):
            return self._openai(request)
        return super()._handle(request)

    # ------------------------------------------------------------- openai
    def _openai(self, body: Dict[str, Any]):
        import uuid

        self._reject_unsupported(body)
        chat = "messages" in body
        prompt_ids = self._openai_prompt(body, chat)
        stop = body.get("stop")
        eos_id = None
        stop_text = None
        if isinstance(stop, int):
            eos_id = stop
        elif isinstance(stop, str):
            if self.tokenizer is not None:
                enc = self.tokenizer.encode(stop)
                if len(enc) == 1:
                    eos_id = enc[0]
                else:
                    stop_text = stop
            else:
                raise ValueError("string stop requires a tokenizer")
        elif isinstance(stop, list) and len(stop) == 1:
            return self._openai({**body, "stop": stop[0]})
        elif stop is not None:
            raise ValueError("stop: a single token id or string is supported")

        kw = dict(
            max_tokens=int(body.get("max_tokens", 16)),
            # OpenAI semantics: absent temperature means 1.0 (sampling) —
            # defaulting to greedy here would silently answer a different
            # distribution than every OpenAI SDK client expects
            temperature=float(body.get("temperature", 1.0)),
            eos_id=eos_id,
        )
        rid = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:24]
        model = body.get("model", "ray_tpu")
        created = int(time.time())
        obj = "chat.completion" if chat else "text_completion"

        if body.get("stream"):
            if stop_text is not None:
                raise ValueError(
                    "streaming with a multi-token stop string is not "
                    "supported — use a stop that encodes to one token"
                )
            stream = self.engine.submit_stream(prompt_ids, **kw)

            def chunks():
                reason = "length"
                for tok in stream:
                    if eos_id is not None and tok == eos_id:
                        # OpenAI semantics: the stop sequence is excluded
                        # from the streamed output
                        reason = "stop"
                        continue  # engine ends the stream after eos
                    piece = (
                        self.tokenizer.decode([tok])
                        if self.tokenizer is not None
                        else None
                    )
                    delta = (
                        {"delta": {"content": piece}, "index": 0, "finish_reason": None}
                        if chat
                        else {"text": piece, "token_ids": [tok], "index": 0,
                              "finish_reason": None}
                    )
                    yield {"id": rid, "object": obj + ".chunk", "created": created,
                           "model": model, "choices": [delta]}
                final = (
                    {"delta": {}, "index": 0, "finish_reason": reason}
                    if chat
                    else {"text": "", "index": 0, "finish_reason": reason}
                )
                yield {"id": rid, "object": obj + ".chunk", "created": created,
                       "model": model, "choices": [final]}

            return chunks()

        out = self.engine.generate(prompt_ids, **kw)
        finish = "stop" if (eos_id is not None and out and out[-1] == eos_id) else "length"
        if finish == "stop":
            out = out[:-1]  # OpenAI semantics: stop sequence excluded
        text = self.tokenizer.decode(out) if self.tokenizer is not None else None
        if text is not None and stop_text and stop_text in text:
            # trim at TOKEN granularity so token_ids stay faithful to what
            # the model generated (re-encoding trimmed text could produce
            # ids the model never emitted): keep the longest generated
            # prefix whose decode does not yet contain the stop text, and
            # derive text from it so decode(token_ids) == text
            # contains-stop is monotone in the prefix length, so binary
            # search the cut (a linear scan would decode O(n) prefixes on
            # the serving hot path when the stop lands early)
            lo, hi = 0, len(out)  # invariant: decode(out[:lo]) lacks stop
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if stop_text in self.tokenizer.decode(out[:mid]):
                    hi = mid - 1
                else:
                    lo = mid
            out = out[:lo]
            text = self.tokenizer.decode(out)
            finish = "stop"
        choice: Dict[str, Any] = {"index": 0, "finish_reason": finish, "token_ids": out}
        if chat:
            choice["message"] = {"role": "assistant", "content": text}
        else:
            choice["text"] = text
        return {
            "id": rid,
            "object": obj,
            "created": created,
            "model": model,
            "choices": [choice],
            "usage": {
                "prompt_tokens": len(prompt_ids),
                "completion_tokens": len(out),
                "total_tokens": len(prompt_ids) + len(out),
            },
        }

    def _reject_unsupported(self, body: Dict[str, Any]) -> None:
        """Unimplemented OpenAI sampling params fail loudly — silently
        ignoring them would return samples the client didn't ask for.
        Values matching OpenAI defaults (top_p=1, n=1, zero penalties)
        pass, since SDKs send those unprompted."""
        bad = []
        top_p = body.get("top_p")
        if top_p is not None and top_p < 1.0:
            # sampling config is per-ENGINE: a request may restate the
            # engine's own top_p, but asking for a different distribution
            # must not be silently overridden.  top_p=1.0 always passes —
            # SDKs send the OpenAI default unprompted.
            eng_p = self.engine.top_p
            if eng_p is None or abs(float(top_p) - float(eng_p)) > 1e-9:
                bad.append(
                    f"top_p={top_p} (engine is configured with "
                    f"top_p={eng_p}; per-request nucleus sampling is not "
                    "supported — configure it on the deployment)"
                )
        if body.get("n", 1) not in (None, 1):
            bad.append("n > 1")
        if body.get("best_of", 1) not in (None, 1):
            bad.append("best_of > 1")
        lp = body.get("logprobs")
        if lp is not None and lp is not False:  # NOT `in (None, False)`: 0 == False
            bad.append("logprobs")
        for k in ("presence_penalty", "frequency_penalty"):
            if body.get(k):
                bad.append(k)
        if body.get("echo"):
            bad.append("echo")
        if bad:
            raise ValueError(
                "unsupported OpenAI parameter(s): " + ", ".join(bad)
            )

    def _openai_prompt(self, body: Dict[str, Any], chat: bool) -> List[int]:
        if chat:
            messages = body["messages"]
            if self.tokenizer is None:
                raise ValueError("chat completions require a tokenizer")
            template = getattr(self.tokenizer, "apply_chat_template", None)
            if template is not None:
                ids = template(messages, add_generation_prompt=True)
                return list(ids)
            joined = "\n".join(f"{m['role']}: {m['content']}" for m in messages)
            return list(self.tokenizer.encode(joined + "\nassistant:"))
        prompt = body.get("prompt")
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError("string prompts require a tokenizer")
            return list(self.tokenizer.encode(prompt))
        if isinstance(prompt, list) and all(isinstance(t, int) for t in prompt):
            return prompt
        raise ValueError("prompt must be a string or a list of token ids")
