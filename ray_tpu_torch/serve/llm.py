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

Not in this engine yet (ROADMAP): ``mesh=`` raises
``NotImplementedError``; disaggregated
prefill/decode, metrics, latency sketches, request traces and the flight
recorder, tenant and deadline read from the request context (pass
``tenant=``/``deadline_ts=``), and the Serve deployment wrappers.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.exceptions import DeadlineExceededError
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
from ray_tpu_torch.ops.quantization import quantize_layers
from ray_tpu_torch.runtime import admission
from ray_tpu_torch.serve.kv_blocks import BlockAllocator
from ray_tpu_torch.serve.prefix_cache import PrefixCache

_STREAM_END = object()


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
        cache_kind: str = "paged",
        kv_block_size: int = 16,
        kv_num_blocks: int = 0,
        prefill_chunk_tokens: int = 0,
        prefix_cache: bool = True,
        prefix_cache_max_blocks: int = 0,
    ):
        if mesh is not None:
            raise NotImplementedError("multi-device (mesh) serving is not ported yet")
        if cache_kind not in ("dense", "paged"):
            raise ValueError(f"cache_kind must be 'dense' or 'paged', got {cache_kind!r}")
        self.device = default_device(device, "LLMEngine")
        self.cfg = cfg
        self.B = max_batch_size
        self.S = max_seq_len
        self.cache_kind = cache_kind
        self.kv_block_size = int(kv_block_size)
        if self.kv_block_size < 1:
            raise ValueError(f"kv_block_size must be >= 1, got {self.kv_block_size}")
        # static block-table width: enough logical blocks for a max-length
        # sequence — the table shape never depends on the allocation pattern
        self.max_blocks_per_slot = -(-self.S // self.kv_block_size)
        nb = int(kv_num_blocks)
        if nb <= 0:
            # auto: dense-equivalent capacity (+1 for the garbage page)
            nb = self.B * self.max_blocks_per_slot + 1
        self.kv_num_blocks = nb
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        self._allocator = BlockAllocator(nb) if cache_kind == "paged" else None
        self._prefix = (
            PrefixCache(self.kv_block_size, int(prefix_cache_max_blocks))
            if (cache_kind == "paged" and prefix_cache)
            else None
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

        ``tenant`` keys weighted fair queuing; ``deadline_ts`` (wall clock)
        sheds on arrival when already expired. Raises ``OverloadedError``
        when the bounded waiting queue (count or prefill-token budget) is
        full."""
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
            )
            self._queue.push(req, tenant)
            self._queued_tokens += len(prompt)
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

    def _stream_iter(self, req: GenRequest, q, token_timeout_s: float):
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
        if removed:
            admission.record_shed("engine", "disconnect")
            if not req.future.done():
                req.future.set_exception(
                    RuntimeError("stream consumer disconnected before admission")
                )
        else:
            self._wake.set()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            alloc = self._allocator
            return {
                "active_slots": int(self._active.sum()),
                "max_batch_size": self.B,
                "queued": len(self._queue),
                "queued_prefill_tokens": self._queued_tokens,
                "prefill_forwards": self._prefill_count,
                "slots_evicted": self.num_slots_evicted,
                "shed": self.num_shed,
                "cache_kind": self.cache_kind,
                "device": str(self.device),
                "kv_block_size": self.kv_block_size if alloc is not None else 0,
                "kv_block_pool_size": alloc.capacity if alloc is not None else 0,
                "kv_blocks_in_use": alloc.used_blocks if alloc is not None else 0,
                "kv_blocks_shared": alloc.shared_blocks if alloc is not None else 0,
                "waiting_for_blocks": 1 if self._held_req is not None else 0,
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

    def shutdown(self) -> None:
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=5)
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
        return len(pages)

    def _evictable(self, page: int) -> bool:
        """Only pages whose sole reference is the cache's own may be
        evicted. Caller holds ``self._lock``."""
        return self._allocator.refcount(page) == 1

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
            if req.cancelled:
                with self._lock:
                    self.num_shed += 1
                admission.record_shed("engine", "disconnect")
                if not req.future.done():
                    req.future.set_exception(
                        RuntimeError("stream consumer disconnected before admission")
                    )
                continue
            if req.deadline_ts is not None and time.time() >= req.deadline_ts:
                with self._lock:
                    self.num_shed += 1
                admission.record_shed("engine", "deadline_expired")
                if not req.future.done():
                    req.future.set_exception(
                        DeadlineExceededError("llm_request", "engine_queue", 0.0)
                    )
                if req.stream_queue is not None:
                    req.stream_queue.put(_STREAM_END)
                continue
            return req, free

    def _admit_dense(self) -> None:
        while True:
            popped = self._pop_admissible()
            if popped is None:
                return
            req, free = popped
            slot = free[0]
            try:
                tp = len(req.prompt)
                bucket = _bucket(tp, cap=self.S)
                toks = np.zeros((1, bucket), np.int64)
                toks[0, :tp] = req.prompt
                logits = self._prefill_one(toks, tp, slot)
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
                if short > 0 and self._prefix is not None:
                    evicted = self._prefix.evict(short, self._evictable)
                    if evicted:
                        self._allocator.free(evicted)
                if needed > self._allocator.free_blocks:
                    # head-of-line waits for release paths to return pages;
                    # drop the pins — it re-probes the cache on wake
                    if pins:
                        self._allocator.free(pins)
                    self._held_req = req
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
            req.slot = slot
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
            with self._lock:
                self._prefilling.append(req)

    def _finish_prefill(self, req: GenRequest, logits: torch.Tensor) -> None:
        """Prompt is fully in the paged cache: sample the first token and
        hand the slot to the decode batch."""
        tp = len(req.prompt)
        tok0 = self._sample_first(logits, req.temperature)
        req.generated = [tok0]
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

    def _fail_admit(self, req: GenRequest, exc: BaseException) -> None:
        """A popped request is in neither queue nor slots — fail it HERE or
        its caller hangs forever; return any reserved pages to the pool.
        The in-place cache stays valid (a half-written prefill only touched
        this request's own pages or page 0), so other slots keep serving."""
        if not req.future.done():
            req.future.set_exception(RuntimeError(f"prefill failed: {exc!r}"))
        if req.stream_queue is not None:
            req.stream_queue.put(_STREAM_END)
        if self._allocator is not None and req.slot >= 0:
            with self._lock:
                self._release_blocks_locked(req.slot)

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

    def _retire_blocks_locked(self, req: GenRequest) -> None:
        """Finish path: publish the request's full KV blocks into the prefix
        cache (the request's reference TRANSFERS to the cache for newly
        adopted nodes) and free everything else. Caller holds the lock."""
        slot = req.slot
        blocks = self._slot_blocks[slot]
        self._slot_blocks[slot] = []
        self._block_tables[slot, :] = 0
        self._reserved[slot] = False
        if not blocks:
            return
        if self._prefix is None:
            self._allocator.free(blocks)
            return
        # the last sampled token was never written back to the KV cache;
        # every token before it was — cache exactly those full blocks
        cached = req.prompt + req.generated[:-1]
        adopted, evicted = self._prefix.insert(cached, blocks, self._evictable)
        if evicted:
            self._allocator.free(evicted)
        rest = [b for b in blocks if b not in adopted]
        if rest:
            self._allocator.free(rest)

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
                if not req.future.done():
                    req.future.set_exception(
                        RuntimeError("stream consumer disconnected during prefill")
                    )
                if req.stream_queue is not None:
                    req.stream_queue.put(_STREAM_END)
            if not self._prefilling:
                return False
            req = self._prefilling[0]
        tp = len(req.prompt)
        start = req.prefill_pos
        chunk = self.prefill_chunk_tokens
        # one-shot width buckets the UNCACHED suffix, not the whole prompt
        width = min(chunk, self.S) if chunk > 0 else _bucket(tp - start, cap=self.S)
        n = min(width, tp - start)
        toks = np.zeros((1, width), np.int64)
        toks[0, :n] = req.prompt[start : start + n]
        try:
            self._cow_shared_writes(req.slot, start, n)
            logits = self._prefill_chunk(
                toks, self._block_tables[req.slot : req.slot + 1], start, n
            )
        except BaseException as exc:  # noqa: BLE001
            with self._lock:
                self._prefilling.pop(0)
            self._fail_admit(req, exc)
            return True
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
            with self._lock:
                self._active[req.slot] = False
                self._slots[req.slot] = None
                if self._allocator is not None:
                    self._retire_blocks_locked(req)
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
        for r in victims:
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
        for _, r in victims:
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
                self._fail_inflight(RuntimeError(f"LLMEngine step failed: {exc!r}"))
                # a step that failed mid-update left the pool in an unknown
                # state; reallocate so the engine keeps serving
                self._reset_cache()


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
