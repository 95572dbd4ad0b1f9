"""Batch LLM inference over Datasets.

Parity target: the reference's ``ray.data`` batch-inference pattern (a
stateful ``map_batches`` callable holding the model; their LLM guides wrap
vLLM). Here the callable wraps the native continuous-batching engine
(``ray_tpu_torch.serve.llm.LLMEngine``): every prompt in a batch is submitted at
once, so the engine's slot scheduler packs them into shared decode steps —
offline throughput rides the same machinery as online serving.

    ds = rt.data.from_items([{"prompt": [1, 2, 3]}, ...])
    out = ds.map_batches(
        LLMPredictor,
        fn_constructor_args=(model_factory,),
        batch_size=32,
    )

The engine is cached per (process, factory), so repeated blocks on one
worker reuse the compiled decode step.

The port's copy of ``ray_tpu/data/llm_inference.py``, on the port's
``LLMEngine``: ``engine_kwargs`` pass through unchanged (``device=`` and
``quantize=`` among them; with no device the engine takes the card, and
raises where there is none). Give the map stage ``num_gpus`` so its actors
run next to the card (``executor.py``): such actors live in the driver's
process, receive the factory by reference, and so share one engine when
they see the same factory object and kwargs.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np

_engine_cache: Dict[Any, Any] = {}
_cache_lock = threading.Lock()


def clear_engine_cache() -> None:
    """Shut down and release every cached engine (daemon threads + device
    KV caches + pinned params). Call between unrelated batch-inference
    jobs in a long-lived process; worker processes exit anyway."""
    with _cache_lock:
        entries = list(_engine_cache.values())
        _engine_cache.clear()
    for _factory, engine, _tok in entries:
        try:
            engine.shutdown()
        except Exception:
            pass


class LLMPredictor:
    """``map_batches``-compatible callable: token-id prompts in, generated
    token ids (and text, when the factory supplies a tokenizer) out."""

    def __init__(
        self,
        model_factory: Callable[[], Any],
        *,
        max_tokens: int = 32,
        temperature: float = 0.0,
        eos_id: Optional[int] = None,
        prompt_column: str = "prompt",
        output_column: str = "generated",
        **engine_kwargs,
    ):
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.eos_id = eos_id
        self.prompt_column = prompt_column
        self.output_column = output_column
        # Cache key: factory identity AND the engine kwargs — different
        # kwargs must not silently share an engine. The cached tuple keeps a
        # STRONG reference to the factory, so a cached id() always refers to
        # that still-alive object (no post-GC id recycling).
        key = (id(model_factory), tuple(sorted((k, repr(v)) for k, v in engine_kwargs.items())))
        with _cache_lock:
            entry = _engine_cache.get(key)
            if entry is None:
                # build INSIDE the lock: a racing constructor would
                # otherwise leak a fully-built engine (daemon thread +
                # device params)
                from ray_tpu_torch.serve.llm import LLMEngine

                made = model_factory()
                cfg, params = made[0], made[1]
                tokenizer = made[2] if len(made) > 2 else None
                entry = _engine_cache[key] = (
                    model_factory,
                    LLMEngine(cfg, params, **engine_kwargs),
                    tokenizer,
                )
        self.engine, self.tokenizer = entry[1], entry[2]

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        prompts = batch[self.prompt_column]
        futs = []
        for p in prompts:
            if isinstance(p, str):
                if self.tokenizer is None:
                    raise ValueError(
                        "string prompts need a tokenizer (model_factory returning "
                        "(cfg, params, tokenizer)); otherwise pass token-id lists"
                    )
                p = list(self.tokenizer.encode(p))
            else:
                p = [int(t) for t in p]
            futs.append(
                self.engine.submit(
                    p,
                    max_tokens=self.max_tokens,
                    temperature=self.temperature,
                    eos_id=self.eos_id,
                )
            )
        results: List[List[int]] = [f.result() for f in futs]
        out = dict(batch)
        out[self.output_column] = _object_column(results)
        if self.tokenizer is not None:
            out[self.output_column + "_text"] = _object_column(
                [self.tokenizer.decode(r) for r in results]
            )
        return out


def _object_column(values: List[Any]) -> np.ndarray:
    """One row per VALUE — np.asarray would turn equal-length lists into a
    2-D array and break row alignment."""
    arr = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        arr[i] = v
    return arr
