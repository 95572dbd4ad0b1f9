"""Configuration knobs of the serving path, each overridable by environment.

The port's own copy of the part of ``ray_tpu/core/config.py`` that its
modules read: the LLM engine's cache knobs, the disaggregated-serving
pull timeout, the request-trace knobs and the shed retry hint.  Names,
defaults and the ``RAY_TPU_<NAME>`` environment override are the JAX
package's, so one environment configures both packages.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict

_ENV_PREFIX = "RAY_TPU_"


@dataclasses.dataclass
class Config:
    # ---- admission control -----------------------------------------------
    # Retry-after hint stamped on OverloadedError when a layer has no better
    # estimate of when capacity frees up.
    overload_retry_after_s: float = 1.0

    # ---- LLM serving engine: paged KV + chunked prefill -------------------
    # KV cache layout of serve.llm.LLMEngine: "paged" (block pool + per-slot
    # block tables) or "dense" (one [L, B, Hkv, max_len, Dh] buffer).
    llm_cache_kind: str = "paged"
    # Tokens per KV page.
    kv_block_size: int = 16
    # Total pages in the pool (one is reserved as the garbage page).
    # 0 = auto: max_batch_size * ceil(max_seq_len / kv_block_size) + 1.
    kv_num_blocks: int = 0
    # Chunked prefill: prompts prefill in chunks of this many tokens
    # interleaved with decode steps.  0 = one-shot (power-of-2 bucketed).
    prefill_chunk_tokens: int = 0
    # Prefix-aware KV reuse (paged engines only).
    llm_prefix_cache: bool = True
    # Max full blocks the prefix cache may pin (0 = bounded only by the pool).
    prefix_cache_max_blocks: int = 0
    # Disaggregated prefill/decode: seconds the decode side waits on any
    # one read of a staged block's pull (serve.disagg.pull_block).
    kv_migration_pull_timeout_s: float = 30.0

    # ---- request-scope serving observability -----------------------------
    # Lifecycle traces for serve requests (observability/reqtrace.py).
    serve_request_trace: bool = True
    # Trace 1-in-N requests (1 = every request).
    serve_request_trace_sample_n: int = 1
    # Completed-trace ring capacity.
    serve_request_trace_ring: int = 512

    def apply_env_overrides(self) -> "Config":
        for f in dataclasses.fields(self):
            env_key = _ENV_PREFIX + f.name.upper()
            if env_key in os.environ:
                setattr(self, f.name, _coerce(os.environ[env_key], f.type))
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
    """The process's config, built (with environment overrides) on first use."""
    global _global_config
    if _global_config is None:
        _global_config = Config().apply_env_overrides()
    return _global_config


def set_config(config: Config) -> None:
    global _global_config
    _global_config = config


def reset_config() -> None:
    """Forget the built config: the next ``get_config`` reads the environment
    again."""
    global _global_config
    _global_config = None
