"""DataContext: per-process execution knobs.

Parity: ``python/ray/data/context.py`` (``DataContext.get_current()``,
``target_max_block_size``, shuffle strategy toggle :241, etc.).

The port's copy of ``ray_tpu/data/context.py``: the same behaviour, imports
renamed to ``ray_tpu_torch``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ExecutionResources:
    """Resource limits for streaming execution (parity:
    ray.data.ExecutionResources)."""

    cpu: Optional[float] = None
    gpu: Optional[float] = None
    object_store_memory: Optional[float] = None


@dataclass
class ExecutionOptions:
    """Execution knobs (parity: ray.data.ExecutionOptions).

    ``preserve_order`` orders operator outputs by dispatch;
    ``resource_limits.cpu`` caps in-flight tasks across the topology and
    ``resource_limits.object_store_memory`` caps finished-but-unconsumed
    bytes (both enforced in the streaming executor's dispatch loop).
    ``resource_limits.gpu`` and ``verbose_progress`` are accepted for
    source compatibility but have no effect here (map tasks declare their
    own num_tpus and num_gpus; progress verbosity is a logging knob)."""

    resource_limits: ExecutionResources = field(default_factory=ExecutionResources)
    preserve_order: bool = False
    verbose_progress: bool = False


@dataclass
class DataContext:
    read_parallelism: int = 8
    max_tasks_in_flight: int = 16
    max_outqueue_bundles: int = 32
    target_max_block_size: int = 128 * 1024 * 1024
    target_min_block_size: int = 1 * 1024 * 1024
    use_push_based_shuffle: bool = True
    enable_progress_bars: bool = False
    shuffle_seed: Optional[int] = None
    execution_options: ExecutionOptions = field(default_factory=ExecutionOptions)

    _local = threading.local()

    @property
    def preserve_order(self) -> bool:
        """Release map outputs in dispatch order instead of completion
        order (costs head-of-line blocking). Alias of
        ``execution_options.preserve_order`` — both spellings stay in sync."""
        return self.execution_options.preserve_order

    @preserve_order.setter
    def preserve_order(self, value: bool) -> None:
        self.execution_options.preserve_order = value

    @staticmethod
    def get_current() -> "DataContext":
        ctx = getattr(DataContext._local, "ctx", None)
        if ctx is None:
            ctx = DataContext()
            DataContext._local.ctx = ctx
        return ctx
