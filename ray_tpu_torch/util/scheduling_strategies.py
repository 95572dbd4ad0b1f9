"""Scheduling strategies (public module path parity with
``python/ray/util/scheduling_strategies.py:15,41,135``).

The port's copy of ``ray_tpu/util/scheduling_strategies.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.
"""
from ray_tpu_torch.runtime.scheduler import (
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)

__all__ = [
    "PlacementGroupSchedulingStrategy",
    "NodeAffinitySchedulingStrategy",
    "NodeLabelSchedulingStrategy",
]
