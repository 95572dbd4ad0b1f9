"""Compute strategies and schema types (parity: ray.data ActorPoolStrategy
in _internal/compute.py, Schema in dataset.py).

The port's copy of ``ray_tpu/data/compute.py``: the same behaviour, imports
renamed to ``ray_tpu_torch``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

# node id strings as used by scheduling strategies (parity: ray.data.NodeIdStr)
NodeIdStr = str


@dataclasses.dataclass
class ActorPoolStrategy:
    """Run map UDFs in a pool of long-lived actors instead of stateless
    tasks (parity: ray.data.ActorPoolStrategy). ``size`` (or the
    ``min_size``/``max_size`` pair — the pool here is fixed at min) picks
    the pool size."""

    size: Optional[int] = None
    min_size: Optional[int] = None
    max_size: Optional[int] = None

    def __post_init__(self):
        if self.size is not None and (self.min_size or self.max_size):
            raise ValueError("pass either size or min_size/max_size, not both")


class Schema(dict):
    """Column-name -> (dtype, cell_shape) mapping with the reference's
    ``names``/``types`` accessors (parity: ray.data.Schema). Subclasses
    dict so existing callers that treated schemas as plain dicts keep
    working."""

    @property
    def names(self) -> List[str]:
        return list(self.keys())

    @property
    def types(self) -> List[Any]:
        return [v[0] if isinstance(v, tuple) else v for v in self.values()]

    def __repr__(self):
        cols = ", ".join(f"{k}: {v}" for k, v in self.items())
        return f"Schema({cols})"


def set_progress_bars(enabled: bool) -> bool:
    """Toggle executor progress bars; returns the previous value
    (parity: ray.data.set_progress_bars)."""
    from ray_tpu_torch.data.context import DataContext

    ctx = DataContext.get_current()
    prev = ctx.enable_progress_bars
    ctx.enable_progress_bars = enabled
    return prev
