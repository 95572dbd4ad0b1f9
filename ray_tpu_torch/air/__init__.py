"""AIR common: shared run/scaling configs and the session surface.

The port's copy of ``ray_tpu/air/`` (the same ``__all__``), over the port's
``train`` and ``tune``.

Parity: ``python/ray/air/`` (``config.py:103`` ScalingConfig/RunConfig/
CheckpointConfig/FailureConfig, ``session.py``) — the canonical homes are
``ray_tpu_torch.train``/``ray_tpu_torch.tune``; this package re-exports them under the
AIR path and hosts the experiment-tracking integrations.
"""

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.trainer import Result
from ray_tpu_torch.air.types import (
    AcquiredResources,
    DataBatchType,
    DatasetConfig,
    ResourceRequest,
)

__all__ = [
    "AcquiredResources",
    "Checkpoint",
    "CheckpointConfig",
    "DataBatchType",
    "DatasetConfig",
    "FailureConfig",
    "Result",
    "ResourceRequest",
    "RunConfig",
    "ScalingConfig",
]
