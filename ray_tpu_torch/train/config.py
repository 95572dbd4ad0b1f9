"""Shared Train/Tune configuration objects.

The port's copy of ``ray_tpu/train/config.py``. Parity:
``python/ray/air/config.py:103`` (``ScalingConfig``, ``RunConfig``,
``CheckpointConfig``, ``FailureConfig``) — the AIR-common config surface the
reference shares between Train and Tune.

One difference: a worker that asks for accelerators asks for ``GPU``
(``use_gpu``), where the JAX package's ``use_tpu`` asks for ``TPU``; each
holds ``num_devices_per_worker`` CUDA devices.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


#: Key under which a trainer's primary dataset is passed/looked up
#: (reference: air/constants.py TRAIN_DATASET_KEY).
TRAIN_DATASET_KEY = "train"


@dataclass
class SyncConfig:
    """Driver<->storage sync knobs (reference: _internal/syncer.py
    SyncConfig).  On this runtime, checkpoints/artifacts write straight to
    ``RunConfig.storage_path`` (posix IO) — there is no separate sync
    daemon — so these fields gate only whether trial artifacts are
    mirrored at all."""

    sync_period: float = 300.0
    sync_timeout: float = 1800.0
    sync_artifacts: bool = False


class BackendConfig:
    """Parent class for training-backend configurations (reference:
    train/backend.py).  Concrete backends: the torch (gloo) and device
    trainer setups in ``ray_tpu_torch/train/`` — subclass and override
    ``backend_name`` for custom setups."""

    @property
    def backend_name(self) -> str:
        return type(self).__name__.replace("Config", "").lower() or "custom"


@dataclass
class ScalingConfig:
    """How many workers × what resources each (reference: config.py:103).

    ``num_workers`` data-parallel workers; with ``use_gpu`` each asks for
    ``num_devices_per_worker`` GPUs (a fraction shares a card).
    """

    num_workers: int = 1
    use_gpu: bool = False
    num_devices_per_worker: float = 1
    resources_per_worker: Optional[Dict[str, float]] = None
    trainer_resources: Optional[Dict[str, float]] = None

    def worker_resources(self) -> Dict[str, float]:
        if self.resources_per_worker is not None:
            return dict(self.resources_per_worker)
        res: Dict[str, float] = {"CPU": 1}
        if self.use_gpu:
            res["GPU"] = self.num_devices_per_worker
        return res

    @property
    def total_devices(self) -> float:
        return self.num_workers * self.num_devices_per_worker


@dataclass
class FailureConfig:
    """Worker-group fault tolerance (reference: FailureConfig).

    max_failures: restarts of the whole worker group before giving up;
    -1 = unlimited.
    """

    max_failures: int = 0


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    verbose: int = 0
    # tune experiment callbacks (air/integrations loggers plug in here)
    callbacks: Optional[list] = None
    # stop criteria for Tune trials: {"metric": threshold} dict or a
    # tune.Stopper (reference puts stop on air.RunConfig the same way)
    stop: Optional[Any] = None
    sync_config: Optional["SyncConfig"] = None
