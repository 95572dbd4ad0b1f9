"""ray_tpu_torch.train: distributed training orchestration.

The port's copy of ``ray_tpu/train/__init__.py``: trainers spawn a gang of
worker actors, each rank on its CUDA device (or the CPU when the trainer
is given ``device="cpu"``), ``train.report`` streams metrics/checkpoints to
the driver, checkpoints are crash-atomic framed tree files, and
:class:`TrainController` runs an elastic, repairable ``StageGroup`` gang.
The JAX package's ``JaxTrainer`` and ``JaxPredictor`` raise
``NotPortedError`` naming the port's :class:`DeviceTrainer` and
:class:`DevicePredictor`. The train step itself is
:func:`ray_tpu_torch.models.transformer.make_train_step`.
"""

from ray_tpu_torch.train.checkpoint import Checkpoint, load_framed, save_framed
from ray_tpu_torch.train.controller import TrainController, global_batch
from ray_tpu_torch.train.config import (
    TRAIN_DATASET_KEY,
    BackendConfig,
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    SyncConfig,
)
from ray_tpu_torch.train.session import (
    TrainContext,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    report,
)
from ray_tpu_torch.train.predictor import (
    DevicePredictor,
    JaxPredictor,
    Predictor,
    PredictorNotSerializableException,
)
from ray_tpu_torch.train.trainer import (
    BaseTrainer,
    DataConfig,
    DataParallelTrainer,
    DeviceTrainer,
    JaxTrainer,
    Result,
    TorchTrainer,
    TrainingIterator,
)

__all__ = [
    "TRAIN_DATASET_KEY",
    "BackendConfig",
    "BaseTrainer",
    "SyncConfig",
    "TrainingIterator",
    "Checkpoint",
    "CheckpointConfig",
    "DataConfig",
    "DataParallelTrainer",
    "DevicePredictor",
    "DeviceTrainer",
    "FailureConfig",
    "JaxPredictor",
    "JaxTrainer",
    "Predictor",
    "PredictorNotSerializableException",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "TorchTrainer",
    "TrainContext",
    "TrainController",
    "global_batch",
    "get_checkpoint",
    "get_context",
    "get_dataset_shard",
    "load_framed",
    "report",
    "save_framed",
]
