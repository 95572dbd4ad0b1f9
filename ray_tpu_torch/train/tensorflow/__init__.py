"""TensorFlow backend: TF_CONFIG-rendezvous'd worker gangs.

Parity: ``python/ray/train/tensorflow/`` — ``TensorflowTrainer`` +
``TensorflowConfig`` (reference ``train/tensorflow/config.py``:
``_setup_tensorflow_environment`` builds the ``TF_CONFIG`` cluster spec from
the worker gang's addresses so ``tf.distribute.MultiWorkerMirroredStrategy``
rendezvouses without its own launcher).

Workers run as PROCESS actors (TF runtime state is per-OS-process, same
reasoning as the torch backend). The trainer allocates one port per rank up
front, builds the shared cluster spec, and each worker exports TF_CONFIG
before the user loop starts — any TF_CONFIG-aware library finds it.

The port's copy of ``ray_tpu/train/tensorflow/__init__.py``.  TensorFlow
runs its own CPU path, as in the JAX package: the ranks are host ranks
(``device="cpu"``) unless the caller names a device, and TensorFlow is
imported only where a model is saved, loaded or run.
"""

from __future__ import annotations

import json
import socket
from dataclasses import dataclass
from typing import Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.predictor import Predictor
from ray_tpu_torch.train.trainer import DataParallelTrainer

__all__ = [
    "TensorflowTrainer",
    "TensorflowConfig",
    "TensorflowCheckpoint",
    "TensorflowPredictor",
    "prepare_dataset_shard",
]


@dataclass
class TensorflowConfig:
    """Cluster-spec settings (reference TensorflowConfig)."""

    host: str = "127.0.0.1"


def _free_ports(n: int, host: str):
    from ray_tpu_torch.util.misc import reserve_port

    socks = [reserve_port(host) for _ in range(n)]
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()  # freed just before workers bind; held together above so
        # the n reservations are guaranteed distinct
    return ports


def _with_tf_config(fn, cluster_spec: dict):
    """Export TF_CONFIG (cluster + this rank's task) around the user loop."""

    def wrapped(config):
        import inspect
        import os

        from ray_tpu_torch.train import get_context

        rank = get_context().get_world_rank()
        os.environ["TF_CONFIG"] = json.dumps(
            {"cluster": cluster_spec, "task": {"type": "worker", "index": rank}}
        )
        try:
            takes_config = bool(inspect.signature(fn).parameters)
            return fn(config) if takes_config else fn()
        finally:
            os.environ.pop("TF_CONFIG", None)

    return wrapped


class TensorflowTrainer(DataParallelTrainer):
    """Distributed TF trainer (reference TensorflowTrainer): process-actor
    gang with a shared TF_CONFIG cluster spec; the user loop builds its
    ``MultiWorkerMirroredStrategy`` under that spec."""

    _worker_execution = "process"

    def __init__(
        self,
        train_loop_per_worker,
        *,
        tensorflow_config: Optional[TensorflowConfig] = None,
        **kwargs,
    ):
        self.tensorflow_config = tensorflow_config or TensorflowConfig()
        kwargs.setdefault("device", "cpu")  # TensorFlow's own CPU path
        super().__init__(train_loop_per_worker, **kwargs)

    def fit(self):
        host = self.tensorflow_config.host
        n = self.scaling_config.num_workers if self.scaling_config else 1
        ports = _free_ports(n, host)
        cluster = {"worker": [f"{host}:{p}" for p in ports]}
        raw_loop = self.train_loop_per_worker
        self.train_loop_per_worker = _with_tf_config(raw_loop, cluster)
        try:
            return super().fit()
        finally:
            self.train_loop_per_worker = raw_loop


def prepare_dataset_shard(dataset_shard):
    """Passthrough hook (reference prepare_dataset_shard disables TF
    auto-sharding on an already-sharded dataset; our shards arrive
    pre-split from DataConfig)."""
    return dataset_shard


class TensorflowCheckpoint(Checkpoint):
    """A checkpoint holding one saved keras model (parity:
    ``train/tensorflow/tensorflow_checkpoint.py``)."""

    MODEL_FILENAME = "model.keras"

    @classmethod
    def from_model(cls, model, base_dir: Optional[str] = None) -> "TensorflowCheckpoint":
        import os
        import tempfile

        d = base_dir or tempfile.mkdtemp(prefix="tf_ckpt_")
        os.makedirs(d, exist_ok=True)
        model.save(os.path.join(d, cls.MODEL_FILENAME))
        return cls(d)

    def get_model(self):
        import os

        import tensorflow as tf

        return tf.keras.models.load_model(os.path.join(self.path, self.MODEL_FILENAME))


class TensorflowPredictor(Predictor):
    """Batch inference with a keras model (parity:
    ``train/tensorflow/tensorflow_predictor.py``)."""

    def __init__(self, model, preprocessor=None):
        super().__init__(preprocessor)
        self.model = model

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, preprocessor=None) -> "TensorflowPredictor":
        return cls(TensorflowCheckpoint(checkpoint.path).get_model(), preprocessor)

    def _predict_numpy(self, data, **kwargs):
        import numpy as np

        if isinstance(data, dict):
            x = np.stack([np.asarray(v, dtype=np.float32) for v in data.values()], axis=-1)
        else:
            x = np.asarray(data, dtype=np.float32)
        out = self.model(x, training=False)
        return {"predictions": np.asarray(out)}
