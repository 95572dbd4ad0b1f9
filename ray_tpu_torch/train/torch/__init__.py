"""Torch backend: distributed torch training over a process-actor gang.

The port's copy of ``ray_tpu/train/torch/__init__.py``. Parity:
``python/ray/train/torch/`` — ``TorchTrainer``, ``TorchConfig``
(``config.py:112``: rank-0 address broadcast + ``dist.init_process_group``),
``prepare_model`` (DDP wrap, ``train_loop_utils.py:158``) and
``prepare_data_loader`` (DistributedSampler injection).

A torch process group is per-OS-process global state, so Torch gangs run as
PROCESS actors (spawned, never forked: no CUDA context crosses a fork); the
trainer picks a free TCP port up front and every rank joins a gloo group
over it before the user loop starts.  On the card the ranks ask for a GPU
share and see the card (every rank on ``cuda:0`` on one card);
:func:`get_device` is the rank's device — where the JAX package returns the
CPU, since its compute runs through JAX (ROADMAP.md, Queue 3).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.predictor import Predictor
from ray_tpu_torch.train.trainer import DataParallelTrainer

__all__ = [
    "TorchTrainer",
    "TorchConfig",
    "TorchCheckpoint",
    "TorchPredictor",
    "prepare_model",
    "prepare_data_loader",
    "get_device",
]


@dataclass
class TorchConfig:
    """Process-group settings (reference TorchConfig, train/torch/config.py)."""

    backend: str = "gloo"
    init_method: str = "tcp"
    timeout_s: int = 1800


def _free_port() -> int:
    from ray_tpu_torch.util.misc import free_port

    return free_port()


def _with_process_group(fn, backend: str, master_addr: str, master_port: int, timeout_s: int):
    """Wrap the user loop: join the gloo world before, tear down after.
    Rank/world come from the train session (the wrapper runs inside the
    worker after init_session)."""

    def wrapped(config):
        import datetime
        import inspect

        import torch.distributed as dist

        from ray_tpu_torch.train import get_context

        ctx = get_context()
        # Torch-launcher env contract (reference TorchConfig sets the same):
        # libraries that re-derive the rendezvous from env (HF Accelerate,
        # lightning) find it without their own launcher.
        import os

        os.environ["MASTER_ADDR"] = master_addr
        os.environ["MASTER_PORT"] = str(master_port)
        os.environ["RANK"] = str(ctx.get_world_rank())
        os.environ["LOCAL_RANK"] = str(ctx.get_local_rank())
        os.environ["WORLD_SIZE"] = str(ctx.get_world_size())
        os.environ["LOCAL_WORLD_SIZE"] = str(ctx.get_local_world_size())
        os.environ["NODE_RANK"] = str(ctx.get_node_rank())
        created_group = False
        if not dist.is_initialized():  # loops that rendezvous themselves keep working
            dist.init_process_group(
                backend=backend,
                init_method=f"tcp://{master_addr}:{master_port}",
                rank=ctx.get_world_rank(),
                world_size=ctx.get_world_size(),
                timeout=datetime.timedelta(seconds=timeout_s),
            )
            created_group = True
        try:
            takes_config = bool(inspect.signature(fn).parameters)
            return fn(config) if takes_config else fn()
        finally:
            if created_group:
                try:
                    dist.destroy_process_group()
                except Exception:
                    pass

    return wrapped


class TorchTrainer(DataParallelTrainer):
    """Distributed torch trainer (reference TorchTrainer): the worker gang
    runs in separate processes, wired into one ``torch.distributed`` gloo
    group; ``prepare_model`` adds DDP gradient sync.  ``device``: where the
    ranks compute, ``"cuda"`` (the default) or ``"cpu"``."""

    _worker_execution = "process"

    def __init__(
        self,
        train_loop_per_worker,
        *,
        torch_config: Optional[TorchConfig] = None,
        **kwargs,
    ):
        self.torch_config = torch_config or TorchConfig()
        # on CUDA every rank holds a GPU share (``WorkerGroup``), and a
        # process worker holding one sees the card (``runtime/worker_pool.py``)
        super().__init__(train_loop_per_worker, **kwargs)

    def fit(self):
        # fresh port per fit: gloo leaves TIME_WAIT sockets behind
        port = _free_port()
        raw_loop = self.train_loop_per_worker
        self.train_loop_per_worker = _with_process_group(
            raw_loop,
            self.torch_config.backend,
            "127.0.0.1",
            port,
            self.torch_config.timeout_s,
        )
        try:
            return super().fit()
        finally:
            self.train_loop_per_worker = raw_loop


def get_device():
    """The torch device of this rank (reference train.torch.get_device):
    its CUDA device, or the CPU when the trainer was given ``device="cpu"``.
    Outside a train worker there is no rank, and this raises."""
    from ray_tpu_torch.train.session import get_context

    return get_context().get_devices()[0]


def prepare_model(model, *, parallel_strategy: str = "ddp"):
    """Wrap for gradient sync (reference prepare_model): DDP when the
    process group is up and world_size > 1, identity otherwise."""
    import torch.distributed as dist

    if parallel_strategy and dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        from torch.nn.parallel import DistributedDataParallel

        return DistributedDataParallel(model)
    return model


def prepare_data_loader(data_loader):
    """Re-build a DataLoader with a DistributedSampler so each rank sees its
    shard (reference prepare_data_loader)."""
    import torch.distributed as dist
    from torch.utils.data import DataLoader
    from torch.utils.data.distributed import DistributedSampler

    if not (dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1):
        return data_loader
    from torch.utils.data import SequentialSampler

    shuffle = not isinstance(data_loader.sampler, SequentialSampler)
    sampler = DistributedSampler(data_loader.dataset, shuffle=shuffle)
    return DataLoader(
        data_loader.dataset,
        batch_size=data_loader.batch_size,
        sampler=sampler,
        num_workers=data_loader.num_workers,
        collate_fn=data_loader.collate_fn,
        drop_last=data_loader.drop_last,
        pin_memory=data_loader.pin_memory,
        worker_init_fn=data_loader.worker_init_fn,
        generator=data_loader.generator,
    )


class TorchCheckpoint(Checkpoint):
    """A checkpoint holding a torch module's ``state_dict`` (parity:
    ``train/torch/torch_checkpoint.py``)."""

    MODEL_FILENAME = "model.pt"

    @classmethod
    def from_model(cls, model, base_dir: Optional[str] = None) -> "TorchCheckpoint":
        return cls.from_state_dict(model.state_dict(), base_dir)

    @classmethod
    def from_state_dict(cls, state_dict, base_dir: Optional[str] = None) -> "TorchCheckpoint":
        import tempfile

        import torch

        d = base_dir or tempfile.mkdtemp(prefix="torch_ckpt_")
        os.makedirs(d, exist_ok=True)
        torch.save(state_dict, os.path.join(d, cls.MODEL_FILENAME))
        return cls(d)

    def get_model(self, model):
        """Load the stored state dict into ``model`` and return it."""
        import torch

        state = torch.load(
            os.path.join(self.path, self.MODEL_FILENAME), weights_only=True
        )
        model.load_state_dict(state)
        model.eval()
        return model


class TorchPredictor(Predictor):
    """Batch inference with a torch module (parity:
    ``train/torch/torch_predictor.py``).  Dict batches stack their feature
    columns along the last axis; the model and its inputs sit on ``device``
    (CUDA unless ``"cpu"`` is asked for; the JAX package's predictor runs
    on the CPU, ROADMAP.md Queue 3); outputs come back as numpy."""

    def __init__(self, model, preprocessor=None, device=None):
        super().__init__(preprocessor)
        from ray_tpu_torch.models.common import default_device

        self.device = default_device(device, "TorchPredictor")
        self.model = model.to(self.device)
        self.model.eval()

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, model, preprocessor=None,
                        device=None) -> "TorchPredictor":
        return cls(TorchCheckpoint(checkpoint.path).get_model(model), preprocessor, device)

    def _predict_numpy(self, data, **kwargs):
        import numpy as np
        import torch

        if isinstance(data, dict):
            x = np.stack([np.asarray(v, dtype=np.float32) for v in data.values()], axis=-1)
        else:
            x = np.asarray(data, dtype=np.float32)
        with torch.no_grad():
            out = self.model(torch.from_numpy(x).to(self.device), **kwargs)
        return {"predictions": out.detach().cpu().numpy()}
