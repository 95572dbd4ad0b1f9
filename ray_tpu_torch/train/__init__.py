"""Training support of the port: crash-atomic framed checkpoints of tensor
trees and train states. The train step itself is
:func:`ray_tpu_torch.models.transformer.make_train_step`."""

from ray_tpu_torch.train.checkpoint import Checkpoint, load_framed, save_framed

__all__ = ["Checkpoint", "load_framed", "save_framed"]
