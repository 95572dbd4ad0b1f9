"""Accelerator detection (the port's counterpart of ``ray_tpu/accelerators``)."""

from ray_tpu_torch.accelerators.gpu import (
    cuda_available,
    device_memory,
    get_num_gpus,
    get_visible_device_ids,
    gpu_resources,
)

__all__ = [
    "cuda_available",
    "device_memory",
    "get_num_gpus",
    "get_visible_device_ids",
    "gpu_resources",
]
