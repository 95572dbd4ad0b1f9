"""GPU detection: visible CUDA devices and the node's ``GPU`` resource.

The port's counterpart of ``ray_tpu/accelerators/tpu.py``.  The JAX package
counts the TPU chips that JAX enumerates under ``TPU_VISIBLE_CHIPS``; the
port counts the CUDA devices that PyTorch enumerates under
``CUDA_VISIBLE_DEVICES``.  An empty ``CUDA_VISIBLE_DEVICES`` (what the worker
pool sets for its processes) hides every card without importing torch, so a
CPU worker never creates a CUDA context.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"


def get_visible_device_ids() -> Optional[List[str]]:
    """Device mask from CUDA_VISIBLE_DEVICES (None = all visible)."""
    raw = os.environ.get(CUDA_VISIBLE_DEVICES_ENV)
    if raw is None:
        return None
    return [x.strip() for x in raw.split(",") if x.strip()]


def cuda_available() -> bool:
    """True when this process can reach a CUDA device through torch."""
    if get_visible_device_ids() == []:
        return False
    try:
        import torch
    except ImportError:
        return False
    return torch.cuda.is_available()


def get_num_gpus() -> int:
    """CUDA devices visible to this process (0 without torch or CUDA)."""
    if not cuda_available():
        return 0
    import torch

    return torch.cuda.device_count()


def gpu_resources() -> Dict[str, float]:
    """The resource dict this host registers: ``{"GPU": n}``, or nothing."""
    n = get_num_gpus()
    return {"GPU": float(n)} if n else {}


def device_memory() -> Optional[Dict[str, int]]:
    """Used and total bytes of device 0, or None when no card is visible
    (the reporter's counterpart of the JAX package's ``_tpu_memory``)."""
    if not cuda_available():
        return None
    import torch

    free, total = torch.cuda.mem_get_info()
    return {"used": int(total - free), "total": int(total)}
