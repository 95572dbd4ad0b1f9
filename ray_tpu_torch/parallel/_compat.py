"""The two helpers of ``ray_tpu/parallel/_compat.py`` that are not JAX
version shims: the size of a mesh axis, and the roll that the reference
spells as a gather to survive its SPMD partitioner (a plain ``torch.roll``
here, where each rank rolls what it holds)."""

from __future__ import annotations

import torch


def axis_size(axis_name: str) -> int:
    """The size of ``axis_name`` in the current mesh."""
    from ray_tpu_torch.parallel.mesh import current_mesh

    return current_mesh().shape[axis_name]


def spmd_roll(x: torch.Tensor, shift: int, axis: int) -> torch.Tensor:
    return torch.roll(x, shift, axis)
