"""Shared model-layer helpers."""

from __future__ import annotations

import math

import torch


def dense_init(generator: torch.Generator, shape, fan_in, dtype=torch.float32) -> torch.Tensor:
    """1/sqrt(fan_in) normal init — the shared recipe of every model here.
    Drawn on ``generator``'s device."""
    x = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return (x / math.sqrt(fan_in)).to(dtype)


def default_device(device, what: str) -> torch.device:
    """``device``, or ``cuda`` when it is None. No silent CPU fallback: with
    no device named and no CUDA device present this raises, so a run meant
    for the GPU never quietly runs on the host."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on CUDA by default and no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
