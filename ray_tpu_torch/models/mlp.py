"""Small MLP classifier — the "hello world" model for examples and tests.

Counterpart of ``ray_tpu/models/mlp.py``: the same param list of
``{"w", "b"}`` dicts, so a JAX param list converts leaf by leaf."""

from __future__ import annotations

import dataclasses
import math
from typing import List

import torch


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: int = 256
    depth: int = 2
    out_dim: int = 10
    dtype: torch.dtype = torch.float32


def mlp_init(cfg: MLPConfig, generator: torch.Generator) -> List[dict]:
    """Random params drawn from ``generator``, on its device: normal weights
    at 1/sqrt(fan_in), zero biases (the JAX recipe; the numbers differ)."""
    dims = [cfg.in_dim] + [cfg.hidden] * cfg.depth + [cfg.out_dim]
    dev = generator.device
    return [
        {
            "w": (torch.randn(a, b, generator=generator, device=dev, dtype=cfg.dtype)
                  / math.sqrt(a)),
            "b": torch.zeros(b, dtype=cfg.dtype, device=dev),
        }
        for a, b in zip(dims[:-1], dims[1:])
    ]


def mlp_apply(params: List[dict], x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x
