"""Model checkpoint helpers: (config, params) round-trips.

The port's counterpart of ``ray_tpu/models/checkpoint.py``:

    save_model(path, cfg, params)
    cfg, params = load_model(path)                 # params on CUDA
    cfg, params = load_model(path, device="cpu")   # on the CPU, when asked

Like the engine and the train step, ``load_model`` places the params on
CUDA unless a device is named, and raises when none is named and no CUDA
device is present (the JAX package restores onto its accelerator).

The config is written as JSON (dataclass fields; torch dtypes stored by
name) and the params through the crash-atomic framed writer of
:mod:`ray_tpu_torch.train.checkpoint` (a pickled host copy; the JAX package
uses orbax).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Tuple, Type

import torch

from ray_tpu_torch.models.common import default_device
from ray_tpu_torch.train.checkpoint import _map_tensors, load_framed, save_framed

_CONFIG_FILE = "model_config.json"
_PARAMS_FILE = "params.pkl"

# registry of known config classes (extensible via register_config)
_CONFIG_TYPES: dict = {}


def register_config(cls: Type) -> Type:
    _CONFIG_TYPES[cls.__name__] = cls
    return cls


def _encode_field(v: Any) -> Any:
    if isinstance(v, torch.dtype):  # cfg.dtype, cfg.param_dtype
        return {"__dtype__": str(v).replace("torch.", "")}
    return v


def _decode_field(v: Any) -> Any:
    if isinstance(v, dict) and "__dtype__" in v:
        return getattr(torch, v["__dtype__"])
    return v


def save_model(path: str, cfg: Any, params: Any) -> None:
    """Write cfg (dataclass) + params (nested dict of tensors) under ``path``."""
    os.makedirs(path, exist_ok=True)
    fields = {
        f.name: _encode_field(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)
    }
    with open(os.path.join(path, _CONFIG_FILE), "w") as f:
        json.dump({"type": type(cfg).__name__, "fields": fields}, f, indent=1)
    save_framed(os.path.join(path, _PARAMS_FILE),
                _map_tensors(params, lambda t: t.detach().cpu()))


def load_model(path: str, device=None) -> Tuple[Any, Any]:
    """Returns (cfg, params) saved by :func:`save_model`, the params on
    ``device`` (default CUDA; no silent CPU fallback)."""
    device = default_device(device, "load_model")
    with open(os.path.join(path, _CONFIG_FILE)) as f:
        meta = json.load(f)
    cls = _CONFIG_TYPES.get(meta["type"])
    if cls is None:
        raise ValueError(
            f"unknown model config type {meta['type']!r}; register it with "
            "ray_tpu_torch.models.checkpoint.register_config"
        )
    cfg = cls(**{k: _decode_field(v) for k, v in meta["fields"].items()})
    params = load_framed(os.path.join(path, _PARAMS_FILE))
    if params is None:
        raise FileNotFoundError(f"no readable params at {path} (missing or torn)")
    return cfg, _map_tensors(params, lambda t: t.to(device))


def _register_builtin():
    from ray_tpu_torch.models.dit import DiTConfig
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.models.vit import ViTConfig

    for c in (TransformerConfig, ViTConfig, DiTConfig):
        register_config(c)


_register_builtin()
