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


def as_generator(seed_or_generator, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device``: the one given, or a new one
    seeded with the integer given (the ``init_state`` argument of the train
    steps)."""
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    return torch.Generator(device=device).manual_seed(int(seed_or_generator))


class JittedStep:
    """A callable train step carrying its batch placement, the reference's
    wrapper of a jitted step under a mesh (``common.py:33``):
    ``shard_batch(...)`` returns this rank's block of a full batch, and
    ``shard_state(state)`` this rank's shards of a full train state (every
    rank holding the same one, e.g. a JAX state converted by
    :func:`ray_tpu_torch.convert.train_state_from_numpy`)."""

    def __init__(self, fn, shard_batch, shard_state=None):
        self._fn = fn
        self.shard_batch = shard_batch
        self.shard_state = shard_state

    def __call__(self, *args):
        return self._fn(*args)


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p)*(W/p), p*p*C] (ViT/DiT patch embedding)."""
    B, H, W, C = images.shape
    p = patch_size
    x = images.reshape(B, H // p, p, W // p, p, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, (H // p) * (W // p), p * p * C)


def unpatchify(patches: torch.Tensor, image_size: int, patch_size: int,
               channels: int) -> torch.Tensor:
    """[B, N, p*p*C] -> [B, H, W, C] — inverse of :func:`patchify`."""
    B = patches.shape[0]
    p = patch_size
    g = image_size // p
    x = patches.reshape(B, g, g, p, p, channels)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, image_size, image_size, channels)
