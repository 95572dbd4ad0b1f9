"""Weight conversion: a JAX param tree, as numpy arrays, to the port's tensors.

The port keeps the JAX package's param layout (the same nested dict, stacked
``[n_layers, ...]`` layer leaves), so conversion is a leaf-by-leaf copy.
bfloat16 needs a bit-level view: numpy holds it as an ``ml_dtypes`` array,
which ``torch.from_numpy`` rejects, so it crosses as 16-bit integers and is
reinterpreted as ``torch.bfloat16``. Every leaf arrives bit for bit.

Callers turn the JAX tree into numpy arrays first (``np.asarray`` per leaf),
so this module never imports JAX. :func:`train_state_from_numpy` carries a
JAX train state (params, optax's Adam ``mu``/``nu``/``count``, ``step``)
across the same way, into the state of
:func:`ray_tpu_torch.models.transformer.make_train_step`.
:func:`rllib_params_from_jax` and :func:`adam_state_from_jax` carry an RL
module's params tree (dicts and lists of layers, stacked per-agent leaves),
a whole algorithm state with its optax states (DreamerV3's), and an optax
``adam``, ``adamw`` or ``chain(clip_by_global_norm, adam)`` state into
``ray_tpu_torch.rllib``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def tensor_from_numpy(arr: np.ndarray, device=None) -> torch.Tensor:
    """One array to a tensor with identical bits (bfloat16 included)."""
    arr = np.array(arr, order="C")  # own, writable memory: tensors may be updated in place
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device) if device is not None else t


def params_from_numpy(tree: Any, device=None) -> Any:
    """Nested dicts of numpy arrays -> the same dicts of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(np.asarray(tree), device)


def train_state_from_numpy(params: Any, mu: Any, nu: Any, count, step, device=None) -> dict:
    """A JAX train state, as numpy, -> the port's train state. ``mu``, ``nu``
    and ``count`` are the fields of optax's ``ScaleByAdamState`` (the first
    entry of ``optax.adamw``'s state tuple); ``step`` is the JAX state's
    step. The port's state then takes the next step as the JAX one would."""
    def scalar(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32, device=device)

    return {
        "params": params_from_numpy(params, device),
        "opt": {"mu": params_from_numpy(mu, device), "nu": params_from_numpy(nu, device),
                "count": scalar(count)},
        "step": scalar(step),
    }


def _is_adam(node) -> bool:
    return all(hasattr(node, f) for f in ("count", "mu", "nu"))


def rllib_params_from_jax(tree: Any, device=None) -> Any:
    """An ``rllib`` params tree or algorithm state, as numpy (dicts, lists
    of ``{"w", "b"}`` layers, leaves, stacked per-agent leaves) -> the same
    tree of float32 tensors. An optax state inside it (DreamerV3's
    ``wm_opt``, ...) becomes the port's Adam state
    (:func:`adam_state_from_jax`); a Python number stays as it is (ARS's
    normalizer count)."""
    if _is_adam(tree) or (isinstance(tree, tuple) and any(_is_adam(m) for m in tree)):
        return adam_state_from_jax(tree, device)
    if isinstance(tree, dict):
        return {k: rllib_params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rllib_params_from_jax(v, device) for v in tree)
    if isinstance(tree, (bool, int, float)):
        return tree
    return tensor_from_numpy(np.asarray(tree, np.float32), device)


def adam_state_from_jax(opt_state: Any, device=None) -> dict:
    """The Adam state inside an optax state, as numpy (``optax.adam``'s or
    ``optax.adamw``'s, or a ``chain`` holding it: the first member with
    ``count``, ``mu`` and ``nu``) -> ``{"count", "mu", "nu"}``, the state of
    ``ray_tpu_torch.rllib.learner.adam`` and ``adamw``."""
    if _is_adam(opt_state):
        return {"count": torch.tensor(int(np.asarray(opt_state.count)), dtype=torch.int32,
                                      device=device),
                "mu": rllib_params_from_jax(opt_state.mu, device),
                "nu": rllib_params_from_jax(opt_state.nu, device)}
    if isinstance(opt_state, (list, tuple)):
        for member in opt_state:
            try:
                return adam_state_from_jax(member, device)
            except ValueError:
                pass
    raise ValueError("no Adam state (count, mu, nu) in this optax state")
