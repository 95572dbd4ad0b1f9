"""Learner / LearnerGroup: gradient updates.

Parity: `rllib/core/learner/learner.py:107` (per-framework gradient math on
one accelerator) and `learner_group.py:69` (multi-GPU DDP data-parallel
learners). A Learner takes gradients of its loss with ``torch.autograd``
and steps the port's own optax counterparts below (``adam``,
``clip_by_global_norm``, ``chain``, ``global_norm``), whose states keep
optax's fields (``count``, ``mu``, ``nu``) so that a JAX optimizer state
crosses leaf for leaf (``ray_tpu_torch.convert.adam_state_from_jax``).
Params are replaced, never updated in place: a caller that kept the old
tree (IMPALA's behaviour params, a target network) keeps its values.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.models.common import default_device
from ray_tpu_torch.rllib.rl_module import tree_leaves, tree_map, tree_unflatten
from ray_tpu_torch.rllib.sample_batch import SampleBatch

# loss_fn(params, batch, **aux) -> (loss, stats_dict)
LossFn = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def to_tensor(value, device) -> torch.Tensor:
    """A batch column on ``device`` as a loss or module takes it: floats as
    float32 and integers as int64 (``gather``'s index type), as the JAX
    package's ``jnp.asarray`` makes every float64 float32 with x64 off."""
    t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.array(value))
    if t.is_floating_point():
        t = t.float()
    elif t.dtype != torch.bool:
        t = t.long()
    return t.to(device)


# ---------------------------------------------------------------------------
# optax counterparts
# ---------------------------------------------------------------------------
class GradientTransformation(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params) ->
    (updates, state)`` (optax's protocol)."""

    init: Callable
    update: Callable


def global_norm(tree) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tree_leaves(tree))))


def _leafwise(fn):
    """``fn`` over lists of leaves -> the same over trees (one ``_foreach``
    launch an operation for every leaf, not one a leaf)."""
    def call(*trees):
        return tree_unflatten(trees[0], fn(*(tree_leaves(t) for t in trees)))

    return call


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         eps_root: float = 0.0) -> GradientTransformation:
    """``optax.adam``: eps outside the square root, bias correction by the
    step count, updates scaled by ``-lr``. State ``{"count", "mu", "nu"}``."""
    def init(params):
        leaf = tree_leaves(params)[0]
        return {"count": torch.zeros((), dtype=torch.int32, device=leaf.device),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        g, mu, nu = (tree_leaves(t) for t in (grads, state["mu"], state["nu"]))
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1), torch._foreach_mul(mu, b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                                torch._foreach_mul(nu, b2))
        count = state["count"] + 1
        c1, c2 = 1 - b1**count, 1 - b2**count  # float32, as optax computes them
        denom = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_add(torch._foreach_div(nu, c2), eps_root)), eps)
        updates = torch._foreach_mul(torch._foreach_div(torch._foreach_div(mu, c1), denom), -lr)
        return tree_unflatten(grads, updates), {"count": count,
                                                "mu": tree_unflatten(grads, mu),
                                                "nu": tree_unflatten(grads, nu)}

    return GradientTransformation(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          eps_root: float = 0.0, weight_decay: float = 1e-4) -> GradientTransformation:
    """``optax.adamw``: Adam's update, then ``+ weight_decay * params`` (every
    leaf: no mask), then ``* -lr``. The state is Adam's ``{"count", "mu",
    "nu"}`` (optax's is a chain holding Adam's state first)."""
    inner = adam(1.0, b1, b2, eps, eps_root)  # scaled by -1: undone below

    def update(grads, state, params):
        updates, state = inner.update(grads, state, params)
        u, p = tree_leaves(updates), tree_leaves(params)
        # -(-u) is u exactly; optax adds the decay before the rate's scaling
        u = torch._foreach_add(torch._foreach_neg(u), p, alpha=weight_decay)
        return tree_unflatten(grads, torch._foreach_mul(u, -lr)), state

    return GradientTransformation(inner.init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """``optax.clip_by_global_norm``: scaled by ``max_norm / norm`` where the
    global norm is not below ``max_norm``. Stateless (state ``()``)."""

    def update(grads, state, params=None):
        g_norm = global_norm(grads)
        scale = torch.where(g_norm < max_norm, 1.0, max_norm / g_norm)
        return _leafwise(lambda g: torch._foreach_mul(g, scale))(grads), state

    return GradientTransformation(lambda params: (), update)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    """``optax.chain``: the state is the tuple of the members' states."""

    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(grads, state, params=None):
        new_state = []
        for tx, s in zip(txs, state):
            grads, s = tx.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


apply_updates = _leafwise(torch._foreach_add)


def value_and_grad(loss_fn: Callable, params, *args, **kwargs):
    """-> ((loss, aux), grads) of ``loss_fn(params, ...) -> (loss, aux)``:
    gradients of every leaf of ``params`` (zeros where the loss does not
    read it, as JAX gives)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, aux = loss_fn(tree_unflatten(params, leaves), *args, **kwargs)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return (loss.detach(), aux), tree_unflatten(params, grads)


def floats(stats: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Scalar stats as Python floats, read from the device in one copy."""
    if not stats:
        return {}
    values = torch.stack([v.detach().reshape(()) for v in stats.values()]).float().tolist()
    return dict(zip(stats, values))


class Learner:
    def __init__(
        self,
        module,
        loss_fn: LossFn,
        *,
        optimizer: Optional[GradientTransformation] = None,
        lr: float = 3e-4,
        max_grad_norm: Optional[float] = 0.5,
        seed: int = 0,
        device=None,
    ):
        self.device = default_device(device, "Learner")
        self.module = module
        self.loss_fn = loss_fn
        tx = optimizer or adam(lr)
        if max_grad_norm is not None:
            tx = chain(clip_by_global_norm(max_grad_norm), tx)
        self.tx = tx
        self.params = module.init(torch.Generator(device=self.device).manual_seed(seed))
        self.opt_state = tx.init(self.params)

    def update_raw(self, batch: SampleBatch, **aux) -> Dict[str, torch.Tensor]:
        """One update returning stats as device tensors (losses may be
        per-row vectors — e.g. |TD| for prioritized-replay write-back)."""
        tbatch = {k: to_tensor(v, self.device) for k, v in batch.items()}
        (loss, stats), grads = value_and_grad(self.loss_fn, self.params, tbatch, **aux)
        with torch.no_grad():
            updates, self.opt_state = self.tx.update(grads, self.opt_state, self.params)
            self.params = apply_updates(self.params, updates)
            stats = {k: v.detach() for k, v in stats.items()}
            stats["total_loss"] = loss
            stats["grad_norm"] = global_norm(grads)
        return stats

    def update(self, batch: SampleBatch, **aux) -> Dict[str, float]:
        return floats(self.update_raw(batch, **aux))

    def get_state(self) -> Dict[str, Any]:
        return {"params": self.params, "opt_state": self.opt_state}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = to_device(state["params"], self.device)
        self.opt_state = to_device(state["opt_state"], self.device)


def to_device(tree, device):
    """Every tensor of a nested state on ``device``; other leaves as they are."""
    return tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, tree)


class LearnerGroup:
    """Data-parallel learners over a device mesh.

    The reference ships gradients between learner processes with NCCL
    allreduce, and the JAX package runs one SPMD update over its mesh. Here
    ``mesh`` is a ``ray_tpu_torch.parallel.Mesh``: a batch is padded by
    wrap-tiling to a multiple of the mesh's size, as the JAX package pads
    it, and the one learner takes the padded batch's update on its device —
    the mean the SPMD ``psum`` takes. A DDP across cards is not ported.
    """

    def __init__(self, learner: Learner, mesh=None):
        self.learner = learner
        self.mesh = mesh
        if mesh is not None:
            from ray_tpu_torch.parallel import Mesh

            if not isinstance(mesh, Mesh):
                raise TypeError("LearnerGroup(mesh=) takes a ray_tpu_torch.parallel.Mesh")
        self._n = mesh.size if mesh is not None else 1

    def update(self, batch: SampleBatch, **aux) -> Dict[str, float]:
        if self.mesh is not None:
            n = len(batch)
            pad = (-n) % self._n
            if pad:
                # wrap-tile rows so even a batch smaller than the mesh size
                # becomes divisible
                idx = np.arange(n + pad) % n
                batch = SampleBatch({k: np.asarray(v)[idx] for k, v in batch.items()})
        return self.learner.update(batch, **aux)

    @property
    def params(self):
        return self.learner.params

    def get_state(self):
        return self.learner.get_state()

    def set_state(self, state):
        self.learner.set_state(state)
