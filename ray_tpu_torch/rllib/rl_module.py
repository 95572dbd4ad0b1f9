"""RLModule: the neural-net container of the new API stack.

Parity: `rllib/core/rl_module/rl_module.py` — a framework-agnostic module
with `forward_exploration` / `forward_inference` / `forward_train` entry
points owned by both EnvRunners (sampling) and Learners (updates).

A module is a frozen config + plain functions over a params tree: the JAX
package's tree (dicts, lists of ``{"w", "b"}`` layers, leaf tensors such as
``log_std``), so weights map leaf for leaf (``ray_tpu_torch.convert``).
``init`` draws on the device of the ``torch.Generator`` it is given;
exploration draws from a generator where the JAX package splits a key.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Sequence, Tuple

import torch


# ---------------------------------------------------------------------------
# params trees: dicts (leaves in sorted-key order, as JAX flattens them),
# lists and tuples of tensors
# ---------------------------------------------------------------------------
def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves) -> object:
    """A tree shaped as ``like`` holding ``leaves`` (in :func:`tree_leaves`
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def _mlp_init(generator: torch.Generator, dims: Sequence[int], out_scale: float = 1.0):
    device = generator.device
    layers = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        scale = (out_scale if i == len(dims) - 2 else 1.0) * math.sqrt(2.0 / a)
        w = torch.randn((a, b), generator=generator, device=device, dtype=torch.float32)
        layers.append({"w": w * scale, "b": torch.zeros((b,), device=device)})
    return layers


def _mlp_apply(layers, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1:
            x = torch.tanh(x)
    return x


def _gumbel(generator: torch.Generator, shape, device) -> torch.Tensor:
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device).clamp_(min=tiny)
    return -torch.log(-torch.log(u))


def gather_last(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``values[..., index]`` row by row (``take_along_axis``)."""
    return torch.gather(values, -1, index.long()[..., None])[..., 0]


@dataclasses.dataclass(frozen=True)
class ActorCriticModule:
    """Discrete-action actor-critic (PPO's module): shared-nothing policy and
    value MLP heads."""

    obs_size: int
    num_actions: int
    hidden: Tuple[int, ...] = (64, 64)

    def init(self, generator: torch.Generator):
        return {
            "pi": _mlp_init(generator, (self.obs_size, *self.hidden, self.num_actions), 0.01),
            "vf": _mlp_init(generator, (self.obs_size, *self.hidden, 1)),
        }

    def logits(self, params, obs: torch.Tensor) -> torch.Tensor:
        return _mlp_apply(params["pi"], obs)

    def value(self, params, obs: torch.Tensor) -> torch.Tensor:
        return _mlp_apply(params["vf"], obs)[..., 0]

    def explore(self, params, obs: torch.Tensor, generator: torch.Generator):
        """-> (action, logp, value): a categorical draw (Gumbel-max)."""
        logits = self.logits(params, obs)
        action = torch.argmax(logits + _gumbel(generator, logits.shape, logits.device), dim=-1)
        logp = gather_last(torch.log_softmax(logits, dim=-1), action)
        return action, logp, self.value(params, obs)

    def logp_entropy(self, params, obs: torch.Tensor, actions: torch.Tensor):
        logp_all = torch.log_softmax(self.logits(params, obs), dim=-1)
        logp = gather_last(logp_all, actions)
        entropy = -torch.sum(torch.exp(logp_all) * logp_all, dim=-1)
        return logp, entropy

    def inference_action(self, params, obs: torch.Tensor) -> torch.Tensor:
        """Greedy action for evaluation (forward_inference parity)."""
        return torch.argmax(self.logits(params, obs), dim=-1)


@dataclasses.dataclass(frozen=True)
class ContinuousActorCriticModule:
    """Continuous-action actor-critic: gaussian policy with state-independent
    log-std, plus a value head. Actions are squashed by clipping in the env."""

    obs_size: int
    action_size: int
    hidden: Tuple[int, ...] = (64, 64)

    def init(self, generator: torch.Generator):
        return {
            "pi": _mlp_init(generator, (self.obs_size, *self.hidden, self.action_size), 0.01),
            "log_std": torch.zeros((self.action_size,), device=generator.device),
            "vf": _mlp_init(generator, (self.obs_size, *self.hidden, 1)),
        }

    def value(self, params, obs):
        return _mlp_apply(params["vf"], obs)[..., 0]

    def explore(self, params, obs, generator: torch.Generator):
        mean = _mlp_apply(params["pi"], obs)
        std = torch.exp(params["log_std"])
        noise = torch.randn(mean.shape, generator=generator, device=mean.device)
        action = mean + std * noise
        logp = self._gauss_logp(mean, params["log_std"], action)
        return action, logp, self.value(params, obs)

    @staticmethod
    def _gauss_logp(mean, log_std, action):
        var = torch.exp(2 * log_std)
        return torch.sum(
            -0.5 * ((action - mean) ** 2 / var + 2 * log_std + math.log(2 * math.pi)),
            dim=-1,
        )

    def logp_entropy(self, params, obs, actions):
        mean = _mlp_apply(params["pi"], obs)
        logp = self._gauss_logp(mean, params["log_std"], actions)
        entropy = torch.sum(params["log_std"] + 0.5 * math.log(2 * math.pi * math.e))
        return logp, entropy.expand(logp.shape)

    def inference_action(self, params, obs) -> torch.Tensor:
        """Mean action for evaluation (forward_inference parity)."""
        return _mlp_apply(params["pi"], obs)


@dataclasses.dataclass(frozen=True)
class QModule:
    """Q-network for DQN: obs -> per-action Q values."""

    obs_size: int
    num_actions: int
    hidden: Tuple[int, ...] = (64, 64)

    def init(self, generator: torch.Generator):
        return {"q": _mlp_init(generator, (self.obs_size, *self.hidden, self.num_actions))}

    def q_values(self, params, obs: torch.Tensor) -> torch.Tensor:
        return _mlp_apply(params["q"], obs)

    def explore(self, params, obs: torch.Tensor, generator: torch.Generator, epsilon):
        """Epsilon-greedy action selection (vectorized over leading dims)."""
        greedy = torch.argmax(self.q_values(params, obs), dim=-1)
        random_a = torch.randint(0, self.num_actions, greedy.shape, generator=generator,
                                 device=greedy.device)
        explore = torch.rand(greedy.shape, generator=generator, device=greedy.device) < epsilon
        return torch.where(explore, random_a, greedy)

    def inference_action(self, params, obs: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.q_values(params, obs), dim=-1)


@dataclasses.dataclass(frozen=True)
class DDPGModule:
    """Deterministic-policy module for DDPG/TD3: tanh actor scaled to the
    action bounds plus twin Q critics (DDPG trains only q1; TD3 both)."""

    obs_size: int
    action_size: int
    action_low: float = -1.0
    action_high: float = 1.0
    hidden: Tuple[int, ...] = (64, 64)

    def init(self, generator: torch.Generator):
        qdims = (self.obs_size + self.action_size, *self.hidden, 1)
        return {
            "pi": _mlp_init(generator, (self.obs_size, *self.hidden, self.action_size)),
            "q1": _mlp_init(generator, qdims),
            "q2": _mlp_init(generator, qdims),
        }

    def _scale(self, tanh_a):
        lo, hi = self.action_low, self.action_high
        return lo + (tanh_a + 1.0) * 0.5 * (hi - lo)

    def action(self, params, obs: torch.Tensor) -> torch.Tensor:
        """Deterministic policy output, already in env action space."""
        return self._scale(torch.tanh(_mlp_apply(params["pi"], obs)))

    def explore(self, params, obs: torch.Tensor, generator: torch.Generator, noise_scale):
        """Gaussian exploration noise (scaled to the action range) clipped
        back into bounds — the reference's OU noise converged to this."""
        a = self.action(params, obs)
        span = 0.5 * (self.action_high - self.action_low)
        noise = noise_scale * span * torch.randn(a.shape, generator=generator, device=a.device)
        return torch.clamp(a + noise, self.action_low, self.action_high)

    def q_values(self, params, obs, action):
        x = torch.cat([obs, action], dim=-1)
        return (
            _mlp_apply(params["q1"], x)[..., 0],
            _mlp_apply(params["q2"], x)[..., 0],
        )

    def inference_action(self, params, obs: torch.Tensor) -> torch.Tensor:
        return self.action(params, obs)


@dataclasses.dataclass(frozen=True)
class SACModule:
    """SAC module: tanh-squashed gaussian actor + twin Q critics."""

    obs_size: int
    action_size: int
    action_low: float = -1.0
    action_high: float = 1.0
    hidden: Tuple[int, ...] = (64, 64)

    def init(self, generator: torch.Generator):
        qdims = (self.obs_size + self.action_size, *self.hidden, 1)
        return {
            "pi": _mlp_init(generator, (self.obs_size, *self.hidden, 2 * self.action_size)),
            "q1": _mlp_init(generator, qdims),
            "q2": _mlp_init(generator, qdims),
        }

    def _scale(self, tanh_a):
        lo, hi = self.action_low, self.action_high
        return lo + (tanh_a + 1.0) * 0.5 * (hi - lo)

    def sample_action(self, params, obs, noise: torch.Tensor):
        """-> (env_action, logp) with the tanh-squash logp correction.
        ``noise`` is the standard normal draw, shaped as the mean
        (``obs.shape[:-1] + (action_size,)``): the caller draws it from its
        generator where the JAX package passes a key."""
        out = _mlp_apply(params["pi"], obs)
        mean, log_std = torch.chunk(out, 2, dim=-1)
        log_std = torch.clamp(log_std, -10.0, 2.0)
        std = torch.exp(log_std)
        raw = mean + std * noise
        logp = torch.sum(
            -0.5 * ((raw - mean) ** 2 / std**2 + 2 * log_std + math.log(2 * math.pi)),
            dim=-1,
        )
        tanh_a = torch.tanh(raw)
        # log det of tanh + affine scaling jacobian
        logp = logp - torch.sum(
            torch.log((1 - tanh_a**2) * 0.5 * (self.action_high - self.action_low) + 1e-6),
            dim=-1,
        )
        return self._scale(tanh_a), logp

    def inference_action(self, params, obs) -> torch.Tensor:
        """Deterministic tanh(mean) action for evaluation."""
        mean, _ = torch.chunk(_mlp_apply(params["pi"], obs), 2, dim=-1)
        return self._scale(torch.tanh(mean))

    def q_values(self, params, obs, action):
        x = torch.cat([obs, action], dim=-1)
        return (
            _mlp_apply(params["q1"], x)[..., 0],
            _mlp_apply(params["q2"], x)[..., 0],
        )
