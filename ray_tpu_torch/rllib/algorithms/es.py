"""ES / ARS: black-box evolution strategies.

Parity: `rllib_contrib/es` (OpenAI-ES: antithetic gaussian perturbations,
centered-rank fitness shaping, Adam on the estimated gradient) and
`rllib_contrib/ars` (Augmented Random Search V2: top-k direction selection,
reward-std scaling, online observation normalization, linear policy by
default).

The whole population evaluates as one batched rollout on the device:
perturbed params carry a leading population axis, the policy MLP runs as
batched matmuls over it, and each member steps its own env of one batched
env set for ``eval_length`` steps, with alive-masking past its episode's
end. The algorithm draws the perturbations from its generator; the update
functions (:func:`_es_update`, :func:`_ars_update`) take them, and the
returns, as tensors. Ranks come from stable sorts, as ``jnp.argsort``'s
(CartPole returns tie often), taken on the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.envs import DeviceEnv
from ray_tpu_torch.rllib.learner import adam, apply_updates, to_device
from ray_tpu_torch.rllib.rl_module import _mlp_init, tree_leaves, tree_map, tree_unflatten


class ESConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 0.02
        self.population_size = 64  # perturbation PAIRS are pop/2
        self.noise_std = 0.05
        self.weight_decay = 0.005
        self.eval_length = 0  # 0 -> env.max_episode_steps


class ARSConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 0.02
        self.population_size = 32  # directions = pop/2
        self.noise_std = 0.05
        self.top_directions = 8
        self.eval_length = 0
        self.hidden = ()  # ARS default: linear policy


class _DeterministicPolicy:
    """Policy-only MLP over a population: argmax logits for discrete envs,
    scaled tanh for continuous. Params carry a leading population axis."""

    def __init__(self, env: DeviceEnv, hidden: Tuple[int, ...]):
        self.env = env
        out = env.num_actions if env.discrete else env.action_size
        self.dims = (env.observation_size, *hidden, out)

    def init(self, generator: torch.Generator):
        return _mlp_init(generator, self.dims)

    def action(self, pop, obs: torch.Tensor) -> torch.Tensor:
        """pop: layers of [P, a, b] / [P, b]; obs [P, O] -> actions [P, ...]."""
        x = obs
        for i, layer in enumerate(pop):
            x = torch.baddbmm(layer["b"][:, None], x[:, None], layer["w"])[:, 0]
            if i < len(pop) - 1:
                x = torch.tanh(x)
        if self.env.discrete:
            return torch.argmax(x, dim=-1)
        lo, hi = self.env.action_low, self.env.action_high
        return lo + (torch.tanh(x) + 1.0) * 0.5 * (hi - lo)


def _evaluate(env: DeviceEnv, policy: _DeterministicPolicy, pop, state, obs, length: int,
              norm: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One episode a population member, from the batched env ``state`` /
    ``obs`` (one env a member). -> (returns[P], steps[P], obs_sum[P, O],
    obs_sqsum[P, O]): alive-masking freezes the accumulations past each
    episode's end, and the sums are of the raw observations. ``norm`` is
    ARS's (mean, std), applied to what the policy sees."""
    P = obs.shape[0]
    ret = torch.zeros((P,), device=obs.device)
    alive = torch.ones((P,), device=obs.device)
    steps = torch.zeros((P,), device=obs.device)
    osum = torch.zeros_like(obs)
    osq = torch.zeros_like(obs)
    with torch.no_grad():
        for _ in range(length):
            seen = obs if norm is None else (obs - norm[0]) / norm[1]
            a = policy.action(pop, seen)
            state, obs2, r, term, trunc = env.step(state, a)
            done = (term | trunc).float()
            ret = ret + r * alive
            osum = osum + obs * alive[:, None]
            osq = osq + obs * obs * alive[:, None]
            steps = steps + alive
            alive = alive * (1.0 - done)
            obs = obs2
    return ret, steps, osum, osq


def _perturb(leaves: List[torch.Tensor], eps: List[torch.Tensor], std: float):
    """Antithetic pairs ``theta +/- std * eps`` stacked [P = 2 * half]."""
    return [torch.cat([leaf[None] + std * e, leaf[None] - std * e]) for leaf, e in zip(leaves, eps)]


def _stable_argsort(x: torch.Tensor) -> torch.Tensor:
    """``jnp.argsort``'s order (stable: tied elements keep their order),
    computed on the host with numpy's stable sort: a population's returns
    are tens of numbers, and the order is then the same on every device."""
    order = np.argsort(x.detach().cpu().numpy(), kind="stable")
    return torch.as_tensor(order, device=x.device)


def _centered_ranks(returns: torch.Tensor) -> torch.Tensor:
    """Centered-rank shaping in [-0.5, 0.5]; ties keep their order."""
    order = _stable_argsort(returns)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(order.shape[0], device=order.device)
    return ranks.float() / (returns.shape[0] - 1) - 0.5


def _es_update(cfg: ESConfig, tx, theta, opt_state, eps: List[torch.Tensor],
               returns: torch.Tensor):
    """One ES step from the perturbations ``eps`` (one ``[half, *leaf]``
    tensor a leaf, in :func:`tree_leaves` order) and the population's
    returns ``[P]`` (the ``+`` half first). -> (theta, opt_state)."""
    half = cfg.population_size // 2
    shaped = _centered_ranks(returns)
    w = shaped[:half] - shaped[half:]  # antithetic difference weights
    leaves = tree_leaves(theta)
    grads = tree_unflatten(theta, [
        -torch.tensordot(w, e, dims=1) / (cfg.population_size * cfg.noise_std)
        + cfg.weight_decay * leaf
        for leaf, e in zip(leaves, eps)
    ])
    updates, opt_state = tx.update(grads, opt_state, theta)
    return apply_updates(theta, updates), opt_state


def _ars_update(cfg: ARSConfig, theta, eps: List[torch.Tensor], returns: torch.Tensor):
    """One ARS V2 step: the top-k directions by the better of each pair,
    stepped by the reward-std-scaled average of their return differences.
    -> theta."""
    half = cfg.population_size // 2
    k_top = min(cfg.top_directions, half)
    r_plus, r_minus = returns[:half], returns[half:]
    score = torch.maximum(r_plus, r_minus)
    top = _stable_argsort(-score)[:k_top]
    diffs = r_plus[top] - r_minus[top]
    # the population std (ddof 0), as jnp's
    sigma_r = torch.cat([r_plus[top], r_minus[top]]).std(correction=0) + 1e-8
    scale = cfg.lr / (k_top * sigma_r)
    return tree_unflatten(theta, [
        leaf + scale * torch.tensordot(diffs, e[top], dims=1)
        for leaf, e in zip(tree_leaves(theta), eps)
    ])


def _draw_eps(generator: torch.Generator, theta, half: int) -> List[torch.Tensor]:
    return [torch.randn((half,) + tuple(leaf.shape), generator=generator, device=leaf.device)
            for leaf in tree_leaves(theta)]


def _broadcast(theta, n: int):
    return tree_map(lambda leaf: leaf.expand((n,) + tuple(leaf.shape)), theta)


def _eval_result(returns: torch.Tensor, num_episodes: int) -> dict:
    return {
        "evaluation": {
            "episode_return_mean": float(returns.mean()),
            "episode_return_min": float(returns.min()),
            "episode_return_max": float(returns.max()),
            "num_episodes": num_episodes,
        }
    }


class _EvolutionBase(Algorithm):
    """Shared setup of ES and ARS: the policy, theta, the eval length and
    the generator of perturbations and episode starts."""

    def _setup_policy(self) -> None:
        cfg = self.config
        env = cfg.env
        assert cfg.population_size % 2 == 0, "population_size must be even (antithetic)"
        self.policy = _DeterministicPolicy(env, cfg.hidden)
        self.theta = self.policy.init(torch.Generator(device=self.device).manual_seed(cfg.seed))
        self._length = cfg.eval_length or env.max_episode_steps
        self._generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)

    def _population_returns(self, pop, generator, n: int, norm=None):
        state, obs = self.config.env.reset(generator, n, self.device)
        return _evaluate(self.config.env, self.policy, pop, state, obs, self._length, norm)

    def _evaluate_theta(self, num_episodes: int, norm=None) -> dict:
        """theta over ``num_episodes`` fresh episodes from a FIXED generator:
        evaluation repeats and never advances the training draws."""
        g = torch.Generator(device=self.device).manual_seed(self.config.seed + 10_000)
        returns, _, _, _ = self._population_returns(_broadcast(self.theta, num_episodes), g,
                                                    num_episodes, norm)
        return _eval_result(returns, num_episodes)

    def stop(self) -> None:
        pass


class ES(_EvolutionBase):
    def setup(self) -> None:
        self._setup_policy()
        self.tx = adam(self.config.lr)
        self.opt_state = self.tx.init(self.theta)

    def training_step(self) -> Dict[str, float]:
        cfg: ESConfig = self.config
        eps = _draw_eps(self._generator, self.theta, cfg.population_size // 2)
        pop = tree_unflatten(self.theta, _perturb(tree_leaves(self.theta), eps, cfg.noise_std))
        returns, steps, _, _ = self._population_returns(pop, self._generator,
                                                        cfg.population_size)
        with torch.no_grad():
            self.theta, self.opt_state = _es_update(cfg, self.tx, self.theta, self.opt_state,
                                                    eps, returns)
        host = returns.cpu()
        self._record_episodes([float(r) for r in host], int(steps.sum()))
        return {"fitness_mean": float(host.mean()), "fitness_max": float(host.max())}

    def evaluate(self, num_episodes: int = 10) -> dict:
        return self._evaluate_theta(num_episodes)

    def get_state(self):
        return {
            "theta": self.theta,
            "opt_state": self.opt_state,
            "iteration": self.iteration,
            "total_env_steps": self._total_env_steps,
        }

    def set_state(self, state):
        self.theta = to_device(state["theta"], self.device)
        self.opt_state = to_device(state["opt_state"], self.device)
        self.iteration = state["iteration"]
        self._total_env_steps = state["total_env_steps"]


ESConfig.algo_class = ES


class _ObsNormalizer:
    """Running mean/std over observations (ARS V2). Updates from the masked
    sums the eval rollout already accumulates."""

    def __init__(self, dim: int, device):
        self.count = 1e-4
        self.mean = torch.zeros((dim,), device=device)
        # sum of squared deviations; primed so std starts at 1 (not 1/sqrt(count))
        self.m2 = torch.full((dim,), self.count, device=device)

    def update(self, obs_sum, obs_sqsum, n: float) -> None:
        if n <= 0:
            return
        batch_mean = obs_sum / n
        batch_var = torch.clamp(obs_sqsum / n - batch_mean**2, min=0.0)
        delta = batch_mean - self.mean
        tot = self.count + n
        self.mean = self.mean + delta * n / tot
        self.m2 = self.m2 + batch_var * n + delta**2 * self.count * n / tot
        self.count = tot

    @property
    def std(self):
        return torch.sqrt(torch.clamp(self.m2 / self.count, min=1e-8))


class ARS(_EvolutionBase):
    """ARS V2: evaluate +/- each direction on normalized observations, keep
    the top-k directions by best-of-pair return, step by the reward-std-scaled
    average of their return differences."""

    def setup(self) -> None:
        self._setup_policy()
        self.normalizer = _ObsNormalizer(self.config.env.observation_size, self.device)

    def training_step(self) -> Dict[str, float]:
        cfg: ARSConfig = self.config
        eps = _draw_eps(self._generator, self.theta, cfg.population_size // 2)
        pop = tree_unflatten(self.theta, _perturb(tree_leaves(self.theta), eps, cfg.noise_std))
        norm = (self.normalizer.mean, self.normalizer.std)
        returns, steps, osum, osq = self._population_returns(pop, self._generator,
                                                             cfg.population_size, norm)
        with torch.no_grad():
            self.theta = _ars_update(cfg, self.theta, eps, returns)
        n = float(steps.sum())
        self.normalizer.update(osum.sum(0), osq.sum(0), n)
        host = returns.cpu()
        self._record_episodes([float(r) for r in host], int(n))
        return {
            "fitness_mean": float(host.mean()),
            "fitness_max": float(host.max()),
            "obs_count": float(self.normalizer.count),
        }

    def evaluate(self, num_episodes: int = 10) -> dict:
        return self._evaluate_theta(num_episodes, (self.normalizer.mean, self.normalizer.std))

    def get_state(self):
        return {
            "theta": self.theta,
            "norm": (self.normalizer.count, self.normalizer.mean, self.normalizer.m2),
            "iteration": self.iteration,
            "total_env_steps": self._total_env_steps,
        }

    def set_state(self, state):
        self.theta = to_device(state["theta"], self.device)
        count, mean, m2 = state["norm"]
        self.normalizer.count = float(count)
        self.normalizer.mean = to_device(mean, self.device)
        self.normalizer.m2 = to_device(m2, self.device)
        self.iteration = state["iteration"]
        self._total_env_steps = state["total_env_steps"]


ARSConfig.algo_class = ARS
