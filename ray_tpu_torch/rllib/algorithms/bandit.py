"""Contextual linear bandits: LinUCB and Linear Thompson Sampling.

Parity: `rllib_contrib/bandit` (BanditLinUCB / BanditLinTS — per-arm linear
models with closed-form posterior updates; no gradient descent, no replay).

Each arm keeps the sufficient statistics (A = lambda*I + sum x x^T, b =
sum r*x) as device tensors stacked [num_arms, D, D]; action selection is
one ``torch.linalg.solve`` on the stacked statistics and the update a
rank-1 add. Contexts come from a batched env (obs IS the context; reward
arrives for the pulled arm only).

D5: :class:`LinearBanditEnv` draws its true arm weights from a
``torch.Generator`` seeded with ``env_seed`` (the JAX package: a JAX key of
it), and its reward noise and next contexts from a per-env integer key
that its state carries, drawn at reset from the caller's generator (the
JAX package: the per-env JAX key in its state). The same ``env_seed``
makes another draw of the same problem. The key's stream is MINSTD
(Park-Miller) with Box-Muller normals: integer arithmetic, so the card and
the CPU step a state to the same draws.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict

import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.envs import DeviceEnv
from ray_tpu_torch.rllib.learner import to_device

_MINSTD_M = 2_147_483_647  # 2^31 - 1: a key times a multiplier stays within int64
_MINSTD_A = 48_271


def _minstd_normals(key: torch.Tensor, n: int):
    """``n`` standard normals an env from its MINSTD key ``[N]`` (int64 in
    [1, M - 1]), by Box-Muller over the key's next draws. -> (normals
    [N, n], the key after those draws)."""
    m = 2 * ((n + 1) // 2)
    mult = torch.tensor([pow(_MINSTD_A, j, _MINSTD_M) for j in range(1, m + 1)],
                        dtype=torch.int64, device=key.device)
    k = (key[:, None] * mult) % _MINSTD_M
    u = (k.double() / _MINSTD_M).float()  # in (0, 1)
    r = torch.sqrt(-2.0 * torch.log(u[:, 0::2]))
    theta = (2.0 * math.pi) * u[:, 1::2]
    z = torch.cat([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    return z[:, :n], k[:, -1]


@functools.lru_cache(maxsize=None)
def _arm_weights(env_seed: int, num_arms: int, context_dim: int, device: str) -> torch.Tensor:
    g = torch.Generator().manual_seed(env_seed)  # on the CPU: every device the same weights
    return torch.randn((num_arms, context_dim), generator=g).to(device)


@dataclasses.dataclass(frozen=True)
class LinearBanditEnv(DeviceEnv):
    """Synthetic contextual bandit: true per-arm weights are drawn from the
    given seed; reward = <w_arm, context> + noise. One step per "episode"
    (bandits have horizon 1). Batched: ``reset(generator, num_envs,
    device)``, ``step(state, arms [N])``."""

    num_arms: int = 5
    context_dim: int = 8
    noise: float = 0.1
    env_seed: int = 0
    max_episode_steps: int = 1

    @property
    def observation_size(self):  # type: ignore[override]
        return self.context_dim

    @property
    def num_actions(self):  # type: ignore[override]
        return self.num_arms

    def _weights(self, device) -> torch.Tensor:
        return _arm_weights(self.env_seed, self.num_arms, self.context_dim,
                            str(torch.device(device)))

    def _draws(self, key: torch.Tensor, n: int):
        """(normals [N, n], next key) of each env's key (D5)."""
        return _minstd_normals(key, n)

    def reset(self, generator: torch.Generator, num_envs: int, device=None):
        device = generator.device if device is None else torch.device(device)
        ctx = torch.randn((num_envs, self.context_dim), generator=generator, device=device)
        key = torch.randint(1, _MINSTD_M, (num_envs,), generator=generator, device=device,
                            dtype=torch.int64)
        return {"ctx": ctx, "key": key}, ctx

    def step(self, state, action):
        ctx = state["ctx"]
        w = self._weights(ctx.device)
        z, key = self._draws(state["key"], 1 + self.context_dim)
        reward = torch.sum(w[action.long()] * ctx, dim=-1) + self.noise * z[:, 0]
        new_ctx = z[:, 1:].contiguous()
        n = ctx.shape[0]
        done = torch.ones((n,), dtype=torch.bool, device=ctx.device)  # horizon-1
        return ({"ctx": new_ctx, "key": key}, new_ctx, reward, done,
                torch.zeros((n,), dtype=torch.bool, device=ctx.device))

    def best_expected_reward(self, ctx: torch.Tensor) -> torch.Tensor:
        return torch.amax(ctx @ self._weights(ctx.device).T, dim=-1)


class BanditConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.reg_lambda = 1.0
        self.ucb_alpha = 1.0  # LinUCB exploration bonus scale
        self.ts_scale = 1.0  # LinTS posterior sample scale
        self.steps_per_iter = 64
        self.exploration = "ucb"  # "ucb" | "ts"


class LinUCBConfig(BanditConfig):
    pass


class LinTSConfig(BanditConfig):
    def __init__(self):
        super().__init__()
        self.exploration = "ts"


def _select(cfg: BanditConfig, A: torch.Tensor, b: torch.Tensor, ctx: torch.Tensor,
            noise: torch.Tensor) -> torch.Tensor:
    """The arm to pull for context ``ctx [D]``; ``noise [arms]`` is LinTS's
    standard normal draw (unread by LinUCB)."""
    theta = torch.linalg.solve(A, b[..., None])[..., 0]  # [arms, D]
    mean = theta @ ctx
    cov_ctx = torch.linalg.solve(A, ctx.expand(b.shape)[..., None])[..., 0]
    var = torch.einsum("ad,d->a", cov_ctx, ctx)
    if cfg.exploration == "ts":
        # sample from each arm's posterior N(theta, scale^2 * A^-1)
        score = mean + cfg.ts_scale * torch.sqrt(torch.clamp(var, min=0.0)) * noise
    else:
        bonus = torch.sqrt(torch.clamp(var, min=0.0))
        score = mean + cfg.ucb_alpha * bonus
    return torch.argmax(score)


def _update(A, b, arm, ctx, reward):
    """The rank-1 statistics update of the pulled arm (new tensors)."""
    A = A.clone()
    b = b.clone()
    A[arm] += torch.outer(ctx, ctx)
    b[arm] += reward * ctx
    return A, b


class LinUCB(Algorithm):
    """Closed-form contextual bandit. Stats update is exact (rank-1), so
    there is no learner/optimizer — `training_step` pulls arms, observes
    rewards, and refreshes the posterior."""

    def setup(self) -> None:
        cfg: BanditConfig = self.config
        env = cfg.env
        assert env.discrete and env.max_episode_steps == 1, (
            "bandit algorithms need a horizon-1 discrete env"
        )
        d = env.observation_size
        eye = torch.eye(d, device=self.device)
        self.A = eye[None].repeat(env.num_actions, 1, 1) * cfg.reg_lambda
        self.b = torch.zeros((env.num_actions, d), device=self.device)
        self._generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._regret_sum = 0.0

    def training_step(self) -> Dict[str, float]:
        cfg: BanditConfig = self.config
        env = cfg.env
        rewards = []
        regret = 0.0
        for _ in range(cfg.steps_per_iter):
            state, ctx = env.reset(self._generator, 1, self.device)
            noise = torch.randn((env.num_actions,), generator=self._generator,
                                device=self.device)
            arm = _select(cfg, self.A, self.b, ctx[0], noise)
            state, _, reward, _, _ = env.step(state, arm[None])
            self.A, self.b = _update(self.A, self.b, arm, ctx[0], reward[0])
            rewards.append(float(reward[0]))
            if hasattr(env, "best_expected_reward"):
                regret += float(env.best_expected_reward(ctx)[0]) - rewards[-1]
        self._regret_sum += regret
        self._record_episodes(rewards, cfg.steps_per_iter)
        return {
            "reward_mean": float(torch.tensor(rewards, dtype=torch.float32).mean()),
            "regret_this_iter": regret,
            "cumulative_regret": self._regret_sum,
        }

    def get_state(self):
        return {
            "A": self.A,
            "b": self.b,
            "iteration": self.iteration,
            "total_env_steps": self._total_env_steps,
        }

    def set_state(self, state):
        self.A = to_device(state["A"], self.device)
        self.b = to_device(state["b"], self.device)
        self.iteration = state["iteration"]
        self._total_env_steps = state["total_env_steps"]

    def stop(self) -> None:
        pass


LinUCBConfig.algo_class = LinUCB


class LinTS(LinUCB):
    pass


LinTSConfig.algo_class = LinTS
