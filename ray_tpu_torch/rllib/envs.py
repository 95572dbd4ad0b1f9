"""Batched functional environments on a torch device.

Parity: the JAX package's pure envs (``ray_tpu/rllib/envs.py``), which the
sampler ``vmap``s. Here every env function takes a leading batch dimension
instead: ``reset(generator, num_envs, device) -> (state, obs)`` draws
``num_envs`` starting states with a ``torch.Generator``, and ``step(state,
action) -> (state, obs, reward, terminated, truncated)`` advances them all
at once. The state is a dict of tensors. The runner steps these functions
from Python, one set of launches an env step, on the device of its
generator.

CartPole and Pendulum keep the classic-control constants and dynamics of
the JAX package, operation for operation in float32, so their flags come
out equal step for step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

State = Any


def _uniform(generator: torch.Generator, shape, low: float, high: float, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return u * (high - low) + low


def _f32(x: float) -> float:
    """``x`` rounded to float32: a threshold compared exactly as the JAX
    package compares its weakly typed constant with a float32 state."""
    return float(torch.tensor(x, dtype=torch.float32))


_X_LIMIT = _f32(2.4)
_THETA_LIMIT = _f32(12 * math.pi / 180)


class DeviceEnv:
    """Functional env protocol. Subclasses are stateless; all state is in the
    ``state`` dict of ``[num_envs, ...]`` tensors threaded through ``step``."""

    observation_size: int
    # Discrete envs set num_actions; continuous envs set action_size + bounds.
    num_actions: int = 0
    action_size: int = 0
    action_low: float = -1.0
    action_high: float = 1.0
    max_episode_steps: int = 1000

    @property
    def discrete(self) -> bool:
        return self.num_actions > 0

    def reset(self, generator: torch.Generator, num_envs: int, device=None
              ) -> Tuple[State, torch.Tensor]:
        raise NotImplementedError

    def step(
        self, state: State, action: torch.Tensor
    ) -> Tuple[State, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (next_state, obs, reward, terminated, truncated), each with a
        leading ``num_envs`` dimension. Terminated is a true environment
        terminal (no future value); truncated is a time limit — learners
        must still bootstrap V/Q(next_obs) there."""
        raise NotImplementedError


# the JAX package's name for the protocol, kept so that ``__all__`` is equal
JaxEnv = DeviceEnv


@dataclasses.dataclass(frozen=True)
class CartPole(DeviceEnv):
    """Classic CartPole-v1 dynamics (Barto-Sutton-Anderson), batched.

    Episode ends when |x| > 2.4, |theta| > 12deg, or after 500 steps.
    Reward is +1 per step; solved ~= return 475.
    """

    gravity: float = 9.8
    masscart: float = 1.0
    masspole: float = 0.1
    length: float = 0.5
    force_mag: float = 10.0
    tau: float = 0.02
    max_episode_steps: int = 500

    observation_size = 4
    num_actions = 2

    def reset(self, generator: torch.Generator, num_envs: int, device=None):
        device = generator.device if device is None else torch.device(device)
        pos = _uniform(generator, (num_envs, 4), -0.05, 0.05, device)
        state = {"s": pos, "t": torch.zeros(num_envs, dtype=torch.int32, device=device)}
        return state, pos

    def step(self, state, action):
        x, x_dot, theta, theta_dot = state["s"].unbind(-1)
        force = torch.where(action == 1, self.force_mag, -self.force_mag).to(x.dtype)
        costh, sinth = torch.cos(theta), torch.sin(theta)
        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length
        temp = (force + polemass_length * theta_dot**2 * sinth) / total_mass
        thetaacc = (self.gravity * sinth - costh * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costh**2 / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costh / total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        obs = torch.stack([x, x_dot, theta, theta_dot], dim=-1)
        t = state["t"] + 1
        terminated = (x.abs() > _X_LIMIT) | (theta.abs() > _THETA_LIMIT)
        truncated = (t >= self.max_episode_steps) & ~terminated
        reward = torch.ones_like(x)
        return {"s": obs, "t": t}, obs, reward, terminated, truncated


@dataclasses.dataclass(frozen=True)
class Pendulum(DeviceEnv):
    """Pendulum-v1 swing-up, batched. Continuous torque in [-2, 2];
    obs = (cos th, sin th, thdot); reward = -(th^2 + .1 thdot^2 + .001 u^2)."""

    max_speed: float = 8.0
    max_torque: float = 2.0
    dt: float = 0.05
    g: float = 10.0
    m: float = 1.0
    length: float = 1.0
    max_episode_steps: int = 200

    observation_size = 3
    action_size = 1
    action_low = -2.0
    action_high = 2.0

    def _obs(self, th, thdot):
        return torch.stack([torch.cos(th), torch.sin(th), thdot], dim=-1)

    def reset(self, generator: torch.Generator, num_envs: int, device=None):
        device = generator.device if device is None else torch.device(device)
        th = _uniform(generator, (num_envs,), -math.pi, math.pi, device)
        thdot = _uniform(generator, (num_envs,), -1.0, 1.0, device)
        state = {"th": th, "thdot": thdot,
                 "t": torch.zeros(num_envs, dtype=torch.int32, device=device)}
        return state, self._obs(th, thdot)

    def step(self, state, action):
        th, thdot = state["th"], state["thdot"]
        u = torch.clamp(action.reshape(th.shape), -self.max_torque, self.max_torque)
        # floor-mod in float32, as jnp's % (torch.remainder has its sign rule)
        norm_th = torch.remainder(th + math.pi, 2 * math.pi) - math.pi
        cost = norm_th**2 + 0.1 * thdot**2 + 0.001 * u**2
        thdot = thdot + (
            3 * self.g / (2 * self.length) * torch.sin(th)
            + 3.0 / (self.m * self.length**2) * u
        ) * self.dt
        thdot = torch.clamp(thdot, -self.max_speed, self.max_speed)
        th = th + thdot * self.dt
        t = state["t"] + 1
        # pendulum never terminates; the 200-step cap is pure truncation
        truncated = t >= self.max_episode_steps
        return (
            {"th": th, "thdot": thdot, "t": t},
            self._obs(th, thdot),
            -cost,
            torch.zeros_like(truncated),
            truncated,
        )
