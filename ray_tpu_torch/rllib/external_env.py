"""External (host-loop) and multi-agent environments.

The native sampling path (``rllib/env_runner.py``) steps batched functional
envs on the device. This module covers the reference's OTHER env surface (SURVEY §2.4 RLlib:
``rllib/env/``):

* :class:`GymEnvRunner` — steps stateful gymnasium-API environments
  (``reset() -> (obs, info)``, ``step(a) -> (obs, r, term, trunc, info)``)
  from the host, batching N instances per policy call so the device sees
  one batched forward per env step on its ``device`` (RolloutWorker/SingleAgentEnvRunner
  role, ``rllib/evaluation/rollout_worker.py``). Works with gymnasium when
  installed and with any object implementing the same five-tuple API —
  no gym dependency is required.
* :class:`MultiAgentEnv` + :class:`MultiAgentEnvRunner` — dict-keyed
  agents sharing one policy (parameter sharing, the most common
  multi-agent configuration; ``rllib/env/multi_agent_env.py`` role).
  Per-agent transitions flatten into the same SampleBatch the learners
  already consume.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.models.common import default_device
from ray_tpu_torch.rllib.env_runner import on_device, to_numpy
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class GymEnvRunner:
    """Host-loop sampler over gymnasium-style envs.

    ``env_fns`` build N independent env instances; actions come from the
    same module interface the device runner uses (``policy`` selects
    actor_critic / q / sac / random), drawn from a generator on ``device``
    (CUDA unless given the CPU)."""

    def __init__(
        self,
        env_fns: List[Callable[[], Any]],
        module,
        *,
        policy: str = "actor_critic",
        rollout_length: int = 128,
        seed: int = 0,
        discrete: Optional[bool] = None,
        num_actions: int = 0,
        action_size: int = 0,
        action_low: float = -1.0,
        action_high: float = 1.0,
        device=None,
    ):
        self.device = default_device(device, "GymEnvRunner")
        self.envs = [fn() for fn in env_fns]
        self.module = module
        self.policy = policy
        self.rollout_length = rollout_length
        self.num_envs = len(self.envs)
        self.discrete = bool(num_actions) if discrete is None else discrete
        self.num_actions = num_actions
        self.action_size = action_size
        self.action_low = action_low
        self.action_high = action_high
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._obs: Optional[np.ndarray] = None
        self._ep_ret = np.zeros(self.num_envs)
        self.metrics: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def _reset_all(self) -> np.ndarray:
        obs = []
        for env in self.envs:
            out = env.reset()
            obs.append(out[0] if isinstance(out, tuple) else out)
        return np.stack(obs)

    def _act(self, params, obs: np.ndarray, extra: Dict[str, Any]):
        """One batched device call for all env instances."""
        with torch.no_grad():
            action, aux = self._device_act(on_device(params, self.device),
                                           torch.from_numpy(np.array(obs, np.float32))
                                           .to(self.device), extra)
            return to_numpy(action), {k: to_numpy(v) for k, v in aux.items()}

    def _device_act(self, params, obs: torch.Tensor, extra: Dict[str, Any]):
        m, g = self.module, self._generator
        if self.policy == "actor_critic":
            action, logp, value = m.explore(params, obs, g)
            return action, {SampleBatch.LOGP: logp, SampleBatch.VALUES: value}
        if self.policy == "q":
            return m.explore(params, obs, g, extra["epsilon"]), {}
        if self.policy == "sac":
            noise = torch.randn(obs.shape[:-1] + (m.action_size,), generator=g, device=obs.device)
            action, logp = m.sample_action(params, obs, noise)
            return action, {SampleBatch.LOGP: logp}
        if self.policy == "random":
            if self.discrete:
                return torch.randint(0, self.num_actions, (self.num_envs,), generator=g,
                                     device=obs.device), {}
            u = torch.rand((self.num_envs, self.action_size), generator=g, device=obs.device)
            return u * (self.action_high - self.action_low) + self.action_low, {}
        raise ValueError(f"unknown policy {self.policy!r}")

    def sample(
        self, params, extra: Optional[Dict[str, Any]] = None
    ) -> Tuple[SampleBatch, np.ndarray, List[float]]:
        """One rollout; same contract as EnvRunner.sample: (time-major
        batch [T, B, ...], final_obs [B, ...], completed episode returns)."""
        if self._obs is None:
            self._obs = self._reset_all()
        records: Dict[str, list] = {}
        episode_returns: List[float] = []
        for _t in range(self.rollout_length):
            action, aux = self._act(params, self._obs, extra or {})
            next_obs = np.empty_like(self._obs)
            reward = np.zeros(self.num_envs, np.float32)
            term = np.zeros(self.num_envs, bool)
            trunc = np.zeros(self.num_envs, bool)
            for i, env in enumerate(self.envs):
                out = env.step(action[i])
                if len(out) == 5:  # gymnasium API
                    o, r, te, tr, _info = out
                else:  # classic gym 4-tuple
                    o, r, te, _info = out
                    tr = False
                next_obs[i], reward[i], term[i], trunc[i] = o, r, te, tr
            self._ep_ret += reward
            step_rec = {
                SampleBatch.OBS: self._obs.copy(),
                SampleBatch.ACTIONS: action,
                SampleBatch.REWARDS: reward,
                SampleBatch.DONES: term.copy(),
                SampleBatch.TRUNCATEDS: trunc.copy(),
                SampleBatch.NEXT_OBS: next_obs.copy(),
                **aux,
            }
            for k, v in step_rec.items():
                records.setdefault(k, []).append(v)
            for i in range(self.num_envs):
                if term[i] or trunc[i]:
                    episode_returns.append(float(self._ep_ret[i]))
                    self._ep_ret[i] = 0.0
                    out = self.envs[i].reset()
                    next_obs[i] = out[0] if isinstance(out, tuple) else out
            self._obs = next_obs
        traj = {k: np.stack(v) for k, v in records.items()}
        self.metrics = {
            "episodes_this_iter": len(episode_returns),
            "env_steps_this_iter": self.rollout_length * self.num_envs,
        }
        return SampleBatch(traj), self._obs.copy(), episode_returns

    def stop(self) -> None:
        for env in self.envs:
            close = getattr(env, "close", None)
            if close is not None:
                close()


# ---------------------------------------------------------------------------
# multi-agent
# ---------------------------------------------------------------------------
class MultiAgentEnv:
    """Dict-keyed multi-agent env protocol (``multi_agent_env.py`` role).

    ``reset() -> (obs_dict, info)``; ``step(action_dict) -> (obs_dict,
    reward_dict, terminated_dict, truncated_dict, info)``. The special key
    ``"__all__"`` in terminated/truncated ends the episode for everyone."""

    agents: List[str] = []

    def reset(self):
        raise NotImplementedError

    def step(self, action_dict: Dict[str, Any]):
        raise NotImplementedError


class MultiAgentEnvRunner:
    """Parameter-shared sampling over a MultiAgentEnv: each step batches
    every live agent's observation into ONE policy forward, then routes the
    per-agent actions back; transitions flatten agent-major into the shared
    SampleBatch the learners already consume."""

    def __init__(
        self,
        env: MultiAgentEnv,
        module,
        *,
        policy: str = "actor_critic",
        rollout_length: int = 128,
        seed: int = 0,
        device=None,
    ):
        self.device = default_device(device, "MultiAgentEnvRunner")
        self.env = env
        self.module = module
        self.policy = policy
        self.rollout_length = rollout_length
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._obs: Optional[Dict[str, np.ndarray]] = None
        self._ep_ret = 0.0
        self.metrics: Dict[str, float] = {}

    def _act(self, params, obs_batch: np.ndarray):
        if self.policy == "actor_critic":
            with torch.no_grad():
                obs = torch.from_numpy(np.array(obs_batch, np.float32)).to(self.device)
                action, logp, value = self.module.explore(on_device(params, self.device), obs,
                                                          self._generator)
            return to_numpy(action), {
                SampleBatch.LOGP: to_numpy(logp),
                SampleBatch.VALUES: to_numpy(value),
            }
        raise ValueError(
            f"multi-agent runner supports policy='actor_critic' (got {self.policy!r})"
        )

    def sample(self, params, extra=None) -> Tuple[SampleBatch, np.ndarray, List[float]]:
        if self._obs is None:
            out = self.env.reset()
            self._obs = out[0] if isinstance(out, tuple) else out
            self._ep_ret = 0.0
        records: Dict[str, list] = {}
        episode_returns: List[float] = []
        # FIXED roster every step: agents may terminate individually (and
        # drop out of next_obs) mid-episode, but the recorded batch must
        # stay rectangular — dead agents carry their last obs, zero reward,
        # and done=True until the episode resets
        roster = list(self.env.agents)
        last_obs = {a: self._obs.get(a, np.zeros_like(next(iter(self._obs.values())))) for a in roster}
        dead = {a: a not in self._obs for a in roster}
        for _t in range(self.rollout_length):
            obs_batch = np.stack([last_obs[a] for a in roster])
            action, aux = self._act(params, obs_batch)
            action_dict = {
                a: action[i] for i, a in enumerate(roster) if not dead[a]
            }
            next_obs, rewards, terms, truncs, _info = self.env.step(action_dict)
            done_all = terms.get("__all__", False) or truncs.get("__all__", False)
            reward_vec = np.asarray([rewards.get(a, 0.0) for a in roster], np.float32)
            term_vec = np.asarray(
                [bool(terms.get(a, False)) or dead[a] or bool(done_all) for a in roster]
            )
            trunc_vec = np.asarray([bool(truncs.get(a, False)) for a in roster])
            for a in roster:
                if a in next_obs:
                    last_obs[a] = next_obs[a]
                if terms.get(a, False) or truncs.get(a, False) or a not in next_obs:
                    dead[a] = True
            next_vec = np.stack([last_obs[a] for a in roster])
            step_rec = {
                SampleBatch.OBS: obs_batch,
                SampleBatch.ACTIONS: action,
                SampleBatch.REWARDS: reward_vec,
                SampleBatch.DONES: term_vec,
                SampleBatch.TRUNCATEDS: trunc_vec,
                SampleBatch.NEXT_OBS: next_vec,
                **aux,
            }
            for k, v in step_rec.items():
                records.setdefault(k, []).append(v)
            self._ep_ret += float(reward_vec.sum())
            if done_all or all(dead.values()):
                episode_returns.append(self._ep_ret)
                out = self.env.reset()
                self._obs = out[0] if isinstance(out, tuple) else out
                self._ep_ret = 0.0
                last_obs = {a: self._obs[a] for a in roster}
                dead = {a: False for a in roster}
            else:
                self._obs = {a: v for a, v in next_obs.items()}
        traj = {k: np.stack(v) for k, v in records.items()}
        self.metrics = {
            "episodes_this_iter": len(episode_returns),
            "env_steps_this_iter": self.rollout_length * len(roster),
        }
        final = np.stack([last_obs[a] for a in roster])
        return SampleBatch(traj), final, episode_returns

    def stop(self) -> None:
        close = getattr(self.env, "close", None)
        if close is not None:
            close()
