"""SimpleQ / Ape-X DQN: the plain and the distributed ends of Q-learning.

Parity: `rllib_contrib/simple_q` (vanilla TD(0) Q-learning — no double-Q,
no dueling, hard periodic target sync) and `rllib_contrib/apex_dqn`
(Horgan et al.'s distributed DQN: many actors with per-actor exploration
epsilons feeding one learner through prioritized replay with
importance-weighted updates).

Ape-X's contribution is its schedule: each runner samples at its own rung
of the epsilon ladder (``EnvRunnerGroup.sample_each``; remote runners on
the card hold a share of the GPU each), and the prioritized buffer returns
its sampled indices, so the weighted-Huber update's |TD| goes straight back
as priorities. The buffer is the host's numpy with the JAX package's
``default_rng``: the same seed samples the same indices and weights.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn import _copy, _soft_update
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup, to_numpy
from ray_tpu_torch.rllib.learner import Learner, LearnerGroup, floats, to_device
from ray_tpu_torch.rllib.replay_buffer import PrioritizedReplayBuffer, ReplayBuffer
from ray_tpu_torch.rllib.rl_module import QModule, gather_last
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class SimpleQConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.buffer_capacity = 50_000
        self.learning_starts = 500
        self.target_update_freq = 32  # hard sync every N updates
        self.epsilon = 0.1
        self.num_updates_per_iter = 8
        self.train_batch_size = 128


def _simple_q_loss(module: QModule, gamma: float):
    def loss_fn(params, batch, target_params):
        q = module.q_values(params, batch[SampleBatch.OBS])
        q_taken = gather_last(q, batch[SampleBatch.ACTIONS])
        # vanilla TD(0): target net both picks and evaluates the max
        next_q = torch.amax(module.q_values(target_params, batch[SampleBatch.NEXT_OBS]), dim=-1)
        not_done = 1.0 - batch[SampleBatch.DONES].float()
        target = batch[SampleBatch.REWARDS] + gamma * not_done * next_q.detach()
        loss = torch.mean((q_taken - target) ** 2)
        return loss, {"q_mean": torch.mean(q_taken)}

    return loss_fn


def _flat_rows(batch) -> SampleBatch:
    """A runner's [T, B, ...] rollout as [T*B, ...] rows."""
    return SampleBatch({k: np.asarray(v).reshape((-1,) + v.shape[2:]) for k, v in batch.items()})


class SimpleQ(Algorithm):
    def setup(self) -> None:
        cfg: SimpleQConfig = self.config
        env = cfg.env
        assert env.discrete, "SimpleQ requires a discrete-action env"
        self.module = QModule(env.observation_size, env.num_actions, cfg.hidden)
        self.runners = EnvRunnerGroup(
            env,
            self.module,
            policy="q",
            num_runners=cfg.num_env_runners,
            num_envs_per_runner=cfg.num_envs_per_runner,
            rollout_length=cfg.rollout_length,
            seed=cfg.seed,
            remote=cfg.remote_runners,
            device=self.device,
        )
        self.learners = LearnerGroup(
            Learner(
                self.module,
                _simple_q_loss(self.module, cfg.gamma),
                lr=cfg.lr,
                max_grad_norm=cfg.max_grad_norm,
                seed=cfg.seed,
                device=self.device,
            )
        )
        self.target_params = _copy(self.learners.params)
        self.buffer = ReplayBuffer(cfg.buffer_capacity, seed=cfg.seed)
        self._updates = 0

    def get_state(self):
        state = super().get_state()
        state["target_params"] = self.target_params
        state["updates"] = self._updates
        return state

    def set_state(self, state) -> None:
        super().set_state(state)
        self.target_params = to_device(state["target_params"], self.device)
        self._updates = state["updates"]

    def training_step(self) -> Dict[str, float]:
        cfg: SimpleQConfig = self.config
        # float32, as the JAX package's jnp.asarray of it
        eps = float(np.float32(cfg.epsilon))
        for batch, _, ep_returns in self.runners.sample(self.learners.params, {"epsilon": eps}):
            self._record_episodes(ep_returns, len(batch) * batch[SampleBatch.OBS].shape[1])
            self.buffer.add(_flat_rows(batch))
        stats: Dict[str, float] = {}
        if len(self.buffer) < cfg.learning_starts:
            return stats
        for _ in range(cfg.num_updates_per_iter):
            stats = self.learners.update(
                self.buffer.sample(cfg.train_batch_size), target_params=self.target_params
            )
            self._updates += 1
            if self._updates % cfg.target_update_freq == 0:
                self.target_params = _copy(self.learners.params)
        return stats


SimpleQConfig.algo_class = SimpleQ


class ApexDQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.num_env_runners = 4
        self.buffer_capacity = 100_000
        self.learning_starts = 1000
        self.target_update_tau = 0.01
        self.num_updates_per_iter = 16
        self.train_batch_size = 128
        # Ape-X epsilon ladder: runner i explores at eps_base^(1 + i/(N-1)*alpha)
        self.epsilon_base = 0.4
        self.epsilon_alpha = 7.0
        self.prioritized_alpha = 0.6
        self.prioritized_beta = 0.4


def _apex_loss(module: QModule, gamma: float):
    def loss_fn(params, batch, target_params):
        q = module.q_values(params, batch[SampleBatch.OBS])
        q_taken = gather_last(q, batch[SampleBatch.ACTIONS])
        # double-DQN targets (Ape-X uses the full Rainbow-lite learner)
        next_a = torch.argmax(module.q_values(params, batch[SampleBatch.NEXT_OBS]), dim=-1)
        next_q = gather_last(module.q_values(target_params, batch[SampleBatch.NEXT_OBS]), next_a)
        not_done = 1.0 - batch[SampleBatch.DONES].float()
        target = batch[SampleBatch.REWARDS] + gamma * not_done * next_q.detach()
        td = q_taken - target
        huber = torch.where(td.abs() < 1.0, 0.5 * td**2, td.abs() - 0.5)
        loss = torch.mean(batch["weights"] * huber)
        return loss, {"td_abs": td.abs(), "q_mean": torch.mean(q_taken)}

    return loss_fn


class ApexDQN(Algorithm):
    """Distributed prioritized-replay DQN. Each runner samples at its own
    rung of the epsilon ladder; the learner consumes IS-weighted prioritized
    minibatches and writes fresh |TD| priorities back after every update."""

    def setup(self) -> None:
        cfg: ApexDQNConfig = self.config
        env = cfg.env
        assert env.discrete, "ApexDQN requires a discrete-action env"
        self.module = QModule(env.observation_size, env.num_actions, cfg.hidden)
        self.runners = EnvRunnerGroup(
            env,
            self.module,
            policy="q",
            num_runners=cfg.num_env_runners,
            num_envs_per_runner=cfg.num_envs_per_runner,
            rollout_length=cfg.rollout_length,
            seed=cfg.seed,
            remote=cfg.remote_runners,
            device=self.device,
        )
        n = max(1, cfg.num_env_runners)
        self._epsilons = [
            cfg.epsilon_base ** (1 + (i / max(1, n - 1)) * cfg.epsilon_alpha)
            for i in range(n)
        ]
        self.learners = LearnerGroup(
            Learner(
                self.module,
                _apex_loss(self.module, cfg.gamma),
                lr=cfg.lr,
                max_grad_norm=cfg.max_grad_norm,
                seed=cfg.seed,
                device=self.device,
            )
        )
        self.target_params = _copy(self.learners.params)
        self.buffer = PrioritizedReplayBuffer(
            cfg.buffer_capacity,
            seed=cfg.seed,
            alpha=cfg.prioritized_alpha,
            beta=cfg.prioritized_beta,
        )

    def get_state(self):
        state = super().get_state()
        state["target_params"] = self.target_params
        return state

    def set_state(self, state) -> None:
        super().set_state(state)
        self.target_params = to_device(state["target_params"], self.device)

    def training_step(self) -> Dict[str, float]:
        cfg: ApexDQNConfig = self.config
        # per-runner epsilons (float32, as jnp.asarray makes them): each
        # runner samples at its ladder rung
        results = self.runners.sample_each(
            self.learners.params,
            [{"epsilon": float(np.float32(e))} for e in self._epsilons],
        )
        for batch, _, ep_returns in results:
            self._record_episodes(ep_returns, len(batch) * batch[SampleBatch.OBS].shape[1])
            self.buffer.add(_flat_rows(batch))
        stats: Dict[str, float] = {}
        if len(self.buffer) < cfg.learning_starts:
            return stats
        for _ in range(cfg.num_updates_per_iter):
            sample = self.buffer.sample(cfg.train_batch_size)
            idx = sample.sampled_indices
            raw = self.learners.learner.update_raw(sample, target_params=self.target_params)
            self.buffer.update_priorities(idx, to_numpy(raw.pop("td_abs")))
            stats = floats(raw)
            self.target_params = _soft_update(
                self.target_params, self.learners.params, cfg.target_update_tau
            )
        return stats


ApexDQNConfig.algo_class = ApexDQN
