"""DQN: double Q-learning with a target network and replay.

Parity: `rllib/algorithms/dqn/` — epsilon-greedy sampling into a replay
buffer, double-DQN TD targets, periodic (soft) target sync.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup
from ray_tpu_torch.rllib.learner import Learner, LearnerGroup, to_device
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.rl_module import QModule, gather_last, tree_map
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.buffer_capacity = 50_000
        self.learning_starts = 1000
        self.target_update_tau = 0.01
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_decay_steps = 10_000
        self.num_updates_per_iter = 8
        self.train_batch_size = 128


def _dqn_loss(module: QModule, gamma: float):
    def loss_fn(params, batch, target_params):
        q = module.q_values(params, batch[SampleBatch.OBS])
        q_taken = gather_last(q, batch[SampleBatch.ACTIONS])
        # double DQN: online net picks the argmax, target net evaluates it
        next_q_online = module.q_values(params, batch[SampleBatch.NEXT_OBS])
        next_a = torch.argmax(next_q_online, dim=-1)
        next_q_target = module.q_values(target_params, batch[SampleBatch.NEXT_OBS])
        next_q = gather_last(next_q_target, next_a)
        not_done = 1.0 - batch[SampleBatch.DONES].float()
        target = batch[SampleBatch.REWARDS] + gamma * not_done * next_q.detach()
        td = q_taken - target
        loss = torch.mean(torch.where(td.abs() < 1.0, 0.5 * td**2, td.abs() - 0.5))
        return loss, {"td_error_mean": torch.mean(td.abs()), "q_mean": torch.mean(q_taken)}

    return loss_fn


def _soft_update(target, online, tau):
    with torch.no_grad():
        return tree_map(lambda t, o: (1 - tau) * t + tau * o, target, online)


def _copy(params):
    return tree_map(torch.clone, params)


class DQN(Algorithm):
    def setup(self) -> None:
        cfg: DQNConfig = self.config
        env = cfg.env
        assert env.discrete, "DQN requires a discrete-action env"
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
                _dqn_loss(self.module, cfg.gamma),
                lr=cfg.lr,
                max_grad_norm=cfg.max_grad_norm,
                seed=cfg.seed,
                device=self.device,
            )
        )
        self.target_params = _copy(self.learners.params)
        self.buffer = ReplayBuffer(cfg.buffer_capacity, seed=cfg.seed)

    def get_state(self):
        state = super().get_state()
        state["target_params"] = self.target_params
        return state

    def set_state(self, state) -> None:
        super().set_state(state)
        # Older checkpoints predate target_params; fall back to a copy of the
        # restored online network (their behavior at save time).
        if "target_params" in state:
            self.target_params = to_device(state["target_params"], self.device)
        else:
            self.target_params = _copy(self.learners.params)

    def _epsilon(self) -> float:
        cfg: DQNConfig = self.config
        frac = min(1.0, self._total_env_steps / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final - cfg.epsilon_initial)

    def training_step(self) -> Dict[str, float]:
        cfg: DQNConfig = self.config
        # float32, as the JAX package's jnp.asarray of it
        eps = float(np.float32(self._epsilon()))
        for batch, _, ep_returns in self.runners.sample(
            self.learners.params, {"epsilon": eps}
        ):
            self._record_episodes(ep_returns, len(batch) * batch[SampleBatch.OBS].shape[1])
            flat = SampleBatch(
                {k: np.asarray(v).reshape((-1,) + v.shape[2:]) for k, v in batch.items()}
            )
            self.buffer.add(flat)
        stats: Dict[str, float] = {"epsilon": eps}
        if len(self.buffer) < cfg.learning_starts:
            return stats
        for _ in range(cfg.num_updates_per_iter):
            sample = self.buffer.sample(cfg.train_batch_size)
            stats.update(self.learners.update(sample, target_params=self.target_params))
            self.target_params = _soft_update(
                self.target_params, self.learners.params, cfg.target_update_tau
            )
        return stats


DQNConfig.algo_class = DQN
