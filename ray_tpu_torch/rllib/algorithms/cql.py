"""CQL: conservative Q-learning for offline RL.

Parity: ``rllib/algorithms/cql/`` — SAC's twin-critic backbone trained purely
from a fixed dataset, plus the conservative regularizer
``E_s[logsumexp_a Q(s,a) - E_{a~D} Q(s,a)]`` (Kumar et al. 2020) that pushes
down Q on out-of-distribution actions. The logsumexp is estimated over
uniform-random and current-policy action samples, batched over the samples
(no Python loop over them). The draws an update needs come in as tensors
(:meth:`_CQLLearner.draw_noise`), where the JAX package splits a key.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.learner import (
    adam,
    apply_updates,
    floats,
    to_device,
    to_tensor,
    value_and_grad,
)
from ray_tpu_torch.rllib.rl_module import SACModule, tree_map
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class CQLConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.offline_data: Optional[SampleBatch] = None
        self.cql_alpha = 1.0          # conservative penalty weight (min_q_weight)
        self.num_ood_actions = 4      # action samples for the logsumexp
        self.target_update_tau = 0.005
        self.num_updates_per_iter = 16
        self.train_batch_size = 256
        self.initial_alpha = 0.1

    def offline(self, data: SampleBatch) -> "CQLConfig":
        self.offline_data = data
        return self


class _CQLLearner:
    """Owns critic/actor/target optimizers; one update step."""

    def __init__(self, module: SACModule, cfg: CQLConfig, device):
        self.module = module
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = module.init(torch.Generator(device=self.device).manual_seed(cfg.seed))
        self.target_params = tree_map(torch.clone, self.params)
        self.tx = adam(cfg.lr)
        self.opt_state = self.tx.init(self.params)
        self._generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)

    def draw_noise(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """An update's draws: standard normals for the next-state ("next"),
        the policy's OOD ("pi", one per OOD sample) and the actor's
        ("actor") actions; the uniform OOD actions themselves ("rand")."""
        m, n, g = self.module, self.cfg.num_ood_actions, self._generator
        ba = (batch_size, m.action_size)

        def normal(shape):
            return torch.randn(shape, generator=g, device=self.device)

        u = torch.rand((n,) + ba, generator=g, device=self.device)
        return {"next": normal(ba), "rand": u * (m.action_high - m.action_low) + m.action_low,
                "pi": normal((n,) + ba), "actor": normal(ba)}

    def _critic_loss(self, params, b, noise):
        m, cfg = self.module, self.cfg
        obs, actions = b[SampleBatch.OBS], b[SampleBatch.ACTIONS]
        with torch.no_grad():
            # --- SAC bellman target (no entropy term in the min for CQL's
            # standard form; alpha fixed here)
            next_action, next_logp = m.sample_action(params, b[SampleBatch.NEXT_OBS],
                                                     noise["next"])
            q1_t, q2_t = m.q_values(self.target_params, b[SampleBatch.NEXT_OBS], next_action)
            target_q = torch.minimum(q1_t, q2_t) - cfg.initial_alpha * next_logp
            not_done = 1.0 - b[SampleBatch.DONES].float()
            y = b[SampleBatch.REWARDS] + cfg.gamma * not_done * target_q
            # --- OOD actions: uniform, and the current policy's
            pi_a, _ = m.sample_action(params, obs, noise["pi"])  # [N, B, A]
            ood = torch.cat([noise["rand"], pi_a], dim=0)  # [2N, B, A]

        q1, q2 = m.q_values(params, obs, actions)
        bellman = torch.mean((q1 - y) ** 2 + (q2 - y) ** 2)
        q1_ood, q2_ood = m.q_values(params, obs.expand(ood.shape[:2] + obs.shape[1:]), ood)
        cql1 = torch.logsumexp(q1_ood, dim=0) - q1
        cql2 = torch.logsumexp(q2_ood, dim=0) - q2
        penalty = cfg.cql_alpha * torch.mean(cql1 + cql2)
        return bellman + penalty, {
            "bellman": bellman,
            "cql_penalty": penalty,
            "q_mean": torch.mean(q1),
        }

    def _actor_loss(self, params, b, noise):
        obs = b[SampleBatch.OBS]
        action, logp = self.module.sample_action(params, obs, noise["actor"])
        q1, q2 = self.module.q_values(tree_map(torch.Tensor.detach, params), obs, action)
        return torch.mean(self.cfg.initial_alpha * logp - torch.minimum(q1, q2)), None

    def update(self, batch: SampleBatch, noise: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One update; ``noise`` as :meth:`draw_noise` gives it."""
        b = {k: to_tensor(v, self.device) for k, v in batch.items()}
        noise = {k: v.to(self.device) for k, v in noise.items()}
        (closs, cstats), cgrad = value_and_grad(self._critic_loss, self.params, b, noise)
        (aloss, _), agrad = value_and_grad(self._actor_loss, self.params, b, noise)
        with torch.no_grad():
            grads = tree_map(lambda g1, g2: g1 + g2, cgrad, agrad)
            updates, self.opt_state = self.tx.update(grads, self.opt_state, self.params)
            self.params = apply_updates(self.params, updates)
            tau = self.cfg.target_update_tau
            self.target_params = tree_map(lambda t, p: t * (1 - tau) + p * tau,
                                          self.target_params, self.params)
            stats = {k: v.detach() for k, v in cstats.items()}
            stats["actor_loss"] = aloss
        return floats(stats)

    def get_state(self):
        return {
            "params": self.params,
            "target_params": self.target_params,
            "opt_state": self.opt_state,
        }

    def set_state(self, state):
        self.params = to_device(state["params"], self.device)
        self.target_params = to_device(state["target_params"], self.device)
        self.opt_state = to_device(state["opt_state"], self.device)


class CQL(Algorithm):
    def setup(self) -> None:
        cfg: CQLConfig = self.config
        if cfg.offline_data is None:
            raise ValueError("CQLConfig.offline(data) is required")
        env = cfg.env
        if env.discrete:
            raise ValueError("CQL here targets continuous control (SAC backbone)")
        self.module = SACModule(
            env.observation_size,
            env.action_size,
            env.action_low,
            env.action_high,
            cfg.hidden,
        )
        self.learner = _CQLLearner(self.module, cfg, self.device)
        self.data = cfg.offline_data.as_numpy()
        self._rng = np.random.default_rng(cfg.seed)
        self.runners = None

    def training_step(self) -> Dict[str, float]:
        cfg: CQLConfig = self.config
        stats: Dict[str, float] = {}
        cols = (
            SampleBatch.OBS,
            SampleBatch.NEXT_OBS,
            SampleBatch.ACTIONS,
            SampleBatch.REWARDS,
            SampleBatch.DONES,
        )
        for _ in range(cfg.num_updates_per_iter):
            idx = self._rng.integers(0, len(self.data), cfg.train_batch_size)
            batch = SampleBatch({k: self.data[k][idx] for k in cols})
            stats = self.learner.update(batch, self.learner.draw_noise(cfg.train_batch_size))
        return stats

    def get_state(self):
        return {
            "learner": self.learner.get_state(),
            "iteration": self.iteration,
            "total_env_steps": self._total_env_steps,
        }

    def set_state(self, state):
        self.learner.set_state(state["learner"])
        self.iteration = state["iteration"]
        self._total_env_steps = state["total_env_steps"]


CQLConfig.algo_class = CQL
