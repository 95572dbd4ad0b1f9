"""MARWIL: monotonic advantage re-weighted imitation learning.

Parity: ``rllib/algorithms/marwil/`` — offline imitation where each
(obs, action) pair's log-likelihood is weighted by
``exp(beta * normalized_advantage)``; advantages come from monte-carlo
returns minus a jointly-trained value baseline. ``beta = 0`` reduces to BC
(the reference implements BC as MARWIL(beta=0) the same way).

Offline data must carry OBS, ACTIONS and RETURNS columns (see
``ray_tpu_torch.rllib.offline`` for recording/loading).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.learner import Learner, LearnerGroup
from ray_tpu_torch.rllib.rl_module import ActorCriticModule, ContinuousActorCriticModule
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class MARWILConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.offline_data: Optional[SampleBatch] = None
        self.beta = 1.0
        self.vf_coeff = 1.0
        # running normalizer for advantage scale (reference: moving avg of
        # squared advantages, marwil_tf_policy.py ws update)
        self.moving_average_sqd_adv_norm_update_rate = 1e-3
        self.num_updates_per_iter = 16
        self.train_batch_size = 256

    def offline(self, data: SampleBatch) -> "MARWILConfig":
        self.offline_data = data
        return self


def _marwil_loss(module, beta: float, vf_coeff: float):
    def loss_fn(params, batch):
        obs = batch[SampleBatch.OBS]
        logp, _ = module.logp_entropy(params, obs, batch[SampleBatch.ACTIONS])
        values = module.value(params, obs)
        adv = batch[SampleBatch.RETURNS] - values
        vf_loss = torch.mean(adv**2)
        # normalize advantage scale with the running estimate fed in as a
        # batch aux (updated host-side between steps)
        norm = torch.sqrt(batch["adv_sqd_norm"]) + 1e-8
        weights = torch.exp(beta * adv.detach() / norm) if beta else torch.ones_like(logp)
        weights = torch.clamp(weights, max=20.0)  # explosion guard (reference clips too)
        pi_loss = -torch.mean(weights * logp)
        total = pi_loss + vf_coeff * vf_loss
        return total, {
            "policy_loss": pi_loss,
            "vf_loss": vf_loss,
            "mean_adv": torch.mean(adv),
        }

    return loss_fn


class MARWIL(Algorithm):
    def setup(self) -> None:
        cfg: MARWILConfig = self.config
        if cfg.offline_data is None:
            raise ValueError("MARWILConfig.offline(data) is required")
        env = cfg.env
        if env.discrete:
            self.module = ActorCriticModule(env.observation_size, env.num_actions, cfg.hidden)
        else:
            self.module = ContinuousActorCriticModule(
                env.observation_size, env.action_size, cfg.hidden
            )
        self.learners = LearnerGroup(
            Learner(
                self.module,
                _marwil_loss(self.module, cfg.beta, cfg.vf_coeff),
                lr=cfg.lr,
                max_grad_norm=cfg.max_grad_norm,
                seed=cfg.seed,
                device=self.device,
            )
        )
        self.data = cfg.offline_data.as_numpy()
        if SampleBatch.RETURNS not in self.data:
            raise ValueError("MARWIL offline data needs a RETURNS column (monte-carlo returns)")
        self._rng = np.random.default_rng(cfg.seed)
        self._adv_sqd_norm = 1.0
        self.runners = None

    def training_step(self) -> Dict[str, float]:
        cfg: MARWILConfig = self.config
        stats: Dict[str, float] = {}
        cols = (SampleBatch.OBS, SampleBatch.ACTIONS, SampleBatch.RETURNS)
        for _ in range(cfg.num_updates_per_iter):
            idx = self._rng.integers(0, len(self.data), cfg.train_batch_size)
            mb = SampleBatch({k: self.data[k][idx] for k in cols})
            mb["adv_sqd_norm"] = np.float32(self._adv_sqd_norm)
            stats = self.learners.update(mb)
            # update the running squared-advantage norm from the report
            rate = cfg.moving_average_sqd_adv_norm_update_rate
            self._adv_sqd_norm += rate * (
                float(stats.get("vf_loss", self._adv_sqd_norm)) - self._adv_sqd_norm
            )
        return stats


MARWILConfig.algo_class = MARWIL
