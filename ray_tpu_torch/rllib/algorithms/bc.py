"""BC: behavior cloning from offline data.

Parity: `rllib/algorithms/bc/` (offline RL entry point — supervised
log-likelihood on recorded (obs, action) pairs; MARWIL with beta=0).
Offline data is any SampleBatch — e.g. recorded by an expert EnvRunner or
loaded from a `ray_tpu_torch.data` dataset or an ``.npz`` file.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.learner import Learner, LearnerGroup
from ray_tpu_torch.rllib.rl_module import ActorCriticModule, ContinuousActorCriticModule
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class BCConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.offline_data: Optional[SampleBatch] = None
        self.num_updates_per_iter = 16
        self.train_batch_size = 256

    def offline(self, data: SampleBatch) -> "BCConfig":
        self.offline_data = data
        return self


def _bc_loss(module):
    def loss_fn(params, batch):
        logp, _ = module.logp_entropy(
            params, batch[SampleBatch.OBS], batch[SampleBatch.ACTIONS]
        )
        loss = -logp.mean()
        return loss, {"neg_logp": loss}

    return loss_fn


class BC(Algorithm):
    def setup(self) -> None:
        cfg: BCConfig = self.config
        if cfg.offline_data is None:
            raise ValueError("BCConfig.offline(data) is required")
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
                _bc_loss(self.module),
                lr=cfg.lr,
                max_grad_norm=cfg.max_grad_norm,
                seed=cfg.seed,
                device=self.device,
            )
        )
        self.data = cfg.offline_data.as_numpy()
        self._rng = np.random.default_rng(cfg.seed)
        self.runners = None

    def training_step(self) -> Dict[str, float]:
        cfg: BCConfig = self.config
        stats: Dict[str, float] = {}
        for _ in range(cfg.num_updates_per_iter):
            idx = self._rng.integers(0, len(self.data), cfg.train_batch_size)
            mb = SampleBatch(
                {
                    k: v[idx]
                    for k, v in self.data.items()
                    if k in (SampleBatch.OBS, SampleBatch.ACTIONS)
                }
            )
            stats = self.learners.update(mb)
        return stats


BCConfig.algo_class = BC
