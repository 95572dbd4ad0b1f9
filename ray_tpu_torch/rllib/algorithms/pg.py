"""PG / A2C / A3C: the classic policy-gradient family.

Parity: `rllib_contrib/pg` (vanilla REINFORCE on sampled returns),
`rllib_contrib/a2c` (synchronous advantage actor-critic, one SGD pass per
sampled batch), `rllib_contrib/a3c` (asynchronous per-worker gradient
updates), on the same runners and Learner as PPO.

Returns and advantages come from PPO's shared GAE (``lambda=1`` for the
Monte-Carlo PG flavour). A3C's asynchrony is its schedule: each runner
samples with the params as of its turn and its update applies at once, so
later runners in an iteration act on a policy the earlier ones moved.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.ppo import attach_gae_and_flatten
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup
from ray_tpu_torch.rllib.learner import Learner, LearnerGroup
from ray_tpu_torch.rllib.rl_module import ActorCriticModule, ContinuousActorCriticModule
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class PGConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 4e-3


def _pg_loss(module):
    def loss_fn(params, batch):
        logp, _ = module.logp_entropy(
            params, batch[SampleBatch.OBS], batch[SampleBatch.ACTIONS]
        )
        # centered Monte-Carlo returns; no learned baseline (that's A2C)
        ret = batch[SampleBatch.RETURNS]
        ret = ret - ret.mean()
        loss = -torch.mean(logp * ret)
        return loss, {"policy_loss": loss}

    return loss_fn


class _PolicyGradientBase(Algorithm):
    """Shared setup/sampling for the PG family: actor-critic module (PG
    ignores the value head in its loss but still uses it to bootstrap
    truncated rollout tails), GAE-derived targets, flattened [T*B] batches."""

    _gae_lambda = 1.0

    def _make_loss(self):
        raise NotImplementedError

    def setup(self) -> None:
        cfg = self.config
        env = cfg.env
        if env.discrete:
            self.module = ActorCriticModule(env.observation_size, env.num_actions, cfg.hidden)
        else:
            self.module = ContinuousActorCriticModule(
                env.observation_size, env.action_size, cfg.hidden
            )
        self.runners = EnvRunnerGroup(
            env,
            self.module,
            policy="actor_critic",
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
                self._make_loss(),
                lr=cfg.lr,
                max_grad_norm=cfg.max_grad_norm,
                seed=cfg.seed,
                device=self.device,
            )
        )
        self._value_fn = self.module.value

    def _process(self, batch, final_obs, ep_returns) -> SampleBatch:
        """Record metrics and hand off to PPO's shared GAE-attach-and-flatten."""
        self._record_episodes(ep_returns, len(batch) * batch[SampleBatch.OBS].shape[1])
        return attach_gae_and_flatten(
            batch,
            final_obs,
            self._value_fn,
            self.learners.params,
            self.config.gamma,
            self._gae_lambda,
        )

    def _flat_batches(self) -> List[SampleBatch]:
        """Sample all runners synchronously (same params), attach targets."""
        return [
            self._process(batch, final_obs, ep_returns)
            for batch, final_obs, ep_returns in self.runners.sample(self.learners.params)
        ]

    def training_step(self) -> Dict[str, float]:
        # synchronous: one update over the concatenation of all runner batches
        return self.learners.update(SampleBatch.concat_samples(self._flat_batches()))


class PG(_PolicyGradientBase):
    def _make_loss(self):
        return _pg_loss(self.module)


PGConfig.algo_class = PG


class A2CConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.gae_lambda = 1.0
        self.entropy_coeff = 0.01
        self.vf_loss_coeff = 0.5


def _a2c_loss(module, entropy_coeff, vf_loss_coeff):
    def loss_fn(params, batch):
        logp, entropy = module.logp_entropy(
            params, batch[SampleBatch.OBS], batch[SampleBatch.ACTIONS]
        )
        adv = batch[SampleBatch.ADVANTAGES]
        # the population std (ddof 0), as jnp's
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pi_loss = -torch.mean(logp * adv)
        value = module.value(params, batch[SampleBatch.OBS])
        vf_loss = torch.mean((value - batch[SampleBatch.RETURNS]) ** 2)
        ent = torch.mean(entropy)
        total = pi_loss + vf_loss_coeff * vf_loss - entropy_coeff * ent
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss, "entropy": ent}

    return loss_fn


class A2C(_PolicyGradientBase):
    @property
    def _gae_lambda(self):
        return self.config.gae_lambda

    def _make_loss(self):
        cfg: A2CConfig = self.config
        return _a2c_loss(self.module, cfg.entropy_coeff, cfg.vf_loss_coeff)


A2CConfig.algo_class = A2C


class A3CConfig(A2CConfig):
    def __init__(self):
        super().__init__()
        self.num_env_runners = 2


class A3C(A2C):
    """A2C with the asynchronous update schedule: each runner samples with
    the params as of ITS turn and its gradient applies immediately, so later
    runners in an iteration act on a policy already updated by earlier ones
    (the stale-gradient hogwild schedule, without the lock-free races)."""

    def training_step(self) -> Dict[str, float]:
        stats: Dict[str, float] = {}
        for i in range(self.runners.num_runners):
            batch, final_obs, ep_returns = self.runners.sample_one(
                i, self.learners.params
            )
            stats = self.learners.update(self._process(batch, final_obs, ep_returns))
        return stats


A3CConfig.algo_class = A3C
