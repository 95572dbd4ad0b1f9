"""PPO: clipped-surrogate policy gradient with GAE.

Parity: `rllib/algorithms/ppo/` (PPO on the new API stack — EnvRunner
sampling, GAE advantage, clipped surrogate + value loss + entropy bonus,
multi-epoch minibatch SGD). GAE runs on the device as a reverse loop over
the rollout's time steps (the JAX package's reverse ``lax.scan``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup, to_numpy
from ray_tpu_torch.rllib.learner import Learner, LearnerGroup, to_tensor
from ray_tpu_torch.rllib.rl_module import (
    ActorCriticModule,
    ContinuousActorCriticModule,
    tree_leaves,
)
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.clip_param = 0.2
        self.gae_lambda = 0.95
        self.entropy_coeff = 0.01
        self.vf_loss_coeff = 0.5
        self.num_epochs = 4
        self.minibatch_size = 256


def _gae(rewards, values, dones, final_value, gamma, lam):
    """Generalized advantage estimation over time-major [T, B] tensors,
    as a reverse loop. -> (advantages, returns)."""
    next_values = torch.cat([values[1:], final_value[None]], dim=0)
    not_done = 1.0 - dones.float()
    deltas = rewards + gamma * next_values * not_done - values
    advs = torch.empty_like(deltas)
    carry = torch.zeros_like(final_value)
    for t in range(deltas.shape[0] - 1, -1, -1):
        carry = deltas[t] + gamma * lam * not_done[t] * carry
        advs[t] = carry
    return advs, advs + values


def attach_gae_and_flatten(batch, final_obs, value_fn, params, gamma, lam) -> SampleBatch:
    """Attach GAE advantages/returns to one runner's [T, B] rollout and
    flatten it to [T*B] rows. Truncated (time-limit) cuts still have future
    value: fold gamma*V(next_obs) into the reward, then break the GAE chain
    at BOTH kinds of episode end (reference: terminateds/truncateds).
    Shared by PPO and the PG family. The values run on the device of
    ``params``."""
    device = tree_leaves(params)[0].device
    with torch.no_grad():
        final_value = value_fn(params, to_tensor(final_obs, device))
        truncated = to_tensor(batch[SampleBatch.TRUNCATEDS], device)
        next_values = value_fn(params, to_tensor(batch[SampleBatch.NEXT_OBS], device))
        rewards = (
            to_tensor(batch[SampleBatch.REWARDS], device)
            + gamma * truncated.float() * next_values
        )
        advs, returns = _gae(
            rewards,
            to_tensor(batch[SampleBatch.VALUES], device),
            to_tensor(batch[SampleBatch.DONES], device) | truncated,
            final_value,
            gamma,
            lam,
        )
    batch[SampleBatch.ADVANTAGES] = to_numpy(advs)
    batch[SampleBatch.RETURNS] = to_numpy(returns)
    return SampleBatch(
        {k: np.asarray(v).reshape((-1,) + np.shape(v)[2:]) for k, v in batch.items()}
    )


_LOSS_COLUMNS = (SampleBatch.OBS, SampleBatch.ACTIONS, SampleBatch.LOGP,
                 SampleBatch.ADVANTAGES, SampleBatch.RETURNS)


def _ppo_loss(module, clip_param, entropy_coeff, vf_loss_coeff):
    def loss_fn(params, batch):
        logp, entropy = module.logp_entropy(
            params, batch[SampleBatch.OBS], batch[SampleBatch.ACTIONS]
        )
        ratio = torch.exp(logp - batch[SampleBatch.LOGP])
        adv = batch[SampleBatch.ADVANTAGES]
        # the population std (ddof 0), as jnp's
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        surrogate = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1 - clip_param, 1 + clip_param) * adv
        )
        value = module.value(params, batch[SampleBatch.OBS])
        vf_loss = torch.mean((value - batch[SampleBatch.RETURNS]) ** 2)
        pi_loss = -torch.mean(surrogate)
        ent = torch.mean(entropy)
        total = pi_loss + vf_loss_coeff * vf_loss - entropy_coeff * ent
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss, "entropy": ent}

    return loss_fn


class PPO(Algorithm):
    def setup(self) -> None:
        cfg: PPOConfig = self.config
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
                _ppo_loss(self.module, cfg.clip_param, cfg.entropy_coeff, cfg.vf_loss_coeff),
                lr=cfg.lr,
                max_grad_norm=cfg.max_grad_norm,
                seed=cfg.seed,
                device=self.device,
            )
        )
        self._value_fn = self.module.value
        self._rng = np.random.default_rng(cfg.seed)

    def training_step(self) -> Dict[str, float]:
        cfg: PPOConfig = self.config
        flat_batches = []
        for batch, final_obs, ep_returns in self.runners.sample(self.learners.params):
            self._record_episodes(ep_returns, len(batch) * batch[SampleBatch.OBS].shape[1])
            flat_batches.append(
                attach_gae_and_flatten(
                    batch,
                    final_obs,
                    self._value_fn,
                    self.learners.params,
                    cfg.gamma,
                    cfg.gae_lambda,
                )
            )
        # the columns the loss reads: the others would be shuffled and copied
        # to the device with every minibatch for nothing
        train_batch = SampleBatch.concat_samples(
            [SampleBatch({k: b[k] for k in _LOSS_COLUMNS}) for b in flat_batches])
        stats: Dict[str, float] = {}
        for _ in range(cfg.num_epochs):
            for mb in train_batch.minibatches(
                min(cfg.minibatch_size, len(train_batch)), self._rng
            ):
                stats = self.learners.update(mb)
        return stats


PPOConfig.algo_class = PPO
