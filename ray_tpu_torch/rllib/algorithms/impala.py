"""IMPALA and APPO: V-trace off-policy actor-critic.

Parity: ``rllib/algorithms/impala/`` (V-trace corrected actor-critic over
stale behavior policies, Espeholt et al. 2018) and ``rllib/algorithms/appo/``
(APPO = IMPALA with PPO's clipped surrogate on the V-trace advantages).

V-trace is a reverse loop over time-major [T, B] rollouts inside the loss;
the behavior-policy lag that makes V-trace matter comes from
``broadcast_interval`` — env runners keep sampling with a stale weight copy
and only re-sync every N updates (the reference's asynchronous broadcast,
``impala.py`` learner-thread design).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup
from ray_tpu_torch.rllib.learner import Learner, LearnerGroup, to_tensor
from ray_tpu_torch.rllib.rl_module import ActorCriticModule, ContinuousActorCriticModule
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.vtrace_rho_clip = 1.0
        self.vtrace_c_clip = 1.0
        self.entropy_coeff = 0.01
        self.vf_loss_coeff = 0.5
        # runners re-sync weights every N training steps (policy lag source)
        self.broadcast_interval = 1
        self.lr = 5e-4


def vtrace(behavior_logp, target_logp, rewards, values, dones, final_value, gamma, rho_clip, c_clip):
    """V-trace targets/advantages over time-major [T, B] tensors (one reverse
    loop, Espeholt et al. eq. 1).

    Returns (vs, pg_advantages): vs are the corrected value targets; the
    policy gradient uses rho_t * (r_t + gamma*vs_{t+1} - V(x_t)).
    """
    rho = torch.exp(target_logp - behavior_logp)
    clipped_rho = torch.clamp(rho, max=rho_clip)
    clipped_c = torch.clamp(rho, max=c_clip)
    not_done = 1.0 - dones.float()
    next_values = torch.cat([values[1:], final_value[None]], dim=0)
    deltas = clipped_rho * (rewards + gamma * next_values * not_done - values)
    acc = torch.zeros_like(final_value)
    steps = []
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + gamma * not_done[t] * clipped_c[t] * acc
        steps.append(acc)
    vs = torch.stack(steps[::-1]) + values
    next_vs = torch.cat([vs[1:], final_value[None]], dim=0)
    pg_adv = clipped_rho * (rewards + gamma * next_vs * not_done - values)
    return vs, pg_adv


def _impala_loss(module, cfg: "IMPALAConfig", clip_param: float | None = None):
    """Time-major loss with V-trace inside it."""

    def loss_fn(params, batch):
        T, B = batch[SampleBatch.REWARDS].shape
        obs = batch[SampleBatch.OBS]
        flat_obs = obs.reshape((T * B,) + obs.shape[2:])
        actions = batch[SampleBatch.ACTIONS]
        flat_actions = actions.reshape((T * B,) + actions.shape[2:])
        logp_flat, entropy = module.logp_entropy(params, flat_obs, flat_actions)
        target_logp = logp_flat.reshape(T, B)
        values = module.value(params, flat_obs).reshape(T, B)

        vs, pg_adv = vtrace(
            batch[SampleBatch.LOGP],
            target_logp,
            batch[SampleBatch.REWARDS],
            values,
            batch[SampleBatch.DONES],
            batch["final_value"],
            cfg.gamma,
            cfg.vtrace_rho_clip,
            cfg.vtrace_c_clip,
        )
        pg_adv = pg_adv.detach()
        vs = vs.detach()

        if clip_param is None:
            pi_loss = -torch.mean(target_logp * pg_adv)  # IMPALA
        else:
            # APPO: PPO clip on the importance ratio, V-trace advantages
            ratio = torch.exp(target_logp - batch[SampleBatch.LOGP])
            surrogate = torch.minimum(
                ratio * pg_adv, torch.clamp(ratio, 1 - clip_param, 1 + clip_param) * pg_adv
            )
            pi_loss = -torch.mean(surrogate)
        vf_loss = torch.mean((values - vs) ** 2)
        ent = torch.mean(entropy)
        total = pi_loss + cfg.vf_loss_coeff * vf_loss - cfg.entropy_coeff * ent
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss, "entropy": ent}

    return loss_fn


class IMPALA(Algorithm):
    _clip_param: float | None = None

    def setup(self) -> None:
        cfg: IMPALAConfig = self.config
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
                _impala_loss(self.module, cfg, self._clip_param),
                lr=cfg.lr,
                max_grad_norm=cfg.max_grad_norm,
                seed=cfg.seed,
                device=self.device,
            )
        )
        # stale weights the runners act with (broadcast_interval lag); the
        # learner replaces its params at each update, so this tree keeps
        # its values
        self._behavior_params = self.learners.params
        self._steps_since_broadcast = 0

    def training_step(self) -> Dict[str, float]:
        cfg: IMPALAConfig = self.config
        stats: Dict[str, float] = {}
        for batch, final_obs, ep_returns in self.runners.sample(self._behavior_params):
            self._record_episodes(ep_returns, len(batch) * batch[SampleBatch.OBS].shape[1])
            with torch.no_grad():
                final_value = self.module.value(self.learners.params,
                                                to_tensor(final_obs, self.device))
            train_batch = SampleBatch(
                {
                    SampleBatch.OBS: batch[SampleBatch.OBS],
                    SampleBatch.ACTIONS: batch[SampleBatch.ACTIONS],
                    SampleBatch.REWARDS: batch[SampleBatch.REWARDS],
                    SampleBatch.DONES: np.asarray(batch[SampleBatch.DONES])
                    | np.asarray(batch[SampleBatch.TRUNCATEDS]),
                    SampleBatch.LOGP: batch[SampleBatch.LOGP],
                    "final_value": final_value,
                }
            )
            stats = self.learners.update(train_batch)
        self._steps_since_broadcast += 1
        if self._steps_since_broadcast >= cfg.broadcast_interval:
            self._behavior_params = self.learners.params
            self._steps_since_broadcast = 0
        return stats


class APPOConfig(IMPALAConfig):
    def __init__(self):
        super().__init__()
        self.clip_param = 0.2


class APPO(IMPALA):
    @property
    def _clip_param(self):
        return self.config.clip_param


IMPALAConfig.algo_class = IMPALA
APPOConfig.algo_class = APPO
