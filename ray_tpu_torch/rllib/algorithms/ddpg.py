"""DDPG / TD3: deterministic-policy-gradient continuous control.

Parity: `rllib_contrib/ddpg` (deterministic actor + Q critic with target
networks and exploration noise) and `rllib_contrib/td3` (the three TD3
fixes: twin critics with min-target, delayed policy updates, target-policy
smoothing noise). TD3 here IS DDPG with those three knobs on — one learner
covers both, the config chooses.

An update is the critic's TD regression on targets from the target nets,
then (every ``policy_delay``-th update: a Python branch) the actor's ascent
through the frozen critic and the targets' soft update. The JAX package
draws the smoothing noise from a key inside its jitted update; here the
algorithm draws the standard normal from its generator and passes it to
:meth:`_DDPGLearner.update`.
"""

from __future__ import annotations

from typing import Dict

import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup
from ray_tpu_torch.rllib.learner import (
    adam,
    apply_updates,
    floats,
    to_device,
    to_tensor,
    value_and_grad,
)
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.rl_module import DDPGModule, tree_map
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class DDPGConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.critic_lr = 1e-3
        self.buffer_capacity = 50_000
        self.learning_starts = 1000
        self.target_update_tau = 0.005
        self.num_updates_per_iter = 8
        self.train_batch_size = 128
        self.exploration_noise = 0.1
        # TD3 knobs (off => plain DDPG)
        self.twin_q = False
        self.policy_delay = 1
        self.target_noise = 0.0
        self.target_noise_clip = 0.5


class TD3Config(DDPGConfig):
    def __init__(self):
        super().__init__()
        self.twin_q = True
        self.policy_delay = 2
        self.target_noise = 0.2


def _zeros(tree):
    return tree_map(torch.zeros_like, tree)


class _DDPGLearner:
    """Separate actor/critic optimizers over one params tree; one update
    covering both DDPG and TD3 semantics."""

    def __init__(self, module: DDPGModule, cfg: DDPGConfig, device):
        self.module = module
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = module.init(torch.Generator(device=self.device).manual_seed(cfg.seed))
        self.target_params = tree_map(torch.clone, self.params)
        self.actor_tx = adam(cfg.lr)
        self.critic_tx = adam(cfg.critic_lr)
        self.actor_opt_state = self.actor_tx.init(self.params)
        self.critic_opt_state = self.critic_tx.init(self.params)
        self._step = 0

    def update(self, batch: SampleBatch, noise: torch.Tensor) -> Dict[str, float]:
        """One update; ``noise`` is the standard normal draw of the target
        actions' smoothing ([B, A], read only when ``target_noise > 0``)."""
        self._step += 1
        return floats(self._update(batch, noise, self._step % self.cfg.policy_delay == 0))

    def _update(self, batch, noise, do_policy_update: bool) -> Dict[str, torch.Tensor]:
        m, cfg = self.module, self.cfg
        b = {k: to_tensor(v, self.device) for k, v in batch.items()}
        obs, next_obs = b[SampleBatch.OBS], b[SampleBatch.NEXT_OBS]
        with torch.no_grad():
            next_a = m.action(self.target_params, next_obs)
            if cfg.target_noise > 0.0:
                # target-policy smoothing (TD3): noise on the TARGET action,
                # clipped, so the critic can't exploit sharp Q ridges
                span = 0.5 * (m.action_high - m.action_low)
                clip = cfg.target_noise_clip * span
                smooth = torch.clamp(cfg.target_noise * span * noise.to(self.device), -clip, clip)
                next_a = torch.clamp(next_a + smooth, m.action_low, m.action_high)
            tq1, tq2 = m.q_values(self.target_params, next_obs, next_a)
            next_q = torch.minimum(tq1, tq2) if cfg.twin_q else tq1
            not_done = 1.0 - b[SampleBatch.DONES].float()
            target = b[SampleBatch.REWARDS] + cfg.gamma * not_done * next_q

        def critic_loss(p):
            q1, q2 = m.q_values(p, obs, b[SampleBatch.ACTIONS])
            loss = torch.mean((q1 - target) ** 2)
            if cfg.twin_q:
                loss = loss + torch.mean((q2 - target) ** 2)
            return loss, torch.mean(q1).detach()

        (closs, q_mean), cgrads = value_and_grad(critic_loss, self.params)
        with torch.no_grad():
            cgrads = {**cgrads, "pi": _zeros(cgrads["pi"])}
            cupd, self.critic_opt_state = self.critic_tx.update(
                cgrads, self.critic_opt_state, self.params)
            self.params = apply_updates(self.params, cupd)

        def actor_loss(p):
            a = m.action(p, obs)
            q1, _ = m.q_values(tree_map(torch.Tensor.detach, p), obs, a)
            return -torch.mean(q1), None

        aloss = torch.zeros((), device=self.device)
        if do_policy_update:
            (aloss, _), agrads = value_and_grad(actor_loss, self.params)
            with torch.no_grad():
                agrads = {"pi": agrads["pi"], "q1": _zeros(agrads["q1"]),
                          "q2": _zeros(agrads["q2"])}
                aupd, self.actor_opt_state = self.actor_tx.update(
                    agrads, self.actor_opt_state, self.params)
                self.params = apply_updates(self.params, aupd)
                tau = cfg.target_update_tau
                self.target_params = tree_map(lambda t, o: (1 - tau) * t + tau * o,
                                              self.target_params, self.params)
        return {"critic_loss": closs, "actor_loss": aloss, "q_mean": q_mean}

    def get_state(self):
        return {
            "params": self.params,
            "target_params": self.target_params,
            "actor_opt_state": self.actor_opt_state,
            "critic_opt_state": self.critic_opt_state,
            "step": self._step,
        }

    def set_state(self, state):
        self.params = to_device(state["params"], self.device)
        self.target_params = to_device(state["target_params"], self.device)
        self.actor_opt_state = to_device(state["actor_opt_state"], self.device)
        self.critic_opt_state = to_device(state["critic_opt_state"], self.device)
        self._step = state["step"]


class DDPG(Algorithm):
    def setup(self) -> None:
        cfg: DDPGConfig = self.config
        env = cfg.env
        assert not env.discrete, "DDPG/TD3 require a continuous-action env"
        self.module = DDPGModule(
            env.observation_size,
            env.action_size,
            env.action_low,
            env.action_high,
            cfg.hidden,
        )
        self.runners = EnvRunnerGroup(
            env,
            self.module,
            policy="ddpg",
            num_runners=cfg.num_env_runners,
            num_envs_per_runner=cfg.num_envs_per_runner,
            rollout_length=cfg.rollout_length,
            seed=cfg.seed,
            remote=cfg.remote_runners,
            device=self.device,
        )
        self.learners = _DDPGLearner(self.module, cfg, self.device)
        self.buffer = ReplayBuffer(cfg.buffer_capacity, seed=cfg.seed)
        self._generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)

    def training_step(self) -> Dict[str, float]:
        cfg: DDPGConfig = self.config
        extra = {"noise_scale": cfg.exploration_noise}
        for batch, _, ep_returns in self.runners.sample(self.learners.params, extra):
            self._record_episodes(ep_returns, len(batch) * batch[SampleBatch.OBS].shape[1])
            self.buffer.add(SampleBatch({k: v.reshape((-1,) + v.shape[2:])
                                         for k, v in batch.items()}))
        stats: Dict[str, float] = {}
        if len(self.buffer) < cfg.learning_starts:
            return stats
        shape = (cfg.train_batch_size, self.module.action_size)
        for _ in range(cfg.num_updates_per_iter):
            noise = torch.randn(shape, generator=self._generator, device=self.device)
            stats = self.learners.update(self.buffer.sample(cfg.train_batch_size), noise)
        return stats


DDPGConfig.algo_class = DDPG


class TD3(DDPG):
    pass


TD3Config.algo_class = TD3
