"""SAC: soft actor-critic for continuous control.

Parity: `rllib/algorithms/sac/` — tanh-gaussian actor, twin Q critics with
target networks, entropy-regularized targets with a learned temperature
alpha tuned toward -|A| target entropy.

The JAX package draws an update's two action noises from a key inside its
jitted update; here the algorithm draws them from its generator and passes
them to :meth:`_SACLearner.update` as one ``[2, B, A]`` tensor (next-state
actions, then policy actions).
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
from ray_tpu_torch.rllib.rl_module import SACModule, tree_map
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.buffer_capacity = 50_000
        self.learning_starts = 1000
        self.target_update_tau = 0.005
        self.num_updates_per_iter = 8
        self.train_batch_size = 128
        self.initial_alpha = 0.1
        self.learn_alpha = True


class _SACLearner:
    """SAC needs three interleaved optimizers (critic, actor, alpha), so it
    owns its update rather than reusing the single-loss Learner."""

    def __init__(self, module: SACModule, cfg: SACConfig, device):
        self.module = module
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = module.init(torch.Generator(device=self.device).manual_seed(cfg.seed))
        self.target_params = tree_map(torch.clone, self.params)
        self.log_alpha = torch.log(torch.tensor(cfg.initial_alpha, device=self.device))
        self.tx = adam(cfg.lr)
        self.opt_state = self.tx.init(self.params)
        self.alpha_tx = adam(cfg.lr)
        self.alpha_opt_state = self.alpha_tx.init(self.log_alpha)
        self.target_entropy = -float(module.action_size)

    def update(self, batch: SampleBatch, noise: torch.Tensor) -> Dict[str, float]:
        """One update; ``noise[0]`` and ``noise[1]`` are the standard normal
        draws of the next-state and the policy actions ([B, A] each)."""
        m, cfg = self.module, self.cfg
        b = {k: to_tensor(v, self.device) for k, v in batch.items()}
        noise = noise.to(self.device)
        alpha = torch.exp(self.log_alpha)
        with torch.no_grad():
            next_a, next_logp = m.sample_action(self.params, b[SampleBatch.NEXT_OBS], noise[0])
            tq1, tq2 = m.q_values(self.target_params, b[SampleBatch.NEXT_OBS], next_a)
            next_v = torch.minimum(tq1, tq2) - alpha * next_logp
            not_done = 1.0 - b[SampleBatch.DONES].float()
            target = b[SampleBatch.REWARDS] + cfg.gamma * not_done * next_v

        def critic_loss(p):
            q1, q2 = m.q_values(p, b[SampleBatch.OBS], b[SampleBatch.ACTIONS])
            return torch.mean((q1 - target) ** 2) + torch.mean((q2 - target) ** 2), None

        def actor_loss(p):
            a, logp = m.sample_action(p, b[SampleBatch.OBS], noise[1])
            # critic params frozen for the actor step
            q1, q2 = m.q_values(tree_map(torch.Tensor.detach, p), b[SampleBatch.OBS], a)
            return torch.mean(alpha * logp - torch.minimum(q1, q2)), torch.mean(logp).detach()

        (closs, _), cgrads = value_and_grad(critic_loss, self.params)
        (aloss, mean_logp), agrads = value_and_grad(actor_loss, self.params)
        with torch.no_grad():
            # critic step uses q grads, actor step uses pi grads
            grads = {"pi": agrads["pi"], "q1": cgrads["q1"], "q2": cgrads["q2"]}
            updates, self.opt_state = self.tx.update(grads, self.opt_state, self.params)
            self.params = apply_updates(self.params, updates)
            if cfg.learn_alpha:
                # d/d log_alpha of -exp(log_alpha) * (mean_logp + target_entropy)
                agrad = -torch.exp(self.log_alpha) * (mean_logp + self.target_entropy)
                aupd, self.alpha_opt_state = self.alpha_tx.update(
                    agrad, self.alpha_opt_state, self.log_alpha)
                self.log_alpha = self.log_alpha + aupd
            tau = cfg.target_update_tau
            self.target_params = tree_map(lambda t, o: (1 - tau) * t + tau * o,
                                          self.target_params, self.params)
            stats = {
                "critic_loss": closs,
                "actor_loss": aloss,
                "alpha": torch.exp(self.log_alpha),
                "mean_logp": mean_logp,
            }
        return floats(stats)

    def get_state(self):
        return {
            "params": self.params,
            "target_params": self.target_params,
            "log_alpha": self.log_alpha,
            "opt_state": self.opt_state,
            "alpha_opt_state": self.alpha_opt_state,
        }

    def set_state(self, state):
        for k, v in state.items():
            setattr(self, k, to_device(v, self.device))


class SAC(Algorithm):
    def setup(self) -> None:
        cfg: SACConfig = self.config
        env = cfg.env
        assert not env.discrete, "SAC requires a continuous-action env"
        self.module = SACModule(
            env.observation_size,
            env.action_size,
            env.action_low,
            env.action_high,
            cfg.hidden,
        )
        self.runners = EnvRunnerGroup(
            env,
            self.module,
            policy="sac",
            num_runners=cfg.num_env_runners,
            num_envs_per_runner=cfg.num_envs_per_runner,
            rollout_length=cfg.rollout_length,
            seed=cfg.seed,
            remote=cfg.remote_runners,
            device=self.device,
        )
        self.learners = _SACLearner(self.module, cfg, self.device)
        self.buffer = ReplayBuffer(cfg.buffer_capacity, seed=cfg.seed)
        self._generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)

    def training_step(self) -> Dict[str, float]:
        cfg: SACConfig = self.config
        for batch, _, ep_returns in self.runners.sample(self.learners.params):
            self._record_episodes(ep_returns, len(batch) * batch[SampleBatch.OBS].shape[1])
            flat = SampleBatch(
                {
                    k: v.reshape((-1,) + v.shape[2:])
                    for k, v in batch.items()
                    if k != SampleBatch.LOGP
                }
            )
            self.buffer.add(flat)
        stats: Dict[str, float] = {}
        if len(self.buffer) < cfg.learning_starts:
            return stats
        shape = (2, cfg.train_batch_size, self.module.action_size)
        for _ in range(cfg.num_updates_per_iter):
            noise = torch.randn(shape, generator=self._generator, device=self.device)
            stats = self.learners.update(self.buffer.sample(cfg.train_batch_size), noise)
        return stats


SACConfig.algo_class = SAC
