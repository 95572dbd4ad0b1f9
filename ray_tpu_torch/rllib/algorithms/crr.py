"""CRR: critic-regularized regression for offline continuous control.

Parity: `rllib_contrib/crr` (Wang et al. — advantage-weighted behavior
cloning: maximize log pi(a|s) * f(A(s,a)) on DATASET actions, where
A = Q(s,a) - E_{a'~pi} Q(s,a') and f is the binary indicator 1[A>0] or
exp(A/beta); the critic trains by ordinary TD with policy-sampled next
actions. Unlike plain BC, bad dataset actions get zero (or exponentially
small) weight — the policy imitates only what the critic endorses).

One update is the critic's TD step, then (past the critic's warm-up) the
weighted-BC actor step; the baseline E_{a'~pi}Q takes ``m`` policy samples
batched over a leading sample axis. The draws come in as tensors
(:meth:`CRR.draw_noise`), where the JAX package splits a key inside its
jitted update. Offline only — no env sampling; data arrives as a
SampleBatch like BC/MARWIL/CQL.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.ddpg import _zeros
from ray_tpu_torch.rllib.algorithms.dqn import _soft_update
from ray_tpu_torch.rllib.learner import (
    adam,
    apply_updates,
    floats,
    to_device,
    to_tensor,
    value_and_grad,
)
from ray_tpu_torch.rllib.rl_module import SACModule, _mlp_apply, tree_map
from ray_tpu_torch.rllib.sample_batch import SampleBatch


def _tanh_gauss_log_prob(module: SACModule, params, obs, action):
    """log pi(action|obs) for the tanh-squashed gaussian policy — the
    inverse of SACModule.sample_action's squash + affine scale."""
    lo, hi = module.action_low, module.action_high
    span = 0.5 * (hi - lo)
    tanh_a = torch.clamp((action - lo) / (hi - lo) * 2.0 - 1.0, -0.999999, 0.999999)
    # cap the inverse: a dataset action AT the bound has atanh -> inf, and a
    # handful of such rows would otherwise dominate the weighted-BC mean and
    # saturate the policy (raw |3| already maps to tanh 0.995)
    raw = torch.clamp(torch.atanh(tanh_a), -3.0, 3.0)
    out = _mlp_apply(params["pi"], obs)
    mean, log_std = torch.chunk(out, 2, dim=-1)
    log_std = torch.clamp(log_std, -10.0, 2.0)
    std = torch.exp(log_std)
    logp = torch.sum(
        -0.5 * ((raw - mean) ** 2 / std**2 + 2 * log_std + math.log(2 * math.pi)),
        dim=-1,
    )
    return logp - torch.sum(torch.log((1 - tanh_a**2) * span + 1e-6), dim=-1)


class CRRConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.critic_lr = 1e-3
        self.target_update_tau = 0.005
        self.train_batch_size = 256
        self.updates_per_iter = 50
        # critic-only updates before the actor starts: an underfit critic's
        # slope would launch the policy toward a bound it can't return from
        # (weights go ~0 there, so the BC gradient vanishes)
        self.critic_warmup_updates = 400
        self.advantage_samples = 4  # m policy samples for the baseline
        self.weight_fn = "bin"  # "bin" (1[A>0]) | "exp" (exp(A/beta), capped)
        self.beta = 1.0
        self.weight_cap = 20.0

    def offline_data(self, batch: SampleBatch) -> "CRRConfig":
        self.offline_batch = batch
        return self


class CRR(Algorithm):
    def setup(self) -> None:
        cfg: CRRConfig = self.config
        env = cfg.env
        assert not env.discrete, "this CRR implementation is continuous-action"
        assert getattr(cfg, "offline_batch", None) is not None, (
            "CRRConfig.offline_data(batch) is required (offline algorithm)"
        )
        self.module = SACModule(
            env.observation_size,
            env.action_size,
            env.action_low,
            env.action_high,
            cfg.hidden,
        )
        self.params = self.module.init(torch.Generator(device=self.device).manual_seed(cfg.seed))
        self.target_params = tree_map(torch.clone, self.params)
        self.actor_tx = adam(cfg.lr)
        self.critic_tx = adam(cfg.critic_lr)
        self.actor_opt = self.actor_tx.init(self.params)
        self.critic_opt = self.critic_tx.init(self.params)
        self._generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self._data = {k: np.asarray(v) for k, v in cfg.offline_batch.as_numpy().items()}
        # offline columns may be [T, B, ...]: flatten to rows
        if self._data[SampleBatch.ACTIONS].ndim == 3 or (
            self._data[SampleBatch.REWARDS].ndim == 2
        ):
            self._data = {k: v.reshape((-1,) + v.shape[2:]) for k, v in self._data.items()}
        self._rng = np.random.default_rng(cfg.seed)
        self._updates = 0

    def draw_noise(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """An update's standard normal draws: the next-state actions'
        ("next", [B, A]) and the baseline's policy samples ("adv",
        [m, B, A])."""
        shape = (batch_size, self.module.action_size)
        g = self._generator
        return {"next": torch.randn(shape, generator=g, device=self.device),
                "adv": torch.randn((self.config.advantage_samples,) + shape, generator=g,
                                   device=self.device)}

    def _update(self, batch, noise, do_actor: bool) -> Dict[str, torch.Tensor]:
        """One update from a batch of tensors and :meth:`draw_noise`'s draws."""
        cfg: CRRConfig = self.config
        m = self.module
        obs, act = batch[SampleBatch.OBS], batch[SampleBatch.ACTIONS]
        rew = batch[SampleBatch.REWARDS]
        done = batch[SampleBatch.DONES].float()
        next_obs = batch[SampleBatch.NEXT_OBS]

        # -- critic: TD with policy-sampled next actions --------------------
        with torch.no_grad():
            next_a, _ = m.sample_action(self.params, next_obs, noise["next"])
            tq1, tq2 = m.q_values(self.target_params, next_obs, next_a)
            target = rew + cfg.gamma * (1.0 - done) * torch.minimum(tq1, tq2)

        def critic_loss(p):
            q1, q2 = m.q_values(p, obs, act)
            return torch.mean((q1 - target) ** 2) + torch.mean((q2 - target) ** 2), None

        (closs, _), cgrads = value_and_grad(critic_loss, self.params)
        with torch.no_grad():
            cgrads = {**cgrads, "pi": _zeros(cgrads["pi"])}
            cupd, self.critic_opt = self.critic_tx.update(cgrads, self.critic_opt, self.params)
            self.params = apply_updates(self.params, cupd)

        if not do_actor:
            # the target must track the critic during warmup too, or
            # every warmup TD step bootstraps off the frozen random init
            self.target_params = _soft_update(self.target_params, self.params,
                                              cfg.target_update_tau)
            zero = torch.zeros((), device=obs.device)
            return {"critic_loss": closs, "actor_loss": zero, "weight_mean": zero,
                    "advantage_mean": zero}

        # -- advantage of the DATASET action vs the policy baseline --------
        with torch.no_grad():
            n = noise["adv"].shape[0]
            obs_m = obs.expand((n,) + obs.shape)
            a_s, _ = m.sample_action(self.params, obs_m, noise["adv"])  # [m, B, A]
            bq1, bq2 = m.q_values(self.params, obs_m, a_s)
            q1d, q2d = m.q_values(self.params, obs, act)
            adv = torch.minimum(q1d, q2d) - torch.minimum(bq1, bq2).mean(dim=0)
            if cfg.weight_fn == "bin":
                w = (adv > 0).float()
            else:
                w = torch.clamp(torch.exp(adv / cfg.beta), max=cfg.weight_cap)

        # -- actor: advantage-weighted BC on dataset actions ---------------
        def actor_loss(p):
            return -torch.mean(w * _tanh_gauss_log_prob(m, p, obs, act)), None

        (aloss, _), agrads = value_and_grad(actor_loss, self.params)
        with torch.no_grad():
            agrads = {"pi": agrads["pi"], "q1": _zeros(agrads["q1"]), "q2": _zeros(agrads["q2"])}
            aupd, self.actor_opt = self.actor_tx.update(agrads, self.actor_opt, self.params)
            self.params = apply_updates(self.params, aupd)
            self.target_params = _soft_update(self.target_params, self.params,
                                              cfg.target_update_tau)
        return {"critic_loss": closs, "actor_loss": aloss, "weight_mean": torch.mean(w),
                "advantage_mean": torch.mean(adv)}

    def training_step(self) -> Dict[str, float]:
        cfg: CRRConfig = self.config
        n = len(self._data[SampleBatch.REWARDS])
        stats: Dict[str, torch.Tensor] = {}
        for _ in range(cfg.updates_per_iter):
            idx = self._rng.integers(0, n, cfg.train_batch_size)
            batch = {k: to_tensor(v[idx], self.device) for k, v in self._data.items()}
            stats = self._update(batch, self.draw_noise(cfg.train_batch_size),
                                 do_actor=self._updates >= cfg.critic_warmup_updates)
            self._updates += 1
        # one device->host sync for the LAST update's stats, not one per step
        return floats(stats)

    def evaluate(self, num_episodes: int = 10) -> Dict[str, float]:
        """Deterministic tanh(mean) policy over fresh env episodes."""
        cfg: CRRConfig = self.config
        env = cfg.env
        g = torch.Generator(device=self.device).manual_seed(cfg.seed + 10_000)
        returns = []
        with torch.no_grad():
            for _ in range(num_episodes):
                state, obs = env.reset(g, 1, self.device)
                ret, done, steps = 0.0, False, 0
                while not done and steps < env.max_episode_steps:
                    a = self.module.inference_action(self.params, obs)
                    state, obs, r, term, trunc = env.step(state, a)
                    ret += float(r[0])
                    done = bool(term[0]) or bool(trunc[0])
                    steps += 1
                returns.append(ret)
        return {
            "evaluation": {
                "episode_return_mean": float(np.mean(returns)),
                "episode_return_min": float(np.min(returns)),
                "episode_return_max": float(np.max(returns)),
                "num_episodes": num_episodes,
            }
        }

    def get_state(self):
        return {
            "params": self.params,
            "target_params": self.target_params,
            "actor_opt": self.actor_opt,
            "critic_opt": self.critic_opt,
            "updates": self._updates,
            "iteration": self.iteration,
            "total_env_steps": self._total_env_steps,
        }

    def set_state(self, state) -> None:
        state = to_device(state, self.device)
        self.params = state["params"]
        self.target_params = state["target_params"]
        self.actor_opt = state["actor_opt"]
        self.critic_opt = state["critic_opt"]
        self._updates = state.get("updates", self.config.critic_warmup_updates)
        self.iteration = state["iteration"]
        self._total_env_steps = state["total_env_steps"]

    def stop(self) -> None:
        pass


CRRConfig.algo_class = CRR
