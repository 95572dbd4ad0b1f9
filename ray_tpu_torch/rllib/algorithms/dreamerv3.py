"""DreamerV3: model-based RL via imagination in a learned world model.

Parity: ``rllib/algorithms/dreamerv3/`` (the reference's TF implementation
of Hafner et al. 2023), as the JAX package's compact rebuild keeps it:

* RSSM world model — deterministic GRU path + categorical stochastic
  latents with straight-through gradients and 1% unimix,
* symlog predictions with two-hot discretized reward/critic heads,
* KL balancing with free bits (dyn 0.5 / rep 0.1),
* actor/critic trained purely on imagined rollouts from replayed
  posterior states; lambda-returns bootstrapped from a slow EMA critic;
  returns normalized by an EMA of their 5th-95th percentile range.

Collection, the posterior pass, imagination and the lambda-returns are
loops over time of tensor operations on the device (the JAX package scans
each as one XLA program); the replay buffer holds fixed-length sequence
chunks on the host. Every categorical draw is ``argmax(logits + gumbel)``,
as ``jax.random.categorical`` draws it, and the Gumbel noise comes in as
tensors (:meth:`DreamerV3.draw_noise`), drawn from the algorithm's
generator where the JAX package splits a key. The GRU is the JAX
package's cell: ``n = tanh(r * n)`` over the whole candidate
pre-activation, ``h' = (1 - z) * n + z * h``.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env_runner import _tree_where, to_numpy
from ray_tpu_torch.rllib.learner import (
    adam,
    apply_updates,
    floats,
    to_device,
    to_tensor,
    value_and_grad,
)
from ray_tpu_torch.rllib.rl_module import _gumbel, gather_last, tree_map

# ---------------------------------------------------------------- symlog
NUM_BINS = 63


def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def _linspace_bins() -> torch.Tensor:
    # jnp.linspace's form, start * (1 - s) + stop * s (its float32 values
    # may differ from these by an ulp)
    s = torch.arange(NUM_BINS - 1, dtype=torch.float32) / (NUM_BINS - 1)
    return torch.cat([-10.0 * (1 - s) + 10.0 * s, torch.tensor([10.0])])


_BINS = symexp(_linspace_bins())
_BINS_ON: Dict[str, torch.Tensor] = {}


def _bins(device) -> torch.Tensor:
    key = str(device)
    if key not in _BINS_ON:
        _BINS_ON[key] = _BINS.to(device)
    return _BINS_ON[key]


def twohot(x):
    """Encode scalars as two-hot weights over the symexp bin atoms."""
    bins = _bins(x.device)
    x = torch.clamp(x, bins[0], bins[-1])
    idx_hi = torch.clamp(torch.searchsorted(bins, x.contiguous()), 1, NUM_BINS - 1)
    idx_lo = idx_hi - 1
    lo, hi = bins[idx_lo], bins[idx_hi]
    w_hi = (x - lo) / torch.clamp(hi - lo, min=1e-8)
    oh_lo = F.one_hot(idx_lo, NUM_BINS).to(x.dtype) * (1.0 - w_hi)[..., None]
    oh_hi = F.one_hot(idx_hi, NUM_BINS).to(x.dtype) * w_hi[..., None]
    return oh_lo + oh_hi


def twohot_mean(logits):
    """Expected scalar under a two-hot categorical head."""
    return torch.sum(torch.softmax(logits, -1) * _bins(logits.device), -1)


# ---------------------------------------------------------------- modules
def _mlp_init(generator: torch.Generator, sizes, out_scale=1.0):
    layers = []
    device = generator.device
    for i in range(len(sizes) - 1):
        scale = out_scale if i == len(sizes) - 2 else 1.0
        w = torch.randn((sizes[i], sizes[i + 1]), generator=generator, device=device)
        layers.append({"w": w * scale / math.sqrt(sizes[i]),
                       "b": torch.zeros((sizes[i + 1],), device=device)})
    return layers


def _mlp(layers, x, act=F.silu):
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1:
            x = act(x)
    return x


def _gru_init(generator: torch.Generator, in_size, size):
    device = generator.device
    return {
        "wi": torch.randn((in_size, 3 * size), generator=generator, device=device)
        / math.sqrt(in_size),
        "wh": torch.randn((size, 3 * size), generator=generator, device=device) / math.sqrt(size),
        "b": torch.zeros((3 * size,), device=device),
    }


def _gru(p, h, x):
    gates = x @ p["wi"] + h @ p["wh"] + p["b"]
    r, z, n = torch.chunk(gates, 3, dim=-1)
    r, z = torch.sigmoid(r), torch.sigmoid(z)
    n = torch.tanh(r * n)
    return (1.0 - z) * n + z * h


class DreamerV3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.deter_size = 256
        self.latent_cats = 16       # number of categorical variables
        self.latent_classes = 16    # classes per variable
        self.units = 256
        self.seq_len = 16           # replayed training sequence length
        self.batch_size_seqs = 16
        self.horizon = 15           # imagination length
        self.replay_capacity = 500  # chunks
        self.world_lr = 4e-4
        self.ac_lr = 1e-4
        self.gamma = 0.997
        self.lam = 0.95
        self.entropy_coeff = 3e-4
        self.unimix = 0.01
        self.free_bits = 1.0
        self.kl_dyn = 0.5
        self.kl_rep = 0.1
        self.critic_ema = 0.98
        self.retnorm_ema = 0.99
        self.updates_per_iter = 4
        self.num_envs = 8


class DreamerV3(Algorithm):
    def setup(self) -> None:
        cfg = self.config
        env = cfg.env
        assert env.discrete, "this DreamerV3 build supports discrete actions"
        self.env = env
        self._generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._z_dim = cfg.latent_cats * cfg.latent_classes
        self._feat_dim = cfg.deter_size + self._z_dim
        self._wm_opt = adam(cfg.world_lr)
        self._ac_opt = adam(cfg.ac_lr)
        self.state = self._init_params(self._generator)
        self._replay: list = []
        self._env_state = None

    # ------------------------------------------------------------- params
    def _init_params(self, g: torch.Generator):
        cfg = self.config
        obs, acts = self.env.observation_size, self.env.num_actions
        U, D, Z = cfg.units, cfg.deter_size, self._z_dim
        wm = {
            "encoder": _mlp_init(g, (obs, U, U)),
            "gru_in": _mlp_init(g, (Z + acts, U)),
            "gru": _gru_init(g, U, D),
            "prior": _mlp_init(g, (D, U, Z)),
            "post": _mlp_init(g, (D + U, U, Z)),
            "decoder": _mlp_init(g, (D + Z, U, obs)),
            "reward": _mlp_init(g, (D + Z, U, NUM_BINS), out_scale=0.0),
            "cont": _mlp_init(g, (D + Z, U, 1)),
        }
        actor = _mlp_init(g, (self._feat_dim, U, acts), out_scale=0.01)
        critic = _mlp_init(g, (self._feat_dim, U, NUM_BINS), out_scale=0.0)
        return {
            "wm": wm,
            "actor": actor,
            "critic": critic,
            "critic_slow": tree_map(torch.clone, critic),
            "wm_opt": self._wm_opt.init(wm),
            "actor_opt": self._ac_opt.init(actor),
            "critic_opt": self._ac_opt.init(critic),
            "ret_scale": torch.ones((), device=self.device),
        }

    # -------------------------------------------------------- latent utils
    def _logits_to_probs(self, logits):
        cfg = self.config
        shaped = logits.reshape(logits.shape[:-1] + (cfg.latent_cats, cfg.latent_classes))
        probs = torch.softmax(shaped, -1)
        return (1.0 - cfg.unimix) * probs + cfg.unimix / cfg.latent_classes

    def _sample_latent(self, gumbel, logits):
        """Straight-through categorical sample, flattened to [.., Z];
        ``gumbel`` is Gumbel noise shaped [.., cats, classes]."""
        probs = self._logits_to_probs(logits)
        idx = torch.argmax(torch.log(probs) + gumbel, dim=-1)
        oh = F.one_hot(idx, self.config.latent_classes).to(probs.dtype)
        sample = oh + probs - probs.detach()
        return sample.reshape(sample.shape[:-2] + (self._z_dim,))

    def _kl(self, post_logits, prior_logits):
        p = self._logits_to_probs(post_logits)
        q = self._logits_to_probs(prior_logits)
        kl = torch.sum(p * (torch.log(p) - torch.log(q)), -1)  # [.., cats]
        return torch.sum(kl, -1)  # nats per step

    def draw_noise(self, T: int, B: int, generator=None) -> Dict[str, torch.Tensor]:
        """An update's Gumbel draws for a [T, B] batch: the posterior pass's
        latents ("obs_z"), and imagination's actions ("im_a") and latents
        ("im_z") from its T * B starts."""
        cfg = self.config
        g = generator or self._generator
        lat = (cfg.latent_cats, cfg.latent_classes)
        n = T * B
        return {"obs_z": _gumbel(g, (T, B) + lat, g.device),
                "im_a": _gumbel(g, (cfg.horizon, n, self.env.num_actions), g.device),
                "im_z": _gumbel(g, (cfg.horizon, n) + lat, g.device)}

    # --------------------------------------------------------- collection
    def _policy_step(self, wm, actor, h, obs, gz, ga):
        acts = self.env.num_actions
        embed = _mlp(wm["encoder"], symlog(obs))
        post_logits = _mlp(wm["post"], torch.cat([h, embed], -1))
        z = self._sample_latent(gz, post_logits)
        feat = torch.cat([h, z], -1)
        action = torch.argmax(_mlp(actor, feat) + ga, dim=-1)
        # advance deterministic state with (z, action)
        gin = _mlp(wm["gru_in"], torch.cat([z, F.one_hot(action, acts).to(z.dtype)], -1))
        return _gru(wm["gru"], h, gin), z, action

    def _collect(self):
        """``seq_len`` env steps of every env with the current policy; ->
        (the chunk's columns [T, E, ...] on the host, completed returns)."""
        cfg, env, g = self.config, self.env, self._generator
        wm, actor = self.state["wm"], self.state["actor"]
        E, lat = cfg.num_envs, (cfg.latent_cats, cfg.latent_classes)
        env_state, obs, h, z, ep_ret = (self._env_state, self._obs, self._h, self._z,
                                        self._ep_ret)
        recs: Dict[str, list] = {}
        with torch.no_grad():
            for _ in range(cfg.seq_len):
                gz = _gumbel(g, (E,) + lat, self.device)
                ga = _gumbel(g, (E, env.num_actions), self.device)
                h2, z2, action = self._policy_step(wm, actor, h, obs, gz, ga)
                env_state2, next_obs, reward, term, trunc = env.step(env_state, action)
                done = term | trunc
                ep2 = ep_ret + reward
                rec = {"obs": obs, "action": action, "reward": reward,
                       "cont": 1.0 - term.float(), "reset": done,
                       "_completed": torch.where(done, ep2, torch.nan)}
                for k, v in rec.items():
                    recs.setdefault(k, []).append(v)
                rs, ro = env.reset(g, E, self.device)
                env_state = _tree_where(done, rs, env_state2)
                obs = torch.where(done[:, None], ro, next_obs)
                # recurrent state resets with the episode
                h = torch.where(done[:, None], torch.zeros_like(h2), h2)
                z = torch.where(done[:, None], torch.zeros_like(z2), z2)
                ep_ret = torch.where(done, 0.0, ep2)
        self._env_state, self._obs, self._h, self._z, self._ep_ret = (env_state, obs, h, z,
                                                                      ep_ret)
        traj = {k: to_numpy(torch.stack(v)) for k, v in recs.items()}
        return traj, traj.pop("_completed")

    # ------------------------------------------------------------- update
    def _observe(self, wm, batch, gz):
        """Posterior pass over a [T, B, ...] chunk; -> (the world-model loss,
        (feats [T, B, F], stats)). ``gz`` [T, B, cats, classes] is its Gumbel
        noise."""
        cfg = self.config
        T, B = batch["action"].shape
        embed = _mlp(wm["encoder"], symlog(batch["obs"]))  # every step's at once
        act_oh = F.one_hot(batch["action"], self.env.num_actions).float()
        h = torch.zeros((B, cfg.deter_size), device=embed.device)
        feats, priors, posts = [], [], []
        for t in range(T):
            # reset recurrent state at episode starts recorded in replay
            h = torch.where(batch["reset_prev"][t][:, None], torch.zeros_like(h), h)
            prior_logits = _mlp(wm["prior"], h)
            post_logits = _mlp(wm["post"], torch.cat([h, embed[t]], -1))
            z = self._sample_latent(gz[t], post_logits)
            feats.append(torch.cat([h, z], -1))
            priors.append(prior_logits)
            posts.append(post_logits)
            gin = _mlp(wm["gru_in"], torch.cat([z, act_oh[t]], -1))
            h = _gru(wm["gru"], h, gin)
        feats, priors, posts = torch.stack(feats), torch.stack(priors), torch.stack(posts)
        # heads
        recon = _mlp(wm["decoder"], feats)
        rew_logits = _mlp(wm["reward"], feats)
        cont_logit = _mlp(wm["cont"], feats)[..., 0]
        recon_loss = torch.mean(torch.sum((recon - symlog(batch["obs"])) ** 2, -1))
        rew_loss = -torch.mean(torch.sum(
            twohot(symlog(batch["reward"])) * torch.log_softmax(rew_logits, -1), -1))
        cont_loss = torch.mean(
            torch.clamp(cont_logit, min=0) - cont_logit * batch["cont"]
            + torch.log1p(torch.exp(-torch.abs(cont_logit)))
        )
        kl_dyn = self._kl(posts.detach(), priors)
        kl_rep = self._kl(posts, priors.detach())
        kl_loss = (cfg.kl_dyn * torch.mean(torch.clamp(kl_dyn, min=cfg.free_bits))
                   + cfg.kl_rep * torch.mean(torch.clamp(kl_rep, min=cfg.free_bits)))
        loss = recon_loss + rew_loss + cont_loss + kl_loss
        return loss, (feats, {"recon": recon_loss.detach(), "reward": rew_loss.detach(),
                              "kl": kl_loss.detach()})

    def _observe_loss(self, wm, gz, batch) -> torch.Tensor:
        """The world-model loss on a fixed batch (tests, diagnostics): the
        same data and noise before and after training isolates learning
        from replay drift."""
        with torch.no_grad():
            return self._observe(wm, self._tensors(batch), gz.to(self.device))[0]

    def _imagine(self, wm, actor, feats0, ga, gz):
        """Actor rollout in latent space from [N, F] starting features."""
        cfg = self.config
        acts = self.env.num_actions
        h, z = feats0[:, : cfg.deter_size], feats0[:, cfg.deter_size:]
        feats, logps, entropies = [], [], []
        for t in range(cfg.horizon):
            feat = torch.cat([h, z], -1)
            logits = _mlp(actor, feat)
            action = torch.argmax(logits + ga[t], dim=-1)
            logsm = torch.log_softmax(logits, -1)
            logps.append(gather_last(logsm, action))
            entropies.append(-torch.sum(torch.softmax(logits, -1) * logsm, -1))
            gin = _mlp(wm["gru_in"], torch.cat([z, F.one_hot(action, acts).to(z.dtype)], -1))
            h = _gru(wm["gru"], h, gin)
            z = self._sample_latent(gz[t], _mlp(wm["prior"], h))
            feats.append(feat)
        return (torch.stack(feats), torch.stack(logps), torch.stack(entropies),
                torch.cat([h, z], -1))

    def _lambda_returns(self, rewards, conts, values, last_value):
        cfg = self.config
        next_values = torch.cat([values[1:], last_value[None]], 0)
        rets = []
        carry = last_value
        for t in range(rewards.shape[0] - 1, -1, -1):
            carry = rewards[t] + cfg.gamma * conts[t] * (
                (1 - cfg.lam) * next_values[t] + cfg.lam * carry)
            rets.append(carry)
        return torch.stack(rets[::-1])

    def _update(self, state, batch, noise):
        """One world-model step and one actor-critic step from ``state`` on
        a batch of tensors and :meth:`draw_noise`'s draws; -> (the new
        state, stats as tensors)."""
        cfg = self.config
        (wm_loss, (feats, wm_stats)), wm_grads = value_and_grad(
            lambda wm: self._observe(wm, batch, noise["obs_z"]), state["wm"])
        with torch.no_grad():
            wm_updates, wm_opt = self._wm_opt.update(wm_grads, state["wm_opt"], state["wm"])
            wm = apply_updates(state["wm"], wm_updates)

        # ---------------- imagination (posterior states, wm frozen)
        starts = feats.reshape(-1, self._feat_dim).detach()
        slow = state["critic_slow"]

        def actor_critic_loss(p):
            im_feats, logps, entropies, last_feat = self._imagine(
                wm, p["actor"], starts, noise["im_a"], noise["im_z"])
            with torch.no_grad():
                # the head was trained on twohot(symlog(r)) — decode symexp,
                # matching the critic path
                rewards = symexp(twohot_mean(_mlp(wm["reward"], im_feats)))
                conts = torch.sigmoid(_mlp(wm["cont"], im_feats)[..., 0])
                slow_vals = symexp(twohot_mean(_mlp(slow, im_feats)))
                last_val = symexp(twohot_mean(_mlp(slow, last_feat)))
                rets = self._lambda_returns(rewards, conts, slow_vals, last_val)
                # return normalization: EMA of the 5-95 percentile range
                flat = rets.reshape(-1)
                spread = torch.quantile(flat, 0.95) - torch.quantile(flat, 0.05)
                scale = torch.clamp(state["ret_scale"], min=1.0)
                adv = (rets - slow_vals) / scale
                # discount weights silence post-termination imagination
                weights = torch.cat(
                    [torch.ones_like(conts[:1]), torch.cumprod(conts[:-1] * cfg.gamma, 0)], 0)
                target = twohot(symlog(rets))
            actor_loss = -torch.mean(weights * (logps * adv + cfg.entropy_coeff * entropies))
            critic_logits = _mlp(p["critic"], im_feats.detach())
            critic_loss = -torch.mean(
                weights * torch.sum(target * torch.log_softmax(critic_logits, -1), -1))
            return actor_loss + critic_loss, (actor_loss.detach(), critic_loss.detach(), spread,
                                              torch.mean(rets))

        (_, (a_loss, c_loss, spread, ret_mean)), grads = value_and_grad(
            actor_critic_loss, {"actor": state["actor"], "critic": state["critic"]})
        with torch.no_grad():
            a_updates, actor_opt = self._ac_opt.update(grads["actor"], state["actor_opt"],
                                                       state["actor"])
            c_updates, critic_opt = self._ac_opt.update(grads["critic"], state["critic_opt"],
                                                        state["critic"])
            actor = apply_updates(state["actor"], a_updates)
            critic = apply_updates(state["critic"], c_updates)
            critic_slow = tree_map(lambda s, o: cfg.critic_ema * s + (1 - cfg.critic_ema) * o,
                                   slow, critic)
            ret_scale = cfg.retnorm_ema * state["ret_scale"] + (1 - cfg.retnorm_ema) * spread
        new_state = {
            "wm": wm,
            "actor": actor,
            "critic": critic,
            "critic_slow": critic_slow,
            "wm_opt": wm_opt,
            "actor_opt": actor_opt,
            "critic_opt": critic_opt,
            "ret_scale": ret_scale,
        }
        stats = {
            "world_model_loss": wm_loss,
            "actor_loss": a_loss,
            "critic_loss": c_loss,
            "imagined_return_mean": ret_mean,
            **wm_stats,
        }
        return new_state, stats

    def _tensors(self, batch) -> Dict[str, torch.Tensor]:
        return {k: to_tensor(v, self.device) for k, v in batch.items()}

    # ------------------------------------------------------- training step
    def training_step(self) -> Dict[str, float]:
        cfg = self.config
        if self._env_state is None:
            self._env_state, self._obs = self.env.reset(self._generator, cfg.num_envs,
                                                        self.device)
            self._h = torch.zeros((cfg.num_envs, cfg.deter_size), device=self.device)
            self._z = torch.zeros((cfg.num_envs, self._z_dim), device=self.device)
            self._ep_ret = torch.zeros((cfg.num_envs,), device=self.device)

        chunk, completed = self._collect()
        self._record_episodes(
            [float(r) for r in completed[~np.isnan(completed)]],
            cfg.seq_len * cfg.num_envs,
        )
        # reset_prev[t] marks that obs[t] started a fresh episode
        resets = chunk.pop("reset")
        chunk["reset_prev"] = np.concatenate(
            [np.ones((1,) + resets.shape[1:], bool), resets[:-1]], 0
        )
        self._replay.append(chunk)
        if len(self._replay) > cfg.replay_capacity:
            self._replay.pop(0)

        stats = {}
        rng = np.random.default_rng(self.iteration)
        for _ in range(cfg.updates_per_iter):
            # a fixed batch shape (sampling WITH replacement), as the JAX
            # package's
            picks = rng.integers(0, len(self._replay), size=cfg.batch_size_seqs)
            batch = self._tensors({
                k: np.concatenate([self._replay[i][k] for i in picks], axis=1)
                for k in self._replay[0]
            })
            T, B = batch["action"].shape
            self.state, stats = self._update(self.state, batch, self.draw_noise(T, B))
        return floats(stats)

    def get_state(self) -> Dict[str, Any]:
        return {"params": tree_map(lambda x: x.detach().clone(), self.state),
                "iteration": self.iteration}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.state = to_device(state["params"], self.device)
        self.iteration = state.get("iteration", 0)


DreamerV3Config.algo_class = DreamerV3
