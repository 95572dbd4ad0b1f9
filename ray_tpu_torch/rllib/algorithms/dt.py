"""Decision Transformer: offline RL as conditional sequence modeling.

Parity: `rllib_contrib/dt` (Chen et al. — a causal transformer over
interleaved (return-to-go, state, action) tokens, trained on offline
trajectories to predict the action given the sequence so far; acting
conditions on a TARGET return and decrements it by observed rewards).

The model is a compact causal transformer in plain tensor operations: a
fixed [B, 3K] token grid, attention as two ``einsum``s with a ``-1e9``
causal mask and a softmax (the JAX package's, which calls no attention
kernel), LayerNorm with the population variance and the tanh-approximated
GELU (``jax.nn.gelu``'s default). Training data comes from the offline
SampleBatch format (`rllib/offline.py`), with return-to-go computed once
on the host; the optimizer is the port's ``adamw`` (optax's defaults).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.learner import (
    adamw,
    apply_updates,
    to_device,
    to_tensor,
    value_and_grad,
)
from ray_tpu_torch.rllib.rl_module import _mlp_init, gather_last
from ray_tpu_torch.rllib.sample_batch import SampleBatch


@dataclasses.dataclass(frozen=True)
class DTModule:
    """Causal transformer over (R, s, a) token triples.

    Sequence layout per timestep t: [R_t, s_t, a_t]; the action head reads
    the S-token positions (which attend to R_t, s_t and all earlier
    triples — never to a_t itself)."""

    obs_size: int
    num_actions: int
    context_length: int = 20  # K timesteps -> 3K tokens
    d_model: int = 64
    n_layers: int = 2
    n_heads: int = 2

    def init(self, generator: torch.Generator):
        D, device = self.d_model, generator.device

        def normal(shape, scale):
            return torch.randn(shape, generator=generator, device=device) * scale

        params = {
            "embed_r": _mlp_init(generator, (1, D)),
            "embed_s": _mlp_init(generator, (self.obs_size, D)),
            "embed_a": normal((self.num_actions + 1, D), 0.02),
            "pos": normal((self.context_length, D), 0.02),
            "head": _mlp_init(generator, (D, D, self.num_actions)),
            "blocks": [],
        }
        scale = 1.0 / math.sqrt(D)
        for _ in range(self.n_layers):
            params["blocks"].append(
                {
                    "wq": normal((D, D), scale),
                    "wk": normal((D, D), scale),
                    "wv": normal((D, D), scale),
                    "wo": normal((D, D), scale),
                    "ln1": {"g": torch.ones((D,), device=device),
                            "b": torch.zeros((D,), device=device)},
                    "ln2": {"g": torch.ones((D,), device=device),
                            "b": torch.zeros((D,), device=device)},
                    "mlp": _mlp_init(generator, (D, 4 * D, D)),
                }
            )
        return params

    @staticmethod
    def _ln(p, x):
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, correction=0)  # jnp's var: ddof 0
        return (x - mu) / torch.sqrt(var + 1e-5) * p["g"] + p["b"]

    def _mlp(self, layers, x):
        # gelu MLP (the tanh-MLP helper is for policy nets); jax.nn.gelu's
        # default is the tanh approximation
        x = x @ layers[0]["w"] + layers[0]["b"]
        x = F.gelu(x, approximate="tanh")
        return x @ layers[1]["w"] + layers[1]["b"]

    def _block(self, p, x, mask):
        B, L, D = x.shape
        H = self.n_heads
        h = self._ln(p["ln1"], x)
        q = (h @ p["wq"]).reshape(B, L, H, D // H)
        k = (h @ p["wk"]).reshape(B, L, H, D // H)
        v = (h @ p["wv"]).reshape(B, L, H, D // H)
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D // H)
        att = att.masked_fill(~mask, -1e9)
        att = torch.softmax(att, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, L, D)
        x = x + out @ p["wo"]
        return x + self._mlp(p["mlp"], self._ln(p["ln2"], x))

    def action_logits(self, params, rtg, obs, actions):
        """rtg [B, K], obs [B, K, O], actions [B, K] — the UNSHIFTED action
        taken at each step (pad index num_actions where not yet taken).
        The a-token of step t sits AFTER s_t in the stream, so the causal
        mask hides a_t from its own predictor while exposing a_{t-1} and
        earlier — no shifting needed. -> logits [B, K, A] at the S tokens."""
        B, K = rtg.shape
        D = self.d_model
        r_tok = rtg[..., None] @ params["embed_r"][0]["w"] + params["embed_r"][0]["b"]
        s_tok = obs @ params["embed_s"][0]["w"] + params["embed_s"][0]["b"]
        a_tok = params["embed_a"][actions.long()]
        pos = params["pos"][:K]
        # interleave -> [B, 3K, D]
        toks = torch.stack([r_tok + pos, s_tok + pos, a_tok + pos], dim=2).reshape(B, 3 * K, D)
        L = 3 * K
        causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=rtg.device))[None, None]
        x = toks
        for p in params["blocks"]:
            x = self._block(p, x, causal)
        s_positions = x.reshape(B, K, 3, D)[:, :, 1]  # the S tokens
        h = torch.tanh(s_positions @ params["head"][0]["w"] + params["head"][0]["b"])
        return h @ params["head"][1]["w"] + params["head"][1]["b"]


class DTConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.context_length = 20
        self.d_model = 64
        self.n_layers = 2
        self.n_heads = 2
        self.train_batch_size = 64
        self.updates_per_iter = 50
        self.target_return: float = 200.0

    def offline_data(self, batch: SampleBatch) -> "DTConfig":
        """Attach the offline experience (time-major [T, B] columns, the
        shape `offline.record_rollouts` produces)."""
        self.offline_batch = batch
        return self


def _dt_loss(module: DTModule):
    def loss_fn(p, rtg, obs, act, mask):
        # the causal layout hides each a_t from its own S-token, so the
        # SAME array serves as both input tokens and labels
        logits = module.action_logits(p, rtg, obs, act)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -gather_last(logp, torch.clamp(act, 0, module.num_actions - 1))
        return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0), None

    return loss_fn


class DT(Algorithm):
    """Trains on offline (R, s, a) sequences; acts by conditioning on
    ``target_return`` and decrementing it with observed rewards."""

    def setup(self) -> None:
        cfg: DTConfig = self.config
        env = cfg.env
        assert env.discrete, "this DT implementation is discrete-action"
        assert getattr(cfg, "offline_batch", None) is not None, (
            "DTConfig.offline_data(batch) is required (offline algorithm)"
        )
        self.module = DTModule(
            env.observation_size,
            env.num_actions,
            cfg.context_length,
            cfg.d_model,
            cfg.n_layers,
            cfg.n_heads,
        )
        self.params = self.module.init(torch.Generator(device=self.device).manual_seed(cfg.seed))
        self.tx = adamw(cfg.lr)
        self.opt_state = self.tx.init(self.params)
        self._build_windows(cfg.offline_batch)
        self._loss = _dt_loss(self.module)
        self._rng = np.random.default_rng(cfg.seed)

    # -- data ---------------------------------------------------------------
    def _build_windows(self, batch: SampleBatch) -> None:
        """Index the offline [T, B] columns: compute return-to-go and the
        list of valid (b, start, n) windows. Window TENSORS are gathered
        lazily per minibatch — materializing every sliding window up front
        would copy the dataset ~K-fold."""
        cfg: DTConfig = self.config
        K = cfg.context_length
        self._obs_col = np.asarray(batch[SampleBatch.OBS], np.float32)  # [T, B, O]
        self._act_col = np.asarray(batch[SampleBatch.ACTIONS], np.int64)  # [T, B]
        rews = np.asarray(batch[SampleBatch.REWARDS], np.float32)
        dones = np.asarray(batch[SampleBatch.DONES], bool)
        if SampleBatch.TRUNCATEDS in batch:
            dones = dones | np.asarray(batch[SampleBatch.TRUNCATEDS], bool)
        T, B = self._act_col.shape
        # return-to-go within episodes (reverse cumulative, reset at dones)
        rtg = np.zeros_like(rews)
        acc = np.zeros(B, np.float32)
        for t in range(T - 1, -1, -1):
            acc = rews[t] + np.where(dones[t], 0.0, acc)
            rtg[t] = acc
        self._rtg_col = rtg
        # per-column episode run lengths -> valid windows (never straddling
        # an episode boundary)
        windows = []
        for b in range(B):
            ep_start = 0
            for t in range(T):
                if dones[t, b] or t == T - 1:
                    ep_end = t + 1
                    for start in range(ep_start, ep_end - 1):
                        n = min(K, ep_end - start)
                        if n >= 2:
                            windows.append((b, start, n))
                    ep_start = ep_end
        self._window_index = np.asarray(windows, np.int64)

    def _gather_windows(self, idx: np.ndarray) -> Tuple[np.ndarray, ...]:
        cfg: DTConfig = self.config
        K = cfg.context_length
        pad_a = self.module.num_actions
        m = len(idx)
        rtg = np.zeros((m, K), np.float32)
        obs = np.zeros((m, K, self.module.obs_size), np.float32)
        act = np.full((m, K), pad_a, np.int64)
        mask = np.zeros((m, K), np.float32)
        for row, (b, start, n) in enumerate(self._window_index[idx]):
            sl = slice(start, start + n)
            rtg[row, :n] = self._rtg_col[sl, b]
            obs[row, :n] = self._obs_col[sl, b]
            act[row, :n] = self._act_col[sl, b]
            mask[row, :n] = 1.0
        return rtg, obs, act, mask

    # -- training -----------------------------------------------------------
    def _update(self, rtg, obs, act, mask) -> torch.Tensor:
        """One AdamW step on a window batch of tensors; -> the loss."""
        (loss, _), grads = value_and_grad(self._loss, self.params, rtg, obs, act, mask)
        with torch.no_grad():
            updates, self.opt_state = self.tx.update(grads, self.opt_state, self.params)
            self.params = apply_updates(self.params, updates)
        return loss

    def training_step(self) -> Dict[str, float]:
        cfg: DTConfig = self.config
        n = len(self._window_index)
        loss = torch.zeros(())
        for _ in range(cfg.updates_per_iter):
            idx = self._rng.integers(0, n, cfg.train_batch_size)
            loss = self._update(*(to_tensor(x, self.device) for x in self._gather_windows(idx)))
        # offline: no env steps are sampled during training
        return {"bc_loss": float(loss), "num_windows": float(n)}

    # -- acting -------------------------------------------------------------
    def _act(self, params, rtg, obs, actions, t: int) -> int:
        with torch.no_grad():
            logits = self.module.action_logits(params, rtg[None], obs[None], actions[None])[0]
            return int(torch.argmax(logits[t]))

    def evaluate(self, num_episodes: int = 5, target_return=None) -> Dict[str, float]:
        """Roll real episodes conditioning on target_return (decremented by
        observed rewards), greedy action selection. The context window is
        rebuilt each step from the episode HISTORY, so the prev-action
        alignment can't drift when the window slides."""
        cfg: DTConfig = self.config
        env = cfg.env
        K = cfg.context_length
        pad_a = self.module.num_actions
        O = env.observation_size
        returns = []
        g = torch.Generator(device=self.device).manual_seed(cfg.seed + 10_000)
        for _ in range(num_episodes):
            state, obs0 = env.reset(g, 1, self.device)
            target = float(target_return if target_return is not None else cfg.target_return)
            hist_obs: list = []
            hist_act: list = []
            hist_rtg: list = []
            ret, done = 0.0, False
            while not done and len(hist_obs) < env.max_episode_steps:
                hist_obs.append(obs0[0].cpu().numpy().astype(np.float32))
                hist_rtg.append(target - ret)
                start = max(0, len(hist_obs) - K)
                n = len(hist_obs) - start
                obs_buf = np.zeros((K, O), np.float32)
                rtg = np.zeros(K, np.float32)
                acts = np.full(K, pad_a, np.int64)
                obs_buf[:n] = np.stack(hist_obs[start:])
                rtg[:n] = np.asarray(hist_rtg[start:])
                # unshifted layout: past steps carry their TAKEN action;
                # the current step's a-slot stays pad (not yet taken, and
                # causally invisible to its own prediction anyway)
                if n > 1:
                    acts[: n - 1] = np.asarray(hist_act[start : start + n - 1])
                a = self._act(self.params, to_tensor(rtg, self.device),
                              to_tensor(obs_buf, self.device), to_tensor(acts, self.device),
                              n - 1)
                hist_act.append(a)
                state, obs0, r, term, trunc = env.step(
                    state, torch.tensor([a], device=self.device))
                ret += float(r[0])
                done = bool(term[0]) or bool(trunc[0])
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
            "opt_state": self.opt_state,
            "iteration": self.iteration,
            "total_env_steps": self._total_env_steps,
        }

    def set_state(self, state) -> None:
        self.params = to_device(state["params"], self.device)
        self.opt_state = to_device(state["opt_state"], self.device)
        self.iteration = state["iteration"]
        self._total_env_steps = state["total_env_steps"]

    def stop(self) -> None:
        pass


DTConfig.algo_class = DT
