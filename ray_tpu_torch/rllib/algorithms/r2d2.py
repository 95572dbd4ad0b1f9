"""R2D2: recurrent replay distributed DQN.

Parity: `rllib_contrib/r2d2` (Kapturowski et al. — an LSTM/GRU Q-network
trained on stored SEQUENCES with burn-in: the first ``burn_in`` steps of
each replayed sequence only rebuild the hidden state, TD loss applies to
the remainder; double-DQN targets; zero-state sequence starts, the paper's
simpler storage option).

The recurrent rollout is the runner's step loop with the GRU hidden state
carried beside the env state (``EnvRunner``'s three hooks), zeroed where an
episode ends. The learner unrolls stored sequences with a loop over time
for online and target networks; burn-in is a fixed mask. The cell is the
JAX package's: ``h' = (1 - z) * h + z * cand`` with the reset gate on the
hidden part of the candidate only (``torch.nn.GRUCell`` puts ``z`` on the
other side).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn import _copy, _soft_update
from ray_tpu_torch.rllib.env_runner import EnvRunner, _tree_where
from ray_tpu_torch.rllib.learner import Learner, LearnerGroup, to_device
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.rl_module import _mlp_apply, _mlp_init, gather_last
from ray_tpu_torch.rllib.sample_batch import SampleBatch


@dataclasses.dataclass(frozen=True)
class GRUQModule:
    """GRU core + dueling-free Q head. The recurrent analog of QModule:
    ``step(params, h, obs) -> (h', q)`` is the single-timestep cell both
    the rollout loop and the learner's unroll call."""

    obs_size: int
    num_actions: int
    hidden_size: int = 64

    def init(self, generator: torch.Generator):
        H, O = self.hidden_size, self.obs_size
        device = generator.device
        return {
            # fused GRU weights: [O, 3H] and [H, 3H] for (reset, update, cand)
            "wx": torch.randn((O, 3 * H), generator=generator, device=device) / math.sqrt(O),
            "wh": torch.randn((H, 3 * H), generator=generator, device=device) / math.sqrt(H),
            "b": torch.zeros((3 * H,), device=device),
            "head": _mlp_init(generator, (H, H, self.num_actions)),
        }

    def initial_state(self, batch_shape: Tuple[int, ...] = (), device=None) -> torch.Tensor:
        return torch.zeros(tuple(batch_shape) + (self.hidden_size,), device=device)

    def step(self, params, h: torch.Tensor, obs: torch.Tensor):
        """One GRU step. h [..., H], obs [..., O] -> (h', q [..., A])."""
        H = self.hidden_size
        gates_x = obs @ params["wx"] + params["b"]
        gates_h = h @ params["wh"]
        r = torch.sigmoid(gates_x[..., :H] + gates_h[..., :H])
        z = torch.sigmoid(gates_x[..., H : 2 * H] + gates_h[..., H : 2 * H])
        cand = torch.tanh(gates_x[..., 2 * H :] + r * gates_h[..., 2 * H :])
        h_new = (1.0 - z) * h + z * cand
        return h_new, _mlp_apply(params["head"], h_new)

    def unroll(self, params, h0: torch.Tensor, obs_seq: torch.Tensor, reset_before=None,
               return_hidden: bool = False):
        """A loop over time: obs_seq [T, B, O], h0 [B, H] -> q_seq [T, B, A].
        ``reset_before`` [T, B] zeroes the hidden state BEFORE consuming
        step t — the learner's mirror of the rollout's reset-at-done.
        ``return_hidden`` also yields the post-step hiddens [T, B, H]."""
        h = h0
        qs, hs = [], []
        for t in range(obs_seq.shape[0]):
            if reset_before is not None:
                h = h * (1.0 - reset_before[t])[..., None]
            h, q = self.step(params, h, obs_seq[t])
            qs.append(q)
            hs.append(h)
        q_seq = torch.stack(qs)
        return (q_seq, torch.stack(hs)) if return_hidden else q_seq

    def explore(self, params, h, obs, generator: torch.Generator, epsilon):
        """Recurrent epsilon-greedy: -> (h', action)."""
        h, q = self.step(params, h, obs)
        greedy = torch.argmax(q, dim=-1)
        random_a = torch.randint(0, self.num_actions, greedy.shape, generator=generator,
                                 device=greedy.device)
        pick = torch.rand(greedy.shape, generator=generator, device=greedy.device) < epsilon
        return h, torch.where(pick, random_a, greedy)


class _RecurrentEnvRunner(EnvRunner):
    """EnvRunner whose loop carries the GRU hidden state, zeroed where an
    episode ends (the recorded sequences therefore always start from a zero
    state at episode boundaries — R2D2's zero-state storage)."""

    def _rollout(self, params, extra):
        records: Dict[str, list] = {}
        env_state, obs, ep_ret, h = self._env_state, self._obs, self._ep_ret, extra["hidden"]
        for _ in range(self.rollout_length):
            h2, action = self.module.explore(params, h, obs, self._generator, extra["epsilon"])
            env_state2, next_obs, reward, terminated, truncated = self.env.step(env_state, action)
            done = terminated | truncated
            ep_ret2 = ep_ret + reward
            completed = torch.where(done, ep_ret2, torch.nan)
            reset_state, reset_obs = self.env.reset(self._generator, self.num_envs, self.device)
            record = {
                SampleBatch.OBS: obs,
                SampleBatch.ACTIONS: action,
                SampleBatch.REWARDS: reward,
                SampleBatch.DONES: terminated,
                SampleBatch.TRUNCATEDS: truncated,
                SampleBatch.NEXT_OBS: next_obs,
                "_completed_return": completed,
            }
            for k, v in record.items():
                records.setdefault(k, []).append(v)
            env_state = _tree_where(done, reset_state, env_state2)
            obs = _tree_where(done, reset_obs, next_obs)
            # hidden state zeroes at episode end, like the env
            h = torch.where(done[..., None], torch.zeros_like(h2), h2)
            ep_ret = torch.where(done, 0.0, ep_ret2)
        self._env_state, self._obs, self._ep_ret = env_state, obs, ep_ret
        return {k: torch.stack(v) for k, v in records.items()}, h

    # base sample() drives everything; these hooks thread the hidden state
    def _on_lazy_reset(self) -> None:
        self._hidden = self.module.initial_state((self.num_envs,), self.device)

    def _augment_extra(self, extra):
        extra["hidden"] = self._hidden
        return extra

    def _consume_rollout(self, out):
        traj, self._hidden = out
        return traj


class R2D2Config(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.hidden_size = 64
        # 16 divides the inherited rollout_length=128, so the OUT-OF-BOX
        # config builds (the setup assert would otherwise reject defaults)
        self.sequence_length = 16
        self.burn_in = 4
        self.buffer_capacity = 2_000  # sequences, not transitions
        self.learning_starts = 100  # sequences
        self.target_update_tau = 0.01
        self.num_updates_per_iter = 4
        self.train_batch_size = 16  # sequences per update
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_decay_steps = 10_000


def _r2d2_loss(module: GRUQModule, gamma: float, burn_in: int):
    def loss_fn(params, batch, target_params):
        # batch arrays are [B, T, ...]; the unroll wants time-major
        obs = batch[SampleBatch.OBS].transpose(0, 1)  # [T, B, O]
        next_obs = batch[SampleBatch.NEXT_OBS].transpose(0, 1)
        actions = batch[SampleBatch.ACTIONS].transpose(0, 1)  # [T, B]
        rewards = batch[SampleBatch.REWARDS].transpose(0, 1)
        dones = batch[SampleBatch.DONES].transpose(0, 1).float()
        truncs = batch[SampleBatch.TRUNCATEDS].transpose(0, 1).float()
        # the rollout resets h at terminated OR truncated; the learner must
        # mirror exactly that, not terminals alone
        ended = torch.clamp(dones + truncs, 0.0, 1.0)
        T, B = actions.shape
        h0 = module.initial_state((B,), obs.device)
        # ONE (T+1)-step unroll per network over [obs..., last next_obs],
        # hidden reset before any step whose predecessor ENDED an episode
        # (term or trunc) — exact hiddens for q_seq (rows :T) and for the
        # within-episode next-state values (rows 1:).
        ext = torch.cat([obs, next_obs[-1:]], dim=0)  # [T+1, B, O]
        resets = torch.cat([torch.zeros((1, B), device=obs.device), ended], dim=0)
        q_ext, h_ext = module.unroll(params, h0, ext, resets, return_hidden=True)
        with torch.no_grad():
            q_ext_target, h_ext_target = module.unroll(target_params, h0, ext, resets,
                                                       return_hidden=True)
        q_seq = q_ext[:T]
        # At an episode end inside the sequence, row t+1 of the ext unroll
        # values the NEXT episode's reset obs — wrong for a truncation,
        # which must bootstrap from next_obs_t (truncation bootstraps,
        # termination zeroes). Correct those steps with one extra cell
        # evaluation from the exact post-step hidden h_ext[:T].
        q_b = module.step(params, h_ext[:T], next_obs)[1]
        with torch.no_grad():
            q_b_target = module.step(target_params, h_ext_target[:T], next_obs)[1]
        e = ended[..., None] > 0
        next_online = torch.where(e, q_b, q_ext[1:])
        next_target = torch.where(e, q_b_target, q_ext_target[1:])
        next_a = torch.argmax(next_online, dim=-1)
        next_q = gather_last(next_target, next_a)
        q_taken = gather_last(q_seq, actions)
        target = rewards + gamma * (1.0 - dones) * next_q.detach()
        td = q_taken - target
        # burn-in: the first steps only build hidden state, no gradient
        mask = (torch.arange(T, device=obs.device) >= burn_in).float()[:, None]
        huber = torch.where(td.abs() < 1.0, 0.5 * td**2, td.abs() - 0.5)
        denom = torch.clamp(torch.sum(mask) * B, min=1.0)
        loss = torch.sum(huber * mask) / denom
        return loss, {
            "td_abs_mean": (torch.sum(td.abs() * mask) / torch.clamp(mask.sum() * B, min=1.0)
                            ).detach(),
            "q_mean": torch.mean(q_taken).detach(),
        }

    return loss_fn


class R2D2(Algorithm):
    def setup(self) -> None:
        cfg: R2D2Config = self.config
        env = cfg.env
        assert env.discrete, "R2D2 requires a discrete-action env"
        assert cfg.rollout_length % cfg.sequence_length == 0, (
            "rollout_length must be a multiple of sequence_length"
        )
        self.module = GRUQModule(env.observation_size, env.num_actions, cfg.hidden_size)
        self.runners = _RecurrentEnvRunner(
            env,
            self.module,
            policy="q",  # selector unused; explore() is called directly
            num_envs=cfg.num_envs_per_runner,
            rollout_length=cfg.rollout_length,
            seed=cfg.seed,
            device=self.device,
        )
        self.learners = LearnerGroup(
            Learner(
                self.module,
                _r2d2_loss(self.module, cfg.gamma, cfg.burn_in),
                lr=cfg.lr,
                max_grad_norm=cfg.max_grad_norm,
                seed=cfg.seed,
                device=self.device,
            )
        )
        self.target_params = _copy(self.learners.params)
        self.buffer = ReplayBuffer(cfg.buffer_capacity, seed=cfg.seed)

    def _epsilon(self) -> float:
        cfg: R2D2Config = self.config
        frac = min(1.0, self._total_env_steps / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final - cfg.epsilon_initial)

    def training_step(self) -> Dict[str, float]:
        cfg: R2D2Config = self.config
        # float32, as the JAX package's jnp.asarray of it
        eps = float(np.float32(self._epsilon()))
        batch, _, ep_returns = self.runners.sample(self.learners.params, {"epsilon": eps})
        T_total, B = batch[SampleBatch.ACTIONS].shape
        self._record_episodes(ep_returns, T_total * B)
        # slice the [T_total, B] rollout into [n_seq, seq_len] rows: each
        # buffer row is ONE sequence ([seq_len, ...] per column)
        L = cfg.sequence_length
        seqs = {}
        for k, v in batch.items():
            v = np.asarray(v)
            # [T_total, B, ...] -> [T/L, L, B, ...] -> [T/L * B, L, ...]
            v = v.reshape((T_total // L, L) + v.shape[1:])
            seqs[k] = np.moveaxis(v, 2, 1).reshape((-1, L) + v.shape[3:])
        self.buffer.add(SampleBatch(seqs))
        stats: Dict[str, float] = {"epsilon": eps}
        if len(self.buffer) < cfg.learning_starts:
            return stats
        for _ in range(cfg.num_updates_per_iter):
            sample = self.buffer.sample(cfg.train_batch_size)
            stats.update(self.learners.update(sample, target_params=self.target_params))
            self.target_params = _soft_update(
                self.target_params, self.learners.params, cfg.target_update_tau
            )
        return stats

    def evaluate(self, num_episodes: int = 10) -> Dict[str, float]:
        """Greedy recurrent evaluation: the same rollout loop at epsilon=0
        on a cached eval runner (hidden state carries like training)."""
        cfg: R2D2Config = self.config
        runner = getattr(self, "_eval_runner", None)
        if runner is None:
            runner = self._eval_runner = _RecurrentEnvRunner(
                cfg.env,
                self.module,
                policy="q",
                num_envs=min(8, max(1, num_episodes)),
                rollout_length=cfg.env.max_episode_steps,
                seed=cfg.seed + 10_000,
                device=self.device,
            )
        runner._generator.manual_seed(cfg.seed + 10_000)
        runner._env_state = None
        returns: list = []
        while len(returns) < num_episodes:
            _, _, ep_returns = runner.sample(self.learners.params, {"epsilon": 0.0})
            returns.extend(ep_returns)
        returns = returns[:num_episodes]
        return {
            "evaluation": {
                "episode_return_mean": float(np.mean(returns)),
                "episode_return_min": float(np.min(returns)),
                "episode_return_max": float(np.max(returns)),
                "num_episodes": len(returns),
            }
        }

    def get_state(self):
        state = super().get_state()
        state["target_params"] = self.target_params
        return state

    def set_state(self, state) -> None:
        super().set_state(state)
        self.target_params = to_device(state["target_params"], self.device)


R2D2Config.algo_class = R2D2
