"""QMIX: cooperative multi-agent Q-learning with monotonic value mixing.

Parity: `rllib_contrib/qmix` (Rashid et al. — per-agent utility networks
Q_i(o_i, a_i) combined by a mixing network whose weights are produced by
hypernetworks over the GLOBAL state and constrained non-negative, so
argmax_a Q_tot decomposes into per-agent argmaxes; trained end-to-end with
TD on the joint reward).

Per-agent utility params are stacked on a leading agent axis (one batched
matmul evaluates all agents, the agent axis second from last in
observations), the mixing hypernetwork is a plain function of the global
state, and rollouts step a batched discrete multi-agent env
(``DiscreteSpread`` below — the grid-action variant of
``maddpg.SimpleSpread``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn import _soft_update
from ray_tpu_torch.rllib.algorithms.maddpg import (
    SimpleSpread,
    _agent_back,
    _agent_first,
    _stacked_mlp_apply,
    _stacked_mlp_init,
)
from ray_tpu_torch.rllib.env_runner import _tree_where, to_numpy
from ray_tpu_torch.rllib.learner import (
    adam,
    apply_updates,
    floats,
    to_device,
    to_tensor,
    value_and_grad,
)
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.rl_module import _mlp_apply, _mlp_init, gather_last, tree_map
from ray_tpu_torch.rllib.sample_batch import SampleBatch

# the 5 grid moves: stay, +x, -x, +y, -y
_MOVES = np.array([[0, 0], [1, 0], [-1, 0], [0, 1], [0, -1]], np.float32)


@dataclasses.dataclass(frozen=True)
class DiscreteSpread(SimpleSpread):
    """SimpleSpread with 5 discrete moves per agent (QMIX needs discrete
    per-agent action spaces). Inherits dynamics/reward/obs; actions are
    indices into the move table."""

    num_actions: int = 5

    def step(self, state, actions: torch.Tensor):
        vel_cmd = torch.as_tensor(_MOVES, device=actions.device)[actions.long()]  # [E, N, 2]
        return super().step(state, vel_cmd)

    def global_state(self, state) -> torch.Tensor:
        """The mixing hypernetwork's input: all positions + landmarks."""
        E = state["pos"].shape[0]
        return torch.cat([state["pos"].reshape(E, -1), state["vel"].reshape(E, -1),
                          state["lm"].reshape(E, -1)], dim=-1)

    @property
    def global_state_size(self) -> int:
        return 6 * self.n_agents


class QMIXConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 5e-4
        self.mixing_embed = 32
        self.buffer_capacity = 50_000
        self.learning_starts = 500
        self.target_update_tau = 0.01
        self.num_updates_per_iter = 4
        self.train_batch_size = 128
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_decay_steps = 20_000
        self.num_envs_per_runner = 8
        self.rollout_length = 25


class _QMixNets:
    """Stacked per-agent utility nets + the monotonic mixer."""

    def __init__(self, env: DiscreteSpread, hidden, embed: int, generator: torch.Generator):
        self.env = env
        self.embed = embed
        N, O, A, S = env.n_agents, env.observation_size, env.num_actions, env.global_state_size
        self.params = {
            "agents": {"q": _stacked_mlp_init(generator, N, (O, *hidden, A))},
            # hypernetworks: global state -> mixer weights (abs() at use
            # enforces monotonicity) and biases
            "hyper_w1": _mlp_init(generator, (S, N * embed)),
            "hyper_b1": _mlp_init(generator, (S, embed)),
            "hyper_w2": _mlp_init(generator, (S, embed)),
            "hyper_b2": _mlp_init(generator, (S, embed, 1)),
        }

    @staticmethod
    def agent_qs(params, obs: torch.Tensor) -> torch.Tensor:
        """obs [..., N, O] -> per-agent Q values [..., N, A]."""
        return _agent_back(_stacked_mlp_apply(params["agents"]["q"], _agent_first(obs)), obs)

    def mix(self, params, chosen_qs: torch.Tensor, global_state: torch.Tensor) -> torch.Tensor:
        """chosen_qs [..., N], global_state [..., S] -> Q_tot [...].
        Weights go through abs(): dQ_tot/dQ_i >= 0 (the QMIX constraint)."""
        N, E = self.env.n_agents, self.embed
        w1 = torch.abs(_mlp_apply(params["hyper_w1"], global_state)).reshape(
            global_state.shape[:-1] + (N, E)
        )
        b1 = _mlp_apply(params["hyper_b1"], global_state)
        h = F.elu(torch.einsum("...n,...ne->...e", chosen_qs, w1) + b1)
        w2 = torch.abs(_mlp_apply(params["hyper_w2"], global_state))
        b2 = _mlp_apply(params["hyper_b2"], global_state)[..., 0]
        return torch.sum(h * w2, dim=-1) + b2


def _qmix_update(cfg: QMIXConfig, nets: _QMixNets, tx, state: dict, batch):
    """One update of ``state`` = {params, target_params, opt_state} from a
    batch of tensors; -> (state, stats)."""
    params, target_params = state["params"], state["target_params"]
    obs = batch[SampleBatch.OBS]  # [B, N, O]
    act = batch[SampleBatch.ACTIONS]  # [B, N]
    rew = batch[SampleBatch.REWARDS]  # [B] shared
    done = batch[SampleBatch.DONES].float()
    gs, next_gs = batch["global_state"], batch["next_global_state"]
    next_obs = batch[SampleBatch.NEXT_OBS]
    with torch.no_grad():
        # double-Q at the team level: online nets pick per-agent argmax,
        # target nets evaluate, the TARGET mixer combines
        next_a = torch.argmax(_QMixNets.agent_qs(params, next_obs), dim=-1)
        next_chosen = gather_last(_QMixNets.agent_qs(target_params, next_obs), next_a)
        next_tot = nets.mix(target_params, next_chosen, next_gs)
        target = rew + cfg.gamma * (1.0 - done) * next_tot

    def loss_fn(p):
        chosen = gather_last(_QMixNets.agent_qs(p, obs), act)
        tot = nets.mix(p, chosen, gs)
        return torch.mean((tot - target) ** 2), torch.mean(tot).detach()

    (loss, q_mean), grads = value_and_grad(loss_fn, params)
    with torch.no_grad():
        updates, opt_state = tx.update(grads, state["opt_state"], params)
        params = apply_updates(params, updates)
        target_params = _soft_update(target_params, params, cfg.target_update_tau)
    return ({"params": params, "target_params": target_params, "opt_state": opt_state},
            {"loss": loss, "q_tot_mean": q_mean})


class QMIX(Algorithm):
    def setup(self) -> None:
        cfg: QMIXConfig = self.config
        env = cfg.env
        assert isinstance(env, DiscreteSpread) or hasattr(env, "global_state"), (
            "QMIX needs a discrete multi-agent env with a global_state view"
        )
        self.env = env
        self.nets = _QMixNets(env, cfg.hidden, cfg.mixing_embed,
                              torch.Generator(device=self.device).manual_seed(cfg.seed))
        self.target_params = tree_map(torch.clone, self.nets.params)
        self.tx = adam(cfg.lr)
        self.opt_state = self.tx.init(self.nets.params)
        self.buffer = ReplayBuffer(cfg.buffer_capacity, seed=cfg.seed)
        self._generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self._env_state = None

    def _epsilon(self) -> float:
        cfg: QMIXConfig = self.config
        frac = min(1.0, self._total_env_steps / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final - cfg.epsilon_initial)

    # -- sampling -----------------------------------------------------------
    def _rollout(self, eps: float):
        cfg: QMIXConfig = self.config
        B, A, g = cfg.num_envs_per_runner, self.env.num_actions, self._generator
        records: Dict[str, list] = {}
        env_state, obs, ep_ret = self._env_state, self._obs, self._ep_ret
        with torch.no_grad():
            for _ in range(cfg.rollout_length):
                greedy = torch.argmax(_QMixNets.agent_qs(self.nets.params, obs), dim=-1)
                rand = torch.randint(0, A, greedy.shape, generator=g, device=greedy.device)
                explore = torch.rand(greedy.shape, generator=g, device=greedy.device) < eps
                act = torch.where(explore, rand, greedy)
                gs = self.env.global_state(env_state)
                env_state2, next_obs, rewards, term, trunc = self.env.step(env_state, act)
                done = term | trunc
                ep_ret2 = ep_ret + rewards.sum(dim=-1) / self.env.n_agents
                reset_state, reset_obs = self.env.reset(g, B, self.device)
                rec = {
                    SampleBatch.OBS: obs,
                    SampleBatch.ACTIONS: act,
                    SampleBatch.REWARDS: rewards[..., 0],  # shared scalar
                    SampleBatch.NEXT_OBS: next_obs,
                    "global_state": gs,
                    "next_global_state": self.env.global_state(env_state2),
                    SampleBatch.DONES: term,
                    SampleBatch.TRUNCATEDS: trunc,
                    "_completed_return": torch.where(done, ep_ret2, torch.nan),
                }
                for k, v in rec.items():
                    records.setdefault(k, []).append(v)
                env_state = _tree_where(done, reset_state, env_state2)
                obs = _tree_where(done, reset_obs, next_obs)
                ep_ret = torch.where(done, 0.0, ep_ret2)
        self._env_state, self._obs, self._ep_ret = env_state, obs, ep_ret
        return {k: to_numpy(torch.stack(v)) for k, v in records.items()}

    def training_step(self) -> Dict[str, float]:
        cfg: QMIXConfig = self.config
        B = cfg.num_envs_per_runner
        # float32, as the JAX package's jnp.asarray of it
        eps = float(np.float32(self._epsilon()))
        if self._env_state is None:
            self._env_state, self._obs = self.env.reset(self._generator, B, self.device)
            self._ep_ret = torch.zeros((B,), device=self.device)
        traj = self._rollout(eps)
        completed = traj.pop("_completed_return")
        ep_returns = [float(r) for r in completed[~np.isnan(completed)]]
        self._record_episodes(ep_returns, cfg.rollout_length * B)
        self.buffer.add(SampleBatch({k: v.reshape((-1,) + v.shape[2:]) for k, v in traj.items()}))
        stats: Dict[str, float] = {"epsilon": eps}
        if len(self.buffer) < cfg.learning_starts:
            return stats
        for _ in range(cfg.num_updates_per_iter):
            sample = self.buffer.sample(cfg.train_batch_size)
            batch = {k: to_tensor(v, self.device) for k, v in sample.items()}
            state, raw = _qmix_update(cfg, self.nets, self.tx, self._state(), batch)
            self._set_learner(state)
            stats.update(floats(raw))
        return stats

    def _state(self):
        return {"params": self.nets.params, "target_params": self.target_params,
                "opt_state": self.opt_state}

    def _set_learner(self, state) -> None:
        self.nets.params = state["params"]
        self.target_params = state["target_params"]
        self.opt_state = state["opt_state"]

    def evaluate(self, num_episodes: int = 10) -> Dict[str, float]:
        """Greedy joint policy (per-agent argmax — exactly the policy the
        monotonic mixer certifies as the Q_tot argmax)."""
        g = torch.Generator(device=self.device).manual_seed(self.config.seed + 10_000)
        B = max(1, num_episodes)
        state, obs = self.env.reset(g, B, self.device)
        rets = torch.zeros((B,), device=self.device)
        with torch.no_grad():
            for _ in range(self.env.max_episode_steps):
                act = torch.argmax(_QMixNets.agent_qs(self.nets.params, obs), dim=-1)
                state, obs, rewards, term, trunc = self.env.step(state, act)
                rets = rets + rewards.sum(dim=-1) / self.env.n_agents
        rets = to_numpy(rets)[:num_episodes]
        return {
            "evaluation": {
                "episode_return_mean": float(rets.mean()),
                "episode_return_min": float(rets.min()),
                "episode_return_max": float(rets.max()),
                "num_episodes": int(len(rets)),
            }
        }

    def get_state(self):
        return {
            **self._state(),
            "iteration": self.iteration,
            "total_env_steps": self._total_env_steps,
        }

    def set_state(self, state) -> None:
        state = to_device(state, self.device)
        self._set_learner(state)
        self.iteration = state["iteration"]
        self._total_env_steps = state["total_env_steps"]

    def stop(self) -> None:
        pass


QMIXConfig.algo_class = QMIX
