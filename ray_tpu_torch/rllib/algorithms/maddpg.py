"""MADDPG: multi-agent DDPG with centralized critics.

Parity: `rllib_contrib/maddpg` (Lowe et al. — decentralized deterministic
actors over each agent's own observation, centralized critics over the
JOINT observation+action, trained from a shared replay buffer; the MPE
"simple spread" cooperative navigation task is the canonical benchmark).

Per-agent params are STACKED along a leading agent axis (the layout the
JAX package's ``vmap``ped init leaves), and every per-agent computation —
actor forwards in the rollout, critic TD updates, actor ascent — is one
batched matmul over that axis. In observations and actions the agent axis
is the second from last (``[..., N, O]``). The environment is batched
(``SimpleSpread`` below): ``reset(generator, num_envs, device)`` and
``step`` over ``[E, N, ...]`` tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn import _soft_update
from ray_tpu_torch.rllib.env_runner import _tree_where, to_numpy
from ray_tpu_torch.rllib.learner import adam, apply_updates, floats, to_device, to_tensor
from ray_tpu_torch.rllib.learner import value_and_grad
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.rl_module import tree_map
from ray_tpu_torch.rllib.sample_batch import SampleBatch


@dataclasses.dataclass(frozen=True)
class SimpleSpread:
    """Cooperative navigation (MPE simple_spread), batched over envs: N
    agents move with continuous 2-D velocity actions to cover N landmarks.
    Shared reward = -sum over landmarks of distance to the nearest agent,
    minus a collision penalty. Per-agent obs: own pos/vel + landmark offsets
    + other-agent offsets."""

    n_agents: int = 3
    arena: float = 1.0
    dt: float = 0.1
    collision_radius: float = 0.1
    collision_penalty: float = 1.0
    max_episode_steps: int = 25

    @property
    def action_size(self) -> int:
        return 2

    action_low: float = -1.0
    action_high: float = 1.0

    @property
    def observation_size(self) -> int:
        # pos(2) + vel(2) + landmarks (2 each) + others (2 each)
        return 4 + 2 * self.n_agents + 2 * (self.n_agents - 1)

    def _obs(self, state):
        pos, vel, lm = state["pos"], state["vel"], state["lm"]
        E, N = pos.shape[0], self.n_agents
        rel_lm = (lm[:, None, :, :] - pos[:, :, None, :]).reshape(E, N, -1)  # [E, N, 2N]
        rel_all = pos[:, None, :, :] - pos[:, :, None, :]  # [E, self, other, 2]
        # each row keeps the N-1 OTHER agents via a fixed index table
        others = torch.tensor([[j for j in range(N) if j != i] for i in range(N)],
                              device=pos.device)
        rel_others = rel_all[:, torch.arange(N, device=pos.device)[:, None], others]
        return torch.cat([pos, vel, rel_lm, rel_others.reshape(E, N, -1)], dim=-1)

    def reset(self, generator: torch.Generator, num_envs: int, device=None):
        device = generator.device if device is None else torch.device(device)
        shape = (num_envs, self.n_agents, 2)
        span = 2.0 * self.arena
        pos = torch.rand(shape, generator=generator, device=device) * span - self.arena
        lm = torch.rand(shape, generator=generator, device=device) * span - self.arena
        state = {
            "pos": pos,
            "vel": torch.zeros(shape, device=device),
            "lm": lm,
            "t": torch.zeros((num_envs,), dtype=torch.int32, device=device),
        }
        return state, self._obs(state)

    def step(self, state, actions: torch.Tensor):
        """actions [E, N, 2] in [-1, 1] -> (state, obs [E, N, O], reward
        [E, N], terminated [E], truncated [E]). Reward is SHARED
        (cooperative task)."""
        act = torch.clamp(actions, self.action_low, self.action_high)
        vel = 0.5 * state["vel"] + act * self.dt
        pos = torch.clamp(state["pos"] + vel, -1.5 * self.arena, 1.5 * self.arena)
        # distance from each landmark to its nearest agent
        d = torch.linalg.vector_norm(state["lm"][:, :, None, :] - pos[:, None, :, :], dim=-1)
        cover_cost = torch.sum(torch.amin(d, dim=2), dim=-1)
        # pairwise collisions
        pd = torch.linalg.vector_norm(pos[:, :, None, :] - pos[:, None, :, :], dim=-1)
        pairs = torch.sum(torch.triu(pd < self.collision_radius, diagonal=1), dim=(1, 2))
        reward = -cover_cost - self.collision_penalty * pairs
        t = state["t"] + 1
        truncated = t >= self.max_episode_steps
        state = {"pos": pos, "vel": vel, "lm": state["lm"], "t": t}
        rewards = reward[:, None].expand(-1, self.n_agents).contiguous()
        return state, self._obs(state), rewards, torch.zeros_like(truncated), truncated


class MADDPGConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.critic_lr = 1e-3
        self.buffer_capacity = 50_000
        self.learning_starts = 500
        self.target_update_tau = 0.01
        self.num_updates_per_iter = 4
        self.train_batch_size = 128
        self.exploration_noise = 0.2
        self.num_envs_per_runner = 8
        self.rollout_length = 25


def _stacked_mlp_init(generator: torch.Generator, n: int, dims, out_scale: float = 1.0):
    """``n`` MLPs stacked on a leading axis: w [n, a, b], b [n, b] (the
    port's ``_mlp_init`` scale)."""
    device = generator.device
    layers = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        scale = (out_scale if i == len(dims) - 2 else 1.0) * math.sqrt(2.0 / a)
        w = torch.randn((n, a, b), generator=generator, device=device)
        layers.append({"w": w * scale, "b": torch.zeros((n, b), device=device)})
    return layers


def _stacked_mlp_apply(layers, x: torch.Tensor) -> torch.Tensor:
    """Stacked MLPs on their own inputs: x [n, B, a] -> [n, B, out] (tanh
    between layers)."""
    for i, layer in enumerate(layers):
        x = torch.baddbmm(layer["b"][:, None, :], x, layer["w"])
        if i < len(layers) - 1:
            x = torch.tanh(x)
    return x


def _agent_first(x: torch.Tensor) -> torch.Tensor:
    """[..., N, d] -> [N, prod(...), d]."""
    return x.reshape((-1,) + x.shape[-2:]).transpose(0, 1)


def _agent_back(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[N, prod(...), d] -> [..., N, d], the leading dims of ``like``."""
    return y.transpose(0, 1).reshape(like.shape[:-1] + y.shape[-1:])


class _MADDPGNets:
    """Stacked per-agent actors + centralized critics. All leaves carry a
    leading [N] agent axis; forwards are batched matmuls over it."""

    def __init__(self, env: SimpleSpread, hidden, generator: torch.Generator):
        self.env = env
        N, O, A = env.n_agents, env.observation_size, env.action_size
        joint = N * O + N * A
        self.params = {
            "pi": _stacked_mlp_init(generator, N, (O, *hidden, A)),
            "q": _stacked_mlp_init(generator, N, (joint, *hidden, 1)),
        }

    @staticmethod
    def actions(params, obs: torch.Tensor) -> torch.Tensor:
        """obs [..., N, O] -> each agent's deterministic action from its OWN
        obs [..., N, A]."""
        return _agent_back(torch.tanh(_stacked_mlp_apply(params["pi"], _agent_first(obs))), obs)

    @staticmethod
    def critics(params, x: torch.Tensor) -> torch.Tensor:
        """Each agent's centralized Q of its joint obs+action input x [N, B,
        J] (or one [B, J] shared by all) -> [N, B]."""
        if x.dim() == 2:
            x = x.expand((params["q"][0]["w"].shape[0],) + x.shape)
        return _stacked_mlp_apply(params["q"], x)[..., 0]


def _maddpg_update(cfg: MADDPGConfig, nets: _MADDPGNets, tx: tuple, state: dict, batch):
    """One update of ``state`` = {params, target_params, actor_opt,
    critic_opt} from a batch of tensors; -> (state, stats)."""
    actor_tx, critic_tx = tx
    params, target_params = state["params"], state["target_params"]
    obs = batch[SampleBatch.OBS]  # [B, N, O]
    act = batch[SampleBatch.ACTIONS]  # [B, N, A]
    rew = batch[SampleBatch.REWARDS]  # [B, N]
    done = batch[SampleBatch.DONES].float()  # [B, N]
    next_obs = batch[SampleBatch.NEXT_OBS]
    B, N = obs.shape[0], obs.shape[1]
    joint_obs = obs.reshape(B, -1)
    joint_act = act.reshape(B, -1)
    with torch.no_grad():
        next_act = nets.actions(target_params, next_obs).reshape(B, -1)
        # each agent's TARGET critic values the joint next state...
        tq = nets.critics(target_params, torch.cat([next_obs.reshape(B, -1), next_act], -1))
        target = rew.T + cfg.gamma * (1.0 - done.T) * tq  # [N, B]

    def critic_loss(p):
        # ...and each agent's ONLINE critic regresses onto it
        q = nets.critics(p, torch.cat([joint_obs, joint_act], -1))
        return torch.mean((q - target) ** 2), None

    (closs, _), cgrads = value_and_grad(critic_loss, params)
    with torch.no_grad():
        cgrads = {**cgrads, "pi": tree_map(torch.zeros_like, cgrads["pi"])}
        cupd, critic_opt = critic_tx.update(cgrads, state["critic_opt"], params)
        params = apply_updates(params, cupd)
    eye = torch.eye(N, dtype=torch.bool, device=obs.device)[:, None, :, None]  # [i, 1, j, 1]

    def actor_loss(p):
        # each agent's actor acts on its own obs; the OTHER agents'
        # replayed actions stay fixed in its critic input
        my_act = nets.actions(p, obs)  # [B, N, A]
        mixed = torch.where(eye, my_act[None], act[None])  # [N, B, N, A]: row i swaps agent i
        x = torch.cat([joint_obs.expand((N,) + joint_obs.shape), mixed.reshape(N, B, -1)], -1)
        q = nets.critics({"q": tree_map(torch.Tensor.detach, p["q"])}, x)  # [N, B]
        return torch.mean(-torch.mean(q, dim=1)), None

    (aloss, _), agrads = value_and_grad(actor_loss, params)
    with torch.no_grad():
        agrads = {**agrads, "q": tree_map(torch.zeros_like, agrads["q"])}
        aupd, actor_opt = actor_tx.update(agrads, state["actor_opt"], params)
        params = apply_updates(params, aupd)
        target_params = _soft_update(target_params, params, cfg.target_update_tau)
    return ({"params": params, "target_params": target_params, "actor_opt": actor_opt,
             "critic_opt": critic_opt}, {"critic_loss": closs, "actor_loss": aloss})


class MADDPG(Algorithm):
    def setup(self) -> None:
        cfg: MADDPGConfig = self.config
        env = cfg.env
        assert isinstance(env, SimpleSpread) or (
            hasattr(env, "n_agents") and hasattr(env, "_obs")
        ), "MADDPG needs a batched multi-agent env (SimpleSpread protocol)"
        self.env = env
        self.nets = _MADDPGNets(env, cfg.hidden,
                                torch.Generator(device=self.device).manual_seed(cfg.seed))
        self.target_params = tree_map(torch.clone, self.nets.params)
        self.actor_tx = adam(cfg.lr)
        self.critic_tx = adam(cfg.critic_lr)
        self.actor_opt = self.actor_tx.init(self.nets.params)
        self.critic_opt = self.critic_tx.init(self.nets.params)
        self.buffer = ReplayBuffer(cfg.buffer_capacity, seed=cfg.seed)
        self._generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self._env_state = None

    # -- sampling -----------------------------------------------------------
    def _rollout(self):
        cfg: MADDPGConfig = self.config
        B, g = cfg.num_envs_per_runner, self._generator
        records: Dict[str, list] = {}
        env_state, obs, ep_ret = self._env_state, self._obs, self._ep_ret
        with torch.no_grad():
            for _ in range(cfg.rollout_length):
                act = self.nets.actions(self.nets.params, obs)  # [B, N, A]
                noise = cfg.exploration_noise * torch.randn(act.shape, generator=g,
                                                            device=act.device)
                act = torch.clamp(act + noise, self.env.action_low, self.env.action_high)
                env_state2, next_obs, rewards, term, trunc = self.env.step(env_state, act)
                done = term | trunc
                ep_ret2 = ep_ret + rewards.sum(dim=-1) / self.env.n_agents
                reset_state, reset_obs = self.env.reset(g, B, self.device)
                rec = {
                    SampleBatch.OBS: obs,
                    SampleBatch.ACTIONS: act,
                    SampleBatch.REWARDS: rewards,
                    SampleBatch.DONES: term[..., None].expand(rewards.shape),
                    SampleBatch.NEXT_OBS: next_obs,
                    "_completed_return": torch.where(done, ep_ret2, torch.nan),
                }
                for k, v in rec.items():
                    records.setdefault(k, []).append(v)
                env_state = _tree_where(done, reset_state, env_state2)
                obs = _tree_where(done, reset_obs, next_obs)
                ep_ret = torch.where(done, 0.0, ep_ret2)
        self._env_state, self._obs, self._ep_ret = env_state, obs, ep_ret
        return {k: to_numpy(torch.stack(v)) for k, v in records.items()}

    def _state(self):
        return {"params": self.nets.params, "target_params": self.target_params,
                "actor_opt": self.actor_opt, "critic_opt": self.critic_opt}

    def _set_learner(self, state) -> None:
        self.nets.params = state["params"]
        self.target_params = state["target_params"]
        self.actor_opt = state["actor_opt"]
        self.critic_opt = state["critic_opt"]

    def training_step(self) -> Dict[str, float]:
        cfg: MADDPGConfig = self.config
        B = cfg.num_envs_per_runner
        if self._env_state is None:
            self._env_state, self._obs = self.env.reset(self._generator, B, self.device)
            self._ep_ret = torch.zeros((B,), device=self.device)
        traj = self._rollout()
        completed = traj.pop("_completed_return")
        ep_returns = [float(r) for r in completed[~np.isnan(completed)]]
        self._record_episodes(ep_returns, cfg.rollout_length * B)
        self.buffer.add(SampleBatch({k: v.reshape((-1,) + v.shape[2:]) for k, v in traj.items()}))
        stats: Dict[str, float] = {}
        if len(self.buffer) < cfg.learning_starts:
            return stats
        for _ in range(cfg.num_updates_per_iter):
            sample = self.buffer.sample(cfg.train_batch_size)
            batch = {k: to_tensor(v, self.device) for k, v in sample.items()}
            state, raw = _maddpg_update(cfg, self.nets, (self.actor_tx, self.critic_tx),
                                        self._state(), batch)
            self._set_learner(state)
            stats = floats(raw)
        return stats

    def evaluate(self, num_episodes: int = 10) -> Dict[str, float]:
        """Deterministic (noise-free) joint policy over fresh episodes."""
        g = torch.Generator(device=self.device).manual_seed(self.config.seed + 10_000)
        B = max(1, num_episodes)
        state, obs = self.env.reset(g, B, self.device)
        rets = torch.zeros((B,), device=self.device)
        with torch.no_grad():
            for _ in range(self.env.max_episode_steps):
                act = self.nets.actions(self.nets.params, obs)
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


MADDPGConfig.algo_class = MADDPG
