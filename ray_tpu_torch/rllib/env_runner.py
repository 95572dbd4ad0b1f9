"""EnvRunner / EnvRunnerGroup: experience collection.

Parity: `rllib/env/env_runner_group.py` + `rllib/evaluation/rollout_worker.py`
— a set of workers each stepping vectorized envs and returning SampleBatches.

One runner = ``num_envs`` batched functional envs on one device, advanced
by a Python loop of ``rollout_length`` steps over device tensors with
auto-reset by ``torch.where`` (the JAX package runs the same loop as one
jitted ``lax.scan``). Each step launches the connectors, the module's
forward and draws, and the env's step on the device; the rollout crosses to
the host once, as numpy. A group fans runners out as ``ray_tpu_torch``
actors (the reference's worker-set pattern) or runs them inline.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.models.common import default_device
from ray_tpu_torch.rllib.envs import DeviceEnv
from ray_tpu_torch.rllib.rl_module import tree_map
from ray_tpu_torch.rllib.sample_batch import SampleBatch


def _tree_where(cond: torch.Tensor, if_true, if_false):
    """Select tree leaves by a [B]-shaped bool, broadcast to each leaf rank."""

    def sel(a, b):
        c = cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim()))
        return torch.where(c, a, b)

    return tree_map(sel, if_true, if_false)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A rollout column on the host, in the JAX package's dtypes (its int
    actions are int32)."""
    a = t.detach().cpu().numpy()
    return a.astype(np.int32) if a.dtype == np.int64 else a


def on_device(params, device):
    """``params`` on ``device`` (a remote runner may be handed host copies)."""
    return tree_map(lambda p: p.to(device), params)


class EnvRunner:
    """Collects rollouts with a step loop on the device.

    `policy` selects the action function:
      - "actor_critic": module.explore -> (action, logp, value) recorded.
      - "q": epsilon-greedy on module.q_values; `extra` carries epsilon.
      - "sac": module.sample_action; logp recorded.
      - "ddpg": deterministic module.explore + gaussian noise; `extra`
        carries noise_scale.
      - "inference": module.inference_action — greedy/mean, for evaluate().
      - "random": uniform actions (warmup for off-policy algos).
    """

    def __init__(
        self,
        env: DeviceEnv,
        module,
        *,
        policy: str = "actor_critic",
        num_envs: int = 8,
        rollout_length: int = 128,
        seed: int = 0,
        env_to_module=None,
        module_to_env=None,
        device=None,
    ):
        self.device = default_device(device, "EnvRunner")
        self.env = env
        self.module = module
        self.policy = policy
        # connector pipelines (rllib/connectors parity), run on the device
        # inside the step loop
        self.env_to_module = env_to_module
        self.module_to_env = module_to_env
        self.num_envs = num_envs
        self.rollout_length = rollout_length
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._env_state = None
        self._obs = None
        self._ep_ret = None
        self.metrics: Dict[str, float] = {}

    # -- action functions ---------------------------------------------------
    def _action_fn(self, params, obs, extra):
        m, g = self.module, self._generator
        if self.policy == "actor_critic":
            action, logp, value = m.explore(params, obs, g)
            return action, {SampleBatch.LOGP: logp, SampleBatch.VALUES: value}
        if self.policy == "q":
            return m.explore(params, obs, g, extra["epsilon"]), {}
        if self.policy == "sac":
            noise = torch.randn(obs.shape[:-1] + (m.action_size,), generator=g,
                                device=obs.device)
            action, logp = m.sample_action(params, obs, noise)
            return action, {SampleBatch.LOGP: logp}
        if self.policy == "ddpg":
            return m.explore(params, obs, g, extra["noise_scale"]), {}
        if self.policy == "inference":
            # greedy/mean actions via the module's forward_inference analog
            return m.inference_action(params, obs), {}
        if self.policy == "random":
            if self.env.discrete:
                return torch.randint(0, self.env.num_actions, obs.shape[:1], generator=g,
                                     device=obs.device), {}
            u = torch.rand(obs.shape[:1] + (self.env.action_size,), generator=g,
                           device=obs.device)
            low, high = self.env.action_low, self.env.action_high
            return u * (high - low) + low, {}
        raise ValueError(f"unknown policy {self.policy!r}")

    def _rollout(self, params, extra):
        records: Dict[str, List[torch.Tensor]] = {}
        env_state, obs, ep_ret = self._env_state, self._obs, self._ep_ret
        for _ in range(self.rollout_length):
            # env_to_module runs HERE, once, and the TRANSFORMED obs is
            # what gets recorded — the learner must see the same inputs
            # the policy acted on, or importance ratios/value targets
            # compare different observation spaces
            obs_mod = self.env_to_module(obs) if self.env_to_module is not None else obs
            action, aux = self._action_fn(params, obs_mod, extra)
            env_action = self.module_to_env(action) if self.module_to_env is not None else action
            env_state2, next_obs, reward, terminated, truncated = self.env.step(
                env_state, env_action)
            next_obs_mod = (
                self.env_to_module(next_obs) if self.env_to_module is not None else next_obs
            )
            done = terminated | truncated
            ep_ret2 = ep_ret + reward
            completed = torch.where(done, ep_ret2, torch.nan)
            reset_state, reset_obs = self.env.reset(self._generator, self.num_envs, self.device)
            env_state = _tree_where(done, reset_state, env_state2)
            obs = _tree_where(done, reset_obs, next_obs)
            ep_ret = torch.where(done, 0.0, ep_ret2)
            record = {
                SampleBatch.OBS: obs_mod,
                SampleBatch.ACTIONS: action,
                SampleBatch.REWARDS: reward,
                SampleBatch.DONES: terminated,
                SampleBatch.TRUNCATEDS: truncated,
                SampleBatch.NEXT_OBS: next_obs_mod,
                "_completed_return": completed,
                **aux,
            }
            for k, v in record.items():
                records.setdefault(k, []).append(v)
        self._env_state, self._obs, self._ep_ret = env_state, obs, ep_ret
        return {k: torch.stack(v) for k, v in records.items()}

    # -- subclass hooks (recurrent runners thread extra loop state) --------
    def _on_lazy_reset(self) -> None:
        """Called once when the env set is first (re)initialized."""

    def _augment_extra(self, extra: Dict[str, Any]) -> Dict[str, Any]:
        """Inject per-rollout carry (e.g. a hidden state) into ``extra``."""
        return extra

    def _consume_rollout(self, out):
        """Unpack the rollout's output (and stash any aux carry)."""
        return out

    # -- public API ---------------------------------------------------------
    def sample(
        self, params, extra: Optional[Dict[str, Any]] = None
    ) -> Tuple[SampleBatch, np.ndarray, List[float]]:
        """One rollout. -> (time-major batch [T, B, ...], final_obs [B, ...],
        completed episode returns), all on the host."""
        with torch.no_grad():
            if self._env_state is None:
                self._env_state, self._obs = self.env.reset(
                    self._generator, self.num_envs, self.device)
                self._ep_ret = torch.zeros((self.num_envs,), device=self.device)
                self._on_lazy_reset()
            extra = self._augment_extra(dict(extra or {}))
            out = self._rollout(on_device(params, self.device), extra)
            traj = {k: to_numpy(v) for k, v in self._consume_rollout(out).items()}
            final_obs = self._obs
            if self.env_to_module is not None:
                # bootstrap values are computed on the module's view of obs
                final_obs = self.env_to_module(final_obs)
            final_obs = to_numpy(final_obs)
        completed = traj.pop("_completed_return")
        episode_returns = [float(r) for r in completed[~np.isnan(completed)]]
        self.metrics = {
            "episodes_this_iter": len(episode_returns),
            "env_steps_this_iter": self.rollout_length * self.num_envs,
        }
        return SampleBatch(traj), final_obs, episode_returns

    def stop(self) -> None:
        pass


class EnvRunnerGroup:
    """Fan out N runners. `remote=True` places each runner in a
    ``ray_tpu_torch`` actor (parity: EnvRunnerGroup's remote workers);
    otherwise inline. A remote runner on the card holds ``1/num_runners`` of
    a GPU, which makes it an in-process GPU actor beside the card; given
    ``device="cpu"`` it is a plain actor (a process worker)."""

    def __init__(
        self,
        env: DeviceEnv,
        module,
        *,
        policy: str = "actor_critic",
        num_runners: int = 1,
        num_envs_per_runner: int = 8,
        rollout_length: int = 128,
        seed: int = 0,
        remote: bool = False,
        device=None,
    ):
        self.device = default_device(device, "EnvRunnerGroup")
        self.remote = remote and num_runners > 0
        mk = lambda i: dict(  # noqa: E731
            policy=policy,
            num_envs=num_envs_per_runner,
            rollout_length=rollout_length,
            seed=seed + i,
            device=str(self.device),
        )
        if self.remote:
            import ray_tpu_torch

            RemoteRunner = ray_tpu_torch.remote(EnvRunner)
            if self.device.type == "cuda":
                RemoteRunner = RemoteRunner.options(num_gpus=1 / num_runners)
            self._runners = [
                RemoteRunner.remote(env, module, **mk(i)) for i in range(num_runners)
            ]
        else:
            self._runners = [
                EnvRunner(env, module, **mk(i)) for i in range(max(1, num_runners))
            ]

    def sample(self, params, extra: Optional[Dict[str, Any]] = None):
        """-> list of (batch, final_obs, episode_returns) per runner."""
        return self.sample_each(params, [extra] * len(self._runners))

    def sample_each(self, params, extras: List[Optional[Dict[str, Any]]]):
        """Sample with a PER-RUNNER extra dict (e.g. Ape-X's epsilon ladder).
        Remote runners overlap; inline runners go sequentially."""
        if self.remote:
            import ray_tpu_torch

            refs = [
                r.sample.remote(params, e) for r, e in zip(self._runners, extras)
            ]
            return ray_tpu_torch.get(refs)
        return [r.sample(params, e) for r, e in zip(self._runners, extras)]

    def sample_one(self, index: int, params, extra: Optional[Dict[str, Any]] = None):
        """Sample a single runner (A3C's interleaved schedule)."""
        runner = self._runners[index]
        if self.remote:
            import ray_tpu_torch

            return ray_tpu_torch.get(runner.sample.remote(params, extra))
        return runner.sample(params, extra)

    def stop(self) -> None:
        if self.remote:
            import ray_tpu_torch

            for r in self._runners:
                ray_tpu_torch.kill(r)

    @property
    def num_runners(self) -> int:
        return len(self._runners)
