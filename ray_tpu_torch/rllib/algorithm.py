"""Algorithm / AlgorithmConfig: the RL training loop and its configuration.

Parity: `rllib/algorithms/algorithm.py:213` (an `Algorithm` is a Tune
Trainable whose `train()` runs one iteration and returns a result dict) and
`rllib/algorithms/algorithm_config.py:117` (fluent configuration:
`.environment().env_runners().training().resources().build()`).

An algorithm runs on CUDA unless its config names another device with
``.resources(device=...)`` (the name RLlib gives it): ``build()`` raises
where there is no CUDA device and none was named. Checkpoints hold CPU
tensors, so one saved on the card restores on the CPU and the other way
round.
"""

from __future__ import annotations

import copy
import pickle
from collections import deque
from typing import Any, Dict, Optional

import numpy as np

import torch

from ray_tpu_torch.rllib.envs import DeviceEnv
from ray_tpu_torch.rllib.learner import to_device, to_tensor
from ray_tpu_torch.rllib.env_runner import to_numpy


class AlgorithmConfig:
    """Fluent configuration. Subclasses add algorithm-specific `training()`
    keys; `build()` instantiates the matching Algorithm."""

    algo_class = None  # set by subclasses

    def __init__(self):
        self.env: Optional[DeviceEnv] = None
        self.seed = 0
        # resources: None is CUDA (and raises at build() without it)
        self.device: Optional[str] = None
        # env runners
        self.num_env_runners = 1
        self.num_envs_per_runner = 8
        self.rollout_length = 128
        self.remote_runners = False
        # training
        self.lr = 3e-4
        self.gamma = 0.99
        self.train_batch_size = 1024
        self.max_grad_norm: Optional[float] = 0.5
        self.hidden = (64, 64)
        # evaluation (parity: AlgorithmConfig.evaluation)
        self.evaluation_interval: Optional[int] = None
        self.evaluation_duration = 10  # episodes per evaluation

    def environment(self, env) -> "AlgorithmConfig":
        # a string resolves through the shared tune registry
        # (tune.register_env — the reference routes RLlib env names the
        # same way, tune/registry.py)
        if isinstance(env, str):
            from ray_tpu_torch.tune.experiment import get_env_creator

            creator = get_env_creator(env)
            if creator is None:
                raise ValueError(
                    f"unknown env name {env!r}: call "
                    f"tune.register_env({env!r}, creator) first"
                )
            env = creator({})
        self.env = env
        return self

    def debugging(self, *, seed: int = 0) -> "AlgorithmConfig":
        self.seed = seed
        return self

    def evaluation(
        self,
        *,
        evaluation_interval: Optional[int] = None,
        evaluation_duration: Optional[int] = None,
    ) -> "AlgorithmConfig":
        """Periodic greedy evaluation during training (parity:
        AlgorithmConfig.evaluation — ``evaluation_interval`` in
        iterations; results nest under ``result["evaluation"]``)."""
        if evaluation_interval is not None:
            if evaluation_interval <= 0:
                raise ValueError("evaluation_interval must be a positive iteration count")
            self.evaluation_interval = evaluation_interval
        if evaluation_duration is not None:
            if evaluation_duration <= 0:
                raise ValueError("evaluation_duration must be a positive episode count")
            self.evaluation_duration = evaluation_duration
        return self

    def env_runners(
        self,
        *,
        num_env_runners: Optional[int] = None,
        num_envs_per_runner: Optional[int] = None,
        rollout_length: Optional[int] = None,
        remote: Optional[bool] = None,
    ) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_runner is not None:
            self.num_envs_per_runner = num_envs_per_runner
        if rollout_length is not None:
            self.rollout_length = rollout_length
        if remote is not None:
            self.remote_runners = remote
        return self

    def resources(self, *, device: Optional[str] = None) -> "AlgorithmConfig":
        """Where the algorithm's modules, learners and runners run (parity:
        AlgorithmConfig.resources). None is CUDA."""
        self.device = device
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown training key {k!r}")
            setattr(self, k, v)
        return self

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def build(self) -> "Algorithm":
        if self.env is None:
            raise ValueError("call .environment(env) before .build()")
        return self.algo_class(self)


class Algorithm:
    """Base training loop: iterations + metrics + checkpointing.

    Subclasses implement `setup()` (build runners/learner) and
    `training_step()` (one sample+update cycle returning learner stats).
    """

    def __init__(self, config: AlgorithmConfig):
        from ray_tpu_torch.models.common import default_device

        self.config = config
        self.device = default_device(config.device, type(self).__name__)
        self.iteration = 0
        self._total_env_steps = 0
        self._episode_returns = deque(maxlen=100)
        self.setup()

    # -- subclass hooks -----------------------------------------------------
    def setup(self) -> None:
        raise NotImplementedError

    def training_step(self) -> Dict[str, float]:
        raise NotImplementedError

    # -- public API ---------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        stats = self.training_step()
        self.iteration += 1
        returns = list(self._episode_returns)
        result = {
            "training_iteration": self.iteration,
            "num_env_steps_sampled_lifetime": self._total_env_steps,
            "env_runners": {
                "episode_return_mean": float(np.mean(returns)) if returns else np.nan,
                "episode_return_max": float(np.max(returns)) if returns else np.nan,
                "num_episodes": len(returns),
            },
            "learners": stats,
        }
        # flat aliases (the reference keeps legacy top-level keys)
        result["episode_return_mean"] = result["env_runners"]["episode_return_mean"]
        interval = getattr(self.config, "evaluation_interval", None)
        if interval and interval > 0 and self.iteration % interval == 0:
            try:
                ev = self.evaluate(
                    num_episodes=getattr(self.config, "evaluation_duration", 10)
                )
            except NotImplementedError as exc:
                # an algorithm without an inference module must not lose a
                # long run mid-training to a config oversight: warn once
                # and disable instead of crashing the trial
                import warnings

                warnings.warn(
                    f"evaluation_interval disabled: {exc}", RuntimeWarning,
                    stacklevel=2,
                )
                self.config.evaluation_interval = None
            else:
                # evaluate() wraps under "evaluation" — unwrap so the
                # result nests once (result["evaluation"]["episode_return_mean"])
                result["evaluation"] = ev.get("evaluation", ev)
        return result

    def _record_episodes(self, episode_returns, env_steps: int) -> None:
        self._episode_returns.extend(episode_returns)
        self._total_env_steps += env_steps

    def evaluate(self, num_episodes: int = 10) -> Dict[str, Any]:
        """Run the current policy GREEDILY on a fresh env set and report
        episode returns (parity: Algorithm.evaluate / evaluation_config
        with explore=False). Does not touch training state."""
        from ray_tpu_torch.rllib.env_runner import EnvRunner

        module = getattr(self, "module", None)
        # CQL keeps its learner as `self.learner` (singular); accept both
        learners = getattr(self, "learners", None) or getattr(self, "learner", None)
        if (
            module is None
            or not hasattr(module, "inference_action")
            or not hasattr(learners, "params")
        ):
            raise NotImplementedError(
                f"{type(self).__name__} has no inference module to evaluate"
            )
        cfg = self.config
        runner = getattr(self, "_eval_runner", None)
        if runner is None:
            # built once and cached, as in the JAX package
            runner = self._eval_runner = EnvRunner(
                cfg.env,
                module,
                policy="inference",
                num_envs=min(8, max(1, num_episodes)),
                rollout_length=cfg.env.max_episode_steps,
                seed=cfg.seed + 10_000,
                device=self.device,
            )
        # reset per call: same seed -> same episodes (deterministic evals)
        runner._generator.manual_seed(cfg.seed + 10_000)
        runner._env_state = None
        params = learners.params
        returns: list = []
        while len(returns) < num_episodes:
            _, _, ep_returns = runner.sample(params)
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

    def stop(self) -> None:
        runners = getattr(self, "runners", None)
        if runners is not None:
            runners.stop()

    # -- inference API (parity: Algorithm.compute_single_action /
    # compute_actions / get_module / get_policy / weights) ------------------
    def _learner_group(self):
        lg = getattr(self, "learners", None) or getattr(self, "learner", None)
        if lg is None and hasattr(self, "params"):
            return self  # DT/CRR-style algorithms hold params directly
        if lg is None:
            raise NotImplementedError(f"{type(self).__name__} has no learner group")
        return lg

    def get_module(self, module_id: Optional[str] = None):
        """The RLModule holding the trained policy (parity: get_module;
        single-module algorithms ignore ``module_id``)."""
        m = getattr(self, "module", None)
        if m is None:
            raise NotImplementedError(f"{type(self).__name__} exposes no RLModule")
        return m

    def get_policy(self, policy_id: Optional[str] = None):
        """New-stack parity: the RLModule IS the policy object."""
        return self.get_module(policy_id)

    def get_weights(self, policies: Optional[list] = None):
        """The current parameter pytree (parity: get_weights)."""
        return self._learner_group().params

    def set_weights(self, weights) -> None:
        lg = self._learner_group()
        target = getattr(lg, "learner", lg)  # LearnerGroup wraps one Learner
        target.params = to_device(weights, self.device)

    def compute_single_action(self, observation, *, explore: bool = False):
        """Action for ONE observation with the trained policy (parity:
        compute_single_action).  ``explore=False`` is the greedy
        forward_inference path; stochastic exploration belongs to the
        algorithm's own rollout machinery."""
        import numpy as np

        if explore:
            raise NotImplementedError(
                "compute_single_action(explore=True): use the algorithm's "
                "rollout path; inference here is greedy (reference "
                "forward_inference semantics)"
            )
        obs = np.asarray(observation)[None, ...]
        act = self.compute_actions(obs)
        a = act[0]
        return a.item() if getattr(a, "ndim", 1) == 0 else a

    def compute_actions(self, observations, *, explore: bool = False):
        """Greedy actions for a batch of observations (parity:
        compute_actions)."""
        import numpy as np

        if explore:
            raise NotImplementedError("see compute_single_action")
        module = self.get_module()
        if not hasattr(module, "inference_action"):
            raise NotImplementedError(
                f"{type(module).__name__} has no inference_action"
            )
        params = self._learner_group().params
        with torch.no_grad():
            obs = to_tensor(np.asarray(observations, np.float32), self.device)
            return to_numpy(module.inference_action(params, obs))

    # -- checkpointing (parity: Algorithm.save/restore/from_checkpoint) -----
    def get_state(self) -> Dict[str, Any]:
        return {
            "learner": self.learners.get_state(),
            "iteration": self.iteration,
            "total_env_steps": self._total_env_steps,
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        state = to_device(state, self.device)
        self.learners.set_state(state["learner"])
        self.iteration = state["iteration"]
        self._total_env_steps = state["total_env_steps"]

    # config attributes holding whole offline datasets — stripped from
    # checkpoints (a periodic save must not serialize multi-GB replay data)
    _HEAVY_CONFIG_ATTRS = ("offline_data",)

    def save(self, path: str) -> str:
        """Self-describing checkpoint: state + the pickled config, so
        :meth:`from_checkpoint` can rebuild without the caller re-supplying
        the algorithm class or its configuration.  Offline datasets on the
        config are NOT serialized; a revived offline algorithm carries its
        trained weights but needs fresh data to continue training."""
        cfg = self.config
        stripped = {
            a: getattr(cfg, a)
            for a in self._HEAVY_CONFIG_ATTRS
            if getattr(cfg, a, None) is not None
        }
        if stripped:
            # shallow copy, NOT cfg.copy() (deepcopy) — deepcopying would
            # duplicate the very multi-GB dataset the strip exists to avoid
            cfg = copy.copy(cfg)
            for a in stripped:
                setattr(cfg, a, None)
        with open(path, "wb") as f:
            pickle.dump(
                {
                    "__algo_ckpt__": 1,
                    "config": cfg,
                    "stripped_config_attrs": sorted(stripped),
                    "state": to_device(self.get_state(), "cpu"),
                },
                f,
            )
        return path

    def restore(self, path: str) -> None:
        with open(path, "rb") as f:
            blob = pickle.load(f)
        # accept both the self-describing format and a bare state dict
        self.set_state(blob["state"] if "__algo_ckpt__" in blob else blob)

    @classmethod
    def from_checkpoint(cls, path: str, config: Optional["AlgorithmConfig"] = None,
                        device: Optional[str] = None) -> "Algorithm":
        """Rebuild a trained algorithm from :meth:`save` output (parity:
        Algorithm.from_checkpoint).  Offline algorithms must pass ``config``
        carrying the dataset — checkpoints strip offline data.  ``device``
        replaces the config's (a checkpoint saved on the card revived on the
        CPU: ``device="cpu"``)."""
        with open(path, "rb") as f:
            blob = pickle.load(f)
        if "__algo_ckpt__" not in blob:
            raise ValueError(
                f"{path!r} is a bare state dict (pre-config checkpoint "
                "format); build the algorithm from its config and call "
                "restore(path) instead"
            )
        stripped = blob.get("stripped_config_attrs") or []
        if config is None and stripped:
            raise ValueError(
                f"checkpoint {path!r} stripped config attrs {stripped} "
                "(offline datasets are not serialized); pass config= with "
                "the data attached, or build manually and restore(path)"
            )
        config = config or blob["config"]
        if device is not None:
            config = copy.copy(config).resources(device=device)
        algo = config.build()
        algo.set_state(blob["state"])
        return algo

    # -- Trainable-protocol aliases (parity: Algorithm inherits Trainable) --
    def step(self) -> Dict[str, Any]:
        return self.train()

    def cleanup(self) -> None:
        self.stop()

    def save_checkpoint(self, checkpoint_dir: str) -> str:
        import os

        return self.save(os.path.join(checkpoint_dir, "algorithm_state.pkl"))

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        import os

        self.restore(os.path.join(checkpoint_dir, "algorithm_state.pkl"))

    # -- Tune integration ---------------------------------------------------
    @classmethod
    def as_trainable(cls, config: AlgorithmConfig, stop_iters: int = 10):
        """A Tune function-trainable running this algorithm (parity: passing
        an Algorithm class to Tuner)."""

        def trainable(tune_config: dict):
            from ray_tpu_torch.tune import session

            cfg = config.copy()
            for k, v in tune_config.items():
                if hasattr(cfg, k):
                    setattr(cfg, k, v)
            algo = cfg.build()
            try:
                for _ in range(stop_iters):
                    session.report(algo.train())
            finally:
                algo.stop()

        return trainable
