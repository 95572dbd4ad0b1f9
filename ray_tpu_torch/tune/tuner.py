"""Tuner: the user-facing experiment API.

The port's copy of ``ray_tpu/tune/tuner.py``, whole.  Train-on-Tune runs a
trainer through ``BaseTrainer.as_trainable``, which reports the trainer's
terminal metrics once, as in the JAX package: a scheduler cannot stop such
a trial early.  Give a trainer's trials no GPU of their own
(``with_resources``): its ranks take their share of the card.

Parity: ``python/ray/tune/tuner.py`` (``Tuner(trainable, param_space,
tune_config, run_config).fit() -> ResultGrid``) and ``tune.run``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

from ray_tpu_torch.train.config import RunConfig
from ray_tpu_torch.train.trainer import BaseTrainer, Result
from ray_tpu_torch.tune.controller import ERROR, TERMINATED, Trial, TuneController
from ray_tpu_torch.tune.schedulers import FIFOScheduler, TrialScheduler
from ray_tpu_torch.tune.search import BasicVariantGenerator, Searcher


@dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int = 4
    search_alg: Optional[Searcher] = None
    scheduler: Optional[TrialScheduler] = None


class ResultGrid:
    """Parity: ray.tune.ResultGrid."""

    def __init__(self, trials: List[Trial], metric: Optional[str], mode: str):
        self._trials = trials
        self._metric = metric
        self._mode = mode

    def __len__(self) -> int:
        return len(self._trials)

    def __getitem__(self, i: int) -> Result:
        return self._to_result(self._trials[i])

    def _to_result(self, t: Trial) -> Result:
        metrics = dict(t.last_result)
        # the trial's config rides with its metrics so analysis surfaces
        # (ExperimentAnalysis.best_config) can answer "which config won"
        metrics.setdefault("config", t.config)
        return Result(
            metrics=metrics,
            checkpoint=t.latest_checkpoint,
            path=t.trial_dir,
            metrics_dataframe=t.history,
            error=t.error,
            config=t.config,
        )

    @property
    def errors(self) -> List[BaseException]:
        return [t.error for t in self._trials if t.error is not None]

    def get_best_result(self, metric: Optional[str] = None, mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("metric required (set TuneConfig.metric or pass metric=)")
        candidates = [t for t in self._trials if metric in t.last_result]
        if not candidates:
            raise RuntimeError("no trial reported the metric " + metric)
        best = (max if mode == "max" else min)(candidates, key=lambda t: t.last_result[metric])
        return self._to_result(best)

    def get_dataframe(self) -> List[Dict[str, Any]]:
        return [dict(t.last_result, trial_id=t.trial_id, status=t.status) for t in self._trials]


class Tuner:
    def __init__(
        self,
        trainable: Union[Callable, BaseTrainer],
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
    ):
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self._restore_dir: Optional[str] = None

    # ------------------------------------------------------ resume (parity:
    # Tuner.restore / Tuner.can_restore — tuner.py in the reference)
    @classmethod
    def can_restore(cls, path: str) -> bool:
        """True when ``path`` holds a resumable experiment state."""
        from ray_tpu_torch.tune.controller import TuneController

        return os.path.exists(os.path.join(path, TuneController.STATE_FILE))

    @classmethod
    def restore(
        cls,
        path: str,
        trainable: Union[Callable, "BaseTrainer"],
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
    ) -> "Tuner":
        """Resume an interrupted experiment from its directory.

        Finished trials return with their recorded results (and feed the
        searcher's history); unfinished ones re-run from their latest
        checkpoint.  The trainable is re-supplied by the caller — same as
        the reference, which cannot always serialize it.  Searcher
        internals beyond fed-back results are not restored.
        """
        if not cls.can_restore(path):
            raise ValueError(
                f"{path!r} has no experiment state to restore "
                "(expected experiment_state.pkl written by a prior fit)"
            )
        if param_space is None and (tune_config is None or tune_config.search_alg is None):
            raise ValueError(
                "Tuner.restore needs the original param_space (or a "
                "tune_config with its search_alg): without it, grid points "
                "not yet started before the interrupt would silently "
                "disappear from the resumed experiment"
            )
        tuner = cls(
            trainable,
            param_space=param_space,
            tune_config=tune_config,
            run_config=run_config,
        )
        tuner._restore_dir = path
        return tuner

    def fit(self) -> ResultGrid:
        trainable = self.trainable
        param_space = self.param_space
        if isinstance(trainable, str):
            # registry name (tune.register_trainable)
            from ray_tpu_torch.tune.experiment import get_trainable

            trainable = get_trainable(trainable)
        from ray_tpu_torch.tune.experiment import Trainable as _ClassTrainable

        if isinstance(trainable, type) and issubclass(trainable, _ClassTrainable):
            # dict stops are ALSO checked inside the adapter loop: the
            # push-model report buffer means the controller's async check
            # alone lets a fast trial overshoot the exact iteration bound
            # (both sides share dict_stop_met, so the policy can't drift)
            stop = self.run_config.stop if isinstance(self.run_config.stop, dict) else None
            trainable = trainable.as_function_trainable(stop=stop)
        if isinstance(trainable, BaseTrainer):
            # Train-on-Tune: the search space targets train_loop_config.
            param_space = dict(param_space.get("train_loop_config", param_space))
            trainable = self.trainable.as_trainable()
        custom_searcher = self.tune_config.search_alg is not None
        searcher = self.tune_config.search_alg or BasicVariantGenerator(
            param_space, num_samples=self.tune_config.num_samples
        )
        # TuneConfig.metric/mode flow into a custom searcher that wasn't
        # given its own — a model-based searcher with metric=None would
        # silently degrade to random search
        if custom_searcher and searcher.metric is None:
            searcher.metric = self.tune_config.metric
            searcher.mode = self.tune_config.mode
        exp_dir = None
        if self.run_config.storage_path:
            exp_dir = os.path.join(self.run_config.storage_path, self.run_config.name or "tune_experiment")
        if self._restore_dir:
            exp_dir = self._restore_dir
        controller = TuneController(
            trainable,
            searcher=searcher,
            scheduler=self.tune_config.scheduler,
            metric=self.tune_config.metric,
            mode=self.tune_config.mode,
            max_concurrent_trials=self.tune_config.max_concurrent_trials,
            experiment_dir=exp_dir,
            max_failures_per_trial=self.run_config.failure_config.max_failures,
            callbacks=self.run_config.callbacks,
            num_samples=self.tune_config.num_samples if custom_searcher else None,
            stop=self.run_config.stop,
        )
        if self._restore_dir:
            import pickle

            with open(os.path.join(self._restore_dir, TuneController.STATE_FILE), "rb") as f:
                controller.preseed(pickle.load(f)["trials"])
        trials = controller.run()
        self._results = ResultGrid(trials, self.tune_config.metric, self.tune_config.mode)
        return self._results

    def get_results(self) -> ResultGrid:
        """The ResultGrid of the completed fit (parity: Tuner.get_results)."""
        results = getattr(self, "_results", None)
        if results is None:
            raise RuntimeError("Tuner.get_results(): call fit() first")
        return results


def run(
    trainable: Callable,
    *,
    config: Optional[Dict[str, Any]] = None,
    num_samples: int = 1,
    metric: Optional[str] = None,
    mode: str = "max",
    scheduler: Optional[TrialScheduler] = None,
    search_alg: Optional[Searcher] = None,
    max_concurrent_trials: int = 4,
    stop=None,
    **kwargs,
) -> ResultGrid:
    """Functional entry point (parity: tune.run)."""
    return Tuner(
        trainable,
        param_space=config,
        tune_config=TuneConfig(
            metric=metric,
            mode=mode,
            num_samples=num_samples,
            scheduler=scheduler,
            search_alg=search_alg,
            max_concurrent_trials=max_concurrent_trials,
        ),
        run_config=RunConfig(stop=stop) if stop is not None else None,
    ).fit()
