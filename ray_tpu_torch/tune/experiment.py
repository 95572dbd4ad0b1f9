"""Tune public-surface tail: Trainable (the class API), Experiment /
ExperimentAnalysis / run_experiments, Stopper, progress reporters, the
trainable/env registries, with_parameters / with_resources, and the
scheduler/searcher string factories.

The port's copy of ``ray_tpu/tune/experiment.py``, whole; the env
registry waits for ``rllib/`` to read it.

Parity anchors: python/ray/tune/trainable/trainable.py (class API),
tune/experiment/experiment.py, tune/analysis/experiment_analysis.py,
tune/stopper/, tune/progress_reporter.py, tune/registry.py,
tune/trainable/util.py (with_parameters), tune/execution/placement_groups.py
(PlacementGroupFactory).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

from ray_tpu_torch.exceptions import RayTpuError
from ray_tpu_torch.tune.callback import Callback


class TuneError(RayTpuError):
    """Tune-layer failure (parity: tune.error.TuneError)."""


def dict_stop_met(stop: Optional[dict], result: dict) -> bool:
    """THE dict-stop policy ({"metric": threshold}, >= semantics) — one
    definition shared by the class-trainable adapter (exact, in-loop) and
    the controller (async, for function trainables) so the two can't
    drift."""
    return bool(stop) and any(k in result and result[k] >= v for k, v in stop.items())


# --------------------------------------------------------------------------
# Trainable: the class API
# --------------------------------------------------------------------------
class Trainable:
    """Subclass API: override ``setup``/``step`` (and optionally
    ``save_checkpoint``/``load_checkpoint``/``reset_config``/``cleanup``).
    The controller runs function trainables; ``as_function_trainable``
    adapts an instance-per-trial loop onto that path: construct, step until
    a stop signal, report every step's result through the session."""

    def __init__(self, config: Optional[dict] = None):
        self.config = dict(config or {})
        self._iteration = 0
        self.setup(self.config)

    # -- overridable surface ------------------------------------------
    def setup(self, config: dict) -> None:
        pass

    def step(self) -> dict:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[str]:
        return None

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        pass

    def reset_config(self, new_config: dict) -> bool:
        return False

    def cleanup(self) -> None:
        pass

    # -- driver surface ------------------------------------------------
    def train(self) -> dict:
        self._iteration += 1
        result = self.step() or {}
        result.setdefault("training_iteration", self._iteration)
        return result

    @property
    def iteration(self) -> int:
        return self._iteration

    def stop(self) -> None:
        self.cleanup()

    @classmethod
    def as_function_trainable(cls, stop: Optional[dict] = None) -> Callable:
        """The adapter the Tuner uses for class trainables: run train()
        in a loop, reporting each result; honor ``stop`` criteria and the
        session's stop request (how schedulers interrupt a trial)."""

        def fn(config: dict):
            from ray_tpu_torch.tune.session import report

            t = cls(config)
            try:
                while True:
                    # report() raises TrialInterrupt when a scheduler
                    # requested a stop — the cooperative interrupt point
                    result = t.train()
                    report(result)
                    if dict_stop_met(stop, result):
                        break
            finally:
                t.stop()

        fn.__name__ = cls.__name__
        # with_resources() on a class trainable stores the bundle on the
        # subclass; the adapter function must carry it to the controller.
        res = getattr(cls, "_tune_resources", None)
        if res:
            fn._tune_resources = dict(res)  # type: ignore[attr-defined]
        return fn


# --------------------------------------------------------------------------
# Stoppers
# --------------------------------------------------------------------------
class Stopper:
    """Decides per-result whether a trial (or the experiment) should stop
    (parity: tune/stopper/stopper.py)."""

    def __call__(self, trial_id: str, result: dict) -> bool:
        return False

    def stop_all(self) -> bool:
        return False


class MaximumIterationStopper(Stopper):
    def __init__(self, max_iter: int):
        self._max_iter = max_iter

    def __call__(self, trial_id, result):
        return result.get("training_iteration", 0) >= self._max_iter


class TimeoutStopper(Stopper):
    def __init__(self, timeout_s: float):
        self._deadline = time.monotonic() + timeout_s

    def stop_all(self):
        return time.monotonic() >= self._deadline


# --------------------------------------------------------------------------
# Experiment / analysis
# --------------------------------------------------------------------------
@dataclass
class Experiment:
    """A named experiment spec (parity: tune.Experiment) — the inputs
    ``run_experiments`` feeds one at a time into ``tune.run``."""

    name: str
    run: Union[Callable, type]
    config: Dict[str, Any] = field(default_factory=dict)
    num_samples: int = 1
    metric: Optional[str] = None
    mode: str = "max"
    stop: Optional[dict] = None


class ExperimentAnalysis:
    """Best-trial queries over finished results (parity:
    tune.ExperimentAnalysis — constructed here from a ResultGrid instead of
    re-parsing trial dirs: the grid already holds metrics/checkpoints)."""

    def __init__(self, result_grid, metric: Optional[str] = None, mode: str = "max"):
        self._grid = result_grid
        self.default_metric = metric
        self.default_mode = mode

    @property
    def results(self) -> List[Any]:
        return [self._grid[i] for i in range(len(self._grid))]

    def dataframe(self) -> List[Dict[str, Any]]:
        return self._grid.get_dataframe()

    def get_best_result(self, metric: Optional[str] = None, mode: Optional[str] = None):
        return self._grid.get_best_result(metric or self.default_metric, mode or self.default_mode)

    @property
    def best_result(self):
        return self.get_best_result()

    @property
    def best_config(self) -> Optional[dict]:
        best = self.get_best_result()
        return best.metrics.get("config") if best.metrics else None


def run_experiments(experiments: Union[Experiment, List[Experiment]]) -> Dict[str, Any]:
    """Run each experiment via tune.run (parity: tune.run_experiments);
    returns {name: ResultGrid}."""
    from ray_tpu_torch.tune.tuner import run as tune_run

    if isinstance(experiments, Experiment):
        experiments = [experiments]
    out = {}
    for exp in experiments:
        out[exp.name] = tune_run(
            exp.run,
            config=exp.config,
            num_samples=exp.num_samples,
            metric=exp.metric,
            mode=exp.mode,
            stop=exp.stop,
        )
    return out


# --------------------------------------------------------------------------
# Progress reporters
# --------------------------------------------------------------------------
class ProgressReporter(Callback):
    """Periodic experiment-progress output (parity:
    tune/progress_reporter.py).  Wired as a Tune Callback: the controller
    invokes ``on_trial_result``; ``should_report`` throttles."""

    def __init__(self, max_report_frequency: float = 5.0):
        self._freq = max_report_frequency
        self._last = 0.0
        self._rows: Dict[str, dict] = {}

    def should_report(self) -> bool:
        return time.monotonic() - self._last >= self._freq

    def report(self, trials_rows: List[str]) -> None:
        raise NotImplementedError

    # Callback-compatible hooks (duck-typed against tune.callback.Callback)
    def on_trial_result(self, trial, result: dict) -> None:
        self._rows[trial.trial_id] = {"status": trial.status, **{
            k: v for k, v in result.items() if isinstance(v, (int, float, str))
        }}
        if self.should_report():
            self._last = time.monotonic()
            lines = [
                f"  {tid}: {row}" for tid, row in sorted(self._rows.items())
            ]
            self.report([f"== Tune progress ({len(self._rows)} trials) =="] + lines)

    def on_trial_complete(self, trial) -> None:
        self._rows.pop(trial.trial_id, None)


class CLIReporter(ProgressReporter):
    def report(self, lines: List[str]) -> None:
        print("\n".join(lines), flush=True)


class JupyterNotebookReporter(CLIReporter):
    """In a notebook the output cell is replaced instead of appended when
    IPython is available; otherwise identical to CLIReporter."""

    def report(self, lines: List[str]) -> None:
        try:
            from IPython.display import clear_output

            clear_output(wait=True)
        except ImportError:
            pass
        super().report(lines)


# --------------------------------------------------------------------------
# Registries + wrappers
# --------------------------------------------------------------------------
_trainable_registry: Dict[str, Callable] = {}
_env_registry: Dict[str, Callable] = {}


def register_trainable(name: str, trainable: Callable) -> None:
    """(parity: tune.register_trainable) — Tuner/run accept the name."""
    _trainable_registry[name] = trainable


def get_trainable(name: str) -> Callable:
    if name not in _trainable_registry:
        raise TuneError(
            f"no trainable registered as {name!r}; register_trainable(name, fn) first"
        )
    return _trainable_registry[name]


def register_env(name: str, env_creator: Callable) -> None:
    """(parity: tune.register_env) — shared with RLlib's env resolution."""
    _env_registry[name] = env_creator


def get_env_creator(name: str) -> Optional[Callable]:
    return _env_registry.get(name)


def with_parameters(trainable: Callable, **params) -> Callable:
    """Bind large constant objects into a trainable OUTSIDE the search
    space (parity: tune.with_parameters — the reference stashes them in the
    object store; here the runtime's by-reference store makes a put+closure
    the same thing).

    Every trial gets the SAME objects: a CUDA tensor is stored as is, so
    all trials share its storage.  A trainable that updates a bound tensor
    in place (the port's train step does: ``make_train_step`` updates its
    state's tensors) changes it for every other trial; train a copy
    (``copy.deepcopy(state)``).  No copy is made here, as the JAX package
    makes none (its arrays are immutable)."""
    import ray_tpu_torch

    refs = {k: ray_tpu_torch.put(v) for k, v in params.items()}

    if isinstance(trainable, type) and issubclass(trainable, Trainable):
        class _Bound(trainable):  # type: ignore[misc,valid-type]
            def setup(self, config):
                import ray_tpu_torch as _rt

                bound = {k: _rt.get(r) for k, r in refs.items()}
                super().setup({**config, **bound})

        _Bound.__name__ = trainable.__name__
        return _Bound

    def fn(config: dict):
        import ray_tpu_torch as _rt

        bound = {k: _rt.get(r) for k, r in refs.items()}
        return trainable(config, **bound)

    fn.__name__ = getattr(trainable, "__name__", "with_parameters")
    return fn


def with_resources(trainable: Callable, resources: Union[dict, "PlacementGroupFactory"]) -> Callable:
    """Attach per-trial resource requirements (parity: tune.with_resources);
    the controller submits each trial's session actor with them.  Wraps —
    never mutates — so the caller's function stays resource-free and two
    with_resources() calls on one trainable can't leak into each other."""
    import functools

    if isinstance(resources, PlacementGroupFactory):
        resources = resources.head_bundle()

    if isinstance(trainable, type) and issubclass(trainable, Trainable):
        # A plain-function wrapper would hide the class from Tuner.fit's
        # issubclass adapter check, so the trial would construct the class
        # once (running only setup) and finish with zero steps.  Subclass
        # instead so the class-trainable path still fires.
        sub = type(trainable.__name__, (trainable,), {})
        sub._tune_resources = dict(resources)  # type: ignore[attr-defined]
        return sub

    @functools.wraps(trainable)
    def wrapped(config):
        return trainable(config)

    wrapped._tune_resources = dict(resources)  # type: ignore[attr-defined]
    return wrapped


class PlacementGroupFactory:
    """Per-trial bundle spec (parity: execution/placement_groups.py).  The
    first bundle is the trainable's own; extras are for its child workers."""

    def __init__(self, bundles: List[Dict[str, float]], strategy: str = "PACK"):
        if not bundles:
            raise ValueError("at least one bundle required")
        self.bundles = [dict(b) for b in bundles]
        self.strategy = strategy

    def head_bundle(self) -> Dict[str, float]:
        return dict(self.bundles[0])

    def required_resources(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for b in self.bundles:
            for k, v in b.items():
                out[k] = out.get(k, 0) + v
        return out


@dataclass
class ResumeConfig:
    """What to do with unfinished/errored trials when restoring an
    experiment (parity: tune.ResumeConfig)."""

    resume_unfinished: bool = True
    resume_errored: bool = False
    restart_errored: bool = False


# --------------------------------------------------------------------------
# string factories
# --------------------------------------------------------------------------
def create_scheduler(name: str, **kwargs):
    """Scheduler by name (parity: tune.create_scheduler)."""
    from ray_tpu_torch.tune import schedulers as S

    table = {
        "fifo": S.FIFOScheduler,
        "async_hyperband": S.AsyncHyperBandScheduler,
        "asha": S.AsyncHyperBandScheduler,
        "hyperband": S.HyperBandScheduler,
        "hb_bohb": S.HyperBandForBOHB,
        "median_stopping_rule": S.MedianStoppingRule,
        "pbt": S.PopulationBasedTraining,
        "pbt_replay": S.PopulationBasedTrainingReplay,
        "pb2": S.PB2,
        "resource_changing": S.ResourceChangingScheduler,
    }
    if name not in table:
        raise TuneError(f"unknown scheduler {name!r}; choose from {sorted(table)}")
    return table[name](**kwargs)


def create_searcher(name: str, **kwargs):
    """Searcher by name (parity: tune.create_searcher)."""
    from ray_tpu_torch.tune import search as S

    table = {
        "variant_generator": S.BasicVariantGenerator,
        "random": S.BasicVariantGenerator,
        "tpe": S.TPESearcher,
        "hyperopt": S.HyperOptSearch,
        "optuna": S.OptunaSearch,
        "bayesopt": S.BayesOptSearch,
        "ax": S.AxSearch,
    }
    if name not in table:
        raise TuneError(f"unknown searcher {name!r}; choose from {sorted(table)}")
    return table[name](**kwargs)
