"""Trial schedulers: FIFO, ASHA, HyperBand, median stopping, PBT, PB2.

The port's copy of ``ray_tpu/tune/schedulers.py``, whole: the decisions,
the PBT exploit draws and PB2's numpy GP are the JAX package's draw for
draw (``random.Random`` and ``numpy.random.default_rng`` seeded alike).
``DistributeResources`` splits CPUs only; a trial's GPU share passes
through unchanged.

Parity: ``python/ray/tune/schedulers/`` — ``async_hyperband.py`` (ASHA),
``hb.py`` (HyperBand), ``median_stopping_rule.py``, ``pbt.py``, ``pb2.py``.  Decisions
are made per reported result: CONTINUE or STOP; PBT may also mutate a
trial's config and restart it from a peer's checkpoint (exploit/explore).
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Any, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


class TrialScheduler:
    def set_search_properties(self, metric: str, mode: str) -> None:
        self.metric = metric
        self.mode = mode

    def on_trial_result(self, trial, result: dict) -> str:
        return CONTINUE

    def on_trial_complete(self, trial, result: Optional[dict]) -> None:
        pass

    def choose_trial_to_run(self, pending: list) -> Optional[Any]:
        return pending[0] if pending else None


class FIFOScheduler(TrialScheduler):
    """Run every trial to completion in submission order."""


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA (parity: async_hyperband.py:AsyncHyperBandScheduler).

    Rungs at ``grace_period * reduction_factor**k``; at each rung a trial
    continues only if its metric is in the top ``1/reduction_factor``
    quantile of results recorded at that rung (asynchronous — no waiting
    for the full bracket).
    """

    def __init__(
        self,
        *,
        time_attr: str = "training_iteration",
        metric: Optional[str] = None,
        mode: str = "max",
        max_t: int = 100,
        grace_period: int = 1,
        reduction_factor: float = 4,
    ):
        self.time_attr = time_attr
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        # rung milestone -> recorded metric values; a trial is evaluated at
        # its FIRST result at-or-after each milestone (reference semantics —
        # exact equality would disable pruning for any coarser time_attr).
        self._rungs: Dict[int, List[float]] = defaultdict(list)
        self._rung_seen: Dict[int, set] = defaultdict(set)
        milestones = []
        t = grace_period
        while t < max_t:
            milestones.append(int(t))
            t *= reduction_factor
        self._milestones = milestones

    def on_trial_result(self, trial, result: dict) -> str:
        t = result.get(self.time_attr)
        value = result.get(self.metric)
        if t is None or value is None:
            return CONTINUE
        if self.mode == "min":
            value = -value
        decision = CONTINUE
        for milestone in self._milestones:
            if t >= milestone and trial.trial_id not in self._rung_seen[milestone]:
                self._rung_seen[milestone].add(trial.trial_id)
                rung = self._rungs[milestone]
                rung.append(value)
                if len(rung) >= self.rf:
                    cutoff = sorted(rung, reverse=True)[max(0, int(len(rung) / self.rf) - 1)]
                    if value < cutoff:
                        decision = STOP
        if t >= self.max_t:
            decision = STOP
        return decision


class HyperBandScheduler(AsyncHyperBandScheduler):
    """Synchronous HyperBand approximated by its asynchronous successor —
    the reference itself recommends ASHA over strict HyperBand for exactly
    the straggler reasons the async variant fixes."""


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose running-average metric falls below the median of
    completed averages at the same step (parity: median_stopping_rule.py)."""

    def __init__(self, *, time_attr: str = "training_iteration", metric: Optional[str] = None,
                 mode: str = "max", grace_period: int = 1, min_samples_required: int = 3):
        self.time_attr = time_attr
        self.metric = metric
        self.mode = mode
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._history: Dict[str, List[float]] = defaultdict(list)

    def on_trial_result(self, trial, result: dict) -> str:
        t = result.get(self.time_attr, 0)
        value = result.get(self.metric)
        if value is None:
            return CONTINUE
        if self.mode == "min":
            value = -value
        self._history[trial.trial_id].append(value)
        if t < self.grace_period:
            return CONTINUE
        means = [sum(v) / len(v) for k, v in self._history.items() if k != trial.trial_id and v]
        if len(means) < self.min_samples:
            return CONTINUE
        median = sorted(means)[len(means) // 2]
        my_mean = sum(self._history[trial.trial_id]) / len(self._history[trial.trial_id])
        return STOP if my_mean < median else CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (parity: pbt.py): every ``perturbation_interval`` steps, a trial
    in the bottom quantile clones the config+checkpoint of a top-quantile
    peer and perturbs hyperparameters (exploit + explore)."""

    def __init__(
        self,
        *,
        time_attr: str = "training_iteration",
        metric: Optional[str] = None,
        mode: str = "max",
        perturbation_interval: int = 4,
        hyperparam_mutations: Optional[Dict[str, Any]] = None,
        quantile_fraction: float = 0.25,
        resample_probability: float = 0.25,
        seed: Optional[int] = None,
    ):
        self.time_attr = time_attr
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_prob = resample_probability
        self.rng = random.Random(seed)
        self._latest: Dict[str, tuple] = {}  # trial_id -> (score, config, checkpoint)
        self._last_t: Dict[str, float] = {}  # trial_id -> latest reported time
        # every exploit decision, for PopulationBasedTrainingReplay
        # (parity: pbt.py policy logging to pbt_policy_*.txt)
        self.policy_log: List[Dict[str, Any]] = []
        # trial_id -> time of its last exploit (parity: pbt.py
        # last_perturbation_time): without this cooldown an exploited trial
        # that restarts from scratch re-crosses the t%interval boundary and
        # is exploited forever
        self._last_perturb: Dict[str, float] = {}

    def on_trial_result(self, trial, result: dict) -> str:
        t = result.get(self.time_attr, 0)
        value = result.get(self.metric)
        if value is None:
            return CONTINUE
        score = -value if self.mode == "min" else value
        self._latest[trial.trial_id] = (score, dict(trial.config), trial.latest_checkpoint)
        self._last_t[trial.trial_id] = t
        # Exploit/explore itself is initiated by the controller, which calls
        # exploit_target() at perturbation boundaries and restarts the trial.
        return CONTINUE

    def at_perturbation_boundary(self, result: dict) -> bool:
        t = result.get(self.time_attr, 0)
        return bool(t) and t % self.interval == 0

    # exploit/explore is driven by the controller calling this:
    def exploit_target(self, trial) -> Optional[tuple]:
        """If trial is bottom-quantile, return (new_config, donor_checkpoint)."""
        if len(self._latest) < 2 or trial.trial_id not in self._latest:
            return None
        t = self._last_t.get(trial.trial_id, 0)
        last = self._last_perturb.get(trial.trial_id)
        if last is not None and t - last < self.interval:
            return None  # cooling down since the previous exploit
        ranked = sorted(self._latest.items(), key=lambda kv: kv[1][0], reverse=True)
        n = len(ranked)
        k = max(1, int(n * self.quantile))
        bottom_ids = [tid for tid, _ in ranked[-k:]]
        if trial.trial_id not in bottom_ids:
            return None
        donor_id, (score, donor_cfg, donor_ckpt) = ranked[self.rng.randrange(k)]
        if donor_id == trial.trial_id:
            return None
        new_cfg = dict(donor_cfg)
        for key, spec in self.mutations.items():
            if self.rng.random() < self.resample_prob:
                new_cfg[key] = spec() if callable(spec) else self.rng.choice(list(spec))
            elif key in new_cfg and isinstance(new_cfg[key], (int, float)):
                factor = self.rng.choice([0.8, 1.2])
                new_cfg[key] = type(new_cfg[key])(new_cfg[key] * factor)
        self._last_perturb[trial.trial_id] = t
        self.policy_log.append(
            {"trial_id": trial.trial_id, "time": t, "config": dict(new_cfg)}
        )
        return new_cfg, donor_ckpt

    def save_policy(self, path: str, trial_id: Optional[str] = None) -> None:
        """Write the recorded exploit schedule as jsonl, optionally filtered
        to one trial — the input PopulationBasedTrainingReplay consumes."""
        import json

        with open(path, "w") as f:
            for row in self.policy_log:
                if trial_id is None or row["trial_id"] == trial_id:
                    f.write(json.dumps(row) + "\n")


class PB2(PopulationBasedTraining):
    """Population-Based Bandits (parity: ``pb2.py``).

    PBT's exploit step with a model-based explore step: instead of randomly
    perturbing hyperparameters, the exploited trial's new config maximizes a
    UCB acquisition on a Gaussian-process model of reward *change* as a
    function of (time, hyperparameters), fit to the whole population's
    history (Parker-Holder et al. 2020, "Provably Efficient Online
    Hyperparameter Optimization with Population-Based Bandits").

    The reference implementation requires GPy; this one is a self-contained
    numpy GP (RBF kernel, median-heuristic lengthscale, fixed noise), which
    is the whole model PB2 needs — the paper's time-varying kernel adds a
    forgetting term handled here by windowing the data to the most recent
    ``max_obs`` observations.

    Only continuous ``hyperparam_bounds`` are tuned by the GP (same
    restriction as the reference); any ``hyperparam_mutations`` keys passed
    through behave as in PBT.
    """

    def __init__(
        self,
        *,
        time_attr: str = "training_iteration",
        metric: Optional[str] = None,
        mode: str = "max",
        perturbation_interval: int = 4,
        hyperparam_bounds: Optional[Dict[str, Any]] = None,
        hyperparam_mutations: Optional[Dict[str, Any]] = None,
        quantile_fraction: float = 0.25,
        ucb_kappa: float = 2.0,
        max_obs: int = 256,
        candidates: int = 256,
        seed: Optional[int] = None,
    ):
        super().__init__(
            time_attr=time_attr,
            metric=metric,
            mode=mode,
            perturbation_interval=perturbation_interval,
            hyperparam_mutations=hyperparam_mutations,
            quantile_fraction=quantile_fraction,
            seed=seed,
        )
        if not hyperparam_bounds:
            raise ValueError("PB2 requires continuous hyperparam_bounds={key: [lo, hi]}")
        self.bounds = {
            k: (float(lo), float(hi)) for k, (lo, hi) in hyperparam_bounds.items()
        }
        self.kappa = ucb_kappa
        self.max_obs = max_obs
        self.n_candidates = candidates
        # rows: (t, [bounded hyperparams in sorted-key order], reward-rate)
        self._obs: List[tuple] = []
        self._window_start: Dict[str, tuple] = {}  # trial_id -> (t, score)

    # ------------------------------------------------------------- data
    def on_trial_result(self, trial, result: dict) -> str:
        decision = super().on_trial_result(trial, result)
        t = result.get(self.time_attr, 0)
        value = result.get(self.metric)
        if value is None or not self.at_perturbation_boundary(result):
            return decision
        score = -value if self.mode == "min" else value
        start = self._window_start.get(trial.trial_id)
        if start is not None and t > start[0]:
            xs = [float(trial.config.get(k, lo)) for k, (lo, _) in sorted(self.bounds.items())]
            # reward RATE over the window: invariant to window length
            y = (score - start[1]) / (t - start[0])
            self._obs.append((float(t), xs, y))
            if len(self._obs) > self.max_obs:
                self._obs = self._obs[-self.max_obs:]
        self._window_start[trial.trial_id] = (t, score)
        return decision

    # ---------------------------------------------------------- explore
    def exploit_target(self, trial) -> Optional[tuple]:
        out = super().exploit_target(trial)
        if out is None:
            return None
        new_cfg, donor_ckpt = out
        for k, v in self._select_bounded(new_cfg).items():
            new_cfg[k] = v
        # keep the policy log pointing at the config the trial will actually
        # train with (super() appended the pre-GP donor config)
        if self.policy_log and self.policy_log[-1]["trial_id"] == trial.trial_id:
            self.policy_log[-1]["config"] = dict(new_cfg)
        # the exploited trial jumps to the donor's checkpoint: its next
        # score delta is dominated by the swap, not the new config — drop
        # the open observation window so the GP never ingests that jump
        self._window_start.pop(trial.trial_id, None)
        return new_cfg, donor_ckpt

    def _select_bounded(self, base_cfg: dict) -> Dict[str, float]:
        import numpy as np

        keys = sorted(self.bounds)
        lows = np.array([self.bounds[k][0] for k in keys])
        highs = np.array([self.bounds[k][1] for k in keys])
        rng = np.random.default_rng(self.rng.randrange(2**31))
        if len(self._obs) < 4:
            sample = lows + rng.random(len(keys)) * (highs - lows)
            return dict(zip(keys, sample.tolist()))

        t_max = max(row[0] for row in self._obs) or 1.0
        X = np.array(
            [[row[0] / t_max] + [
                (row[1][i] - lows[i]) / max(highs[i] - lows[i], 1e-12)
                for i in range(len(keys))
            ] for row in self._obs]
        )
        y = np.array([row[2] for row in self._obs], dtype=float)
        y_std = y.std() or 1.0
        y_n = (y - y.mean()) / y_std

        # median-heuristic RBF lengthscale over the observed inputs
        d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
        med = np.median(d2[d2 > 0]) if (d2 > 0).any() else 1.0
        ls2 = max(med, 1e-6)
        K = np.exp(-d2 / (2 * ls2)) + 1e-4 * np.eye(len(X))
        try:
            L = np.linalg.cholesky(K)
        except np.linalg.LinAlgError:
            L = np.linalg.cholesky(K + 1e-2 * np.eye(len(X)))
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, y_n))

        # candidates at the NEXT window (t=1 in normalized time)
        cand = rng.random((self.n_candidates, len(keys)))
        Xc = np.concatenate([np.ones((self.n_candidates, 1)), cand], axis=1)
        d2c = ((Xc[:, None, :] - X[None, :, :]) ** 2).sum(-1)
        Kc = np.exp(-d2c / (2 * ls2))
        mu = Kc @ alpha
        v = np.linalg.solve(L, Kc.T)
        var = np.maximum(1.0 - (v**2).sum(0), 1e-12)
        ucb = mu + self.kappa * np.sqrt(var)
        best = cand[int(np.argmax(ucb))]
        chosen = lows + best * (highs - lows)
        return dict(zip(keys, chosen.tolist()))


# canonical alias (parity: async_hyperband.py ASHAScheduler = AsyncHyperBand)
ASHAScheduler = AsyncHyperBandScheduler


class HyperBandForBOHB(HyperBandScheduler):
    """HyperBand bracket scheduler for BOHB (parity: ``hb_bohb.py``).

    The reference variant differs from plain HyperBand in feeding paused
    trials back to the TuneBOHB searcher; our searcher protocol reports
    every result to the search algorithm already, so the bracket behavior
    is inherited unchanged.  Pair with ``TuneBOHB`` (gated on ConfigSpace,
    ``tune/search.py``)."""


class PopulationBasedTrainingReplay(PopulationBasedTraining):
    """Replay one trial's recorded PBT schedule (parity: ``pbt.py``
    ``PopulationBasedTrainingReplay``).

    Takes the jsonl policy written by ``PopulationBasedTraining
    .save_policy`` (rows ``{"time": t, "config": {...}}``) — or an in-memory
    list of ``(time, config)`` — and re-applies each config switch when the
    single replayed trial crosses the recorded time, without any population
    or metric logic."""

    def __init__(self, policy, *, time_attr: str = "training_iteration"):
        super().__init__(time_attr=time_attr, metric=None, mode="max")
        if isinstance(policy, str):
            import json

            with open(policy) as f:
                rows = [json.loads(line) for line in f if line.strip()]
            self._policy = [(r["time"], dict(r["config"])) for r in rows]
        else:
            self._policy = [(t, dict(cfg)) for t, cfg in policy]
        self._policy.sort(key=lambda tc: tc[0])
        self._next = 0
        # replay is a SINGLE-trial scheduler: the first trial to report
        # becomes the replay target; siblings run untouched (and warned
        # about) instead of racing each other for policy steps
        self._target_trial: Optional[str] = None
        self._warned: set = set()

    def on_trial_result(self, trial, result: dict) -> str:
        if self._target_trial is None:
            self._target_trial = trial.trial_id
        elif trial.trial_id != self._target_trial and trial.trial_id not in self._warned:
            self._warned.add(trial.trial_id)
            import warnings

            warnings.warn(
                "PopulationBasedTrainingReplay replays ONE trial's schedule; "
                f"trial {trial.trial_id} runs with its original config "
                f"(replay target: {self._target_trial}). Use num_samples=1.",
                RuntimeWarning,
                stacklevel=2,
            )
        self._last_t[trial.trial_id] = result.get(self.time_attr, 0)
        return CONTINUE

    def at_perturbation_boundary(self, result: dict) -> bool:
        return (
            self._next < len(self._policy)
            and result.get(self.time_attr, 0) >= self._policy[self._next][0]
        )

    def exploit_target(self, trial):
        if self._next >= len(self._policy):
            return None
        if self._target_trial is not None and trial.trial_id != self._target_trial:
            return None
        t = self._last_t.get(trial.trial_id, 0)
        if t < self._policy[self._next][0]:
            return None
        _, cfg = self._policy[self._next]
        self._next += 1
        # continue from the trial's own latest checkpoint with the recorded
        # config — replay has no donor population
        return dict(cfg), trial.latest_checkpoint


class DistributeResources:
    """Even-split resource policy (parity:
    ``resource_changing_scheduler.py`` ``DistributeResources``): every
    running trial gets an equal share of the cluster's CPUs, never less
    than its base request."""

    def __init__(self, base_resources: Optional[Dict[str, float]] = None):
        self.base = dict(base_resources or {"CPU": 1})

    def __call__(self, tune_controller, trial, result, scheduler) -> Optional[Dict[str, float]]:
        import ray_tpu_torch

        try:
            total = ray_tpu_torch.cluster_resources().get("CPU", 0)
        except Exception:
            return None
        running = 1
        declared: Dict[str, float] = {}
        if tune_controller is not None:
            running = max(
                1, sum(1 for t in tune_controller.trials if t.status == "RUNNING")
            )
            declared = dict(
                getattr(tune_controller.trainable, "_tune_resources", None) or {}
            )
        share = int(total // running) if total else 0
        # the floor is the trial's DECLARED request (with_resources), raised
        # to the policy base — a reallocation must never shrink a trial
        # below what it asked for, and non-CPU reservations pass through
        out = {**declared, **{k: v for k, v in self.base.items() if k not in declared}}
        floor = max(float(self.base.get("CPU", 1)), float(declared.get("CPU", 0) or 0))
        out["CPU"] = max(floor, float(share or floor))
        return out


class ResourceChangingScheduler(TrialScheduler):
    """Reallocate per-trial resources as the experiment evolves (parity:
    ``resource_changing_scheduler.py``).

    Wraps a base scheduler for trial decisions; after every report the
    allocation function proposes a new resource bundle, stored on the trial
    and applied at its next (re)start — the reference restarts trials from
    checkpoint to apply mid-flight, which here happens naturally at PBT
    exploits, failure retries, and fresh trial launches."""

    def __init__(self, base_scheduler: Optional[TrialScheduler] = None,
                 resources_allocation_function=None):
        self.base_scheduler = base_scheduler or FIFOScheduler()
        self.alloc = resources_allocation_function or DistributeResources()
        self._controller = None  # injected by the controller when it starts

    def set_search_properties(self, metric: str, mode: str) -> None:
        super().set_search_properties(metric, mode)
        self.base_scheduler.set_search_properties(metric, mode)

    def on_trial_result(self, trial, result: dict) -> str:
        decision = self.base_scheduler.on_trial_result(trial, result)
        new = self.alloc(self._controller, trial, result, self)
        if new:
            trial.resources = dict(new)
        return decision

    def on_trial_complete(self, trial, result: Optional[dict]) -> None:
        self.base_scheduler.on_trial_complete(trial, result)

    def choose_trial_to_run(self, pending: list):
        return self.base_scheduler.choose_trial_to_run(pending)

    # PBT-family passthrough: the controller drives exploit/explore through
    # these two hooks — without forwarding them, wrapping PBT in a
    # ResourceChangingScheduler would silently disable exploitation
    def at_perturbation_boundary(self, result: dict) -> bool:
        hook = getattr(self.base_scheduler, "at_perturbation_boundary", None)
        return bool(hook(result)) if hook else False

    def exploit_target(self, trial) -> Optional[tuple]:
        hook = getattr(self.base_scheduler, "exploit_target", None)
        return hook(trial) if hook else None
