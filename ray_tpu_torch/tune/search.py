"""Search spaces and search algorithms.

The port's copy of ``ray_tpu/tune/search.py``: the same domains, draws
(``random.Random``, so a seeded search suggests the JAX package's configs
value for value) and searchers.  ``OptunaSearch`` is the real wrapper when
``optuna`` can be found, found without importing it.

Parity: ``python/ray/tune/search/`` — sample-space primitives
(``tune.choice/uniform/loguniform/randint/grid_search``), the default
``BasicVariantGenerator`` (grid × random, ``basic_variant.py``), and a
``Searcher`` interface for smarter algorithms (the reference plugs Optuna/
HyperOpt/Ax here; we ship the in-tree ones re-implemented).
"""

from __future__ import annotations

import itertools
import math
import random
from typing import Any, Callable, Dict, List, Optional, Tuple


# ------------------------------------------------------------ sample spaces
class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Uniform(Domain):
    def __init__(self, lower, upper):
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return rng.uniform(self.lower, self.upper)


class LogUniform(Domain):
    def __init__(self, lower, upper):
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return math.exp(rng.uniform(math.log(self.lower), math.log(self.upper)))


class RandInt(Domain):
    def __init__(self, lower, upper):
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return rng.randrange(self.lower, self.upper)


class QUniform(Domain):
    def __init__(self, lower, upper, q):
        self.lower, self.upper, self.q = lower, upper, q

    def sample(self, rng):
        return round(rng.uniform(self.lower, self.upper) / self.q) * self.q


class Normal(Domain):
    def __init__(self, mean, sd):
        self.mean, self.sd = mean, sd

    def sample(self, rng):
        return rng.gauss(self.mean, self.sd)


class QNormal(Normal):
    def __init__(self, mean, sd, q):
        super().__init__(mean, sd)
        self.q = q

    def sample(self, rng):
        return round(super().sample(rng) / self.q) * self.q


class QLogUniform(LogUniform):
    def __init__(self, lower, upper, q):
        super().__init__(lower, upper)
        self.q = q

    def sample(self, rng):
        # quantization clips BOTH ends: rounding up past `upper` would hand
        # trials values outside the declared space (reference clips too)
        return min(self.upper, max(self.lower, round(super().sample(rng) / self.q) * self.q))


class LogRandInt(Domain):
    def __init__(self, lower, upper, base=10):
        self.lower, self.upper, self.base = lower, upper, base

    def sample(self, rng):
        lo = math.log(self.lower, self.base)
        hi = math.log(self.upper, self.base)
        return min(self.upper - 1, int(self.base ** rng.uniform(lo, hi)))


class QLogRandInt(LogRandInt):
    def __init__(self, lower, upper, q, base=10):
        super().__init__(lower, upper, base)
        self.q = q

    def sample(self, rng):
        return min(self.upper, max(self.lower, int(round(super().sample(rng) / self.q) * self.q)))


class QRandInt(RandInt):
    def __init__(self, lower, upper, q):
        super().__init__(lower, upper)
        self.q = q

    def sample(self, rng):
        return min(self.upper, max(self.lower, int(round(super().sample(rng) / self.q) * self.q)))


class GridSearch:
    def __init__(self, values):
        self.values = list(values)


def choice(categories) -> Categorical:
    return Categorical(categories)


def uniform(lower, upper) -> Uniform:
    return Uniform(lower, upper)


def loguniform(lower, upper) -> LogUniform:
    return LogUniform(lower, upper)


def randint(lower, upper) -> RandInt:
    return RandInt(lower, upper)


def quniform(lower, upper, q) -> QUniform:
    return QUniform(lower, upper, q)


def grid_search(values) -> GridSearch:
    return GridSearch(values)


def randn(mean: float = 0.0, sd: float = 1.0) -> Normal:
    return Normal(mean, sd)


def qrandn(mean: float, sd: float, q: float) -> QNormal:
    return QNormal(mean, sd, q)


def qrandint(lower: int, upper: int, q: int) -> QRandInt:
    return QRandInt(lower, upper, q)


def qloguniform(lower: float, upper: float, q: float) -> QLogUniform:
    return QLogUniform(lower, upper, q)


def lograndint(lower: int, upper: int, base: float = 10) -> LogRandInt:
    return LogRandInt(lower, upper, base)


def qlograndint(lower: int, upper: int, q: int, base: float = 10) -> QLogRandInt:
    return QLogRandInt(lower, upper, q, base)


def sample_from(fn: Callable[[dict], Any]):
    return _SampleFrom(fn)


class _SampleFrom(Domain):
    def __init__(self, fn):
        self.fn = fn

    def sample(self, rng):  # resolved against the partial config later
        return self.fn


# ----------------------------------------------------------------- searcher
def _sample_config(param_space: Dict[str, Any], rng: random.Random) -> dict:
    """One random draw from a param space (shared by BasicVariantGenerator
    and TPESearcher; grid dims collapse to a uniform choice here)."""
    cfg = {}
    for k, v in param_space.items():
        if isinstance(v, GridSearch):
            cfg[k] = rng.choice(v.values)
        elif isinstance(v, _SampleFrom):
            cfg[k] = v  # resolve after other keys are fixed
        elif isinstance(v, Domain):
            cfg[k] = v.sample(rng)
        else:
            cfg[k] = v
    for k, v in list(cfg.items()):
        if isinstance(v, _SampleFrom):
            cfg[k] = v.fn(cfg)
    return cfg


class Searcher:
    """Interface (parity: search/searcher.py Searcher)."""

    def __init__(self, metric: Optional[str] = None, mode: str = "max"):
        self.metric = metric
        self.mode = mode

    def suggest(self, trial_id: str) -> Optional[dict]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        pass

    def on_trial_complete(self, trial_id: str, result: Optional[dict] = None, error: bool = False) -> None:
        pass

    def on_restore(self, trial_id: str, config: dict, last_result: Optional[dict] = None, completed: bool = False) -> None:
        """Rebuild state for ONE restored trial (Tuner.restore): advance
        deterministic cursors past it and, when completed, absorb its real
        (config, result) pair.  Default: no-op — a stateless searcher needs
        nothing.  NOT suggest(): a model-based searcher must pair the
        restored result with the trial's actual config, never a fresh
        draw."""


class BasicVariantGenerator(Searcher):
    """Grid × random expansion (parity: basic_variant.py).

    Grid dimensions multiply; every grid combination is emitted
    ``num_samples`` times with random dimensions re-sampled each time.
    """

    def __init__(self, param_space: Dict[str, Any], num_samples: int = 1, seed: Optional[int] = None, **kw):
        super().__init__(**kw)
        self.param_space = param_space
        self.num_samples = num_samples
        self.rng = random.Random(seed)
        self._configs = list(self._expand())
        self._next = 0

    def _expand(self):
        grid_keys = [k for k, v in self.param_space.items() if isinstance(v, GridSearch)]
        grid_values = [self.param_space[k].values for k in grid_keys]
        combos = list(itertools.product(*grid_values)) if grid_keys else [()]
        for _ in range(self.num_samples):
            for combo in combos:
                cfg = {}
                for k, v in self.param_space.items():
                    if isinstance(v, GridSearch):
                        cfg[k] = combo[grid_keys.index(k)]
                    elif isinstance(v, _SampleFrom):
                        cfg[k] = v  # resolve after other keys are fixed
                    elif isinstance(v, Domain):
                        cfg[k] = v.sample(self.rng)
                    else:
                        cfg[k] = v
                for k, v in list(cfg.items()):
                    if isinstance(v, _SampleFrom):
                        cfg[k] = v.fn(cfg)
                yield cfg

    @property
    def total_trials(self) -> int:
        return len(self._configs)

    def suggest(self, trial_id: str) -> Optional[dict]:
        if self._next >= len(self._configs):
            return None
        cfg = self._configs[self._next]
        self._next += 1
        return cfg

    def on_restore(self, trial_id: str, config: dict, last_result: Optional[dict] = None, completed: bool = False) -> None:
        # the variant list is deterministic (same space, same seed):
        # advancing the cursor resumes the grid at the next point
        self._next = min(self._next + 1, len(self._configs))


# --------------------------------------------------------------------------
# Model-based search: native TPE (what the reference delegates to
# Optuna/HyperOpt — search/optuna/, search/hyperopt/). Tree-structured
# Parzen Estimator: split observed trials into good/bad by quantile gamma,
# sample candidates from the good distribution, rank by the density ratio
# l(x)/g(x). Supports Uniform/LogUniform/RandInt/QUniform/Categorical.
# --------------------------------------------------------------------------
class TPESearcher(Searcher):
    def __init__(
        self,
        param_space: Dict[str, Any],
        metric: Optional[str] = None,
        mode: str = "max",
        n_startup_trials: int = 8,
        n_candidates: int = 24,
        gamma: float = 0.25,
        seed: Optional[int] = None,
    ):
        super().__init__(metric=metric, mode=mode)
        self.param_space = param_space
        self.n_startup_trials = n_startup_trials
        self.n_candidates = n_candidates
        self.gamma = gamma
        self.rng = random.Random(seed)
        self._live: Dict[str, dict] = {}
        self._observed: List[Tuple[dict, float]] = []

    # -- observation -------------------------------------------------------
    def on_trial_complete(self, trial_id: str, result: Optional[dict] = None, error: bool = False) -> None:
        cfg = self._live.pop(trial_id, None)
        if cfg is None or error or not result or self.metric not in result:
            return
        score = float(result[self.metric])
        if self.mode == "min":
            score = -score
        self._observed.append((cfg, score))

    def on_restore(self, trial_id: str, config: dict, last_result: Optional[dict] = None, completed: bool = False) -> None:
        if not completed:
            # the resumed trial will complete later: register its REAL
            # config so on_trial_complete can pair it with the result
            self._live[trial_id] = dict(config)
            return
        if not last_result or self.metric not in last_result:
            return
        score = float(last_result[self.metric])
        if self.mode == "min":
            score = -score
        # the REAL config pairs with the restored metric (a discarded
        # suggest() would pair it with a fresh random draw)
        self._observed.append((dict(config), score))

    # -- sampling ----------------------------------------------------------
    def _random_config(self) -> dict:
        return _sample_config(self.param_space, self.rng)

    def _to_unit(self, key: str, value) -> Optional[float]:
        """Map a sampled value into [0,1] for kernel density work."""
        dom = self.param_space.get(key)
        if isinstance(dom, (Uniform, QUniform)):
            lo, hi = dom.lower, dom.upper
            return (float(value) - lo) / (hi - lo) if hi > lo else 0.5
        if isinstance(dom, LogUniform):
            import math as _m

            lo, hi = _m.log(dom.lower), _m.log(dom.upper)
            return (_m.log(float(value)) - lo) / (hi - lo) if hi > lo else 0.5
        if isinstance(dom, RandInt):
            lo, hi = dom.lower, dom.upper
            return (float(value) - lo) / max(hi - 1 - lo, 1)
        return None  # categorical / fixed handled separately

    def _density(self, group: List[dict], cfg: dict) -> float:
        """Parzen estimate of cfg's log-density under a trial group."""
        if not group:
            return 0.0
        import math as _m

        bw = max(0.08, 1.0 / max(len(group), 1) ** 0.5)
        logp = 0.0
        for key in self.param_space:
            dom = self.param_space.get(key)
            if isinstance(dom, (Categorical, GridSearch)):
                values = dom.categories if isinstance(dom, Categorical) else dom.values
                # smoothed categorical frequency
                counts = sum(1 for g in group if g.get(key) == cfg.get(key))
                logp += _m.log((counts + 1.0) / (len(group) + len(values)))
                continue
            u = self._to_unit(key, cfg.get(key))
            if u is None:
                continue
            dens = 0.0
            for g in group:
                gu = self._to_unit(key, g.get(key))
                if gu is None:
                    continue
                dens += _m.exp(-0.5 * ((u - gu) / bw) ** 2)
            dens = dens / (len(group) * bw * _m.sqrt(2 * _m.pi)) + 1e-12
            logp += _m.log(dens)
        return logp

    def suggest(self, trial_id: str) -> Optional[dict]:
        if len(self._observed) < self.n_startup_trials:
            cfg = self._random_config()
        else:
            ranked = sorted(self._observed, key=lambda t: t[1], reverse=True)
            n_good = max(1, int(len(ranked) * self.gamma))
            good = [c for c, _ in ranked[:n_good]]
            bad = [c for c, _ in ranked[n_good:]] or good
            candidates = [self._random_config() for _ in range(self.n_candidates)]
            cfg = max(candidates, key=lambda c: self._density(good, c) - self._density(bad, c))
        self._live[trial_id] = cfg
        return cfg


class ConcurrencyLimiter(Searcher):
    """Caps in-flight suggestions (parity: search/concurrency_limiter.py)."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        super().__init__(metric=searcher.metric, mode=searcher.mode)
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    def suggest(self, trial_id: str) -> Optional[dict]:
        if len(self._live) >= self.max_concurrent:
            return None  # controller retries later
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None:
            self._live.add(trial_id)
        return cfg

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id: str, result: Optional[dict] = None, error: bool = False) -> None:
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)

    def on_restore(self, trial_id: str, config: dict, last_result: Optional[dict] = None, completed: bool = False) -> None:
        # restored trials don't occupy a concurrency slot; the cap applies
        # to LIVE suggestions only — delegate straight to the inner searcher
        self.searcher.on_restore(trial_id, config, last_result, completed)


class Repeater(Searcher):
    """Repeats each suggestion N times and reports the averaged metric to
    the wrapped searcher (parity: search/repeater.py — noise-robust
    evaluation)."""

    def on_restore(self, trial_id: str, config: dict, last_result: Optional[dict] = None, completed: bool = False) -> None:
        # advance the inner searcher past restored trials (cursors move,
        # completed pairs absorb); the repeat-group averaging bookkeeping
        # itself is not reconstructed — a partially-restored group reports
        # its post-restore repeats only
        self.searcher.on_restore(trial_id, config, last_result, completed)

    def __init__(self, searcher: Searcher, repeat: int):
        super().__init__(metric=searcher.metric, mode=searcher.mode)
        self.searcher = searcher
        self.repeat = repeat
        self._groups: Dict[str, dict] = {}      # group key -> config
        self._results: Dict[str, List[dict]] = {}
        self._trial_group: Dict[str, str] = {}
        self._counter = 0

    def suggest(self, trial_id: str) -> Optional[dict]:
        group, idx = divmod(self._counter, self.repeat)
        key = f"group_{group}"
        if idx == 0:
            cfg = self.searcher.suggest(key)
            if cfg is None:
                return None
            self._groups[key] = cfg
            self._results[key] = []
        cfg = self._groups.get(key)
        if cfg is None:
            return None
        self._counter += 1
        self._trial_group[trial_id] = key
        return cfg

    def on_trial_complete(self, trial_id: str, result: Optional[dict] = None, error: bool = False) -> None:
        key = self._trial_group.pop(trial_id, None)
        if key is None:
            return
        bucket = self._results.setdefault(key, [])
        # errored repeats count toward group completion but contribute no
        # observation — otherwise one failed repeat stalls the group (and
        # the wrapped searcher's live-trial accounting) forever
        bucket.append(result if (result and not error) else None)
        if len(bucket) >= self.repeat:
            rs = [r for r in self._results.pop(key) if r is not None]
            if not rs:
                self.searcher.on_trial_complete(key, None, error=True)
                return
            metric = self.metric or self.searcher.metric
            vals = [r[metric] for r in rs if metric in r]
            avg = dict(rs[-1])
            if vals:
                avg[metric] = sum(vals) / len(vals)
            self.searcher.on_trial_complete(key, avg, error=False)


def _external_searcher_stub(name: str, dist: str):
    class _Missing(Searcher):
        def __init__(self, *a, **kw):
            raise ImportError(
                f"{name} wraps the external '{dist}' package, which is not "
                f"installed in this environment. Use TPESearcher (native "
                f"model-based search) or BasicVariantGenerator instead."
            )

    _Missing.__name__ = name
    return _Missing


class _OptunaSearch(Searcher):
    """Ask/tell wrapper over an optuna Study (parity:
    python/ray/tune/search/optuna/optuna_search.py — the one external
    searcher users actually reach for).  Domain classes translate onto
    optuna's suggest surface; quantized domains round the suggestion back
    onto their grid (optuna has no q-variants)."""

    def __init__(self, space: Optional[Dict[str, Any]] = None,
                 metric: Optional[str] = None, mode: str = "max",
                 sampler=None, seed: Optional[int] = None, study=None,
                 param_space: Optional[Dict[str, Any]] = None, **kw):
        super().__init__(metric=metric, mode=mode)
        import optuna

        self._optuna = optuna
        self.param_space = space if space is not None else (param_space or {})
        optuna.logging.set_verbosity(optuna.logging.WARNING)
        # Study creation is LAZY (first suggest): the Tuner back-fills
        # metric/mode onto a custom searcher AFTER construction
        # (tuner.py), so an eager study would bake the wrong direction.
        self._study = study
        self._sampler = sampler
        self._seed = seed
        self._live: Dict[str, Any] = {}  # trial_id -> optuna trial

    @property
    def study(self):
        if self._study is None:
            self._study = self._optuna.create_study(
                direction="maximize" if self.mode == "max" else "minimize",
                sampler=self._sampler or self._optuna.samplers.TPESampler(seed=self._seed),
            )
        return self._study

    def on_restore(self, trial_id: str, config: dict, last_result: Optional[dict] = None, completed: bool = False) -> None:
        # optuna trials cannot be reconstructed from (config, result) pairs
        # through the ask/tell surface alone — say so once instead of
        # silently pairing restored results with fresh asks
        import warnings

        if not getattr(type(self), "_warned_restore", False):
            type(self)._warned_restore = True
            warnings.warn(
                "OptunaSearch cannot rebuild study history from a restored "
                "experiment; the resumed search starts with a fresh study "
                "(completed trials keep their recorded results).",
                RuntimeWarning,
                stacklevel=2,
            )

    def _suggest_param(self, ot, name: str, dom) -> Any:
        if isinstance(dom, GridSearch):
            return ot.suggest_categorical(name, list(dom.values))
        if isinstance(dom, Categorical):
            return ot.suggest_categorical(name, list(dom.categories))
        if isinstance(dom, (QLogUniform,)):
            v = ot.suggest_float(name, dom.lower, dom.upper, log=True)
            return min(dom.upper, max(dom.lower, round(v / dom.q) * dom.q))
        if isinstance(dom, LogUniform):
            return ot.suggest_float(name, dom.lower, dom.upper, log=True)
        if isinstance(dom, QUniform):
            return ot.suggest_float(name, dom.lower, dom.upper, step=dom.q)
        if isinstance(dom, (QNormal, Normal)):
            # optuna has no unbounded normal: sample ±4sd bounded
            v = ot.suggest_float(name, dom.mean - 4 * dom.sd, dom.mean + 4 * dom.sd)
            if isinstance(dom, QNormal):
                v = round(v / dom.q) * dom.q
            return v
        if isinstance(dom, Uniform):
            return ot.suggest_float(name, dom.lower, dom.upper)
        if isinstance(dom, (QLogRandInt, LogRandInt)):
            v = ot.suggest_int(name, dom.lower, max(dom.lower, dom.upper - 1), log=True)
            if isinstance(dom, QLogRandInt):
                v = min(dom.upper, max(dom.lower, int(round(v / dom.q) * dom.q)))
            return v
        if isinstance(dom, QRandInt):
            return ot.suggest_int(name, dom.lower, dom.upper, step=dom.q)
        if isinstance(dom, RandInt):
            # our randint upper bound is EXCLUSIVE; optuna's is inclusive
            return ot.suggest_int(name, dom.lower, dom.upper - 1)
        if isinstance(dom, _SampleFrom):
            raise ValueError(
                "tune.sample_from is not translatable to optuna's ask/tell "
                "surface; use explicit Domain classes with OptunaSearch"
            )
        return dom  # constant

    def suggest(self, trial_id: str) -> Optional[dict]:
        ot = self.study.ask()
        self._live[trial_id] = ot
        cfg = {}
        for name, dom in self.param_space.items():
            cfg[name] = self._suggest_param(ot, name, dom)
        return cfg

    def on_trial_complete(self, trial_id: str, result: Optional[dict] = None, error: bool = False) -> None:
        ot = self._live.pop(trial_id, None)
        if ot is None:
            return
        state = self._optuna.trial.TrialState.COMPLETE
        value = None
        if error or not result or self.metric not in result:
            state = self._optuna.trial.TrialState.FAIL
        else:
            value = result[self.metric]
        self.study.tell(ot, value, state=state)


def _make_optuna_search():
    # whether optuna is there, without importing it: importing Tune loads
    # no optional framework (the study is made at the first suggest)
    import importlib.util
    import sys

    try:
        present = "optuna" in sys.modules or importlib.util.find_spec("optuna") is not None
    except (ImportError, ValueError):
        present = False
    return _OptunaSearch if present else _external_searcher_stub("OptunaSearch", "optuna")


# Parity markers for the reference's external-library searchers (gated:
# the libraries are not vendored; the native TPESearcher covers the
# model-based-search role).  OptunaSearch is REAL when optuna is
# importable — ask/tell translation above — and an actionable stub when
# not.
OptunaSearch = _make_optuna_search()
HyperOptSearch = _external_searcher_stub("HyperOptSearch", "hyperopt")
AxSearch = _external_searcher_stub("AxSearch", "ax-platform")
BayesOptSearch = _external_searcher_stub("BayesOptSearch", "bayesian-optimization")
TuneBOHB = _external_searcher_stub("TuneBOHB", "ConfigSpace + hpbandster")
