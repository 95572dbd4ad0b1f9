"""The port's Tune (``ray_tpu_torch.tune``) against the JAX package's, case
by case of ``tests/test_tune.py`` and ``tests/test_tune_api_tail.py``.

Each scenario runs once in each package on the same inputs, all of a
package's scenarios under one runtime (``init(num_cpus=8)``, as the JAX
test modules share one).  Seeded draws, searcher suggestions and scheduler
decisions (driven result by result, so no thread's timing enters them)
must be equal value for value; runs whose outcome depends on the trials'
timing compare the properties the JAX tests assert.  Train-on-Tune runs a
2-layer, d_model 32 decoder's train step through ``JaxTrainer`` and
through ``DeviceTrainer(device="cpu")`` from the same initial state (the
JAX side's flash attention in Pallas interpret mode, f32): losses within
1e-4 relative.  Here the env registry is held alone;
``test_register_env_reaches_rllib`` itself runs against the port's
``rllib`` in ``tests/test_torch_rllib_algos.py``.
"""

import contextlib
import importlib
import io
import os
import pickle
import random
import sys
import time
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

PACKAGES = ("ray_tpu", "ray_tpu_torch")
LOSS_RTOL = 1e-4


class _Side:
    def __init__(self, name):
        self.name = name
        self.is_jax = name == "ray_tpu"
        self.rt = importlib.import_module(name)
        self.tune = importlib.import_module(name + ".tune")
        self.search = importlib.import_module(name + ".tune.search")
        self.ctrl = importlib.import_module(name + ".tune.controller")
        self.session = importlib.import_module(name + ".tune.session")
        self.experiment = importlib.import_module(name + ".tune.experiment")
        self.train = importlib.import_module(name + ".train")

    def trainer(self, loop, **kw):
        if self.is_jax:
            return self.train.JaxTrainer(loop, **kw)
        return self.train.DeviceTrainer(loop, device="cpu", **kw)


class _FakeTrial:
    def __init__(self, tid, config):
        self.trial_id = tid
        self.config = config
        self.latest_checkpoint = None


# --------------------------------------------------------------------------
# search spaces and searchers (no trial runs)
# --------------------------------------------------------------------------
def sc_grid_expansion(s, tmp):
    tune = s.tune
    gen = tune.BasicVariantGenerator(
        {"a": tune.grid_search([1, 2, 3]), "b": tune.grid_search([10, 20]), "c": 5},
        num_samples=2)
    return {"total": gen.total_trials, "configs": [gen.suggest(str(i)) for i in range(13)]}


def sc_seeded_random_draws(s, tmp):
    tune = s.tune
    gen = tune.BasicVariantGenerator(
        {"u": tune.uniform(0, 1), "lu": tune.loguniform(1e-4, 1e-1),
         "c": tune.choice(["x", "y"]), "ri": tune.randint(0, 10),
         "q": tune.quniform(0, 1, 0.25), "g": tune.grid_search([1, 2]),
         "sf": tune.sample_from(lambda cfg: cfg["ri"] * 2)},
        num_samples=5, seed=0)
    return [gen.suggest(str(i)) for i in range(11)]


def sc_sampling_distributions(s, tmp):
    tune = s.tune
    rng = random.Random(0)
    out = [tune.randn(0, 2).sample(rng), tune.qrandn(5, 1, 0.5).sample(rng)]
    for _ in range(50):
        out += [tune.lograndint(1, 1000).sample(rng), tune.qrandint(10, 100, 10).sample(rng),
                tune.qloguniform(0.001, 1.0, 0.001).sample(rng),
                tune.qlograndint(1, 100, 5).sample(rng)]
    return out


def sc_q_samplers_clip_to_bounds(s, tmp):
    tune = s.tune
    rng = random.Random(1)
    out = []
    for _ in range(300):
        out += [tune.qloguniform(1, 130, 50).sample(rng), tune.qlograndint(1, 130, 50).sample(rng),
                tune.qrandint(10, 95, 10).sample(rng)]
    return out


def _bowl(cfg):
    return (cfg["x"] - 0.7) ** 2 + (np.log10(cfg["lr"]) + 2.0) ** 2 + (cfg["opt"] != "adam") * 0.1 \
        + 0.01 * cfg["n"]


def sc_tpe_suggestions(s, tmp):
    tune = s.tune
    space = {"x": tune.uniform(-2, 2), "lr": tune.loguniform(1e-4, 1e-1),
             "opt": tune.choice(["adam", "sgd"]), "n": tune.randint(1, 8)}
    tpe = tune.TPESearcher(space, metric="loss", mode="min", n_startup_trials=6, seed=0)
    out = []
    for i in range(20):
        cfg = tpe.suggest(f"t{i}")
        out.append(cfg)
        tpe.on_trial_complete(f"t{i}", {"loss": float(_bowl(cfg))})
    return out


def sc_tpe_on_restore(s, tmp):
    tpe = s.search.TPESearcher({"x": s.tune.uniform(0.0, 1.0)}, metric="score", mode="max")
    tpe.on_restore("done", {"x": 0.7}, {"score": 1.0}, completed=True)
    first = tpe._observed[-1]
    tpe.on_restore("inflight", {"x": 0.2}, {}, completed=False)
    live = dict(tpe._live["inflight"])
    tpe.on_trial_complete("inflight", {"score": 2.0})
    return {"first": first, "live": live, "last": tpe._observed[-1]}


def sc_concurrency_limiter(s, tmp):
    inner = s.search.BasicVariantGenerator({"x": s.tune.uniform(0, 1)}, num_samples=6, seed=3)
    lim = s.search.ConcurrencyLimiter(inner, max_concurrent=2)
    out = [lim.suggest("a"), lim.suggest("b"), lim.suggest("c")]
    lim.on_trial_complete("a", {"x": 1})
    out += [lim.suggest("c"), lim.suggest("d")]
    return out


def sc_repeater(s, tmp):
    class Fixed(s.search.Searcher):
        def __init__(self):
            super().__init__(metric="score", mode="max")
            self.completed = []

        def suggest(self, trial_id):
            return {"c": len(self.completed)}

        def on_trial_complete(self, trial_id, result=None, error=False):
            self.completed.append((trial_id, result, error))

    inner = Fixed()
    rep = s.search.Repeater(inner, repeat=3)
    ids = [f"t{i}" for i in range(6)]
    sugg = [rep.suggest(t) for t in ids[:3]]
    for t, score in zip(ids[:3], [1.0, 2.0, 3.0]):
        rep.on_trial_complete(t, {"score": score})
    sugg += [rep.suggest(t) for t in ids[3:]]
    rep.on_trial_complete("t3", None, error=True)
    rep.on_trial_complete("t4", None, error=True)
    rep.on_trial_complete("t5", None, error=True)
    return {"suggested": sugg, "completed": inner.completed}


def _fake_optuna():
    """The JAX tests' optuna lookalike (``tests/test_tune_api_tail.py``)."""
    mod = types.ModuleType("optuna")

    class _Trial:
        def __init__(self, rng):
            self.params = {}
            self._rng = rng

        def suggest_float(self, name, low, high, log=False, step=None):
            import math
            if log:
                v = math.exp(self._rng.uniform(math.log(low), math.log(high)))
            elif step:
                v = round(self._rng.uniform(low, high) / step) * step
            else:
                v = self._rng.uniform(low, high)
            self.params[name] = v
            return v

        def suggest_int(self, name, low, high, log=False, step=1):
            v = self._rng.randrange(low, high + 1, step if step else 1)
            self.params[name] = v
            return v

        def suggest_categorical(self, name, choices):
            v = self._rng.choice(list(choices))
            self.params[name] = v
            return v

    class _Study:
        def __init__(self, direction, sampler):
            self.direction = direction
            self.tells = []
            self._rng = random.Random(0)

        def ask(self):
            return _Trial(self._rng)

        def tell(self, trial, value, state=None):
            self.tells.append((trial, value, state))

    mod.create_study = lambda direction, sampler=None: _Study(direction, sampler)
    mod.samplers = types.SimpleNamespace(TPESampler=lambda seed=None: ("tpe", seed))
    mod.trial = types.SimpleNamespace(
        TrialState=types.SimpleNamespace(COMPLETE="COMPLETE", FAIL="FAIL"))
    mod.logging = types.SimpleNamespace(set_verbosity=lambda *_: None, WARNING=30)
    return mod


@contextlib.contextmanager
def _module(name, mod):
    had = name in sys.modules
    old = sys.modules.get(name)
    sys.modules[name] = mod
    try:
        yield mod
    finally:
        if had:
            sys.modules[name] = old
        else:
            sys.modules.pop(name, None)


def sc_optuna_translation_and_telling(s, tmp):
    tune = s.tune
    with _module("optuna", _fake_optuna()):
        space = {"lr": tune.loguniform(1e-5, 1e-1), "bs": tune.choice([16, 32, 64]),
                 "n": tune.randint(1, 10), "d": tune.uniform(0.0, 1.0), "fixed": 7,
                 "q": tune.quniform(0, 1, 0.25), "qi": tune.qrandint(10, 100, 10),
                 "nrm": tune.qrandn(0, 1, 0.5), "lri": tune.qlograndint(1, 100, 5)}
        srch = s.search._OptunaSearch(space, metric="score", mode="max")
        cfg = srch.suggest("t1")
        srch.on_trial_complete("t1", {"score": 0.5})
        cfg2 = srch.suggest("t2")
        srch.on_trial_complete("t2", None, error=True)
        resolved = s.search._make_optuna_search().__name__
        return {"cfg": cfg, "cfg2": cfg2, "direction": srch._study.direction,
                "tells": [(v, st) for _, v, st in srch._study.tells], "resolved": resolved}


def sc_optuna_drives_tune_run(s, tmp):
    tune = s.tune
    with _module("optuna", _fake_optuna()):
        def trainable(config):
            tune.report({"score": -(config["x"] - 0.7) ** 2})

        srch = s.search._OptunaSearch({"x": tune.uniform(0.0, 1.0)}, metric="score", mode="max")
        grid = tune.run(trainable, search_alg=srch, num_samples=6, metric="score", mode="max")
        return {"n": len(grid), "tells": len(srch._study.tells),
                "best": "score" in grid.get_best_result().metrics,
                "xs": sorted(grid[i].config["x"] for i in range(len(grid)))}


def sc_external_searchers_gate_with_importerror(s, tmp):
    out = {}
    for name in ("OptunaSearch", "HyperOptSearch", "AxSearch", "BayesOptSearch", "TuneBOHB"):
        try:
            getattr(s.tune, name)()
            out[name] = None
        except ImportError as exc:
            out[name] = str(exc)
    out["resolved"] = s.search._make_optuna_search().__name__
    return out


# --------------------------------------------------------------------------
# schedulers, driven result by result
# --------------------------------------------------------------------------
def _drive(sched, trials, steps, score):
    """Round-robin reports ``1..steps`` of each trial until the scheduler
    stops it; every decision, in order."""
    out, alive = [], list(trials)
    for i in range(1, steps + 1):
        for t in list(alive):
            d = sched.on_trial_result(t, {"training_iteration": i, "score": score(t, i)})
            out.append((t.trial_id, i, d))
            if d == "STOP":
                alive.remove(t)
    return out


QUALITY = [20.0, 10.0, 5.0, 2.0, 0.05, 0.02, 0.01, 0.005]


def sc_asha_decisions(s, tmp):
    sched = s.tune.AsyncHyperBandScheduler(metric="score", mode="max", max_t=16,
                                           grace_period=2, reduction_factor=2)
    trials = [_FakeTrial(f"t{k}", {"q": q}) for k, q in enumerate(QUALITY)]
    return _drive(sched, trials, 16, lambda t, i: t.config["q"] * i)


def sc_hyperband_decisions(s, tmp):
    out = {}
    for name in ("HyperBandScheduler", "HyperBandForBOHB", "ASHAScheduler"):
        sched = getattr(s.tune, name)(metric="score", mode="min", max_t=9, grace_period=1,
                                      reduction_factor=3)
        trials = [_FakeTrial(f"t{k}", {"q": q}) for k, q in enumerate(QUALITY)]
        out[name] = _drive(sched, trials, 9, lambda t, i: t.config["q"] / i)
    out["alias"] = s.tune.ASHAScheduler is s.tune.AsyncHyperBandScheduler
    out["bohb_is_asha"] = issubclass(s.tune.HyperBandForBOHB, s.tune.AsyncHyperBandScheduler)
    return out


def sc_median_stopping_decisions(s, tmp):
    sched = s.tune.MedianStoppingRule(metric="score", mode="max", grace_period=2)
    trials = [_FakeTrial(f"t{k}", {"q": q}) for k, q in enumerate([1.0, 1.0, 1.0, 0.0, 0.5])]
    return _drive(sched, trials, 8, lambda t, i: t.config["q"] * (1 + 0.1 * i))


def _population(s, sched, lrs, steps=8):
    """A PBT population driven as the controller drives it: each result,
    then ``exploit_target`` at a perturbation boundary; an exploited trial
    takes the new config."""
    trials = [_FakeTrial(f"t{k}", {"lr": lr}) for k, lr in enumerate(lrs)]
    score = {t.trial_id: 0.0 for t in trials}
    log = []
    for i in range(1, steps + 1):
        for t in trials:
            score[t.trial_id] += t.config["lr"]
            r = {"training_iteration": i, "score": score[t.trial_id]}
            sched.on_trial_result(t, r)
            if sched.at_perturbation_boundary(r):
                out = sched.exploit_target(t)
                if out is not None:
                    t.config = dict(out[0])
                    log.append((t.trial_id, i, dict(out[0])))
    return log


def sc_pbt_exploit_log(s, tmp):
    sched = s.tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=2,
        hyperparam_mutations={"lr": [0.01, 0.1, 1.0]}, seed=0)
    log = _population(s, sched, [0.01, 0.1, 1.0, 0.5, 0.05, 0.2])
    return {"log": log, "policy": sched.policy_log}


def sc_pbt_exploit_cooldown(s, tmp):
    sched = s.tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=4,
        hyperparam_mutations={"lr": [0.1, 1.0]}, seed=0)
    weak, strong = _FakeTrial("weak", {"lr": 0.1}), _FakeTrial("strong", {"lr": 1.0})
    sched.on_trial_result(strong, {"training_iteration": 8, "score": 8.0})
    sched.on_trial_result(weak, {"training_iteration": 4, "score": 0.4})
    out = [sched.exploit_target(weak)]
    sched.on_trial_result(weak, {"training_iteration": 4, "score": 0.4})
    out.append(sched.exploit_target(weak))
    sched.on_trial_result(weak, {"training_iteration": 8, "score": 0.8})
    out.append(sched.exploit_target(weak))
    return [None if o is None else o[0] for o in out]


def sc_pb2_exploit_log(s, tmp):
    sched = s.tune.PB2(metric="score", mode="max", perturbation_interval=2,
                       hyperparam_bounds={"lr": [0.01, 1.0]}, seed=0)
    log = _population(s, sched, [0.01, 0.1, 1.0, 0.5, 0.05, 0.2], steps=12)
    return {"log": log, "policy": sched.policy_log, "obs": sched._obs}


def sc_pb2_model(s, tmp):
    PB2 = s.tune.PB2
    out = {}
    sched = PB2(metric="score", mode="max", perturbation_interval=2,
                hyperparam_bounds={"lr": [0.0, 1.0]}, seed=0)
    t = _FakeTrial("t1", {"lr": 0.5})
    for i, score in [(2, 4.0), (4, 10.0)]:
        sched.on_trial_result(t, {"training_iteration": i, "score": score})
    out["obs"] = sched._obs
    cold = PB2(metric="score", mode="max",
               hyperparam_bounds={"lr": [0.1, 0.9], "wd": [1e-5, 1e-3]}, seed=1)
    out["cold"] = cold._select_bounded({})
    gp = PB2(metric="score", mode="max", hyperparam_bounds={"lr": [0.0, 1.0]}, seed=0,
             ucb_kappa=1.0)
    for i in range(24):
        lr = (i % 8) / 8.0
        gp._obs.append((float(i + 1), [lr], lr * 10.0))
    out["picks"] = [gp._select_bounded({})["lr"] for _ in range(5)]
    try:
        PB2(metric="score", mode="max")
        out["no_bounds"] = None
    except ValueError as exc:
        out["no_bounds"] = str(exc)
    win = PB2(metric="score", mode="max", perturbation_interval=4,
              hyperparam_bounds={"lr": [0.0, 1.0]}, seed=0)
    weak, strong = _FakeTrial("weak", {"lr": 0.1}), _FakeTrial("strong", {"lr": 0.9})
    win.on_trial_result(strong, {"training_iteration": 8, "score": 8.0})
    win.on_trial_result(weak, {"training_iteration": 4, "score": 0.4})
    opened = "weak" in win._window_start
    new_cfg, _ = win.exploit_target(weak)
    still = "weak" in win._window_start
    n_obs = len(win._obs)
    win.on_trial_result(weak, {"training_iteration": 8, "score": 8.5})
    out["window"] = [opened, still, new_cfg,
                     win.policy_log[-1]["config"], len(win._obs) - n_obs]
    return out


def sc_pbt_policy_and_replay(s, tmp):
    sched = s.tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=4,
        hyperparam_mutations={"lr": [0.9]}, resample_probability=1.0, seed=0)
    weak, strong = _FakeTrial("weak", {"lr": 0.1}), _FakeTrial("strong", {"lr": 1.0})
    sched.on_trial_result(strong, {"training_iteration": 8, "score": 8.0})
    sched.on_trial_result(weak, {"training_iteration": 4, "score": 0.4})
    sched.exploit_target(weak)
    path = os.path.join(tmp, "policy.jsonl")
    sched.save_policy(path, "weak")
    with open(path) as f:
        text = f.read()
    replay = s.tune.PopulationBasedTrainingReplay(path)
    bound = s.tune.PopulationBasedTrainingReplay([(4, {"lr": 0.5})])
    a, b = _FakeTrial("a", {"lr": 0.1}), _FakeTrial("b", {"lr": 0.2})
    bound.on_trial_result(a, {"training_iteration": 2, "score": 1.0})
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        bound.on_trial_result(b, {"training_iteration": 4, "score": 1.0})
    sibling = bound.exploit_target(b)
    bound.on_trial_result(a, {"training_iteration": 4, "score": 2.0})
    target = bound.exploit_target(a)
    return {"file": text, "policy": replay._policy,
            "warned": [str(x.message) for x in w if issubclass(x.category, RuntimeWarning)],
            "sibling": sibling, "target": target[0], "next": bound._next}


def sc_resource_changing_scheduler(s, tmp):
    tune = s.tune
    seen = []

    def alloc(controller, trial, result, scheduler):
        seen.append(result["training_iteration"])
        return {"CPU": 2.0}

    sched = tune.ResourceChangingScheduler(resources_allocation_function=alloc)
    t = _FakeTrial("t1", {"x": 1})
    t.status = "RUNNING"
    decision = sched.on_trial_result(t, {"training_iteration": 1, "score": 1.0})
    pbt = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=4,
        hyperparam_mutations={"lr": [0.9]}, resample_probability=1.0, seed=0)
    wrapper = tune.ResourceChangingScheduler(base_scheduler=pbt)
    weak, strong = _FakeTrial("weak", {"lr": 0.1}), _FakeTrial("strong", {"lr": 1.0})
    wrapper.on_trial_result(strong, {"training_iteration": 8, "score": 8.0})
    wrapper.on_trial_result(weak, {"training_iteration": 4, "score": 0.4})
    return {"decision": decision, "resources": t.resources, "seen": seen,
            "boundary": wrapper.at_perturbation_boundary({"training_iteration": 4}),
            "exploit": wrapper.exploit_target(weak)[0]}


def sc_distribute_resources_floor(s, tmp):
    out = []
    for declared in ({"CPU": 4, "TPU": 2}, {"CPU": 1, "GPU": 0.5}, {}):
        class _Ctl:
            class trainable:
                _tune_resources = declared

            trials = []

        out.append(s.tune.DistributeResources()(_Ctl(), _FakeTrial("t", {}),
                                                {"training_iteration": 1}, None))
    return out


def sc_factories_and_misc(s, tmp):
    tune = s.tune
    out = {"asha": type(tune.create_scheduler("asha")).__name__,
           "pbt": type(tune.create_scheduler("pbt")).__name__,
           "random": type(tune.create_searcher(
               "random", param_space={"x": tune.uniform(0, 1)})).__name__}
    for bad in (lambda: tune.create_scheduler("nope"), lambda: tune.create_searcher("nope")):
        try:
            bad()
        except tune.TuneError as exc:
            out.setdefault("errors", []).append(str(exc))
    out["resume"] = vars(tune.ResumeConfig())
    stopper = tune.MaximumIterationStopper(2)
    out["stopper"] = [stopper("t", {"training_iteration": 2}), stopper("t", {"training_iteration": 1})]
    pgf = tune.PlacementGroupFactory([{"CPU": 1, "GPU": 0.5}, {"CPU": 1}])
    out["pgf"] = [pgf.required_resources(), pgf.head_bundle()]
    rep = tune.CLIReporter(max_report_frequency=0.0)

    class FakeTrial:
        trial_id = "t1"
        status = "RUNNING"

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rep.on_trial_result(FakeTrial(), {"loss": 0.5})
    out["cli"] = buf.getvalue()
    return out


def sc_env_registry(s, tmp):
    tune = s.tune

    class DummyEnv:
        pass

    tune.register_env("my_env", lambda cfg: DummyEnv())
    creator = s.experiment.get_env_creator("my_env")
    return {"made": type(creator({})).__name__,
            "missing": s.experiment.get_env_creator("unregistered_env")}


# --------------------------------------------------------------------------
# experiments (trials run)
# --------------------------------------------------------------------------
def sc_basic_tune_run(s, tmp):
    tune = s.tune

    def trainable(config):
        tune.report({"score": config["x"] ** 2})

    res = tune.run(trainable, config={"x": tune.grid_search([1, 2, 3, -4])}, metric="score",
                   mode="max")
    best = res.get_best_result()
    return {"n": len(res), "best": best.metrics["score"], "config": best.config,
            "rows": sorted((r["score"], r["status"]) for r in res.get_dataframe())}


def sc_returned_dict_is_final_report(s, tmp):
    tune = s.tune

    def trainable(config):
        return {"score": config["x"]}

    res = tune.run(trainable, config={"x": tune.grid_search([5, 7])}, metric="score", mode="min")
    return res.get_best_result().metrics["score"]


def sc_multi_report_iterations(s, tmp):
    tune = s.tune

    def trainable(config):
        for i in range(5):
            tune.report({"training_iteration": i + 1, "acc": config["lr"] * (i + 1)})

    res = tune.run(trainable, config={"lr": tune.grid_search([0.1, 0.2])}, metric="acc",
                   mode="max")
    best = res.get_best_result()
    return {"acc": best.metrics["acc"], "rows": [r["acc"] for r in best.metrics_dataframe]}


def sc_asha_stops_bad_trials(s, tmp):
    tune = s.tune

    def trainable(config):
        for i in range(1, 17):
            time.sleep(0.03)
            tune.report({"training_iteration": i, "score": config["quality"] * i})

    res = tune.run(trainable, config={"quality": tune.grid_search(QUALITY)}, metric="score",
                   mode="max", max_concurrent_trials=4,
                   scheduler=tune.AsyncHyperBandScheduler(max_t=16, grace_period=2,
                                                          reduction_factor=2))
    iters = [len(t.history) for t in res._trials]
    return {"n": len(res), "best": res.get_best_result().metrics["score"],
            "some_stopped": min(iters) < 16}


def sc_median_stopping_run(s, tmp):
    tune = s.tune

    def trainable(config):
        for i in range(1, 9):
            tune.report({"training_iteration": i, "score": config["q"]})

    res = tune.run(trainable, config={"q": tune.grid_search([1.0, 1.0, 1.0, 0.0])},
                   metric="score", mode="max", max_concurrent_trials=4,
                   scheduler=tune.MedianStoppingRule(grace_period=2))
    return {"n": len(res), "best": res.get_best_result().metrics["score"]}


def sc_checkpoint_through_tune(s, tmp):
    tune = s.tune
    Checkpoint = s.train.Checkpoint

    def trainable(config):
        tune.report({"v": 1}, checkpoint=Checkpoint.from_dict({"cfg": config["x"]}, base_dir=tmp))

    res = tune.run(trainable, config={"x": tune.grid_search([42])}, metric="v", mode="max")
    return res.get_best_result().checkpoint.to_dict()["cfg"]


def sc_errors_surface(s, tmp):
    tune = s.tune

    def trainable(config):
        if config["x"] == 2:
            raise RuntimeError("boom")
        tune.report({"s": config["x"]})

    res = tune.run(trainable, config={"x": tune.grid_search([1, 2])}, metric="s", mode="max")
    return {"errors": ["boom" in str(e) for e in res.errors],
            "best": res.get_best_result().metrics["s"]}


def _pbt_trainable(tune):
    def trainable(config):
        score = 0.0
        for i in range(1, 9):
            score += config["lr"]
            tune.report({"training_iteration": i, "score": score})

    return trainable


def sc_pbt_runs(s, tmp):
    tune = s.tune
    res = tune.run(_pbt_trainable(tune), config={"lr": tune.choice([0.01, 0.1, 1.0])},
                   num_samples=4, metric="score", mode="max", max_concurrent_trials=4,
                   scheduler=tune.PopulationBasedTraining(
                       perturbation_interval=4, hyperparam_mutations={"lr": [0.01, 0.1, 1.0]},
                       seed=0))
    return {"n": len(res), "positive": res.get_best_result().metrics["score"] > 0}


def sc_pb2_runs(s, tmp):
    tune = s.tune
    res = tune.run(_pbt_trainable(tune), config={"lr": tune.uniform(0.01, 1.0)},
                   num_samples=4, metric="score", mode="max", max_concurrent_trials=4,
                   scheduler=tune.PB2(perturbation_interval=4,
                                      hyperparam_bounds={"lr": [0.01, 1.0]}, seed=0))
    return {"n": len(res), "positive": res.get_best_result().metrics["score"] > 0,
            "in_bounds": all(0.01 <= r.config["lr"] <= 1.0 for r in res)}


def sc_tpe_finds_optimum(s, tmp):
    tune = s.tune

    def objective(config):
        tune.report({"loss": (config["x"] - 0.7) ** 2 + (config["y"] + 0.3) ** 2})

    space = {"x": tune.uniform(-2, 2), "y": tune.uniform(-2, 2)}
    searcher = tune.TPESearcher(space, metric="loss", mode="min", n_startup_trials=6, seed=0)
    grid = tune.Tuner(objective, param_space=space, tune_config=tune.TuneConfig(
        search_alg=searcher, num_samples=30, metric="loss", mode="min")).fit()
    return {"n": len(grid),
            "close": grid.get_best_result(metric="loss", mode="min").metrics["loss"] < 0.25}


def sc_resource_changing_end_to_end(s, tmp):
    tune = s.tune

    def trainable(config):
        for i in range(1, 4):
            tune.report({"training_iteration": i, "score": i * config["lr"]})

    sched = tune.ResourceChangingScheduler(
        resources_allocation_function=tune.DistributeResources({"CPU": 1}))
    res = tune.run(trainable, config={"lr": tune.choice([0.1, 1.0])}, num_samples=2,
                   metric="score", mode="max", scheduler=sched)
    return {"n": len(res), "iters": [r.metrics["training_iteration"] for r in res],
            "cpus_at_least_base": all(t.resources["CPU"] >= 1 for t in res._trials)}


def sc_pbt_replay_run(s, tmp):
    tune = s.tune

    def trainable(config):
        for i in range(1, 9):
            tune.report({"training_iteration": i, "lr_seen": config["lr"], "score": i})

    replay = tune.PopulationBasedTrainingReplay([(4, {"lr": 0.5})])
    res = tune.run(trainable, config={"lr": 0.1}, num_samples=1, metric="score", mode="max",
                   scheduler=replay)
    return {"config": res[0].config["lr"], "seen": res[0].metrics["lr_seen"],
            "next": replay._next}


def sc_class_trainable_with_stop(s, tmp):
    tune = s.tune

    class MyTrainable(tune.Trainable):
        def setup(self, config):
            self.base = config.get("base", 0.0)

        def step(self):
            return {"score": self.base + self.iteration}

    grid = tune.run(MyTrainable, config={"base": tune.grid_search([0.0, 10.0])},
                    metric="score", mode="max", stop={"training_iteration": 3})
    return {"best": grid.get_best_result().metrics["score"],
            "iters": sorted(grid[i].metrics["training_iteration"] for i in range(len(grid)))}


def sc_stopper_object(s, tmp):
    tune = s.tune
    calls = []

    class ScoreStopper(tune.Stopper):
        def __call__(self, trial_id, result):
            calls.append(trial_id)
            return result.get("score", 0) >= 2

    def trainable(config):
        for i in range(100):
            tune.report({"score": i})
            time.sleep(0.05)

    grid = tune.run(trainable, config={}, metric="score", mode="max", stop=ScoreStopper())
    return {"called": bool(calls), "early": grid[0].metrics["score"] < 99}


def sc_stop_all_halts_experiment(s, tmp):
    tune = s.tune

    class AfterFirstResult(tune.Stopper):
        fired = False

        def stop_all(self):
            return AfterFirstResult.fired

        def __call__(self, trial_id, result):
            AfterFirstResult.fired = True
            return False

    def trainable(config):
        for i in range(200):
            tune.report({"i": i})
            time.sleep(0.03)

    grid = tune.run(trainable, config={"x": tune.grid_search([1, 2, 3, 4, 5, 6])}, metric="i",
                    mode="max", max_concurrent_trials=2, stop=AfterFirstResult())
    started = [grid[i] for i in range(len(grid)) if grid[i].metrics]
    return {"few": len(started) <= 3, "short": all(r.metrics.get("i", 0) < 199 for r in started)}


def sc_experiments_and_analysis(s, tmp):
    tune = s.tune

    def trainable(config):
        tune.report({"val": config["x"] * 2})

    out = tune.run_experiments([
        tune.Experiment(name="exp_a", run=trainable, config={"x": tune.grid_search([1, 2])},
                        metric="val", mode="max"),
        tune.Experiment(name="exp_b", run=trainable, config={"x": 5}, metric="val", mode="max"),
    ])
    analysis = tune.ExperimentAnalysis(out["exp_b"], metric="val", mode="max")
    return {"names": sorted(out), "a": out["exp_a"].get_best_result().metrics["val"],
            "b": analysis.best_result.metrics["val"], "config": analysis.best_config,
            "rows": len(analysis.dataframe()), "results": len(analysis.results)}


def sc_register_trainable_by_name(s, tmp):
    tune = s.tune

    def trainable(config):
        tune.report({"out": config["k"] + 1})

    tune.register_trainable("my_trainable", trainable)
    out = tune.run("my_trainable", config={"k": 41}, metric="out", mode="max")
    try:
        tune.run("never_registered", config={})
        missing = None
    except tune.TuneError as exc:
        missing = str(exc)
    return {"out": out.get_best_result().metrics["out"], "missing": missing}


def sc_with_parameters_binds_objects(s, tmp):
    tune = s.tune
    big = np.arange(100_000)

    def trainable(config, data=None):
        tune.report({"total": float(data.sum()) + config["off"]})

    fn = tune.with_parameters(trainable, data=big)

    class Cls(tune.Trainable):
        def setup(self, config):
            self.total = float(config["data"].sum())

        def step(self):
            return {"total": self.total}

    bound = tune.with_parameters(Cls, data=big)
    g1 = tune.run(fn, config={"off": tune.grid_search([1.0, 2.0])}, metric="total", mode="max")
    g2 = tune.run(bound, config={}, metric="total", mode="max", stop={"training_iteration": 2})
    return {"name": fn.__name__, "fn": g1.get_best_result().metrics["total"],
            "cls": [bound.__name__, issubclass(bound, tune.Trainable),
                    g2.get_best_result().metrics["total"]]}


def sc_with_resources_and_pgf(s, tmp):
    tune = s.tune

    def trainable(config):
        tune.report({"ok": 1})

    wrapped = tune.with_resources(trainable, tune.PlacementGroupFactory([{"CPU": 1}, {"CPU": 1}]))
    grid = tune.run(wrapped, config={}, metric="ok", mode="max")

    class Step(tune.Trainable):
        def setup(self, config):
            self.k = config["k"]
            self.i = 0

        def train(self):
            self.i += 1
            return {"score": self.k + self.i, "training_iteration": self.i}

    cls = tune.with_resources(Step, {"CPU": 1})
    g2 = tune.run(cls, config={"k": 10}, metric="score", mode="max",
                  stop={"training_iteration": 3})
    return {"res": wrapped._tune_resources, "ok": grid.get_best_result().metrics["ok"],
            "untouched": getattr(trainable, "_tune_resources", None),
            "cls": [isinstance(cls, type) and issubclass(cls, tune.Trainable),
                    cls._tune_resources, g2.get_best_result().metrics["score"]]}


def sc_tuner_get_results(s, tmp):
    tune = s.tune

    def trainable(config):
        tune.report({"score": config["x"]})

    t = tune.Tuner(trainable, param_space={"x": tune.grid_search([1, 2])},
                   tune_config=tune.TuneConfig(metric="score", mode="max"))
    try:
        t.get_results()
        early = None
    except RuntimeError as exc:
        early = str(exc)
    grid = t.fit()
    return {"early": early, "same": t.get_results() is grid, "n": len(grid)}


def _resumable(s):
    tune, Checkpoint = s.tune, s.train.Checkpoint

    def trainable(config):
        ckpt = s.session.get_checkpoint()
        start = ckpt.to_dict()["i"] + 1 if ckpt is not None else 0
        for i in range(start, 4):
            with open(config["log"], "a") as f:
                f.write(f"{config['x']},{i}\n")
            tune.report({"training_iteration": i + 1, "i": i, "x": config["x"]},
                        checkpoint=Checkpoint.from_dict({"i": i}))

    return trainable


def sc_tuner_restore_reruns_only_unfinished(s, tmp):
    tune = s.tune
    cfg = dict(metric="i", mode="max", num_samples=1)
    log = os.path.join(tmp, "steps.log")
    space = {"x": tune.grid_search([10, 20, 30]), "log": log}
    results = tune.Tuner(_resumable(s), param_space=space, tune_config=tune.TuneConfig(**cfg),
                         run_config=s.train.RunConfig(name="resume_exp", storage_path=tmp)).fit()
    first = [r.metrics["i"] for r in results]
    exp_dir = os.path.join(tmp, "resume_exp")
    can = tune.Tuner.can_restore(exp_dir)
    state_path = os.path.join(exp_dir, "experiment_state.pkl")
    with open(state_path, "rb") as f:
        state = pickle.load(f)
    doctored = state["trials"][-1]
    doctored["status"] = "RUNNING"
    doctored["last_result"] = {"training_iteration": 2, "i": 1, "x": doctored["config"]["x"]}
    doctored["checkpoint_path"] = s.train.Checkpoint.from_dict(
        {"i": 1}, base_dir=os.path.join(tmp, "interrupted_ckpt")).path
    with open(state_path, "wb") as f:
        pickle.dump(state, f)
    open(log, "w").close()
    restored = tune.Tuner.restore(exp_dir, _resumable(s), param_space=space,
                                  tune_config=tune.TuneConfig(**cfg)).fit()
    with open(log) as f:
        steps = [tuple(map(int, line.split(","))) for line in f if line.strip()]
    return {"first": first, "can": can, "n": len(restored),
            "by_x": sorted((r.config["x"], r.metrics["i"]) for r in restored), "steps": steps}


def sc_tuner_restore_refusals(s, tmp):
    tune = s.tune
    out = {"can": tune.Tuner.can_restore(tmp)}
    try:
        tune.Tuner.restore(tmp, lambda c: None)
    except ValueError as exc:
        out["no_state"] = str(exc).replace(tmp, "<dir>")
    with open(os.path.join(tmp, "experiment_state.pkl"), "wb") as f:
        pickle.dump({"trials": []}, f)
    try:
        tune.Tuner.restore(tmp, lambda c: None)
    except ValueError as exc:
        out["no_space"] = "param_space" in str(exc)
    return out


def sc_restore_keeps_errored_trials_errored(s, tmp):
    tune = s.tune

    def trainable(config):
        tune.report({"i": 1})

    exp = os.path.join(tmp, "err_exp")
    os.makedirs(exp)
    state = {"trials": [
        {"trial_id": "trial_00000", "config": {"x": 1}, "status": "TERMINATED",
         "last_result": {"i": 1}, "history": [], "checkpoint_path": None, "error": None},
        {"trial_id": "trial_00001", "config": {"x": 2}, "status": "ERROR",
         "last_result": {}, "history": [], "checkpoint_path": None,
         "error": "ValueError('bad config')"},
    ]}
    with open(os.path.join(exp, "experiment_state.pkl"), "wb") as f:
        pickle.dump(state, f)
    res = tune.Tuner.restore(exp, trainable, param_space={"x": tune.grid_search([1, 2])},
                             tune_config=tune.TuneConfig(metric="i", mode="max")).fit()
    return {"n": len(res), "errors": [str(e) for e in res.errors]}


def sc_trial_state_files(s, tmp):
    tune = s.tune

    def trainable(config):
        tune.report({"v": config["x"]})

    tune.Tuner(trainable, param_space={"x": tune.grid_search([3, 4])},
               tune_config=tune.TuneConfig(metric="v", mode="max"),
               run_config=s.train.RunConfig(name="files", storage_path=tmp)).fit()
    out = {}
    for tid in ("trial_00000", "trial_00001"):
        import json

        with open(os.path.join(tmp, "files", tid, "trial_state.json")) as f:
            st = json.load(f)
        st["last_result"].pop("trial_id", None)
        out[tid] = st
    return out


def sc_trainer_on_tune(s, tmp):
    train, tune = s.train, s.tune

    def loop(config):
        train.report({"loss": (config["lr"] - 0.3) ** 2})

    res = tune.Tuner(
        s.trainer(loop, scaling_config=train.ScalingConfig(num_workers=1)),
        param_space={"train_loop_config": {"lr": tune.grid_search([0.1, 0.3, 0.9])}},
        tune_config=tune.TuneConfig(metric="loss", mode="min")).fit()
    best = res.get_best_result()
    return {"n": len(res), "best": best.metrics["loss"], "config": best.config,
            "losses": sorted(round(res[i].metrics["loss"], 12) for i in range(len(res)))}


# a 2-layer decoder's train step inside Train-on-Tune trials
DEC = dict(vocab_size=89, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64)
DEC_TOKENS = np.random.default_rng(1).integers(0, 89, size=(2, 37)).astype(np.int32)
DEC_RATES = [3e-4, 1e-3]


def _jax_initial_state():
    """The JAX step's initial state from key 0, as numpy (the port's loop
    converts it; the JAX loop starts from ``init_state`` itself)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import transformer as jtr

    cfg = jtr.TransformerConfig(**DEC, attention="flash", dtype=jnp.float32)
    init_state, _ = jtr.make_train_step(cfg, learning_rate=DEC_RATES[0])
    return jax.tree.map(np.array, init_state(jax.random.key(0)))


def sc_decoder_steps_on_tune(s, tmp):
    train, tune = s.train, s.tune
    if s.is_jax:
        def loop(config):
            import jax
            import jax.numpy as jnp

            from ray_tpu.models import transformer as jtr

            cfg = jtr.TransformerConfig(**DEC, attention="flash", dtype=jnp.float32)
            init_state, step = jtr.make_train_step(cfg, learning_rate=config["learning_rate"])
            state = init_state(jax.random.key(0))
            for _ in range(2):
                state, loss = step(state, jnp.asarray(DEC_TOKENS))
                train.report({"loss": float(loss)})
        base = {}
    else:
        def loop(config):
            from ray_tpu_torch.convert import train_state_from_numpy
            from ray_tpu_torch.models import transformer as ttr

            cfg = ttr.TransformerConfig(**DEC, attention="flash", dtype=torch.float32)
            device = train.get_context().get_devices()[0]
            _, step = ttr.make_train_step(cfg, learning_rate=config["learning_rate"],
                                          device=device)
            js = config["state"]
            adam = js["opt"][0]
            state = train_state_from_numpy(js["params"], adam.mu, adam.nu, adam.count,
                                           js["step"], device=device)
            for _ in range(2):
                state, loss = step(state, torch.from_numpy(DEC_TOKENS).to(device))
                train.report({"loss": float(loss)})
        base = {"state": _jax_initial_state()}
    res = tune.Tuner(
        s.trainer(loop, train_loop_config=base,
                  scaling_config=train.ScalingConfig(num_workers=1)),
        param_space={"train_loop_config": {"learning_rate": tune.grid_search(DEC_RATES)}},
        tune_config=tune.TuneConfig(metric="loss", mode="min", max_concurrent_trials=2)).fit()
    by_rate = {res[i].config["learning_rate"]: res[i].metrics["loss"] for i in range(len(res))}
    best = res.get_best_result()
    return {"losses": [by_rate[r] for r in DEC_RATES], "errors": len(res.errors),
            "best": best.config["learning_rate"],
            "rows": [len(res[i].metrics_dataframe) for i in range(len(res))]}


SCENARIOS = [fn for name, fn in sorted(globals().items())
             if name.startswith("sc_") and callable(fn)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{package: {scenario: output}}: every scenario under one runtime of
    each package (an exception is the scenario's output)."""
    out = {name: {} for name in PACKAGES}
    for name in PACKAGES:
        side = _Side(name)
        side.rt.init(num_cpus=8)
        try:
            for fn in SCENARIOS:
                key = fn.__name__[3:]
                tmp = str(tmp_path_factory.mktemp(f"{name}_{key}"))
                try:
                    out[name][key] = fn(side, tmp)
                except Exception as exc:  # noqa: BLE001 - reported by the test
                    out[name][key] = ("raised", repr(exc))
        finally:
            side.rt.shutdown()
    return out


def _pair(runs, key):
    j, p = runs["ray_tpu"][key], runs["ray_tpu_torch"][key]
    assert not (isinstance(p, tuple) and p and p[0] == "raised"), p
    assert not (isinstance(j, tuple) and j and j[0] == "raised"), j
    return j, p


def _check_grid(o):
    assert o["total"] == 12 and o["configs"][-1] is None
    return True


def _check_draws(o):
    assert o[-1] is None and len(o) == 11
    for cfg in o[:-1]:
        assert 0 <= cfg["u"] <= 1 and 1e-4 <= cfg["lu"] <= 1e-1 and cfg["c"] in ("x", "y")
        assert 0 <= cfg["ri"] < 10 and cfg["q"] in (0.0, 0.25, 0.5, 0.75, 1.0)
        assert cfg["sf"] == 2 * cfg["ri"]
    return True


def _check_clip(o):
    for a, b, c in zip(o[0::3], o[1::3], o[2::3]):
        assert 1 <= a <= 130 and 1 <= b <= 130 and 10 <= c <= 95
    return True


def _check_asha(o):
    stopped = {t for t, _, d in o if d == "STOP"}
    assert "t0" in stopped  # max_t ends every survivor, the best included
    assert any(i < 16 for t, i, d in o if d == "STOP")
    return True


def _check_median(o):
    assert any(t == "t3" and d == "STOP" for t, _, d in o)
    return True


def _check_pbt(o):
    assert o["log"] and len(o["policy"]) == len(o["log"])
    return True


def _check_pb2(o):
    assert o["log"] and o["obs"]
    assert all(0.01 <= cfg["lr"] <= 1.0 for _, _, cfg in o["log"])
    return True


def _check_pb2_model(o):
    assert o["obs"][0][0] == 4 and o["obs"][0][1] == [0.5] and o["obs"][0][2] == pytest.approx(3.0)
    assert 0.1 <= o["cold"]["lr"] <= 0.9 and 1e-5 <= o["cold"]["wd"] <= 1e-3
    assert sum(p > 0.5 for p in o["picks"]) >= 4
    assert "hyperparam_bounds" in o["no_bounds"]
    opened, still, new_cfg, logged, added = o["window"]
    assert opened and not still and logged == new_cfg and added == 0
    return True


def _check_restore(o):
    assert o["first"] == [3, 3, 3] and o["can"] and o["n"] == 3
    assert o["by_x"] == [(10, 3), (20, 3), (30, 3)]
    assert o["steps"] == [(30, 2), (30, 3)]
    return True


EXPECT = {
    "grid_expansion": _check_grid,
    "seeded_random_draws": _check_draws,
    "q_samplers_clip_to_bounds": _check_clip,
    "tpe_on_restore": lambda o: o == {"first": ({"x": 0.7}, 1.0), "live": {"x": 0.2},
                                      "last": ({"x": 0.2}, 2.0)},
    "concurrency_limiter": lambda o: o[0] and o[1] and o[2] is None and o[3] and o[4] is None,
    "repeater": lambda o: o["completed"][0][1]["score"] == 2.0 and o["completed"][1][2],
    "optuna_translation_and_telling": lambda o: (
        o["tells"] == [(0.5, "COMPLETE"), (None, "FAIL")] and o["cfg"]["fixed"] == 7
        and 1 <= o["cfg"]["n"] <= 9 and o["resolved"] == "_OptunaSearch"),
    "optuna_drives_tune_run": lambda o: o["n"] == 6 and o["tells"] == 6 and o["best"],
    "external_searchers_gate_with_importerror": lambda o: (
        "optuna" in o["OptunaSearch"] and "hyperopt" in o["HyperOptSearch"]
        and "ConfigSpace" in o["TuneBOHB"] and o["resolved"] == "OptunaSearch"),
    "asha_decisions": _check_asha,
    "hyperband_decisions": lambda o: o["alias"] and o["bohb_is_asha"],
    "median_stopping_decisions": _check_median,
    "pbt_exploit_log": _check_pbt,
    "pbt_exploit_cooldown": lambda o: o[0] is not None and o[1] is None and o[2] is not None,
    "pb2_exploit_log": _check_pb2,
    "pb2_model": _check_pb2_model,
    "pbt_policy_and_replay": lambda o: (
        o["policy"][0][0] == 4 and o["policy"][0][1]["lr"] == 0.9 and o["sibling"] is None
        and o["target"] == {"lr": 0.5} and o["next"] == 1 and "ONE trial" in o["warned"][0]),
    "resource_changing_scheduler": lambda o: (
        o["decision"] == "CONTINUE" and o["resources"] == {"CPU": 2.0} and o["seen"] == [1]
        and o["boundary"] and o["exploit"]["lr"] == 0.9),
    "distribute_resources_floor": lambda o: (
        o[0]["CPU"] >= 4.0 and o[0]["TPU"] == 2 and o[1]["GPU"] == 0.5 and o[1]["CPU"] >= 1.0),
    "factories_and_misc": lambda o: (
        o["asha"] == "AsyncHyperBandScheduler" and len(o["errors"]) == 2
        and o["stopper"] == [True, False] and "Tune progress" in o["cli"] and "t1" in o["cli"]
        and o["pgf"] == [{"CPU": 2, "GPU": 0.5}, {"CPU": 1, "GPU": 0.5}]),
    "env_registry": lambda o: o == {"made": "DummyEnv", "missing": None},
    "basic_tune_run": lambda o: o["n"] == 4 and o["best"] == 16 and o["config"] == {"x": -4},
    "returned_dict_is_final_report": lambda o: o == 5,
    "multi_report_iterations": lambda o: o["acc"] == pytest.approx(1.0) and len(o["rows"]) == 5,
    "asha_stops_bad_trials": lambda o: o == {"n": 8, "best": pytest.approx(320.0),
                                            "some_stopped": True},
    "median_stopping_run": lambda o: o["n"] == 4,
    "checkpoint_through_tune": lambda o: o == 42,
    "errors_surface": lambda o: o == {"errors": [True], "best": 1},
    "pbt_runs": lambda o: o == {"n": 4, "positive": True},
    "pb2_runs": lambda o: o == {"n": 4, "positive": True, "in_bounds": True},
    "tpe_finds_optimum": lambda o: o == {"n": 30, "close": True},
    "resource_changing_end_to_end": lambda o: o["n"] == 2 and o["iters"] == [3, 3],
    "pbt_replay_run": lambda o: o == {"config": 0.5, "seen": 0.5, "next": 1},
    "class_trainable_with_stop": lambda o: o["best"] == 13.0 and max(o["iters"]) <= 3,
    "stopper_object": lambda o: o == {"called": True, "early": True},
    "stop_all_halts_experiment": lambda o: o == {"few": True, "short": True},
    "experiments_and_analysis": lambda o: (
        o["names"] == ["exp_a", "exp_b"] and o["a"] == 4 and o["b"] == 10 and o["rows"] == 1
        and o["config"] == {"x": 5}),
    "register_trainable_by_name": lambda o: o["out"] == 42 and "never_registered" in o["missing"],
    "with_parameters_binds_objects": lambda o: (
        o["fn"] == float(np.arange(100_000).sum()) + 2.0 and o["cls"][1]),
    "with_resources_and_pgf": lambda o: (
        o["res"] == {"CPU": 1} and o["ok"] == 1 and o["untouched"] is None
        and o["cls"] == [True, {"CPU": 1}, 13]),
    "tuner_get_results": lambda o: "call fit" in o["early"] and o["same"] and o["n"] == 2,
    "tuner_restore_reruns_only_unfinished": _check_restore,
    "tuner_restore_refusals": lambda o: (
        not o["can"] and "no experiment state" in o["no_state"] and o["no_space"]),
    "restore_keeps_errored_trials_errored": lambda o: (
        o["n"] == 2 and len(o["errors"]) == 1 and "bad config" in o["errors"][0]),
    "trial_state_files": lambda o: o["trial_00000"]["status"] == "TERMINATED",
    "trainer_on_tune": lambda o: o["n"] == 3 and o["best"] == pytest.approx(0.0),
}

# scenarios whose output carries floats computed by different numerics
NUMERIC = {"decoder_steps_on_tune"}


@pytest.mark.parametrize("key", sorted(EXPECT))
def test_tune_scenario_matches_jax(runs, key):
    j, p = _pair(runs, key)
    assert p == j
    assert EXPECT[key](p), p


def test_every_scenario_is_checked():
    assert {fn.__name__[3:] for fn in SCENARIOS} == set(EXPECT) | NUMERIC | {
        "sampling_distributions", "tpe_suggestions"}


@pytest.mark.parametrize("key", ["sampling_distributions", "tpe_suggestions"])
def test_seeded_draws_match_jax_value_for_value(runs, key):
    j, p = _pair(runs, key)
    assert len(p) == len(j) > 10
    assert p == j


def test_decoder_steps_through_train_on_tune_match_jax(runs):
    """Train-on-Tune of a real step: each trial's two losses, the terminal
    one reported to Tune, within 1e-4 relative of the JAX package's."""
    j, p = _pair(runs, "decoder_steps_on_tune")
    assert p["errors"] == j["errors"] == 0
    assert p["rows"] == j["rows"] == [2, 2]
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=LOSS_RTOL)
    assert all(np.isfinite(p["losses"]))
    assert p["best"] == j["best"]


def test_tune_exports_match_jax():
    import ray_tpu.tune as jt
    import ray_tpu_torch.tune as pt

    assert sorted(pt.__all__) == sorted(jt.__all__)
    for name in jt.__all__:
        assert hasattr(pt, name), name


# --------------------------------------------------------------------------
# the device seam: a trial's GPU share (ROADMAP.md, Queue 3)
# --------------------------------------------------------------------------
def _trial_options(side, monkeypatch, resources):
    """The options each package gives a trial's runner actor for
    ``resources`` (recorded, then created as usual)."""
    seen = []
    real = side.ctrl.TrialRunnerActor

    class _Recorder:
        def options(self, **opts):
            seen.append(dict(opts))
            return real.options(**opts)

    monkeypatch.setattr(side.ctrl, "TrialRunnerActor", _Recorder())

    def trainable(config):
        side.tune.report({"ok": 1})

    grid = side.tune.run(side.tune.with_resources(trainable, resources), config={},
                         metric="ok", mode="max")
    assert grid.get_best_result().metrics["ok"] == 1
    return seen[0]


def test_trial_accelerator_resources_map_per_package(monkeypatch):
    """``"TPU"`` is ``num_tpus`` in both packages; ``"GPU"`` is a custom
    resource in the JAX package and ``num_gpus`` (an in-process GPU actor)
    in the port."""
    got = {}
    for name in PACKAGES:
        side = _Side(name)
        side.rt.init(num_cpus=4, resources={"TPU": 1, "GPU": 1})
        try:
            got[name] = (_trial_options(side, monkeypatch, {"CPU": 1, "TPU": 1}),
                         _trial_options(side, monkeypatch, {"CPU": 1, "GPU": 0.5}))
        finally:
            side.rt.shutdown()
    base = {"execution": "inproc", "max_concurrency": 4, "num_cpus": 1}
    assert got["ray_tpu"][0] == got["ray_tpu_torch"][0] == {**base, "num_tpus": 1}
    assert got["ray_tpu"][1] == {**base, "resources": {"GPU": 0.5}}
    assert got["ray_tpu_torch"][1] == {**base, "num_gpus": 0.5}


def test_gpu_trials_share_the_declared_card_in_the_port():
    """Three ``{"GPU": 0.5}`` trials, two at a time, on a one-GPU node: two
    run at once and the third waits for a slot; each runner holds its half
    while it runs.  (A node declared to have a GPU: the trials here compute
    nothing on it.)"""
    import threading

    import ray_tpu_torch as rt
    from ray_tpu_torch import tune

    rt.init(num_cpus=4, num_gpus=1)
    lock = threading.Lock()
    state = {"now": 0, "most": 0, "free": []}

    def trainable(config):
        with lock:
            state["now"] += 1
            state["most"] = max(state["most"], state["now"])
            state["free"].append(rt.available_resources().get("GPU", 0.0))
        time.sleep(0.3)
        with lock:
            state["now"] -= 1
        tune.report({"ok": config["x"]})

    try:
        grid = tune.run(tune.with_resources(trainable, {"GPU": 0.5}),
                        config={"x": tune.grid_search([1, 2, 3])}, metric="ok", mode="max",
                        max_concurrent_trials=2)
    finally:
        rt.shutdown()
    assert len(grid) == 3 and not grid.errors
    assert state["most"] == 2
    assert all(f <= 0.5 for f in state["free"])


def test_stopped_trials_hand_their_gpu_share_on_in_the_port_only():
    """F18: ASHA stops trials that hold half a card each, two at a time; the
    next trial's runner waits for the share a stopped trial's runner holds
    until the loop reaps it.  The port's loop does not wait for the new
    runner (the JAX package's does, ``ray_tpu/tune/controller.py:244``, and
    never reaps the stopped one: it hangs, so it is not run here).  Bounded
    at 120 s."""
    import threading

    import ray_tpu_torch as rt
    from ray_tpu_torch import tune

    def trainable(config):
        for i in range(1, 9):
            time.sleep(0.05)
            tune.report({"training_iteration": i, "score": config["q"] * i})

    rt.init(num_cpus=4, num_gpus=1)
    box = {}

    def run():
        box["grid"] = tune.run(
            tune.with_resources(trainable, {"GPU": 0.5}),
            config={"q": tune.grid_search([8.0, 4.0, 2.0, 1.0, 0.5])}, metric="score",
            mode="max", max_concurrent_trials=2,
            scheduler=tune.AsyncHyperBandScheduler(max_t=8, grace_period=1, reduction_factor=2))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(120)
    try:
        assert not t.is_alive(), "the experiment waited for a GPU share for 120 s"
        grid = box["grid"]
        assert len(grid) == 5 and not grid.errors
        iters = sorted(len(x.history) for x in grid._trials)
        assert iters[0] < 8 and iters[-1] == 8
    finally:
        if not t.is_alive():
            rt.shutdown()
