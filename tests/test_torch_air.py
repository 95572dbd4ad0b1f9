"""The port's AIR surface and usage stats (``ray_tpu_torch.air``,
``ray_tpu_torch.usage``) against the JAX package's, case by case of
``tests/test_air_integrations.py`` and the AIR case of
``tests/test_state_api_tail.py``.

The experiment scenarios run a two-trial grid through each package's
``Tuner`` under one runtime of each (``init(num_cpus=4)``, as the JAX
tests' ``ray_start_regular``): callback events, and the files the wandb and
MLflow fallbacks write (``wandb`` and ``mlflow`` are not installed; the
callbacks are also forced onto the no-package path), compared as the
events and the files' contents less times.  The usage report differs on
purpose in one value: its ``source`` names the package that wrote it.
"""

import importlib
import json
import os

import pytest

torch = pytest.importorskip("torch")

PACKAGES = ("ray_tpu", "ray_tpu_torch")


class _Side:
    def __init__(self, name):
        self.name = name
        self.rt = importlib.import_module(name)
        self.tune = importlib.import_module(name + ".tune")
        self.tuner = importlib.import_module(name + ".tune.tuner")
        self.callback = importlib.import_module(name + ".tune.callback")
        self.config = importlib.import_module(name + ".train.config")
        self.air = importlib.import_module(name + ".air")
        self.mlflow = importlib.import_module(name + ".air.integrations.mlflow")
        self.wandb = importlib.import_module(name + ".air.integrations.wandb")
        self.usage = importlib.import_module(name + ".usage")
        self.usage_lib = importlib.import_module(name + ".usage.usage_lib")


def _experiment(s, tmp, callbacks):
    session = importlib.import_module(s.name + ".tune.session")

    def trainable(config):
        for i in range(3):
            session.report({"score": config["x"] * (i + 1)})

    tuner = s.tuner.Tuner(
        trainable,
        param_space={"x": s.tune.grid_search([1, 2])},
        tune_config=s.tuner.TuneConfig(metric="score", mode="max", num_samples=1),
        run_config=s.config.RunConfig(storage_path=tmp, name="exp", callbacks=callbacks),
    )
    return tuner.fit()


def sc_callback_lifecycle(s, tmp):
    events = []

    class Recorder(s.callback.Callback):
        def on_trial_start(self, trial):
            events.append(("start", trial.config["x"]))

        def on_trial_result(self, trial, result):
            events.append(("result", trial.config["x"], result["score"]))

        def on_trial_complete(self, trial):
            events.append(("complete", trial.config["x"]))

        def on_experiment_end(self, trials):
            events.append(("end", len(trials)))

    results = _experiment(s, tmp, [Recorder()])
    return {"results": len(results), "last": events[-1],
            "per_trial": sorted(e for e in events if e[0] != "end")}


def sc_broken_callback_does_not_kill_experiment(s, tmp):
    class Broken(s.callback.Callback):
        def on_trial_result(self, trial, result):
            raise RuntimeError("boom")

    results = _experiment(s, tmp, [Broken()])
    return sorted(results[i].metrics["score"] for i in range(len(results)))


def sc_wandb_offline_fallback(s, tmp):
    cb = s.wandb.WandbLoggerCallback(project="proj", dir=os.path.join(tmp, "wb"))
    cb._wandb = None
    _experiment(s, tmp, [cb])
    d = os.path.join(tmp, "wb", "wandb")
    with open(os.path.join(d, "config.json")) as f:
        config = json.load(f)
    with open(os.path.join(d, "history.jsonl")) as f:
        rows = [json.loads(line) for line in f.read().splitlines()]
    scores = sorted(r["score"] for r in rows)
    return {"project": config["project"], "config_keys": sorted(config),
            "history_keys": sorted({k for r in rows for k in r} & {"score", "training_iteration"}),
            "scores": scores, "default_project": s.wandb.WandbLoggerCallback().project}


def sc_mlflow_filestore_fallback(s, tmp):
    cb = s.mlflow.MLflowLoggerCallback(tracking_uri=f"file:{tmp}/ml", experiment_name="e1")
    cb._mlflow = None
    _experiment(s, tmp, [cb])
    runs = sorted(os.listdir(os.path.join(tmp, "ml", "mlruns", "e1")))
    out = []
    for run in runs:
        d = os.path.join(tmp, "ml", "mlruns", "e1", run)
        with open(os.path.join(d, "params.json")) as f:
            params = json.load(f)
        with open(os.path.join(d, "status")) as f:
            status = f.read()
        with open(os.path.join(d, "metrics.jsonl")) as f:
            scores = [json.loads(line).get("score") for line in f.read().splitlines()]
        out.append((params, status, scores))
    return {"runs": sorted(out, key=lambda r: json.dumps(r, sort_keys=True)),
            "default_experiment": s.mlflow.MLflowLoggerCallback().experiment_name,
            "setup": (s.mlflow.setup_mlflow({"a": 1}), s.wandb.setup_wandb({"a": 1}))}


def sc_air_type_shims(s, tmp):
    air = s.air
    req = air.ResourceRequest([{"CPU": 2.0}, {"CPU": 1.0}])
    got = air.AcquiredResources(request=req)
    return {"head": req.head_bundle, "strategy": got.request.strategy,
            "split": air.DatasetConfig().split, "empty_head": air.ResourceRequest([]).head_bundle,
            "configs": [type(getattr(air, n)()).__name__ for n in (
                "RunConfig", "ScalingConfig", "CheckpointConfig", "FailureConfig")]}


SCENARIOS = [fn for n, fn in sorted(globals().items()) if n.startswith("sc_")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {name: {} for name in PACKAGES}
    for name in PACKAGES:
        side = _Side(name)
        side.rt.init(num_cpus=4)
        try:
            for fn in SCENARIOS:
                tmp = str(tmp_path_factory.mktemp(f"{name}_{fn.__name__}"))
                try:
                    out[name][fn.__name__[3:]] = fn(side, tmp)
                except Exception as exc:  # noqa: BLE001 - reported by the test
                    out[name][fn.__name__[3:]] = ("raised", repr(exc))
        finally:
            side.rt.shutdown()
    return out


EXPECT = {
    "callback_lifecycle": lambda o: (
        o["results"] == 2 and o["last"] == ("end", 2)
        and [e for e in o["per_trial"] if e[0] != "result"]
        == [("complete", 1), ("complete", 2), ("start", 1), ("start", 2)]
        and len(o["per_trial"]) == 10),
    "broken_callback_does_not_kill_experiment": lambda o: o == [3, 6],
    "wandb_offline_fallback": lambda o: (
        o["project"] == "proj" and o["scores"] == [1, 2, 2, 3, 4, 6]
        and o["default_project"] == "ray_tpu"),
    "mlflow_filestore_fallback": lambda o: (
        [r[1] for r in o["runs"]] == ["FINISHED", "FINISHED"]
        and sorted(r[0]["x"] for r in o["runs"]) == [1, 2]
        and o["setup"] == (None, None) and o["default_experiment"] == "ray_tpu"),
    "air_type_shims": lambda o: (
        o["head"] == {"CPU": 2.0} and o["strategy"] == "PACK" and o["split"] is True),
}


def test_every_scenario_is_checked():
    assert {fn.__name__[3:] for fn in SCENARIOS} == set(EXPECT)


@pytest.mark.parametrize("key", sorted(EXPECT))
def test_air_scenario_matches_jax(runs, key):
    j, p = runs["ray_tpu"][key], runs["ray_tpu_torch"][key]
    assert not (isinstance(p, tuple) and p[:1] == ("raised",)), p
    assert not (isinstance(j, tuple) and j[:1] == ("raised",)), j
    assert p == j
    assert EXPECT[key](p), p


@pytest.mark.parametrize("module", ["air", "air.types", "air.integrations.mlflow",
                                    "air.integrations.wandb"])
def test_air_modules_name_what_the_jax_package_names(module):
    j = importlib.import_module("ray_tpu." + module)
    p = importlib.import_module("ray_tpu_torch." + module)
    names = getattr(j, "__all__", None) or [
        n for n, v in vars(j).items() if not n.startswith("_") and getattr(
            v, "__module__", None) == j.__name__]
    for n in names:
        assert hasattr(p, n), n


def test_usage_report_keys_match_and_name_their_package(tmp_path):
    """Same keys, tags and counters; ``source`` is the writing package's
    own name (the one value that differs on purpose); each package writes
    its report into its session directory at shutdown."""
    reports = {}
    for name in PACKAGES:
        side = _Side(name)
        side.usage.record_extra_usage_tag("test_feature", "1")
        reports[name] = side.usage.usage_report()
        side.rt.init(num_cpus=2)
        session_dir = side.rt.get_cluster().session_dir
        side.rt.shutdown()
        with open(os.path.join(session_dir, "usage_stats.json")) as f:
            written = json.load(f)
        assert written["source"] == name and written["tags"]["test_feature"] == "1"
    j, p = reports["ray_tpu"], reports["ray_tpu_torch"]
    assert sorted(p) == sorted(j)
    assert p["source"] == "ray_tpu_torch" and j["source"] == "ray_tpu"
    assert p["tags"]["test_feature"] == j["tags"]["test_feature"] == "1"
    assert p["version"] == j["version"] and p["schema_version"] == j["schema_version"]
    assert p["total_num_cpus"] == j["total_num_cpus"]


def test_usage_stats_opt_out_and_enabled_init(monkeypatch):
    """``RAY_TPU_USAGE_STATS_ENABLED=0`` records nothing in either package;
    ``=1`` no longer stops the port's ``init``."""
    for name in PACKAGES:
        usage_lib = _Side(name).usage_lib
        monkeypatch.setenv("RAY_TPU_USAGE_STATS_ENABLED", "0")
        usage_lib.record_extra_usage_tag("should_not_appear", "1")
        assert "should_not_appear" not in usage_lib._tags
        assert usage_lib.usage_stats_enabled() is False
    monkeypatch.setenv("RAY_TPU_USAGE_STATS_ENABLED", "1")
    import ray_tpu_torch as rt

    rt.init(num_cpus=1)
    try:
        from ray_tpu_torch.usage import usage_lib

        assert usage_lib.usage_stats_enabled() is True
    finally:
        rt.shutdown()
