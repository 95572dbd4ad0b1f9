"""The port's framework trainers and predictors
(``ray_tpu_torch.train.{gbdt,xgboost,lightgbm,tensorflow,huggingface}``)
against the JAX package's, case by case of ``tests/test_train_gbdt.py``,
``tests/test_train_tf.py``, ``tests/test_train_hf.py`` and the framework
cases of ``tests/test_predictor.py``.

Each scenario runs once in each package on the same inputs, all of a
package's scenarios under one runtime (``init(num_cpus=8)``).  ``xgboost``
and ``lightgbm`` are stood in for by the JAX tests' own lookalikes, put in
``sys.modules`` for the scenario (the ranks are in-process actors, so the
lookalikes reach them).  TensorFlow and transformers run for real where
they import; TensorFlow is imported only inside the scenarios.  The port's
side is given ``device="cpu"`` where it takes a device (the HuggingFace
trainers and ``TransformersPredictor``); the GBDT and TensorFlow trainers
run host ranks in both packages.  Outputs compare exactly, except the
HuggingFace losses (the same seeds, separate processes): both finite.
"""

import collections
import contextlib
import importlib
import json
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

PACKAGES = ("ray_tpu", "ray_tpu_torch")


class _Side:
    def __init__(self, name):
        self.name = name
        self.is_jax = name == "ray_tpu"
        self.rt = importlib.import_module(name)
        self.train = importlib.import_module(name + ".train")
        self.data = importlib.import_module(name + ".data")
        self.gbdt = importlib.import_module(name + ".train.gbdt")

    def mod(self, sub):
        return importlib.import_module(f"{self.name}.train.{sub}")

    @property
    def device_kw(self):
        return {} if self.is_jax else {"device": "cpu"}


@contextlib.contextmanager
def _module(name, mod):
    had, old = name in sys.modules, sys.modules.get(name)
    if mod is None:
        sys.modules.pop(name, None)
    else:
        sys.modules[name] = mod
    try:
        yield mod
    finally:
        if had:
            sys.modules[name] = old
        else:
            sys.modules.pop(name, None)


def _frame(n=32, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    y = (X @ np.array([1.0, -2.0, 0.5]) > 0).astype(np.float64)
    return pd.DataFrame({"a": X[:, 0], "b": X[:, 1], "c": X[:, 2], "label": y})


# --------------------------------------------------------------------------
# the JAX tests' framework lookalikes
# --------------------------------------------------------------------------
def _fake_xgboost(calls, with_collective=False):
    mod = types.ModuleType("xgboost")

    class DMatrix:
        def __init__(self, X, label=None, **kw):
            self.X, self.label, self.kw = X, label, kw

    class Booster:
        def __init__(self):
            self.rounds = 0

        def num_boosted_rounds(self):
            return self.rounds

        def save_model(self, path):
            with open(path, "w") as f:
                f.write(str(self.rounds))

        def load_model(self, path):
            with open(path) as f:
                self.rounds = int(f.read())

    class TrainingCallback:
        pass

    def train(params, dtrain, evals=(), evals_result=None, num_boost_round=10,
              xgb_model=None, callbacks=(), **kw):
        model = Booster()
        if xgb_model is not None:
            model.rounds = xgb_model.rounds
        calls.append({"params": dict(params), "nrows": len(dtrain.X), "rounds": num_boost_round,
                      "eval_names": [name for _, name in evals], "resumed_at": model.rounds,
                      "kw": sorted(kw)})
        evals_log = {name: {"rmse": []} for _, name in evals}
        for epoch in range(num_boost_round):
            model.rounds += 1
            for name in evals_log:
                evals_log[name]["rmse"].append(1.0 / model.rounds)
            for cb in callbacks:
                if hasattr(cb, "after_iteration"):
                    cb.after_iteration(model, epoch, evals_log)
        for cb in callbacks:
            if hasattr(cb, "after_training"):
                cb.after_training(model)
        if evals_result is not None:
            evals_result.update(evals_log)
        return model

    mod.DMatrix, mod.Booster, mod.train = DMatrix, Booster, train
    mod.callback = types.SimpleNamespace(TrainingCallback=TrainingCallback)
    if with_collective:
        entered = []

        class CommunicatorContext:
            def __init__(self, **args):
                self.args = args

            def __enter__(self):
                entered.append(dict(self.args))
                return self

            def __exit__(self, *exc):
                return False

        class RabitTracker:
            def __init__(self, host_ip, n_workers):
                self.host_ip, self.n_workers = host_ip, n_workers

            def start(self):
                pass

            def worker_args(self):
                return {"dmlc_tracker_uri": self.host_ip, "dmlc_tracker_port": 9091}

            def free(self):
                pass

        mod.collective = types.SimpleNamespace(CommunicatorContext=CommunicatorContext)
        mod.tracker = types.SimpleNamespace(RabitTracker=RabitTracker)
        mod._entered = entered
    return mod


def _fake_lightgbm(calls):
    mod = types.ModuleType("lightgbm")
    CallbackEnv = collections.namedtuple(
        "CallbackEnv", ["model", "params", "iteration", "begin_iteration", "end_iteration",
                        "evaluation_result_list"])

    class Dataset:
        def __init__(self, X, label=None, reference=None):
            self.X, self.label, self.reference = X, label, reference

    class Booster:
        def __init__(self, model_file=None):
            self.iters = 0
            if model_file is not None:
                with open(model_file) as f:
                    self.iters = int(f.read())

        def current_iteration(self):
            return self.iters

        def save_model(self, path):
            with open(path, "w") as f:
                f.write(str(self.iters))

        def predict(self, df, **kw):
            return np.asarray(df.sum(axis=1)) * self.iters

    def train(params, train_set, num_boost_round=10, valid_sets=(), valid_names=(),
              init_model=None, callbacks=(), **kw):
        model = Booster()
        if init_model is not None:
            model.iters = init_model.iters
        calls.append({"params": dict(params), "nrows": len(train_set.X),
                      "rounds": num_boost_round, "valid_names": list(valid_names)})
        for it in range(num_boost_round):
            model.iters += 1
            results = [(n, "l2", 1.0 / model.iters, False) for n in valid_names]
            env = CallbackEnv(model, params, it, 0, num_boost_round, results)
            for cb in callbacks:
                cb(env)
        return model

    mod.Dataset, mod.Booster, mod.train = Dataset, Booster, train
    return mod


def _strip_network(params):
    """LightGBM's negotiated params without the host's address and ports."""
    p = dict(params)
    machines = p.pop("machines", None)
    port = p.pop("local_listen_port", None)
    if machines is not None:
        p["machines"] = len(machines.split(","))
        p["listens_on_advertised"] = any(m.endswith(f":{port}") for m in machines.split(","))
    return p


# --------------------------------------------------------------------------
# tests/test_train_gbdt.py
# --------------------------------------------------------------------------
def sc_xgboost_reports_and_checkpoints(s, tmp):
    calls = []
    with _module("xgboost", _fake_xgboost(calls)):
        xgb = s.mod("xgboost")
        r = xgb.XGBoostTrainer(
            params={"eta": 0.3}, label_column="label", num_boost_round=5,
            datasets={"train": s.data.from_pandas(_frame()),
                      "valid": s.data.from_pandas(_frame(seed=1))},
            scaling_config=s.train.ScalingConfig(num_workers=1),
            run_config=s.train.RunConfig(name="xgb_single", storage_path=tmp)).fit()
        rounds = xgb.RayTrainReportCallback.get_model(r.checkpoint).num_boosted_rounds()
    return {"error": r.error, "metrics": r.metrics, "calls": calls, "rounds": rounds,
            "rows": [row["training_iteration"] for row in r.metrics_dataframe]}


def sc_xgboost_resume_trains_remaining_rounds(s, tmp):
    calls = []
    with _module("xgboost", _fake_xgboost(calls)):
        xgb = s.mod("xgboost")
        ds = s.data.from_pandas(_frame())
        first = xgb.XGBoostTrainer(label_column="label", num_boost_round=4, datasets={"train": ds},
                                   run_config=s.train.RunConfig(name="xgb_r1", storage_path=tmp)).fit()
        second = xgb.XGBoostTrainer(label_column="label", num_boost_round=10,
                                    datasets={"train": ds},
                                    run_config=s.train.RunConfig(name="xgb_r2", storage_path=tmp),
                                    resume_from_checkpoint=first.checkpoint).fit()
        rounds = xgb.RayTrainReportCallback.get_model(second.checkpoint).num_boosted_rounds()
    return {"errors": [first.error, second.error], "last": calls[-1], "rounds": rounds}


def sc_xgboost_two_workers_join_collective(s, tmp):
    calls = []
    mod = _fake_xgboost(calls, with_collective=True)
    with _module("xgboost", mod):
        r = s.mod("xgboost").XGBoostTrainer(
            label_column="label", num_boost_round=3,
            datasets={"train": s.data.from_pandas(_frame(n=40))},
            scaling_config=s.train.ScalingConfig(num_workers=2),
            run_config=s.train.RunConfig(name="xgb_gang", storage_path=tmp)).fit()
    return {"error": r.error, "nrows": sorted(c["nrows"] for c in calls),
            "entered": len(mod._entered),
            "ports": [a["dmlc_tracker_port"] for a in mod._entered]}


def sc_xgboost_missing_dependency_is_actionable(s, tmp):
    with _module("xgboost", None):
        r = s.mod("xgboost").XGBoostTrainer(
            label_column="label", num_boost_round=2,
            datasets={"train": s.data.from_pandas(_frame())},
            run_config=s.train.RunConfig(name="xgb_missing", storage_path=tmp)).fit()
    return {"error": r.error is not None, "actionable": "pip install xgboost" in str(r.error)}


def sc_lightgbm_reports_and_checkpoints(s, tmp):
    calls = []
    with _module("lightgbm", _fake_lightgbm(calls)):
        lgb = s.mod("lightgbm")
        r = lgb.LightGBMTrainer(
            params={"objective": "regression"}, label_column="label", num_boost_round=4,
            datasets={"train": s.data.from_pandas(_frame()),
                      "valid": s.data.from_pandas(_frame(seed=2))},
            run_config=s.train.RunConfig(name="lgbm_single", storage_path=tmp)).fit()
        iters = lgb.RayTrainReportCallback.get_model(r.checkpoint).current_iteration()
    return {"error": r.error, "metrics": r.metrics, "calls": calls, "iters": iters}


def sc_lightgbm_two_workers_negotiate_machines(s, tmp):
    calls = []
    with _module("lightgbm", _fake_lightgbm(calls)):
        r = s.mod("lightgbm").LightGBMTrainer(
            label_column="label", num_boost_round=2,
            datasets={"train": s.data.from_pandas(_frame(n=40))},
            scaling_config=s.train.ScalingConfig(num_workers=2),
            run_config=s.train.RunConfig(name="lgbm_gang", storage_path=tmp)).fit()
    ports = {c["params"]["local_listen_port"] for c in calls}
    return {"error": r.error, "nrows": sorted(c["nrows"] for c in calls),
            "params": [_strip_network(c["params"]) for c in calls],
            "distinct_ports": len(ports),
            "same_machines": calls[0]["params"]["machines"] == calls[1]["params"]["machines"]}


def sc_lightgbm_resume_trains_remaining_rounds(s, tmp):
    calls = []
    with _module("lightgbm", _fake_lightgbm(calls)):
        lgb = s.mod("lightgbm")
        ds = s.data.from_pandas(_frame())
        first = lgb.LightGBMTrainer(label_column="label", num_boost_round=3, datasets={"train": ds},
                                    run_config=s.train.RunConfig(name="lgbm_r1",
                                                                 storage_path=tmp)).fit()
        second = lgb.LightGBMTrainer(label_column="label", num_boost_round=8,
                                     datasets={"train": ds},
                                     run_config=s.train.RunConfig(name="lgbm_r2",
                                                                  storage_path=tmp),
                                     resume_from_checkpoint=first.checkpoint).fit()
    return {"error": second.error, "rounds": [c["rounds"] for c in calls]}


def sc_lightgbm_resume_at_target_still_reports(s, tmp):
    calls = []
    with _module("lightgbm", _fake_lightgbm(calls)):
        lgb = s.mod("lightgbm")
        ds = s.data.from_pandas(_frame())
        first = lgb.LightGBMTrainer(label_column="label", num_boost_round=3, datasets={"train": ds},
                                    run_config=s.train.RunConfig(name="lgbm_done1",
                                                                 storage_path=tmp)).fit()
        n = len(calls)
        again = lgb.LightGBMTrainer(label_column="label", num_boost_round=3,
                                    datasets={"train": ds},
                                    run_config=s.train.RunConfig(name="lgbm_done2",
                                                                 storage_path=tmp),
                                    resume_from_checkpoint=first.checkpoint).fit()
        iters = lgb.RayTrainReportCallback.get_model(again.checkpoint).current_iteration()
    return {"error": again.error, "new_calls": len(calls) - n, "metrics": again.metrics,
            "iters": iters}


def sc_group_token_unique_per_attempt(s, tmp):
    wg = importlib.import_module(s.name + ".train.worker_group")
    kw = {} if s.is_jax else {"device_type": "cpu"}
    g1 = wg.WorkerGroup(s.train.ScalingConfig(num_workers=1), "same_name", tmp, **kw)
    g2 = wg.WorkerGroup(s.train.ScalingConfig(num_workers=1), "same_name", tmp, **kw)
    return bool(g1.group_token) and g1.group_token != g2.group_token


def sc_kv_rendezvous_gathers_in_rank_order(s, tmp):
    import threading

    out = {}

    def rank(r):
        out[r] = s.gbdt.kv_rendezvous("rdv/test", r, 3, {"rank": r, "x": r * 10}, timeout=30)

    threads = [threading.Thread(target=rank, args=(r,)) for r in (2, 0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    internal_kv = importlib.import_module(s.name + ".experimental.internal_kv")
    left = internal_kv._internal_kv_get(b"rdv/test/0")
    try:
        s.gbdt.kv_rendezvous("rdv/lonely", 1, 2, {}, timeout=0.1)
        timed_out = None
    except TimeoutError as exc:
        timed_out = str(exc)
    return {"out": out, "left": left, "timeout": timed_out,
            "default_s": s.gbdt.default_rendezvous_timeout()}


def sc_require_module_is_actionable(s, tmp):
    with _module("lightgbm", None):
        try:
            s.gbdt.require_module("lightgbm")
            return None
        except ImportError as exc:
            return str(exc)


def sc_shard_to_xy_checks_the_label(s, tmp):
    ds = s.data.from_pandas(_frame(n=6))
    X, y = s.gbdt.shard_to_xy(ds, "label")
    try:
        s.gbdt.shard_to_xy(ds, "nope")
        bad = None
    except ValueError as exc:
        bad = str(exc)
    return {"cols": list(X.columns), "y": y.tolist(), "bad": bad}


# --------------------------------------------------------------------------
# tests/test_train_tf.py
# --------------------------------------------------------------------------
def sc_tf_config_cluster_spec_wired(s, tmp):
    train = s.train

    def loop(config):
        spec = json.loads(os.environ["TF_CONFIG"])
        rank = train.get_context().get_world_rank()
        with open(os.path.join(config["out_dir"], f"rank{rank}.json"), "w") as f:
            json.dump({"rank": rank, "task_index": spec["task"]["index"],
                       "task_type": spec["task"]["type"],
                       "workers": spec["cluster"]["worker"]}, f)
        train.report({"rank": rank})

    s.mod("tensorflow").TensorflowTrainer(
        loop, train_loop_config={"out_dir": tmp},
        scaling_config=train.ScalingConfig(num_workers=2)).fit()
    specs = []
    for rank in (0, 1):
        with open(os.path.join(tmp, f"rank{rank}.json")) as f:
            specs.append(json.load(f))
    return {"tasks": [(sp["task_index"], sp["task_type"], len(sp["workers"])) for sp in specs],
            "same": specs[0]["workers"] == specs[1]["workers"],
            "distinct": len(set(specs[0]["workers"]))}


def sc_tf_single_worker_keras_fit(s, tmp):
    pytest.importorskip("tensorflow")
    train = s.train

    def loop(config):
        import numpy as np
        import tensorflow as tf

        x = np.random.default_rng(0).standard_normal((64, 4)).astype("float32")
        y = (x.sum(axis=1) > 0).astype("float32")
        model = tf.keras.Sequential(
            [tf.keras.layers.Dense(8, activation="relu"), tf.keras.layers.Dense(1)])
        model.compile(optimizer="adam", loss="mse")
        hist = model.fit(x, y, epochs=2, verbose=0)
        train.report({"loss": float(hist.history["loss"][-1])})

    r = s.mod("tensorflow").TensorflowTrainer(
        loop, scaling_config=train.ScalingConfig(num_workers=1)).fit()
    return {"error": r.error, "nonneg": r.metrics["loss"] >= 0.0}


def sc_tf_prepare_dataset_shard_passes_through(s, tmp):
    tf = s.mod("tensorflow")
    shard = object()
    return {"same": tf.prepare_dataset_shard(shard) is shard,
            "config": vars(tf.TensorflowConfig()), "all": sorted(tf.__all__)}


# --------------------------------------------------------------------------
# the framework cases of tests/test_predictor.py
# --------------------------------------------------------------------------
def sc_xgboost_predictor_roundtrip(s, tmp):
    mod = types.ModuleType("xgboost")

    class DMatrix:
        def __init__(self, df, **kw):
            self.df = df

    class Booster:
        def __init__(self):
            self.rounds = 7

        def load_model(self, path):
            with open(path) as f:
                self.rounds = int(f.read())

        def save_model(self, path):
            with open(path, "w") as f:
                f.write(str(self.rounds))

        def predict(self, dmat, **kw):
            return np.asarray(dmat.df.sum(axis=1)) * self.rounds

    mod.DMatrix, mod.Booster = DMatrix, Booster
    with _module("xgboost", mod):
        xgb = s.mod("xgboost")
        ckpt = xgb.XGBoostCheckpoint.from_model(Booster(), base_dir=tmp)
        out = xgb.XGBoostPredictor.from_checkpoint(ckpt).predict(
            pd.DataFrame({"a": [1.0, 2.0], "b": [0.0, 1.0]}))
    return list(out["predictions"])


def sc_lightgbm_predictor_roundtrip(s, tmp):
    mod = _fake_lightgbm([])
    with _module("lightgbm", mod):
        lgb = s.mod("lightgbm")
        b = mod.Booster()
        b.iters = 5
        ckpt = lgb.LightGBMCheckpoint.from_model(b, base_dir=tmp)
        out = lgb.LightGBMPredictor.from_checkpoint(ckpt).predict(
            pd.DataFrame({"a": [2.0], "b": [1.0]}))
    return list(out["predictions"])


def sc_tensorflow_predictor_roundtrip(s, tmp):
    tf = pytest.importorskip("tensorflow")
    tfm = s.mod("tensorflow")
    model = tf.keras.Sequential(
        [tf.keras.layers.Input(shape=(2,)), tf.keras.layers.Dense(1, use_bias=False)])
    model.layers[0].set_weights([np.array([[2.0], [3.0]], dtype=np.float32)])
    ckpt = tfm.TensorflowCheckpoint.from_model(model, base_dir=tmp)
    out = tfm.TensorflowPredictor.from_checkpoint(ckpt).predict(
        np.array([[1.0, 0.0], [0.0, 1.0]], dtype=np.float32))
    cols = tfm.TensorflowPredictor(model).predict({"a": np.array([1.0]), "b": np.array([1.0])})
    return {"rows": out["predictions"].ravel().tolist(),
            "cols": cols["predictions"].ravel().tolist()}


def _gpt2(transformers):
    torch.manual_seed(0)
    return transformers.GPT2LMHeadModel(
        transformers.GPT2Config(vocab_size=32, n_positions=8, n_embd=8, n_layer=1, n_head=2))


def sc_transformers_predictor_roundtrip(s, tmp):
    transformers = pytest.importorskip("transformers")
    hf = s.mod("huggingface")
    model = _gpt2(transformers)
    ckpt = hf.TransformersCheckpoint.from_model(model, base_dir=tmp)
    p = hf.TransformersPredictor.from_checkpoint(ckpt, model_cls=transformers.GPT2LMHeadModel,
                                                 **s.device_kw)
    ids = np.array([[1, 2, 3], [4, 5, 6]], dtype=np.int64)
    out = p.predict(ids)["predictions"]
    model.eval()
    with torch.no_grad():
        want = model(input_ids=torch.from_numpy(ids)).logits.numpy()
    return {"shape": out.shape, "close": bool(np.allclose(out, want, atol=1e-5)),
            "sum": float(np.round(out.sum(), 4))}


def sc_transformers_predictor_requires_model_or_pipeline(s, tmp):
    pytest.importorskip("transformers")
    try:
        s.mod("huggingface").TransformersPredictor(**s.device_kw)
    except ValueError as exc:
        return str(exc)


def sc_transformers_predictor_default_class_keeps_logits(s, tmp):
    transformers = pytest.importorskip("transformers")
    hf = s.mod("huggingface")
    ckpt = hf.TransformersCheckpoint.from_model(_gpt2(transformers), base_dir=tmp)
    p = hf.TransformersPredictor.from_checkpoint(ckpt, **s.device_kw)
    return p.predict(np.array([[1, 2, 3]], dtype=np.int64))["predictions"].shape


def sc_transformers_predictor_sole_column_and_error(s, tmp):
    transformers = pytest.importorskip("transformers")
    hf = s.mod("huggingface")
    p = hf.TransformersPredictor.from_checkpoint(
        hf.TransformersCheckpoint.from_model(_gpt2(transformers), base_dir=tmp), **s.device_kw)
    ids = np.array([[1, 2, 3]], dtype=np.int64)
    shape = p.predict({"tokens": ids})["predictions"].shape
    try:
        p.predict({"a": ids, "b": ids})
        err = None
    except KeyError as exc:
        err = str(exc)
    return {"shape": shape, "err": err}


# --------------------------------------------------------------------------
# tests/test_train_hf.py
# --------------------------------------------------------------------------
def sc_accelerate_trainer_gang(s, tmp):
    pytest.importorskip("accelerate")
    train = s.train

    def loop(config):
        import torch
        from accelerate import Accelerator

        torch.manual_seed(0)
        acc = Accelerator(cpu=True)
        model = torch.nn.Linear(4, 1)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        model, opt = acc.prepare(model, opt)
        x = torch.randn(16, 4)
        y = x.sum(dim=1, keepdim=True)
        for _ in range(3):
            loss = ((model(x) - y) ** 2).mean()
            acc.backward(loss)
            opt.step()
            opt.zero_grad()
        train.report({"loss": float(loss.detach()), "world": acc.num_processes,
                      "rank": acc.process_index})

    r = s.mod("huggingface").AccelerateTrainer(
        loop, scaling_config=train.ScalingConfig(num_workers=2), **s.device_kw).fit()
    return {"error": r.error, "world": r.metrics["world"], "rank": r.metrics["rank"],
            "finite": bool(np.isfinite(r.metrics["loss"]))}


def sc_transformers_trainer_tiny_model(s, tmp):
    pytest.importorskip("transformers")
    out_dir = os.path.join(tmp, "hf_out")

    def trainer_init(config):
        import torch
        from transformers import GPT2Config, GPT2LMHeadModel, Trainer, TrainingArguments

        torch.manual_seed(0)
        model = GPT2LMHeadModel(
            GPT2Config(vocab_size=64, n_positions=16, n_embd=16, n_layer=1, n_head=2))

        class Toks(torch.utils.data.Dataset):
            def __len__(self):
                return 16

            def __getitem__(self, i):
                ids = torch.randint(0, 64, (8,))
                return {"input_ids": ids, "labels": ids.clone()}

        args = TrainingArguments(output_dir=out_dir, per_device_train_batch_size=4, max_steps=2,
                                 logging_steps=1, report_to=[], use_cpu=True,
                                 save_strategy="no")
        return Trainer(model=model, args=args, train_dataset=Toks())

    r = s.mod("huggingface").TransformersTrainer(
        trainer_init, scaling_config=s.train.ScalingConfig(num_workers=1), **s.device_kw).fit()
    keys = sorted(k for k in r.metrics if k in ("loss", "train_loss", "step", "epoch"))
    return {"error": r.error, "keys": keys,
            "steps": [row.get("step") for row in r.metrics_dataframe]}


SCENARIOS = [fn for name, fn in sorted(globals().items())
             if name.startswith("sc_") and callable(fn)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{package: {scenario: output}} under one runtime of each package (an
    exception is the scenario's output; a skip is recorded as such)."""
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
                except pytest.skip.Exception as exc:
                    out[name][key] = ("skipped", str(exc))
                except Exception as exc:  # noqa: BLE001 - reported by the test
                    out[name][key] = ("raised", repr(exc))
        finally:
            side.rt.shutdown()
    return out


def _pair(runs, key):
    j, p = runs["ray_tpu"][key], runs["ray_tpu_torch"][key]
    for o in (j, p):
        if isinstance(o, tuple) and o and o[0] == "skipped":
            pytest.skip(o[1])
        assert not (isinstance(o, tuple) and o and o[0] == "raised"), o
    return j, p


def _check_xgb(o):
    m = o["metrics"]
    return (o["error"] is None and m["training_iteration"] == 5
            and m["train-rmse"] == pytest.approx(0.2) and m["valid-rmse"] == pytest.approx(0.2)
            and o["calls"][0]["eval_names"] == ["train", "valid"]
            and o["calls"][0]["params"]["eta"] == 0.3 and o["rounds"] == 5)


def _check_lgb_gang(o):
    return (o["error"] is None and o["nrows"] == [20, 20] and o["distinct_ports"] == 2
            and o["same_machines"]
            and all(p["num_machines"] == 2 and p["tree_learner"] == "data" and p["machines"] == 2
                    and p["listens_on_advertised"] for p in o["params"]))


EXPECT = {
    "xgboost_reports_and_checkpoints": _check_xgb,
    "xgboost_resume_trains_remaining_rounds": lambda o: (
        o["errors"] == [None, None] and o["last"]["resumed_at"] == 4
        and o["last"]["rounds"] == 6 and o["rounds"] == 10),
    "xgboost_two_workers_join_collective": lambda o: o == {
        "error": None, "nrows": [20, 20], "entered": 2, "ports": [9091, 9091]},
    "xgboost_missing_dependency_is_actionable": lambda o: o == {"error": True,
                                                                "actionable": True},
    "lightgbm_reports_and_checkpoints": lambda o: (
        o["error"] is None and o["metrics"]["training_iteration"] == 4
        and o["metrics"]["train-l2"] == pytest.approx(0.25)
        and o["calls"][0]["valid_names"] == ["train", "valid"] and o["iters"] == 4),
    "lightgbm_two_workers_negotiate_machines": _check_lgb_gang,
    "lightgbm_resume_trains_remaining_rounds": lambda o: o == {"error": None, "rounds": [3, 5]},
    "lightgbm_resume_at_target_still_reports": lambda o: (
        o["error"] is None and o["new_calls"] == 0
        and o["metrics"]["training_iteration"] == 3 and o["iters"] == 3),
    "group_token_unique_per_attempt": lambda o: o is True,
    "kv_rendezvous_gathers_in_rank_order": lambda o: (
        all(o["out"][r] == [{"rank": k, "x": k * 10} for k in range(3)] for r in range(3))
        and o["left"] is None and "0/2" in o["timeout"]),
    "require_module_is_actionable": lambda o: "pip install lightgbm" in o,
    "shard_to_xy_checks_the_label": lambda o: o["cols"] == ["a", "b", "c"] and "nope" in o["bad"],
    "tf_config_cluster_spec_wired": lambda o: o == {
        "tasks": [(0, "worker", 2), (1, "worker", 2)], "same": True, "distinct": 2},
    "tf_single_worker_keras_fit": lambda o: o == {"error": None, "nonneg": True},
    "tf_prepare_dataset_shard_passes_through": lambda o: o["same"],
    "xgboost_predictor_roundtrip": lambda o: o == [7.0, 21.0],
    "lightgbm_predictor_roundtrip": lambda o: o == [15.0],
    "tensorflow_predictor_roundtrip": lambda o: o == {"rows": [2.0, 3.0], "cols": [5.0]},
    "transformers_predictor_roundtrip": lambda o: o["shape"] == (2, 3, 32) and o["close"],
    "transformers_predictor_requires_model_or_pipeline": lambda o: "model or a pipeline" in o,
    "transformers_predictor_default_class_keeps_logits": lambda o: o == (1, 3, 32),
    "transformers_predictor_sole_column_and_error": lambda o: (
        o["shape"] == (1, 3, 32) and "input_ids" in o["err"]),
    "accelerate_trainer_gang": lambda o: o == {"error": None, "world": 2, "rank": 0,
                                               "finite": True},
    "transformers_trainer_tiny_model": lambda o: (
        o["error"] is None and ("loss" in o["keys"] or "train_loss" in o["keys"])),
}


@pytest.mark.parametrize("key", sorted(EXPECT))
def test_framework_scenario_matches_jax(runs, key):
    j, p = _pair(runs, key)
    assert p == j
    assert EXPECT[key](p), p


def test_every_scenario_is_checked():
    assert {fn.__name__[3:] for fn in SCENARIOS} == set(EXPECT)


def test_framework_modules_export_what_the_jax_package_does():
    for sub in ("xgboost", "lightgbm", "tensorflow"):
        j = importlib.import_module(f"ray_tpu.train.{sub}")
        p = importlib.import_module(f"ray_tpu_torch.train.{sub}")
        assert sorted(p.__all__) == sorted(j.__all__)
    j = importlib.import_module("ray_tpu.train.huggingface")
    p = importlib.import_module("ray_tpu_torch.train.huggingface")
    public = {n for n in vars(j) if not n.startswith("_") and callable(getattr(j, n))}
    assert public <= set(vars(p))


# --------------------------------------------------------------------------
# the device seam (ROADMAP.md, Queue 3): both behaviours
# --------------------------------------------------------------------------
def _accelerate_env(trainer):
    """What the trainer's rank loop leaves in ``ACCELERATE_USE_CPU`` (the
    loop run directly, the variable cleared around it)."""
    old = os.environ.pop("ACCELERATE_USE_CPU", None)
    try:
        return trainer.train_loop_per_worker({})
    finally:
        os.environ.pop("ACCELERATE_USE_CPU", None)
        if old is not None:
            os.environ["ACCELERATE_USE_CPU"] = old


def test_accelerate_moves_to_the_cpu_only_when_asked_in_the_port():
    from ray_tpu.train.huggingface import AccelerateTrainer as JaxAccelerate
    from ray_tpu_torch.train.huggingface import AccelerateTrainer

    def probe(config=None):
        return os.environ.get("ACCELERATE_USE_CPU")

    assert _accelerate_env(JaxAccelerate(probe)) == "true"  # always, in the JAX package
    assert _accelerate_env(AccelerateTrainer(probe, device="cpu")) == "true"
    assert _accelerate_env(AccelerateTrainer(probe, device="cuda")) is None


class _Logits(torch.nn.Module):
    """A transformers-free model: token ids in, ``.logits`` out."""

    def __init__(self):
        super().__init__()
        self.emb = torch.nn.Embedding(16, 4)

    def forward(self, input_ids):
        return types.SimpleNamespace(logits=self.emb(input_ids))


def test_transformers_predictor_places_the_model_in_the_port_only(monkeypatch):
    from ray_tpu.train.huggingface import TransformersPredictor as JaxPredictor
    from ray_tpu_torch.train.huggingface import TransformersPredictor

    ids = np.array([[1, 2, 3]], dtype=np.int64)
    torch.manual_seed(0)
    model = _Logits()
    want = model(torch.from_numpy(ids)).logits.detach().numpy()
    got = TransformersPredictor(model, device="cpu")
    assert got.device == torch.device("cpu")
    np.testing.assert_array_equal(got.predict(ids)["predictions"], want)
    np.testing.assert_array_equal(JaxPredictor(model).predict(ids)["predictions"], want)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformersPredictor(model)
    # the JAX package's runs on the CPU whatever the host has
    assert JaxPredictor(model).predict(ids)["predictions"].shape == (1, 3, 4)
