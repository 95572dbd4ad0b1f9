"""The port's training library (``ray_tpu_torch.train``: trainers, session,
config, checkpoints through a restart, predictors) against the JAX
package's, case by case of ``tests/test_train.py`` and the non-framework
cases of ``tests/test_predictor.py``.

Each scenario runs once in each package on the same inputs (numpy data from
a seed), every scenario of a package under one runtime
(``init(num_cpus=8)``), as the JAX tests share one per module.  A
scenario returns what a caller sees (metrics, shapes, error types); the
test holds the port's output to the JAX package's and both to the JAX
test's expectations.  The JAX package's ``JaxTrainer`` is the port's
``DeviceTrainer(device="cpu")``; its ``JaxPredictor`` the port's
``DevicePredictor(device="cpu")``.  Losses of the regression loop agree
within 1e-5 relative (both f32, the same data and steps).
"""

import importlib
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

PACKAGES = ("ray_tpu", "ray_tpu_torch")


class _Side:
    """One package's train modules, its trainer and predictor under the
    JAX package's names."""

    def __init__(self, name):
        self.name = name
        self.is_jax = name == "ray_tpu"
        self.rt = importlib.import_module(name)
        self.train = importlib.import_module(name + ".train")
        self.data = importlib.import_module(name + ".data")
        self.torch_mod = importlib.import_module(name + ".train.torch")

    def trainer(self, loop=None, **kw):
        if self.is_jax:
            return self.train.JaxTrainer(loop, **kw)
        return self.train.DeviceTrainer(loop, device="cpu", **kw)

    def torch_trainer(self, loop, **kw):
        if self.is_jax:
            return self.torch_mod.TorchTrainer(loop, **kw)
        return self.torch_mod.TorchTrainer(loop, device="cpu", **kw)

    def predictor_from_checkpoint(self, ckpt, apply_fn):
        if self.is_jax:
            return self.train.JaxPredictor.from_checkpoint(ckpt, apply_fn)
        return self.train.DevicePredictor.from_checkpoint(ckpt, apply_fn, device="cpu")

    def torch_predictor_from_checkpoint(self, ckpt, model):
        if self.is_jax:
            return self.torch_mod.TorchPredictor.from_checkpoint(ckpt, model)
        return self.torch_mod.TorchPredictor.from_checkpoint(ckpt, model, device="cpu")

    def ones(self, shape):
        if self.is_jax:
            import jax.numpy as jnp

            return jnp.ones(shape)
        return torch.ones(shape)

    def zeros(self, shape):
        if self.is_jax:
            import jax.numpy as jnp

            return jnp.zeros(shape)
        return torch.zeros(shape)

    def tensor_sum(self, x, axis):
        if self.is_jax:
            import jax.numpy as jnp

            return jnp.sum(x, axis=axis)
        return torch.sum(x, dim=axis)


# --------------------------------------------------------------------------
# the scenarios (each: side, tmp dir -> what a caller sees)
# --------------------------------------------------------------------------
def sc_single_worker_report(s, tmp):
    train = s.train

    def loop(config):
        for i in range(3):
            train.report({"step": i, "loss": 1.0 / (i + 1)})

    r = s.trainer(loop, scaling_config=train.ScalingConfig(num_workers=1)).fit()
    return {"metrics": r.metrics, "rows": len(r.metrics_dataframe), "error": r.error}


def sc_multi_worker_context(s, tmp):
    train = s.train

    def loop(config):
        ctx = train.get_context()
        train.report({"rank": ctx.get_world_rank(), "world": ctx.get_world_size(),
                      "local": ctx.get_local_world_size(),
                      "restart": ctx.get_restart_count(),
                      "token": bool(ctx.get_group_token())})

    return s.trainer(loop, scaling_config=train.ScalingConfig(num_workers=4)).fit().metrics


def sc_train_loop_config(s, tmp):
    train = s.train

    def loop(config):
        train.report({"lr": config["lr"]})

    return s.trainer(loop, train_loop_config={"lr": 0.1}).fit().metrics


def sc_checkpoint_roundtrip(s, tmp):
    train = s.train

    def loop(config):
        ckpt = train.Checkpoint.from_dict({"weights": [1, 2, 3]}, base_dir=tmp)
        train.report({"done": 1}, checkpoint=ckpt)

    r = s.trainer(loop).fit()
    return r.checkpoint.to_dict()["weights"]


def sc_pytree_checkpoint(s, tmp):
    train = s.train

    def loop(config):
        params = {"w": s.ones((2, 2)), "b": s.zeros(2)}
        train.report({"ok": 1}, checkpoint=train.Checkpoint.from_pytree(params, base_dir=tmp))

    tree = s.trainer(loop).fit().checkpoint.to_pytree()
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v).tolist()
            for k, v in tree.items()}


def sc_dataset_shards(s, tmp):
    train = s.train
    ds = s.data.range(80, parallelism=4)

    def loop(config):
        shard = train.get_dataset_shard("train")
        total = sum(int(b["id"].sum()) for b in shard.iter_batches(batch_size=16))
        train.report({"n": shard.count(), "total": total})

    r = s.trainer(loop, scaling_config=train.ScalingConfig(num_workers=4),
                  datasets={"train": ds}).fit()
    return r.metrics


def sc_mesh_available(s, tmp):
    train = s.train

    def loop(config):
        ctx = train.get_context()
        mesh = ctx.get_mesh()
        train.report({"n_devices": len(ctx.get_devices()), "has_mesh": mesh is not None,
                      "axes": list(mesh.axis_names)})

    return s.trainer(loop, scaling_config=train.ScalingConfig(num_workers=2)).fit().metrics


def sc_failure_restart(s, tmp):
    train = s.train
    marker = os.path.join(tmp, "attempt")

    def loop(config):
        ckpt = train.get_checkpoint()
        start = ckpt.to_dict()["step"] + 1 if ckpt else 0
        for step in range(start, 4):
            if step == 2 and not os.path.exists(marker):
                with open(marker, "w") as f:
                    f.write("crashed")
                raise RuntimeError("injected failure")
            train.report({"step": step, "restart": train.get_context().get_restart_count()},
                         checkpoint=train.Checkpoint.from_dict({"step": step}, base_dir=tmp))

    r = s.trainer(loop, run_config=train.RunConfig(
        failure_config=train.FailureConfig(max_failures=2))).fit()
    return {"error": r.error, "metrics": r.metrics,
            "steps": [m["step"] for m in r.metrics_dataframe]}


class _Held:
    """A stand-in for a rank's device state, watched by a weak reference."""


def sc_failed_attempt_locals(s, tmp):
    """Whether the failed attempt's locals (a rank's train state, on the
    card in the port) are still alive when the restarted attempt runs."""
    import weakref

    train = s.train
    held = []

    def loop(config):
        state = _Held()
        held.append(weakref.ref(state))
        if train.get_context().get_restart_count() == 0:
            raise RuntimeError("injected failure")
        train.report({"first_attempt_state_alive": held[0]() is not None})

    r = s.trainer(loop, run_config=train.RunConfig(
        failure_config=train.FailureConfig(max_failures=1))).fit()
    return {"error": r.error, **r.metrics}


def sc_failure_budget(s, tmp):
    train = s.train

    def loop(config):
        raise ValueError("always fails")

    r = s.trainer(loop, run_config=train.RunConfig(
        failure_config=train.FailureConfig(max_failures=1))).fit()
    return {"error": type(r.error).__name__, "cause": type(r.error.cause).__name__}


def _regression_data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 4)).astype(np.float32)
    true_w = np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)
    return x, x @ true_w


def sc_training_end_to_end(s, tmp):
    """An actual model trained through the trainer: linear regression on
    the same seeded numpy data, 100 full-batch gradient steps."""
    train = s.train
    x_np, y_np = _regression_data()

    def jax_loop(config):
        import jax
        import jax.numpy as jnp

        w = jnp.zeros((4, 1))
        x, y = jnp.asarray(x_np), jnp.asarray(y_np)

        @jax.jit
        def step(w, x, y):
            def loss_fn(w):
                return jnp.mean((x @ w - y) ** 2)

            loss, g = jax.value_and_grad(loss_fn)(w)
            return w - 0.1 * g, loss

        for _ in range(100):
            w, loss = step(w, x, y)
        train.report({"loss": float(loss)})

    def port_loop(config):
        dev = train.get_context().get_devices()[0]
        w = torch.zeros((4, 1), device=dev)
        x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)
        for _ in range(100):
            w.requires_grad_(True)
            loss = torch.mean((x @ w - y) ** 2)
            (g,) = torch.autograd.grad(loss, w)
            w = (w - 0.1 * g).detach()
        train.report({"loss": float(loss.detach())})

    r = s.trainer(jax_loop if s.is_jax else port_loop,
                  scaling_config=train.ScalingConfig(num_workers=2)).fit()
    return r.metrics["loss"]


def _torch_loops(config):
    """The two ``TorchTrainer`` loops of ``tests/test_train.py`` in one
    fit: the rank allreduce, then DDP training (the port's with the model
    on ``get_device()``)."""
    import importlib as _il

    import numpy as _np
    import torch as _torch
    import torch.distributed as dist

    pkg = config["package"]
    train = _il.import_module(pkg + ".train")
    ttorch = _il.import_module(pkg + ".train.torch")
    dev = ttorch.get_device()
    ctx = train.get_context()
    t = _torch.tensor([float(ctx.get_world_rank() + 1)], device=dev)
    dist.all_reduce(t)  # 1 + 2 = 3 across both ranks
    out = {"reduced": float(t.item()), "world": dist.get_world_size(), "device": str(dev)}

    _torch.manual_seed(42)  # same init on every rank
    model = ttorch.prepare_model(_torch.nn.Linear(4, 1).to(dev))
    opt = _torch.optim.SGD(model.parameters(), lr=0.1)
    rng = _np.random.default_rng(ctx.get_world_rank())  # different data per rank
    for _ in range(5):
        x = _torch.tensor(rng.normal(size=(8, 4)), dtype=_torch.float32, device=dev)
        y = x.sum(dim=1, keepdim=True)
        loss = ((model(x) - y) ** 2).mean()
        opt.zero_grad()
        loss.backward()  # DDP all-reduces grads here
        opt.step()
    w = model.module.weight if hasattr(model, "module") else model.weight
    w0 = _torch.tensor([w[0, 0].item()])
    gathered = [_torch.zeros(1) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, w0)
    out.update(w0=float(w[0, 0].item()), loss=float(loss.item()),
               w0_spread=float(max(g.item() for g in gathered) - min(g.item() for g in gathered)),
               ddp=hasattr(model, "module"))
    train.report(out)


def sc_torch_trainer(s, tmp):
    r = s.torch_trainer(_torch_loops, train_loop_config={"package": s.name},
                        scaling_config=s.train.ScalingConfig(num_workers=2)).fit()
    return {"metrics": r.metrics, "error": r.error}


def sc_predictor_from_pytree_checkpoint(s, tmp):
    ckpt = s.train.Checkpoint.from_pytree({"scale": np.array(3.0)}, base_dir=tmp)

    def apply_fn(params, x):
        return params["scale"] * s.tensor_sum(x, -1)

    p = s.predictor_from_checkpoint(ckpt, apply_fn)
    out = p.predict({"a": np.array([1.0, 2.0]), "b": np.array([1.0, 0.0])})
    out2 = p.predict(np.array([[1.0, 1.0], [2.0, 0.0]]))
    return [np.asarray(out["predictions"]).tolist(), np.asarray(out2["predictions"]).tolist()]


def sc_predictor_surface(s, tmp):
    """``tests/test_predictor.py``'s non-framework cases."""
    import pandas as pd

    Predictor = s.train.Predictor

    class Double(Predictor):
        @classmethod
        def from_checkpoint(cls, checkpoint, **kw):
            return cls(**kw)

        def _predict_pandas(self, df, **kw):
            return pd.DataFrame({"predictions": df.sum(axis=1) * 2})

    class AddOne:
        def transform_batch(self, df):
            return df + 1

    class Empty(Predictor):
        pass

    out = {
        "pandas": list(Double().predict(pd.DataFrame({"a": [1.0, 2.0], "b": [3.0, 4.0]}))["predictions"]),
        "dict": list(Double().predict({"a": np.array([1.0, 2.0]), "b": np.array([3.0, 4.0])})["predictions"]),
        "preprocessor": list(Double(preprocessor=AddOne()).predict(
            pd.DataFrame({"a": [1.0], "b": [1.0]}))["predictions"]),
        "udf": list(Predictor.from_pandas_udf(lambda df: pd.DataFrame(
            {"predictions": df["x"] * 10})).predict(pd.DataFrame({"x": [1.0, 2.0]}))["predictions"]),
    }
    for key, fn in (("pickle", lambda: pickle.dumps(Double())),
                    ("batch_type", lambda: Double().predict([1, 2, 3])),
                    ("empty", lambda: Empty().predict(pd.DataFrame({"a": [1.0]})))):
        try:
            fn()
            out[key] = None
        except Exception as exc:  # noqa: BLE001 - the error is the output
            out[key] = (type(exc).__name__, str(exc).split(" ")[0] if key != "pickle"
                        else "from_checkpoint" in str(exc))
    ds = s.data.from_pandas(pd.DataFrame({"a": np.arange(8.0), "b": np.ones(8)}))

    class Scorer:
        def __init__(self):
            self.predictor = Double()

        def __call__(self, batch):
            return self.predictor.predict(batch)

    out["map_batches"] = sorted(r["predictions"] for r in
                                ds.map_batches(Scorer, batch_format="pandas").take_all())
    return out


def sc_torch_predictor(s, tmp):
    """``TorchCheckpoint`` / ``TorchPredictor``: dict batches and the
    DataFrame path with a 2-d output."""
    import pandas as pd

    tt = s.torch_mod
    model = torch.nn.Linear(2, 1, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.tensor([[2.0, 3.0]]))
    ckpt = tt.TorchCheckpoint.from_model(model, base_dir=os.path.join(tmp, "a"))
    p = s.torch_predictor_from_checkpoint(ckpt, torch.nn.Linear(2, 1, bias=False))
    out = p.predict({"a": np.array([1.0, 0.0]), "b": np.array([0.0, 1.0])})
    model2 = torch.nn.Linear(2, 1, bias=False)
    with torch.no_grad():
        model2.weight.copy_(torch.tensor([[1.0, 1.0]]))
    p2 = s.torch_predictor_from_checkpoint(
        tt.TorchCheckpoint.from_model(model2, base_dir=os.path.join(tmp, "b")),
        torch.nn.Linear(2, 1, bias=False))
    df = p2.predict(pd.DataFrame({"a": [1.0, 2.0], "b": [3.0, 4.0]}))
    return {"dict": out["predictions"].ravel().tolist(),
            "frame": [float(np.asarray(v).ravel()[0]) for v in df["predictions"]]}


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_single_worker_report, sc_multi_worker_context, sc_train_loop_config,
    sc_checkpoint_roundtrip, sc_pytree_checkpoint, sc_dataset_shards, sc_mesh_available,
    sc_failure_restart, sc_failed_attempt_locals, sc_failure_budget, sc_training_end_to_end,
    sc_torch_trainer,
    sc_predictor_from_pytree_checkpoint, sc_predictor_surface, sc_torch_predictor)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{package: {scenario: output}}: every scenario through one runtime of
    each package (an exception is the scenario's output)."""
    out = {}
    for name in PACKAGES:
        side = _Side(name)
        side.rt.init(num_cpus=8)
        try:
            res = {}
            for key, fn in SCENARIOS.items():
                tmp = str(tmp_path_factory.mktemp(f"{name}_{key}"))
                try:
                    res[key] = fn(side, tmp)
                except Exception as exc:  # noqa: BLE001 - reported by the test
                    res[key] = ("raised", repr(exc))
            out[name] = res
        finally:
            side.rt.shutdown()
    return out


def _pair(runs, key):
    return runs["ray_tpu"][key], runs["ray_tpu_torch"][key]


def test_single_worker_report_matches_jax(runs):
    j, p = _pair(runs, "single_worker_report")
    assert p == j
    assert p["metrics"]["step"] == 2 and p["rows"] == 3 and p["error"] is None


def test_multi_worker_context_matches_jax(runs):
    j, p = _pair(runs, "multi_worker_context")
    assert p == j == {"rank": 0, "world": 4, "local": 4, "restart": 0, "token": True}


def test_train_loop_config_passed_matches_jax(runs):
    j, p = _pair(runs, "train_loop_config")
    assert p == j == {"lr": 0.1}


def test_checkpoint_roundtrip_matches_jax(runs):
    j, p = _pair(runs, "checkpoint_roundtrip")
    assert p == j == [1, 2, 3]


def test_pytree_checkpoint_matches_jax(runs):
    j, p = _pair(runs, "pytree_checkpoint")
    assert p == j == {"w": [[1.0, 1.0], [1.0, 1.0]], "b": [0.0, 0.0]}


def test_dataset_shards_match_jax(runs):
    j, p = _pair(runs, "dataset_shards")
    assert p == j
    assert p["n"] == 20  # 80 rows / 4 workers


def test_mesh_available_in_worker_matches_jax(runs):
    j, p = _pair(runs, "mesh_available")
    assert p == j
    assert p["has_mesh"] is True and p["n_devices"] >= 1 and p["axes"] == ["data"]


def test_failure_restart_resumes_from_checkpoint_matches_jax(runs):
    j, p = _pair(runs, "failure_restart")
    assert p == j
    assert p["error"] is None and p["metrics"] == {"step": 3, "restart": 1}
    assert p["steps"] == [0, 1, 2, 3]


def test_failed_attempt_releases_its_locals_in_the_port_only(runs):
    """Divergence (ROADMAP Queue 3, F14): the JAX package's trainer keeps
    the failed attempt's error, whose traceback frames hold the rank's
    locals, alive through the restart; the port clears those frames when it
    catches the error (``trainer.release_frames``), so a rank's state on
    the card is freed before the restarted rank allocates its own."""
    j, p = _pair(runs, "failed_attempt_locals")
    assert j == {"error": None, "first_attempt_state_alive": True}
    assert p == {"error": None, "first_attempt_state_alive": False}


def test_failure_exhausts_budget_matches_jax(runs):
    j, p = _pair(runs, "failure_budget")
    assert p == j == {"error": "RayTaskError", "cause": "ValueError"}


def test_training_end_to_end_matches_jax(runs):
    j, p = _pair(runs, "training_end_to_end")
    assert p < 0.05 and j < 0.05
    assert abs(p - j) <= 1e-5 * max(abs(j), 1e-3)


def test_torch_trainer_allreduce_matches_jax(runs):
    j, p = _pair(runs, "torch_trainer")
    assert j["error"] is None and p["error"] is None
    for out in (j["metrics"], p["metrics"]):
        assert out["reduced"] == 3.0 and out["world"] == 2


def test_torch_trainer_ddp_training_matches_jax(runs):
    j, p = _pair(runs, "torch_trainer")
    j, p = j["metrics"], p["metrics"]
    assert j["ddp"] and p["ddp"]
    assert np.isfinite(p["loss"]) and p["w0_spread"] == 0.0 == j["w0_spread"]
    # the same seeded model and data on the CPU: the same trained weight
    assert abs(p["w0"] - j["w0"]) <= 1e-5 * abs(j["w0"])
    assert abs(p["loss"] - j["loss"]) <= 1e-5 * max(abs(j["loss"]), 1e-3)


def test_get_device_is_the_ranks_device_in_the_port_only(runs):
    """Divergence (ROADMAP Queue 3): the JAX package's
    ``train.torch.get_device()`` is always the CPU (its compute runs
    through JAX); the port's is the rank's device, the CPU here because the
    trainer was given ``device="cpu"`` (``cuda:0`` on one card:
    ``tests/test_torch_cuda.py -k trainer``)."""
    j, p = _pair(runs, "torch_trainer")
    assert j["metrics"]["device"] == "cpu" == p["metrics"]["device"]
    from ray_tpu.train.torch import get_device as jax_get_device

    from ray_tpu_torch.train.torch import get_device as port_get_device

    assert str(jax_get_device()) == "cpu"  # no rank needed
    with pytest.raises(RuntimeError, match="Not inside a train worker"):
        port_get_device()


def test_predictor_from_tree_checkpoint_matches_jax(runs):
    j, p = _pair(runs, "predictor_from_pytree_checkpoint")
    np.testing.assert_allclose(p, j, rtol=1e-6)
    np.testing.assert_allclose(p, [[6.0, 6.0], [6.0, 6.0]])


def test_predictor_surface_matches_jax(runs):
    j, p = _pair(runs, "predictor_surface")
    assert p == j
    assert p["pandas"] == [8.0, 12.0] and p["dict"] == [8.0, 12.0]
    assert p["preprocessor"] == [8.0] and p["udf"] == [10.0, 20.0]
    assert p["pickle"] == ("PredictorNotSerializableException", True)
    assert p["batch_type"] == ("TypeError", "Unsupported")
    assert p["empty"][0] == "NotImplementedError"
    assert p["map_batches"] == pytest.approx(sorted((a + 1) * 2 for a in np.arange(8.0)))


def test_torch_predictor_matches_jax(runs):
    j, p = _pair(runs, "torch_predictor")
    assert p == j == {"dict": [2.0, 3.0], "frame": [4.0, 6.0]}


def _death_while_starting(name):
    """A rank that dies while the gang starts (``WorkerGroup.start`` made
    to raise the typed death after creating the ranks): what ``fit()`` and
    the ``TrainingIterator`` give the caller."""
    import importlib as il

    rt = il.import_module(name)
    side = _Side(name)
    wg = il.import_module(name + ".train.worker_group").WorkerGroup
    exc = il.import_module(name + ".exceptions")
    original = wg.start

    def start(self):
        original(self)
        raise exc.ActorDiedError(None, "rank died while the gang started")

    rt.init(num_cpus=4)
    wg.start = start
    try:
        run_config = side.train.RunConfig(failure_config=side.train.FailureConfig(max_failures=0))
        out = {}
        try:
            out["fit"] = type(side.trainer(lambda: None, run_config=run_config).fit().error).__name__
        except Exception as e:  # noqa: BLE001 - the error is the output
            out["fit"] = ("raised", type(e).__name__)
        it = side.trainer(lambda: None, run_config=run_config).training_iterator()
        try:
            list(it)
            out["iterator"] = None
        except Exception as e:  # noqa: BLE001 - the error is the output
            out["iterator"] = ("raised", type(e).__name__)
        out["iterator_result_error"] = type(it.result().error).__name__
        return out
    finally:
        wg.start = original
        rt.shutdown()


def test_rank_death_while_the_gang_starts_is_the_attempts_error_in_the_port_only():
    """Divergence (ROADMAP Queue 3, F15): the JAX package starts the gang
    outside its attempt's ``try``, so a rank that dies then escapes
    ``fit()`` untyped by its ``FailureConfig`` and leaves the
    ``TrainingIterator``'s result without an error (what makes
    ``tests/test_train_controller.py::test_training_iterator_member_kill_raises_typed_never_hangs``
    fail now and then). In the port it is the attempt's typed error."""
    assert _death_while_starting("ray_tpu") == {
        "fit": ("raised", "ActorDiedError"), "iterator": ("raised", "ActorDiedError"),
        "iterator_result_error": "NoneType"}
    assert _death_while_starting("ray_tpu_torch") == {
        "fit": "ActorDiedError", "iterator": ("raised", "ActorDiedError"),
        "iterator_result_error": "ActorDiedError"}


# --------------------------------------------------------------------------
# the port's own surface: naming and the device rule
# --------------------------------------------------------------------------
def test_jax_named_entry_points_raise_naming_the_port_ones():
    from ray_tpu_torch.exceptions import NotPortedError
    from ray_tpu_torch.train import JaxPredictor, JaxTrainer

    with pytest.raises(NotPortedError, match="DeviceTrainer"):
        JaxTrainer(lambda: None)
    with pytest.raises(NotPortedError, match="DevicePredictor"):
        JaxPredictor(lambda p, x: x, {})
    with pytest.raises(NotPortedError, match="DevicePredictor"):
        JaxPredictor.from_checkpoint(None, lambda p, x: x)


def test_train_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    """With no device named and no CUDA, every entry point raises (no
    silent CPU fallback); ``device="cpu"`` is the CPU on request."""
    import ray_tpu_torch.accelerators.gpu as gpu
    from ray_tpu_torch import train
    from ray_tpu_torch.train.torch import TorchPredictor, TorchTrainer

    monkeypatch.setattr(gpu, "cuda_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: train.DeviceTrainer(lambda: None),
                 lambda: train.DeviceTrainer(gang={"world_size": 1}),
                 lambda: TorchTrainer(lambda: None),
                 lambda: train.DevicePredictor(lambda p, x: x, {}),
                 lambda: TorchPredictor(torch.nn.Linear(2, 1)),
                 lambda: train.TrainController("nocuda", world_size=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert train.DeviceTrainer(lambda: None, device="cpu")._device_type == "cpu"
    assert TorchPredictor(torch.nn.Linear(2, 1), device="cpu").device.type == "cpu"


def test_scaling_config_asks_for_gpus_where_jax_asks_for_tpus():
    from ray_tpu.train import ScalingConfig as JaxScaling

    from ray_tpu_torch.train import ScalingConfig

    assert ScalingConfig(num_workers=2).worker_resources() == \
        JaxScaling(num_workers=2).worker_resources() == {"CPU": 1}
    assert JaxScaling(use_tpu=True, num_devices_per_worker=2).worker_resources() == \
        {"CPU": 1, "TPU": 2}
    assert ScalingConfig(use_gpu=True, num_devices_per_worker=2).worker_resources() == \
        {"CPU": 1, "GPU": 2}
    assert ScalingConfig(num_workers=3, num_devices_per_worker=2).total_devices == \
        JaxScaling(num_workers=3, num_devices_per_worker=2).total_devices == 6


def test_rank_devices_wrap_the_cards(monkeypatch):
    """A CUDA rank's device: ``cuda:(rank × devices_per_worker) %
    device_count``; a share of one card puts every rank on ``cuda:0``."""
    from ray_tpu_torch.train.worker_group import rank_devices

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [str(d) for r in range(3) for d in rank_devices(r, 1, "cuda")] == \
        ["cuda:0", "cuda:1", "cuda:0"]
    assert [str(d) for d in rank_devices(1, 2, "cuda")] == ["cuda:0", "cuda:1"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert [str(d) for r in range(2) for d in rank_devices(r, 0.5, "cuda")] == \
        ["cuda:0", "cuda:0"]
    assert rank_devices(3, 1, "cpu") == [torch.device("cpu")]


def test_rank_gpu_shares_fit_the_card(monkeypatch):
    """A CUDA rank that names no GPU asks for its share of the node's
    cards, rounded down to the scheduler's milli-units: the shares of every
    gang size fit one card, where rounding to nearest gives 6 × 0.167."""
    import ray_tpu_torch
    from ray_tpu_torch.core.resources import SCALE, to_fixed
    from ray_tpu_torch.train import ScalingConfig
    from ray_tpu_torch.train.worker_group import WorkerGroup

    monkeypatch.setattr(ray_tpu_torch, "cluster_resources", lambda: {"CPU": 8, "GPU": 1.0})
    for n in range(1, 9):
        res = WorkerGroup(ScalingConfig(num_workers=n), "e", "/nonexistent").worker_resources()
        assert n * to_fixed(res["GPU"]) <= SCALE and res["GPU"] > 1 / n - 1 / SCALE, (n, res)
    res = WorkerGroup(ScalingConfig(num_workers=2), "e", "/x", device_type="cpu").worker_resources()
    assert "GPU" not in res


def test_tune_session_matches_jax():
    """``tune/session.py``: outside a trial, and inside one."""
    from ray_tpu.tune import session as jsess

    from ray_tpu_torch.tune import session as psess

    outs = []
    for sess in (jsess, psess):
        got = []
        out = {"outside": (sess.in_tune_session(), sess.get_checkpoint(), sess.get_trial_id())}
        try:
            sess.report({"a": 1})
        except RuntimeError as exc:
            out["report_outside"] = str(exc)
        sess.init_trial_session(sess._TuneSession("t1", lambda m, c: got.append((m, c)), "ck"))
        try:
            sess.report({"a": 2}, checkpoint="c")
            sess.get_trial_session().stop_requested = True
            try:
                sess.report({"a": 3})
            except BaseException as exc:  # noqa: BLE001 - TrialInterrupt
                out["stop"] = type(exc).__name__
            out["inside"] = (sess.in_tune_session(), sess.get_checkpoint(), sess.get_trial_id(), got)
        finally:
            sess.shutdown_trial_session()
        outs.append(out)
    assert outs[1] == outs[0]
    assert outs[1]["stop"] == "TrialInterrupt"
