"""The port's ``TrainController`` (``ray_tpu_torch.train.controller``) and the
gang paths of its trainer against the JAX package's, case by case of
``tests/test_train_controller.py`` and ``tests/test_train_elastic.py``.

Each scenario runs once in each package on the same inputs (the default
least-squares probe loss over ``global_batch``'s seeded numpy batches), all
of a package's scenarios under one runtime, as each JAX test module shares
one (``init(num_cpus=8)`` for the controller cases, ``num_cpus=4`` for the
elastic ones, whose capacity tick reads it).  The port runs on the CPU
(``device="cpu"``).  Tolerances: losses and params within 1e-5 relative
(f32 both, the same batches; only the BLAS and the summation order
differ), the step, history lengths, trace counts' deltas and ``rng_key``
exactly (the port's threefry-2x32 reproduces ``jax.random``'s words).
One more case trains a 2-layer, d_model 64, T 32 decoder through the gang
(the JAX side's flash attention in Pallas interpret mode, f32): losses
within 1e-4 relative.
"""

import importlib
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

PACKAGES = ("ray_tpu", "ray_tpu_torch")
RTOL = 1e-5


class _Side:
    def __init__(self, name):
        self.name = name
        self.is_jax = name == "ray_tpu"
        self.rt = importlib.import_module(name)
        self.train = importlib.import_module(name + ".train")
        self.exc = importlib.import_module(name + ".exceptions")
        self.control = importlib.import_module(name + ".runtime.control")
        self.ckpt = importlib.import_module(name + ".train.checkpoint")
        self.metric_defs = importlib.import_module(name + ".observability.metric_defs")

    def controller(self, name, **kw):
        if not self.is_jax:
            kw.setdefault("device", "cpu")
        return self.train.TrainController(name, **kw)

    def trainer(self, loop=None, **kw):
        if self.is_jax:
            return self.train.JaxTrainer(loop, **kw)
        return self.train.DeviceTrainer(loop, device="cpu", **kw)


def _state(ctl):
    """A controller's resume state as numpy (params, momentum, key, step,
    history)."""
    st = ctl._state()
    return {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in st.items()}


# --------------------------------------------------------------------------
# tests/test_train_controller.py
# --------------------------------------------------------------------------
def _save_in_worker(path, package):
    import importlib as _il

    import numpy as _np

    ck = _il.import_module(package + ".train.checkpoint")
    if package == "ray_tpu":
        import jax

        key = _np.asarray(jax.random.PRNGKey(1234))
    else:
        key = _il.import_module(package + ".train.controller").prng_key(1234)
    tree = {
        "params": _np.arange(16, dtype=_np.float32) / 3.0,
        "momentum": _np.full(16, -0.25, dtype=_np.float32),
        "rng_key": key,
        "step": 7,
    }
    ck.save_framed(path, tree)
    return {k: v.tobytes() if hasattr(v, "tobytes") else v for k, v in tree.items()}


def sc_framed_roundtrip_cross_process(s, tmp):
    path = os.path.join(tmp, "state.ckpt")
    expected = s.rt.get(s.rt.remote(_save_in_worker).options(execution="process").remote(
        path, s.name), timeout=120)
    restored = s.ckpt.load_framed(path)
    return {"step": restored["step"] == expected["step"],
            **{k: np.asarray(restored[k]).tobytes() == expected[k]
               for k in ("params", "momentum", "rng_key")},
            "rng_key_words": np.asarray(restored["rng_key"]).tolist()}


def sc_framed_torn_file(s, tmp):
    path = os.path.join(tmp, "state.ckpt")
    s.ckpt.save_framed(path, {"step": 1})
    s.ckpt.save_framed(path, {"step": 2})
    out = [s.ckpt.load_framed(path)["step"]]
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 3)
    out.append(s.ckpt.load_framed(path)["step"])
    with open(path + ".prev", "r+b") as f:
        f.seek(12)
        f.write(b"\xff\xff\xff")
    out.append(s.ckpt.load_framed(path))
    return out


def sc_checkpoint_state(s, tmp):
    ctl = s.controller("ckpt_rt", world_size=2, batch_size=8, feature_dim=4, seed=5,
                       checkpoint_dir=tmp, checkpoint_period=10**9)
    try:
        ctl.run(3)
        ctl.save_checkpoint()
        saved = s.ckpt.load_framed(ctl.checkpoint_path)
        live = _state(ctl)
        return {"step": saved["step"],
                "params_equal": saved["params"].tobytes() == live["params"].tobytes(),
                "key_equal": saved["rng_key"].tobytes() == live["rng_key"].tobytes(),
                "state": {k: saved[k] for k in ("params", "momentum", "rng_key",
                                                "loss_history", "world_size", "seed")}}
    finally:
        ctl.shutdown()


def sc_recover_bit_exact(s, tmp):
    ctl = s.controller("bitexact_a", world_size=2, batch_size=8, feature_dim=4, seed=21,
                       checkpoint_period=4)
    ref = s.controller("bitexact_b", world_size=2, batch_size=8, feature_dim=4, seed=21,
                       checkpoint_period=10**9)
    try:
        ctl.run(6)  # checkpoint lands at step 4
        s.rt.kill(ctl._members[1], no_restart=False)
        ctl.run(4, auto_repair=True)
        uninterrupted = ref.run(10)
        return {"step": ctl.step_count,
                "repairs": [(r["step"], r["outcome"], r["world_size"], r["error"])
                            for r in ctl.repair_history],
                "bitwise": np.asarray(ctl.losses(), np.float32).tobytes()
                == np.asarray(uninterrupted, np.float32).tobytes(),
                "losses": ctl.losses(), "rng_key": _state(ctl)["rng_key"].tolist(),
                "params": _state(ctl)["params"]}
    finally:
        ctl.shutdown()
        ref.shutdown()


def sc_recover_without_auto_repair(s, tmp):
    ctl = s.controller("typed_err", world_size=2, batch_size=8, feature_dim=4, seed=3)
    try:
        ctl.run(2)
        s.rt.kill(ctl._members[0], no_restart=True)
        try:
            ctl.run(3, auto_repair=False)
            return None
        except (s.exc.RayActorError, s.exc.WorkerCrashedError) as exc:
            return {"typed": True, "type": type(exc).__name__, "step": ctl.step_count}
    finally:
        ctl.shutdown()


def sc_claim_after_head_restart(s, tmp):
    cluster = s.rt.get_cluster()
    ctl = s.controller("claimed", world_size=2, batch_size=8, feature_dim=4, seed=9,
                       checkpoint_period=10**9)
    ckpt_dir = os.path.dirname(ctl.checkpoint_path)
    try:
        ctl.run(5)
        ctl.save_checkpoint()
        saved = _state(ctl)
    finally:
        ctl.shutdown()
    cluster.kill_head()
    cluster.restart_head()
    overrides = {} if s.is_jax else {"device": "cpu"}
    ctl2 = s.train.TrainController.claim("claimed", **overrides)
    try:
        restored = _state(ctl2)
        out = {"dir": os.path.dirname(ctl2.checkpoint_path) == ckpt_dir,
               "step": ctl2.step_count,
               "params": restored["params"].tobytes() == saved["params"].tobytes(),
               "key": restored["rng_key"].tobytes() == saved["rng_key"].tobytes()}
        ctl2.run(1)
        out["after"] = ctl2.step_count
        out["loss"] = ctl2.losses()[-1]
        return out
    finally:
        ctl2.shutdown()


def _kill_one_train_worker(s, cluster, done, timeout=30.0, after=None):
    """Kill the first live train rank, once ``after`` is set (if given; at
    most 60 s), and set ``done``."""
    if after is not None and not after.wait(60.0):
        return
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not done.is_set():
        for info in cluster.control.actors.list_actors():
            if (info.class_name.endswith("TrainWorkerActor")
                    and info.state is s.control.ActorState.ALIVE):
                cluster.kill_actor(info.actor_id, no_restart=True)
                done.set()
                return
        time.sleep(0.02)


def sc_iterator_member_kill(s, tmp):
    train = s.train

    def loop(config):
        for i in range(200):  # ~10s — far beyond the kill
            train.report({"i": i})
            time.sleep(0.05)

    trainer = s.trainer(loop, scaling_config=train.ScalingConfig(num_workers=2),
                        run_config=train.RunConfig(
                            failure_config=train.FailureConfig(max_failures=0)))
    it = trainer.training_iterator()
    killed = threading.Event()
    killer = threading.Thread(target=_kill_one_train_worker,
                              args=(s, s.rt.get_cluster(), killed), daemon=True)
    killer.start()
    t0 = time.monotonic()
    raised = None
    try:
        for _ in it:
            pass
    except (s.exc.RayActorError, s.exc.WorkerCrashedError) as exc:
        raised = type(exc).__name__
    killer.join(timeout=30)
    return {"raised": raised is not None, "killed": killed.is_set(),
            "fast": time.monotonic() - t0 < 30, "error": it.result().error is not None}


def sc_iterator_auto_repair(s, tmp):
    """The kill lands on a running gang: after the consumer's first row (so
    the gang has started, inside the attempt's ``try`` in both packages;
    F15 is the JAX package's race of a kill while it starts), and the loop
    reports until the kill has landed (at most ~60 s), then 20 more times,
    in the first attempt and in the repaired one."""
    train = s.train
    started, killed = threading.Event(), threading.Event()

    def loop(config):
        for i in range(3000):
            train.report({"i": i})
            time.sleep(0.02)
            if killed.is_set() and i >= 20:
                break

    trainer = s.trainer(loop, scaling_config=train.ScalingConfig(num_workers=2),
                        run_config=train.RunConfig(
                            failure_config=train.FailureConfig(max_failures=2)))
    it = trainer.training_iterator(auto_repair=True)
    killer = threading.Thread(target=_kill_one_train_worker,
                              args=(s, s.rt.get_cluster(), killed),
                              kwargs={"after": started}, daemon=True)
    killer.start()
    rows = []
    for row in it:
        rows.append(row)
        started.set()
    killer.join(timeout=30)
    return {"error": it.result().error, "rows": bool(rows), "killed": killed.is_set()}


def sc_gang_mode_fit(s, tmp):
    train = s.train
    trainer = s.trainer(gang=dict(world_size=2, batch_size=8, feature_dim=4, seed=2),
                        num_steps=4, run_config=train.RunConfig(name="gangfit"))
    result = trainer.fit()
    ctl = trainer.controller
    try:
        return {"error": result.error, "step": result.metrics["step"],
                "world_size": result.metrics["world_size"],
                "loss": result.metrics["loss"],
                "rows": [r["step"] for r in result.metrics_dataframe],
                "checkpoint": result.checkpoint is not None,
                "saved": bool(ctl.last_checkpoint) and os.path.exists(ctl.last_checkpoint),
                "plan_state": ctl.status()["plan_state"]}
    finally:
        ctl.shutdown()


# --------------------------------------------------------------------------
# a decoder's loss through the gang (2 layers, d_model 64, T 32)
# --------------------------------------------------------------------------
DEC = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq_len=32)
DEC_T = 32
DEC_SCALE = 0.05  # the flat standard-normal params, scaled to a sane init


def _decoder_loss(s):
    """``loss_fn(flat, batch)``: the decoder's mean next-token loss of the
    batch's rows times their count (the SUM the controller wants), over the
    params unflattened from the flat row (every leaf a slice of it, times
    ``DEC_SCALE``); tokens are the batch's first T features, ``|x| * 1000``
    truncated, modulo the vocabulary."""
    if s.is_jax:
        import jax.numpy as jnp

        from ray_tpu.models import transformer as tr

        cfg = tr.TransformerConfig(**DEC, attention="flash", dtype=jnp.float32)
        reshape, to_tokens = (lambda v, shape: v.reshape(shape)), (
            lambda b: (jnp.abs(b[:, :DEC_T] * 1000.0)).astype(jnp.int32) % DEC["vocab_size"])
    else:
        from ray_tpu_torch.models import transformer as tr

        cfg = tr.TransformerConfig(**DEC, attention="flash", dtype=torch.float32)
        reshape, to_tokens = (lambda v, shape: v.reshape(shape)), (
            lambda b: (b[:, :DEC_T] * 1000.0).abs().to(torch.int32) % DEC["vocab_size"])
    L, d, ff, h = DEC["n_layers"], DEC["d_model"], DEC["d_ff"], DEC["n_heads"]
    dh = d // h
    specs = [("embed", (DEC["vocab_size"], d)), ("final_norm", (d,)),
             ("layers/attn_norm", (L, d)), ("layers/ffn_norm", (L, d)),
             ("layers/w1", (L, d, ff)), ("layers/w2", (L, ff, d)), ("layers/w3", (L, d, ff)),
             ("layers/wk", (L, d, h, dh)), ("layers/wo", (L, h, dh, d)),
             ("layers/wq", (L, d, h, dh)), ("layers/wv", (L, d, h, dh))]
    nparams = sum(int(np.prod(shape)) for _, shape in specs)

    def loss(flat, batch):
        params, off = {"layers": {}}, 0
        for name, shape in specs:
            n = int(np.prod(shape))
            leaf = reshape(flat[off:off + n] * DEC_SCALE, shape)
            off += n
            if name.startswith("layers/"):
                params["layers"][name.split("/")[1]] = leaf
            else:
                params[name] = leaf
        return tr.loss_fn(cfg, params, to_tokens(batch)) * batch.shape[0]

    return loss, nparams


def sc_decoder_gang(s, tmp):
    loss, nparams = _decoder_loss(s)
    ctl = s.controller("decoder", world_size=2, batch_size=2, feature_dim=nparams - 1,
                       seed=11, learning_rate=0.05, loss_fn=loss, checkpoint_period=10**9)
    try:
        state0 = ctl._state()
        losses = ctl.run(3)
        replayed = ctl.replay(state0, 2, 3)
        return {"losses": losses, "nparams": ctl._nparams,
                "replay_bitwise": np.asarray(replayed, np.float32).tobytes()
                == np.asarray(losses, np.float32).tobytes()}
    finally:
        ctl.shutdown()


# --------------------------------------------------------------------------
# tests/test_train_elastic.py
# --------------------------------------------------------------------------
def sc_resize_retraces(s, tmp):
    ctl = s.controller("retrace", world_size=2, batch_size=16, feature_dim=4, seed=1,
                       checkpoint_period=10**9)
    try:
        sizes = []
        ctl.run(2)
        sizes.append(ctl.step_fn._cache_size())
        ctl.run(2)
        sizes.append(ctl.step_fn._cache_size())
        ctl.resize(4, reason="scale_up")
        ctl.run(2)
        sizes.append(ctl.step_fn._cache_size())
        ctl.run(2)
        sizes.append(ctl.step_fn._cache_size())
        ctl.resize(2, reason="scale_down")
        ctl.run(2)
        sizes.append(ctl.step_fn._cache_size())
        return {"deltas": [b - sizes[0] for b in sizes], "losses": ctl.losses(),
                "rng_key": _state(ctl)["rng_key"].tolist()}
    finally:
        ctl.shutdown()


def sc_resize_carries_state(s, tmp):
    ctl = s.controller("carry", world_size=2, batch_size=16, feature_dim=4, seed=13,
                       checkpoint_period=10**9)
    try:
        ctl.run(3)
        before = _state(ctl)
        ctl.resize(4, reason="scale_up")
        mid = _state(ctl)
        ctl.resize(2, reason="scale_down")
        after = _state(ctl)
        ctl.run(1)
        return {"mid_params": mid["params"].tobytes() == before["params"].tobytes(),
                "mid_key": mid["rng_key"].tobytes() == before["rng_key"].tobytes(),
                "mid_step": mid["step"], "after_params":
                after["params"].tobytes() == before["params"].tobytes(),
                "after_step": after["step"], "step": ctl.step_count,
                "reasons": [r["reason"] for r in ctl.resize_history],
                "history": [(r["step"], r["from"], r["to"]) for r in ctl.resize_history],
                "losses": ctl.losses()}
    finally:
        ctl.shutdown()


def sc_scale_down_drains(s, tmp):
    cluster = s.rt.get_cluster()
    NODE_DRAINS = s.metric_defs.NODE_DRAINS
    cluster.add_node({"CPU": 1, "gang0": 1})
    cluster.add_node({"CPU": 1, "gang1": 1})
    drains_before = len(getattr(cluster, "drain_reports", ()))
    ok_before = NODE_DRAINS.get({"outcome": "ok"})
    ctl = s.controller("drainy", world_size=2, batch_size=8, feature_dim=4, seed=4,
                       checkpoint_period=10**9,
                       member_resources=[{"gang0": 1}, {"gang1": 1}])
    try:
        ctl.run(2)
        before = _state(ctl)
        ctl.resize(1, reason="scale_down")
        reports = list(getattr(cluster, "drain_reports", ()))[drains_before:]
        after = _state(ctl)
        ctl.run(1)
        return {"world": ctl.world_size, "drained": bool(reports),
                "outcome": reports[-1]["outcome"] if reports else None,
                "ok_delta": NODE_DRAINS.get({"outcome": "ok"}) - ok_before,
                "params": after["params"].tobytes() == before["params"].tobytes(),
                "step_after": after["step"], "step": ctl.step_count, "losses": ctl.losses()}
    finally:
        ctl.shutdown()


def sc_elastic_tick(s, tmp):
    ctl = s.controller("elastic", world_size=2, batch_size=8, feature_dim=4, seed=6,
                       checkpoint_period=10**9)
    try:
        size = ctl.elastic_tick()
        ctl.run(1)
        return {"size": size, "world": ctl.world_size,
                "reasons": [r["reason"] for r in ctl.resize_history], "losses": ctl.losses()}
    finally:
        ctl.shutdown()


CONTROLLER = (sc_framed_roundtrip_cross_process, sc_framed_torn_file, sc_checkpoint_state,
              sc_recover_bit_exact, sc_recover_without_auto_repair, sc_claim_after_head_restart,
              sc_iterator_member_kill, sc_iterator_auto_repair, sc_gang_mode_fit,
              sc_decoder_gang)
ELASTIC = (sc_resize_retraces, sc_resize_carries_state, sc_scale_down_drains, sc_elastic_tick)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{package: {scenario: output}}: the controller scenarios under one
    runtime of each package, the elastic ones under another (an exception
    is the scenario's output)."""
    out = {name: {} for name in PACKAGES}
    for cpus, group in ((8, CONTROLLER), (4, ELASTIC)):
        for name in PACKAGES:
            side = _Side(name)
            side.rt.init(num_cpus=cpus)
            try:
                for fn in group:
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


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


def test_framed_roundtrip_cross_process_matches_jax(runs):
    j, p = _pair(runs, "framed_roundtrip_cross_process")
    assert p == j
    assert all(p[k] for k in ("step", "params", "momentum", "rng_key"))


def test_framed_rejects_torn_file_and_falls_back_matches_jax(runs):
    j, p = _pair(runs, "framed_torn_file")
    assert p == j == [2, 1, None]


def test_checkpoint_survives_member_state_matches_jax(runs):
    j, p = _pair(runs, "checkpoint_state")
    assert p["step"] == j["step"] == 3 and p["params_equal"] and p["key_equal"]
    assert j["params_equal"] and j["key_equal"]
    js, ps = j["state"], p["state"]
    assert ps["rng_key"].tobytes() == js["rng_key"].tobytes()
    assert (ps["world_size"], ps["seed"]) == (js["world_size"], js["seed"]) == (2, 5)
    assert len(ps["loss_history"]) == len(js["loss_history"]) == 3
    for k in ("params", "momentum", "loss_history"):
        assert ps[k].dtype == js[k].dtype == np.float32
        _close(ps[k], js[k])


def test_recover_resumes_bit_exact_matches_jax(runs):
    j, p = _pair(runs, "recover_bit_exact")
    assert p["bitwise"] and j["bitwise"], "post-repair loss trajectory diverged"
    assert p["step"] == j["step"] == 10
    assert p["repairs"] == j["repairs"] == [(4, "repaired", 2, "ActorDiedError")]
    assert p["rng_key"] == j["rng_key"]
    assert len(p["losses"]) == len(j["losses"]) == 10
    _close(p["losses"], j["losses"])
    _close(p["params"], j["params"])


def test_recover_without_auto_repair_raises_typed_matches_jax(runs):
    j, p = _pair(runs, "recover_without_auto_repair")
    assert p == j and p["typed"] and p["step"] == 2


def test_claim_after_head_restart_matches_jax(runs):
    j, p = _pair(runs, "claim_after_head_restart")
    assert {k: v for k, v in p.items() if k != "loss"} == \
        {k: v for k, v in j.items() if k != "loss"} == \
        {"dir": True, "step": 5, "params": True, "key": True, "after": 6}
    _close(p["loss"], j["loss"])


def test_training_iterator_member_kill_raises_typed_never_hangs_matches_jax(runs):
    j, p = _pair(runs, "iterator_member_kill")
    assert p == {"raised": True, "killed": True, "fast": True, "error": True}
    # the JAX package's result keeps no error when the kill lands while its
    # gang is still starting (F15, ``tests/test_torch_trainer.py``)
    assert {k: j[k] for k in ("raised", "killed", "fast")} == \
        {"raised": True, "killed": True, "fast": True}


def test_training_iterator_auto_repair_restarts_gang_matches_jax(runs):
    j, p = _pair(runs, "iterator_auto_repair")
    assert p == j == {"error": None, "rows": True, "killed": True}


def test_gang_mode_trainer_fit_matches_jax(runs):
    j, p = _pair(runs, "gang_mode_fit")
    _close(p.pop("loss"), j.pop("loss"))
    assert p == j == {"error": None, "step": 4, "world_size": 2, "rows": [1, 2, 3, 4],
                      "checkpoint": True, "saved": True, "plan_state": "READY"}


def test_decoder_loss_through_the_gang_matches_jax(runs):
    """The flagship use: a decoder's loss over the flat row, two members a
    step (the JAX side's Pallas flash kernels in interpret mode)."""
    j, p = _pair(runs, "decoder_gang")
    assert p["nparams"] == j["nparams"]
    assert p["replay_bitwise"] and j["replay_bitwise"]
    assert all(np.isfinite(p["losses"])) and len(p["losses"]) == 3
    _close(p["losses"], j["losses"], rtol=1e-4)


def test_resize_retraces_once_per_mesh_size_matches_jax(runs):
    j, p = _pair(runs, "resize_retraces")
    # steps at a fixed size add no trace; the new size adds one; revisiting
    # a size adds none
    assert p["deltas"] == j["deltas"] == [0, 0, 1, 1, 1]
    assert p["rng_key"] == j["rng_key"]
    _close(p["losses"], j["losses"])


def test_resize_preserves_step_state_exactly_matches_jax(runs):
    j, p = _pair(runs, "resize_carries_state")
    _close(p.pop("losses"), j.pop("losses"))
    assert p == j == {"mid_params": True, "mid_key": True, "mid_step": 3,
                      "after_params": True, "after_step": 3, "step": 4,
                      "reasons": ["scale_up", "scale_down"], "history": [(3, 2, 4), (3, 4, 2)]}


def test_global_batch_pure_function_of_seed_and_step_matches_jax():
    from ray_tpu.train.controller import global_batch as jax_batch

    from ray_tpu_torch.train.controller import global_batch

    a = global_batch(7, 3, batch_size=16, feature_dim=4)
    assert a.tobytes() == jax_batch(7, 3, batch_size=16, feature_dim=4).tobytes()
    assert a.tobytes() == global_batch(7, 3, batch_size=16, feature_dim=4).tobytes()
    assert a.tobytes() != global_batch(7, 4, batch_size=16, feature_dim=4).tobytes()
    assert a.tobytes() != global_batch(8, 3, batch_size=16, feature_dim=4).tobytes()
    rows = np.arange(40, dtype=np.float32).reshape(10, 4)
    assert global_batch(2, 5, batch_size=6, rows=rows).tobytes() == \
        jax_batch(2, 5, batch_size=6, rows=rows).tobytes()
    for world in (1, 2, 4):
        assert np.concatenate(np.split(a, world, axis=0), axis=0).tobytes() == a.tobytes()


def test_scale_down_drains_departing_member_node_matches_jax(runs):
    j, p = _pair(runs, "scale_down_drains")
    _close(p.pop("losses"), j.pop("losses"))
    assert p == j == {"world": 1, "drained": True, "outcome": "ok", "ok_delta": 1,
                      "params": True, "step_after": 2, "step": 3}


def test_elastic_tick_grows_into_capacity_matches_jax(runs):
    j, p = _pair(runs, "elastic_tick")
    _close(p.pop("losses"), j.pop("losses"))
    assert p == j
    assert p["size"] >= 2 and p["world"] == p["size"]
    if p["size"] > 2:
        assert p["reasons"] == ["scale_up"]


@pytest.mark.parametrize("seed", [0, 5, 21, 1234, 2**31 - 1])
def test_threefry_key_and_fold_in_match_jax_random(seed):
    """The port's own threefry-2x32: ``prng_key(seed)`` and 20 folds, word
    for word ``jax.random.PRNGKey`` and ``jax.random.fold_in``."""
    import jax

    from ray_tpu_torch.train.controller import fold_in, prng_key

    want = np.asarray(jax.random.PRNGKey(seed))
    got = prng_key(seed)
    assert got.dtype == want.dtype == np.uint32 and got.tolist() == want.tolist()
    for step in range(20):
        want = np.asarray(jax.random.fold_in(jax.numpy.asarray(want), step))
        got = fold_in(got, step)
        assert got.tolist() == want.tolist(), step
