"""The port's compiled execution plans (``ray_tpu_torch.dag.plan``,
``runtime/channel_manager.py``) against the JAX package's.

The scenarios of ``tests/test_plans.py`` (all but the two-process ones,
held in ``tests/test_torch_multinode_plans.py``, and the dashboard ones,
held in ``tests/test_torch_cli.py``), the plan repairs of ``tests/test_drain.py``, and the plan schedules
of ``tests/test_chaos.py`` (a stage actor killed mid-plan, a stage node
killed under ``auto_repair``, a gang member killed and the gang repaired).
Each runs once in each package, on a fresh runtime shaped as the JAX test's
fixture makes it, on the same inputs; the port's output (values, states,
snapshots, counters, error types) must equal the JAX package's, and both
the JAX test's expectations.  A chaos schedule's summary (fault log,
``events_applied`` kinds, invariant counts, invariant 8's plan transitions
included) must be equal in both packages.

Where the JAX test reads a jitted step's ``_cache_size()`` (traced once, at
install), the port's reads the gang's counters: each member's step runs
once at install (the warm-up) and once an iteration after it.
"""

import importlib
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_runtime import _norm  # noqa: E402

PACKAGES = ("ray_tpu", "ray_tpu_torch")


class _Side:
    """One package's modules and array type, for a scenario."""

    def __init__(self, name):
        self.name = name
        self.rt = importlib.import_module(name)
        self.is_jax = name == "ray_tpu"
        for attr, mod in [("dag", "dag"), ("exc", "exceptions"),
                          ("cm", "runtime.channel_manager"), ("dp", "runtime.data_plane"),
                          ("dev", "runtime.device_plane"), ("md", "observability.metric_defs"),
                          ("fake", "runtime.fake_transfer"), ("store", "core.object_store"),
                          ("config", "core.config"), ("chaos", "chaos"),
                          ("fp", "runtime.failpoints"), ("sched", "runtime.scheduler")]:
            setattr(self, attr, importlib.import_module(f"{name}.{mod}"))

    def array(self, value, dtype=np.float32):
        if self.is_jax:
            import jax.numpy as jnp

            return jnp.asarray(np.asarray(value, dtype))
        return torch.as_tensor(np.asarray(value, dtype))

    def is_array(self, x):
        if self.is_jax:
            import jax

            return isinstance(x, jax.Array)
        return isinstance(x, torch.Tensor)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _both(scenario, init=None):
    """``scenario(side)`` once in each package, each on a fresh runtime
    (``init`` its keyword arguments; None: no runtime)."""
    outs = {}
    for name in PACKAGES:
        side = _Side(name)
        side.config.reset_config()
        cluster = side.rt.init(**init) if init is not None else None
        try:
            outs[name] = _norm(scenario(side, cluster) if init is not None else scenario(side))
        finally:
            if init is not None:
                side.rt.shutdown()
    return outs["ray_tpu"], outs["ray_tpu_torch"]


def _error(exc):
    return type(exc).__name__


# --------------------------------------------------------------------------
# channel layer
# --------------------------------------------------------------------------
def scenario_seq_channel_backpressure_and_order(s):
    ch = s.cm.SeqChannel("t")
    ch.write(0, "a")
    blocked, done = threading.Event(), threading.Event()

    def second():
        blocked.set()
        ch.write(1, "b")
        done.set()

    t = threading.Thread(target=second, daemon=True)
    t.start()
    blocked.wait(2)
    time.sleep(0.05)
    out = {"blocked": not done.is_set(), "first": ch.read()}
    t.join(2)
    out["done"] = done.is_set()
    out["second"] = ch.read()
    return out


def test_seq_channel_backpressure_and_order_matches_jax():
    jax_out, port_out = _both(scenario_seq_channel_backpressure_and_order)
    assert port_out == jax_out == {"blocked": True, "first": (0, "a", False), "done": True,
                                   "second": (1, "b", False)}


def scenario_seq_channel_close_with_typed_error_wakes_reader(s):
    ch = s.cm.SeqChannel("t")
    out = {}

    def reader():
        try:
            ch.read()
        except BaseException as exc:  # noqa: BLE001
            out["reader"] = _error(exc)

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    time.sleep(0.05)
    ch.close(s.exc.ActorDiedError("stage actor killed"))
    t.join(2)
    try:
        ch.write(2, "x")
    except BaseException as exc:  # noqa: BLE001
        out["writer"] = _error(exc)
    return out


def test_seq_channel_close_with_typed_error_wakes_reader_matches_jax():
    jax_out, port_out = _both(scenario_seq_channel_close_with_typed_error_wakes_reader)
    assert port_out == jax_out == {"reader": "ActorDiedError", "writer": "ActorDiedError"}


def scenario_chan_push_stream_delivers_and_nacks_unknown(s):
    mgr = s.cm.global_manager()
    store = s.store.ObjectStore(shm_store=None)
    server = s.dp.store_server(store)
    out = {}
    try:
        chans = mgr.register("testplan", ["c1"])
        stream = s.dp.ChannelStream(server.address, "testplan", "c1")
        payload = np.arange(1000, dtype=np.float32)
        stream.push(0, payload)
        seq, value, is_err = chans["c1"].read()
        out["first"] = (seq, is_err, np.array_equal(np.asarray(value), payload),
                        type(value).__name__)
        stream.push(1, ValueError("boom"), is_error=True)
        seq, value, is_err = chans["c1"].read()
        out["error"] = (seq, is_err, _error(value), str(value))
        bad = s.dp.ChannelStream(server.address, "testplan", "nope")
        try:
            bad.push(0, 1)
        except s.dag.ChannelClosed as exc:
            out["unknown"] = ("ChannelClosed", "unknown channel" in str(exc))
        bad.close()
        stream.close()
    finally:
        mgr.release_plan("testplan")
        server.close()
    return out


def test_chan_push_stream_delivers_and_nacks_unknown_matches_jax():
    jax_out, port_out = _both(scenario_chan_push_stream_delivers_and_nacks_unknown)
    assert port_out == jax_out
    assert port_out["first"] == (0, False, True, "ndarray")
    assert port_out["unknown"] == ("ChannelClosed", True)


def scenario_channel_manager_release_closes_blocked(s):
    mgr = s.cm.ChannelManager()
    chans = mgr.register("p", ["a"])
    errs = []

    def reader():
        try:
            chans["a"].read()
        except s.dag.ChannelClosed as exc:
            errs.append(_error(exc))

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    time.sleep(0.05)
    mgr.release_plan("p")
    t.join(2)
    return {"errs": errs, "released": mgr.channel("p", "a") is None}


def test_channel_manager_release_closes_blocked_matches_jax():
    jax_out, port_out = _both(scenario_channel_manager_release_closes_blocked)
    assert port_out == jax_out == {"errs": ["ChannelClosed"], "released": True}


# --------------------------------------------------------------------------
# plan lifecycle on an in-process multi-node cluster
# --------------------------------------------------------------------------
CLUSTER = {"num_cpus": 2}   # the ray_start_cluster fixture
REGULAR = {"num_cpus": 4}   # the ray_start_regular fixture


def _pipeline(s, cluster):
    """The ``two_node_pipeline`` fixture: four inproc stage actors, two on
    the head and two on a second node."""
    cluster.add_node({"CPU": 2, "stage": 4})

    @s.rt.remote
    class Stage:
        def __init__(self, k):
            self.k = k

        def step(self, x):
            return x + self.k

        def fail(self, x):
            raise ValueError(f"stage error at {x}")

        def flaky(self, x):
            if x < 0:
                raise ValueError(f"stage error at {x}")
            return x + self.k

    head = dict(execution="inproc")
    other = dict(execution="inproc", resources={"stage": 1}, num_cpus=0)
    return [Stage.options(**head).remote(1), Stage.options(**other).remote(10),
            Stage.options(**other).remote(100), Stage.options(**head).remote(1000)]


def _chain(actors, inp):
    d = inp
    for a in actors:
        d = a.step.bind(d)
    return d


def _snapshot(plan):
    """The plan's snapshot less what differs run to run (ids)."""
    snap = dict(plan.snapshot())
    for k in ("plan", "name"):
        snap.pop(k)
    snap["stages"] = [{k: v for k, v in st.items() if k not in ("actor", "node")}
                      for st in snap["stages"]]
    return snap


def scenario_plan_100_iterations_zero_taskspecs(s, cluster):
    actors = _pipeline(s, cluster)
    with s.dag.InputNode() as inp:
        d = _chain(actors, inp)
    plan = d.compile_plan(name="accept")
    out = {"state": plan.state,
           "nodes": {st["node"] for st in plan.snapshot()["stages"]}
           == {n.hex()[:8] for n in cluster.nodes}}
    md = s.md
    before = (md.TASKS_SUBMITTED.series(), md.ACTOR_CALLS_SUBMITTED.series(),
              md.SCHEDULER_TASKS_DISPATCHED.series())
    refs_before = cluster.core_worker.ref_counter.num_tracked()
    out["values"] = [plan.execute(i) for i in range(100)] == [i + 1111 for i in range(100)]
    after = (md.TASKS_SUBMITTED.series(), md.ACTOR_CALLS_SUBMITTED.series(),
             md.SCHEDULER_TASKS_DISPATCHED.series())
    out["zero_taskspecs"] = before == after
    out["zero_refs"] = cluster.core_worker.ref_counter.num_tracked() == refs_before
    out["snapshot"] = _snapshot(plan)
    plan.teardown()
    return out


def test_plan_100_iterations_zero_taskspecs_matches_jax():
    jax_out, port_out = _both(scenario_plan_100_iterations_zero_taskspecs, CLUSTER)
    assert port_out == jax_out
    assert port_out["values"] and port_out["zero_taskspecs"] and port_out["zero_refs"]
    assert port_out["snapshot"]["executions"] == 100 and port_out["snapshot"]["state"] == "READY"


def scenario_plan_execute_async_pipelines_iterations(s, cluster):
    actors = _pipeline(s, cluster)
    with s.dag.InputNode() as inp:
        d = _chain(actors, inp)
    plan = d.compile_plan()
    futs = [plan.execute_async(i) for i in range(50)]
    out = [f.result(timeout=60) for f in futs]
    plan.teardown()
    return out


def test_plan_execute_async_pipelines_iterations_matches_jax():
    jax_out, port_out = _both(scenario_plan_execute_async_pipelines_iterations, CLUSTER)
    assert port_out == jax_out == [i + 1111 for i in range(50)]


def scenario_plan_multi_output_and_kwargs(s, cluster):
    actors = _pipeline(s, cluster)
    with s.dag.InputNode() as inp:
        first = actors[0].step.bind(inp)
        d = s.dag.MultiOutputNode([actors[1].step.bind(first), actors[2].step.bind(first)])
    plan = d.compile_plan()
    out = [plan.execute(5), plan.execute(0), _snapshot(plan)["channels"]]
    plan.teardown()
    return out


def test_plan_multi_output_and_kwargs_matches_jax():
    jax_out, port_out = _both(scenario_plan_multi_output_and_kwargs, CLUSTER)
    assert port_out == jax_out
    assert port_out[:2] == [[16, 106], [11, 101]]


def scenario_plan_user_exception_fails_iteration_not_plan(s, cluster):
    actors = _pipeline(s, cluster)
    with s.dag.InputNode() as inp:
        d = actors[1].fail.bind(actors[0].step.bind(inp))
    plan = d.compile_plan()
    out = []
    for x in (3, 4):
        try:
            plan.execute(x)
        except s.exc.RayTaskError as exc:
            out.append(("RayTaskError", "stage error" in str(exc), plan.state))
    plan.teardown()
    return out


def test_plan_user_exception_fails_iteration_not_plan_matches_jax():
    jax_out, port_out = _both(scenario_plan_user_exception_fails_iteration_not_plan, CLUSTER)
    assert port_out == jax_out == [("RayTaskError", True, "READY")] * 2


def scenario_plan_multi_output_error_does_not_desync_siblings(s, cluster):
    actors = _pipeline(s, cluster)
    with s.dag.InputNode() as inp:
        first = actors[0].step.bind(inp)
        d = s.dag.MultiOutputNode([actors[1].flaky.bind(first), actors[2].step.bind(first)])
    plan = d.compile_plan()
    out = {}
    try:
        plan.execute(-5)  # leaf 0 errors; leaf 1 still produced a value
    except s.exc.RayTaskError as exc:
        out["error"] = "stage error" in str(exc)
    out["state"] = plan.state
    out["next"] = [plan.execute(5), plan.execute(0)]
    plan.teardown()
    return out


def test_plan_multi_output_error_does_not_desync_siblings_matches_jax():
    jax_out, port_out = _both(scenario_plan_multi_output_error_does_not_desync_siblings, CLUSTER)
    assert port_out == jax_out == {"error": True, "state": "READY",
                                   "next": [[16, 106], [11, 101]]}


def scenario_plan_actor_kill_breaks_plan_with_typed_error(s, cluster):
    actors = _pipeline(s, cluster)
    with s.dag.InputNode() as inp:
        d = _chain(actors, inp)
    plan = d.compile_plan()
    out = {"before": plan.execute(1)}
    s.rt.kill(actors[2])
    deadline = time.monotonic() + 10
    while plan.state != "BROKEN" and time.monotonic() < deadline:
        time.sleep(0.02)
    out["state"] = plan.state
    try:
        plan.execute(2)
    except Exception as exc:  # noqa: BLE001 — its type is the result
        out["error"] = _error(exc)
    snap = _snapshot(plan)
    out["history"], out["error_repr"] = snap["history"], snap["error"] is not None
    plan.teardown()
    return out


def test_plan_actor_kill_breaks_plan_with_typed_error_matches_jax():
    jax_out, port_out = _both(scenario_plan_actor_kill_breaks_plan_with_typed_error, CLUSTER)
    assert port_out == jax_out == {"before": 1112, "state": "BROKEN", "error": "ActorDiedError",
                                   "history": ["READY", "BROKEN"], "error_repr": True}


def scenario_plan_node_death_breaks_plan(s, cluster):
    actors = _pipeline(s, cluster)
    with s.dag.InputNode() as inp:
        d = _chain(actors, inp)
    plan = d.compile_plan()
    out = {"before": plan.execute(0)}
    victim = next(nid for nid, n in cluster.nodes.items() if n is not cluster.head_node)
    cluster.kill_node(victim, reason="test")
    out["state"] = plan.state
    try:
        plan.execute(1)
    except (s.exc.ActorDiedError, s.exc.WorkerCrashedError) as exc:
        out["typed"] = True
        out["error"] = _error(exc)
    plan.teardown()
    return out


def test_plan_node_death_breaks_plan_matches_jax():
    jax_out, port_out = _both(scenario_plan_node_death_breaks_plan, CLUSTER)
    assert port_out == jax_out
    assert port_out["before"] == 1111 and port_out["state"] == "BROKEN" and port_out["typed"]


def scenario_plan_teardown_idempotent_and_execute_after(s, cluster):
    actors = _pipeline(s, cluster)
    with s.dag.InputNode() as inp:
        d = _chain(actors[:2], inp)
    plan = d.compile_plan()
    out = {"value": plan.execute(0), "registered": plan.plan_id in cluster.compiled_plans}
    plan.teardown()
    plan.teardown()  # idempotent
    out["unregistered"] = plan.plan_id not in cluster.compiled_plans
    try:
        plan.execute(0)
    except RuntimeError as exc:
        out["after"] = "torn down" in str(exc)
    out["transitions"] = [t[1:] for t in cluster.plan_transitions if t[0] == plan.plan_id]
    return out


def test_plan_teardown_idempotent_and_execute_after_matches_jax():
    jax_out, port_out = _both(scenario_plan_teardown_idempotent_and_execute_after, CLUSTER)
    assert port_out == jax_out == {"value": 11, "registered": True, "unregistered": True,
                                   "after": True, "transitions": [("READY", "TORN_DOWN")]}


def scenario_plan_rejects_function_nodes_and_const_only_stages(s, cluster):
    @s.rt.remote
    def f(x):
        return x

    @s.rt.remote
    class A:
        def m(self, x):
            return x

    a = A.options(execution="inproc").remote()
    out = []
    with s.dag.InputNode() as inp:
        d = f.bind(inp)
    try:
        d.compile_plan()
    except ValueError as exc:
        out.append(("ValueError", "CompiledDAG" in str(exc)))
    with s.dag.InputNode() as inp:
        d = a.m.bind(7)  # no per-iteration input
    try:
        d.compile_plan()
    except ValueError as exc:
        out.append(("ValueError", "per-iteration" in str(exc)))
    return out


def test_plan_rejects_function_nodes_and_const_only_stages_matches_jax():
    jax_out, port_out = _both(scenario_plan_rejects_function_nodes_and_const_only_stages, REGULAR)
    assert port_out == jax_out == [("ValueError", True)] * 2


def scenario_plan_const_args_and_input_selectors(s, cluster):
    @s.rt.remote
    class Mixer:
        def mix(self, x, y, scale=1):
            return (x + y) * scale

    m = Mixer.options(execution="inproc").remote()
    with s.dag.InputNode() as inp:
        d = m.mix.bind(inp.a, inp.b, scale=10)
    plan = d.compile_plan()
    out = [plan.execute(a=3, b=4), plan.execute(a=1, b=1)]
    plan.teardown()
    return out


def test_plan_const_args_and_input_selectors_matches_jax():
    jax_out, port_out = _both(scenario_plan_const_args_and_input_selectors, REGULAR)
    assert port_out == jax_out == [70, 20]


def test_plan_metric_families_in_catalog_match_jax():
    def scenario(s):
        names = {m.name for m in s.md.ALL_METRICS}
        return sorted(n for n in names if n.startswith(("compiled_", "plan_")))

    jax_out, port_out = _both(scenario)
    assert port_out == jax_out
    assert {"compiled_plan_executions_total", "compiled_channel_bytes_total",
            "compiled_channel_occupancy", "compiled_device_channel_bytes_total",
            "plan_stage_group_executions_total"} <= set(port_out)


# --------------------------------------------------------------------------
# device channels: resident slots + control-only streams
# --------------------------------------------------------------------------
def scenario_device_seq_channel_slot_semantics_and_stats(s):
    stats = s.cm.device_channel_stats
    base = stats()
    ch = s.cm.SeqChannel("d", kind="device")
    arr = s.array(np.arange(1024))
    ch.write(0, arr)
    held = stats()
    out = {"occupied": held["occupied_slots"] - base["occupied_slots"],
           "bytes": held["hbm_resident_bytes"] - base["hbm_resident_bytes"]}
    seq, got, is_err = ch.read()
    out["read"] = (seq, is_err, got is arr, stats() == base)
    ch.write(1, np.ones(16, np.float32))
    _, got2, _ = ch.read()
    out["host_placed"] = s.is_array(got2)
    ch.write(2, {"k": 1})
    out["passthrough"] = ch.read()[1]
    out["restored"] = stats() == base
    return out


def test_device_seq_channel_slot_semantics_and_stats_matches_jax():
    jax_out, port_out = _both(scenario_device_seq_channel_slot_semantics_and_stats)
    assert port_out == jax_out == {"occupied": 1, "bytes": 4096, "read": (0, False, True, True),
                                   "host_placed": True, "passthrough": {"k": 1},
                                   "restored": True}


def scenario_device_seq_channel_close_while_blocked_restores_stats(s):
    stats = s.cm.device_channel_stats
    base = stats()
    ch = s.cm.SeqChannel("d", kind="device")
    ch.write(0, s.array(np.ones(256)))
    errs = []
    blocked = threading.Event()

    def second_write():
        blocked.set()
        try:
            ch.write(1, s.array(np.zeros(256)))
        except s.dag.ChannelClosed as exc:
            errs.append(_error(exc))

    t = threading.Thread(target=second_write, daemon=True)
    t.start()
    blocked.wait(2)
    time.sleep(0.05)
    occupied = stats()["occupied_slots"] - base["occupied_slots"]
    ch.close()
    t.join(2)
    return {"occupied": occupied, "errs": errs, "restored": stats() == base}


def test_device_seq_channel_close_while_blocked_restores_stats_matches_jax():
    jax_out, port_out = _both(scenario_device_seq_channel_close_while_blocked_restores_stats)
    assert port_out == jax_out == {"occupied": 1, "errs": ["ChannelClosed"], "restored": True}


def scenario_device_chan_push_host_staged_roundtrip_no_pickle(s):
    mgr = s.cm.global_manager()
    md = s.md
    store = s.store.ObjectStore(shm_store=None)
    server = s.dp.store_server(store)
    out = {}
    try:
        chans = mgr.register("devplan", ["e"], kinds={"e": "device"})
        stream = s.dp.ChannelStream(server.address, "devplan", "e", kind="device")
        host = np.random.default_rng(0).standard_normal((64, 32)).astype(np.float32)
        arr = s.array(host)
        packed_before = s.dev.stats.arrays_packed
        sent_before = md.COMPILED_DEVICE_CHANNEL_BYTES.get({"direction": "sent"})
        recv_before = md.COMPILED_DEVICE_CHANNEL_BYTES.get({"direction": "received"})
        stream.push(0, arr)
        seq, value, is_err = chans["e"].read()
        out["array"] = (seq, is_err, s.is_array(value), np.array_equal(_host(value), host))
        stream.push(1, {"meta": [1, 2, 3]})
        out["dict"] = chans["e"].read()[1]
        stream.push(2, ValueError("boom"), is_error=True)
        seq, value, is_err = chans["e"].read()
        out["error"] = (is_err, _error(value))
        stream.push(3, arr * 2)
        out["again"] = np.array_equal(_host(chans["e"].read()[1]), host * 2)
        out["packed"] = s.dev.stats.arrays_packed - packed_before
        out["sent"] = md.COMPILED_DEVICE_CHANNEL_BYTES.get({"direction": "sent"}) - sent_before
        out["received"] = (md.COMPILED_DEVICE_CHANNEL_BYTES.get({"direction": "received"})
                           - recv_before)
        stream.close()
    finally:
        mgr.release_plan("devplan")
        server.close()
    return out


def test_device_chan_push_host_staged_roundtrip_no_pickle_matches_jax():
    jax_out, port_out = _both(scenario_device_chan_push_host_staged_roundtrip_no_pickle)
    assert port_out == jax_out
    assert port_out["array"] == (0, False, True, True) and port_out["packed"] == 0
    assert port_out["sent"] == port_out["received"] == 2 * 64 * 32 * 4


def scenario_device_chan_push_ticket_path_and_refused_pull_fallback(s):
    mgr = s.cm.global_manager()
    store = s.store.ObjectStore(shm_store=None)
    server = s.dp.store_server(store)
    fake = s.fake.FakeTransferServer()
    out = {}
    try:
        s.dev.install_transfer_server(fake)
        chans = mgr.register("tickplan", ["e"], kinds={"e": "device"})
        stream = s.dp.ChannelStream(server.address, "tickplan", "e", kind="device")
        host = np.arange(4096, dtype=np.float32)
        stream.push(0, s.array(host))
        out["ticket"] = np.array_equal(_host(chans["e"].read()[1]), host)
        # the fake counts a pull after its last byte is sent: the consumer
        # can hold the value a moment before the count moves
        deadline = time.monotonic() + 5
        while fake.pulls_served < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        out["pulls_served"] = fake.pulls_served
        fake.refuse_pulls = True
        stream.push(1, s.array(host + 1))
        out["fallback"] = np.array_equal(_host(chans["e"].read()[1]), host + 1)
        stream.close()
    finally:
        s.dev.install_transfer_server(None)
        fake.close()
        mgr.release_plan("tickplan")
        server.close()
    return out


def test_device_chan_push_ticket_path_and_refused_pull_fallback_matches_jax():
    jax_out, port_out = _both(scenario_device_chan_push_ticket_path_and_refused_pull_fallback)
    assert port_out == jax_out == {"ticket": True, "pulls_served": 1, "fallback": True}


# --------------------------------------------------------------------------
# SPMD stage groups
# --------------------------------------------------------------------------
def scenario_stage_group_plan_trace_once_and_zero_pickle(s, cluster):
    calls = {"n": 0, "shapes": set()}
    if s.is_jax:
        import jax

        step_fn = jax.jit(lambda x: x * 2.0 + 1.0)

        def traces():
            return step_fn._cache_size()
    else:
        def step_fn(x):
            calls["n"] += 1
            calls["shapes"].add(tuple(x.shape))
            return x * 2.0 + 1.0

        def traces():
            return len(calls["shapes"])

    @s.rt.remote
    class Member:
        def step(self, x):
            return step_fn(x)

    members = [Member.options(execution="inproc").remote() for _ in range(2)]
    gang = s.dag.StageGroup(members, "step", split_axis=0, warmup=((8, 16), "float32"))
    with s.dag.InputNode() as inp:
        node = gang.bind(inp)
    plan = node.compile_plan(name="gang")
    out = {}
    try:
        host = np.random.default_rng(1).standard_normal((8, 16)).astype(np.float32)
        x = s.array(host)
        traces_after_install = traces()
        calls_after_install = calls["n"]
        out["primed"] = traces_after_install >= 1
        packed_before = s.dev.stats.arrays_packed
        execs_before = s.md.PLAN_STAGE_GROUP_EXECUTIONS.get()
        ok = []
        for _ in range(20):
            result = plan.execute(x)
            ok.append(s.is_array(result) and np.allclose(_host(result), host * 2.0 + 1.0,
                                                         rtol=1e-6))
        out["results"] = all(ok)
        out["no_retrace"] = traces() == traces_after_install
        out["packed"] = s.dev.stats.arrays_packed - packed_before
        out["group_execs"] = s.md.PLAN_STAGE_GROUP_EXECUTIONS.get() - execs_before
        snap = plan.snapshot()
        out["group"] = [st["group"] for st in snap["stages"]]
        out["kinds"] = sorted(set(snap["channel_kinds"].values()))
        if not s.is_jax:  # the port's counters for the JAX test's _cache_size
            out["port_warmup_calls"] = calls_after_install
            out["port_step_calls"] = calls["n"] - calls_after_install
    finally:
        plan.teardown()
    return out


def test_stage_group_plan_trace_once_and_zero_pickle_matches_jax():
    jax_out, port_out = _both(scenario_stage_group_plan_trace_once_and_zero_pickle, REGULAR)
    warmup, steps = port_out.pop("port_warmup_calls"), port_out.pop("port_step_calls")
    assert port_out == jax_out == {"primed": True, "results": True, "no_retrace": True,
                                   "packed": 0, "group_execs": 20, "group": [2],
                                   "kinds": ["device"]}
    assert (warmup, steps) == (2, 40)  # once a member at install, once a member an iteration


def scenario_stage_group_validation_and_interpreted_execute_rejected(s, cluster):
    out = []
    try:
        s.dag.StageGroup([], "step")
    except ValueError:
        out.append("empty")

    @s.rt.remote
    class Member:
        def step(self, x):
            return x

    members = [Member.options(execution="inproc").remote() for _ in range(2)]
    gang = s.dag.StageGroup(members, "step")
    with s.dag.InputNode() as inp:
        node = gang.bind(inp)
    try:
        node.execute(1)
    except ValueError:
        out.append("interpreted")
    cfg = s.config.get_config()
    old = cfg.plan_stage_group_max_members
    cfg.plan_stage_group_max_members = 1
    try:
        node.compile_plan()
    except ValueError:
        out.append("too_many")
    finally:
        cfg.plan_stage_group_max_members = old
    return out


def test_stage_group_validation_and_interpreted_execute_rejected_matches_jax():
    jax_out, port_out = _both(scenario_stage_group_validation_and_interpreted_execute_rejected,
                              REGULAR)
    assert port_out == jax_out == ["empty", "interpreted", "too_many"]


# --------------------------------------------------------------------------
# plan repair (test_drain.py)
# --------------------------------------------------------------------------
def scenario_plan_repair_after_restartable_stage_death(s, cluster):
    cluster.add_node({"CPU": 1, "stage": 1})
    cluster.add_node({"CPU": 1, "stage": 1})

    @s.rt.remote
    class Stage:
        def __init__(self, k):
            self.k = k

        def step(self, x):
            return x + self.k

    s0 = Stage.options(execution="inproc").remote(1)
    s1 = Stage.options(execution="inproc", num_cpus=0, resources={"stage": 1},
                       max_restarts=1).remote(10)
    with s.dag.InputNode() as inp:
        d = s0.step.bind(s1.step.bind(inp))
    plan = d.compile_plan(name="repairable")
    out = {}
    try:
        out["before"] = plan.execute(5)
        s.rt.kill(s1, no_restart=False)  # restartable: the FSM revives it
        deadline = time.monotonic() + 30
        while plan.state != "BROKEN" and time.monotonic() < deadline:
            time.sleep(0.02)
        out["broken"] = plan.state
        try:
            plan.execute(5)
        except (s.exc.ActorDiedError, s.exc.RayActorError) as exc:
            out["error"] = _error(exc)
        plan.repair(timeout=30)
        out["repaired"] = plan.state
        out["after"] = [plan.execute(i) for i in range(5)]
        out["history"] = list(plan.state_history)
        out["transitions"] = [t[1:] for t in cluster.plan_transitions if t[0] == plan.plan_id]
    finally:
        plan.teardown()
    return out


def test_plan_repair_after_restartable_stage_death_matches_jax():
    jax_out, port_out = _both(scenario_plan_repair_after_restartable_stage_death, CLUSTER)
    assert port_out == jax_out == {
        "before": 16, "broken": "BROKEN", "error": "ActorDiedError", "repaired": "READY",
        "after": [11, 12, 13, 14, 15], "history": ["READY", "BROKEN", "READY"],
        "transitions": [("READY", "BROKEN"), ("BROKEN", "READY")]}


def scenario_plan_repair_fails_for_dead_stage(s, cluster):
    @s.rt.remote
    class Stage:
        def step(self, x):
            return x * 2

    s0 = Stage.options(execution="inproc").remote()  # max_restarts=0
    with s.dag.InputNode() as inp:
        d = s0.step.bind(inp)
    plan = d.compile_plan(name="unrepairable")
    out = {}
    try:
        out["before"] = plan.execute(4)
        s.rt.kill(s0)
        deadline = time.monotonic() + 30
        while plan.state != "BROKEN" and time.monotonic() < deadline:
            time.sleep(0.02)
        out["broken"] = plan.state
        try:
            plan.repair(timeout=3)
        except (s.exc.ActorDiedError, s.exc.RayActorError, TimeoutError) as exc:
            out["repair_error"] = _error(exc)
        out["after"] = plan.state
    finally:
        plan.teardown()
    return out


def test_plan_repair_fails_for_dead_stage_matches_jax():
    jax_out, port_out = _both(scenario_plan_repair_fails_for_dead_stage, REGULAR)
    assert port_out == jax_out == {"before": 8, "broken": "BROKEN",
                                   "repair_error": "ActorDiedError", "after": "BROKEN"}


# --------------------------------------------------------------------------
# plan schedules (test_chaos.py): same seed, same fault log and invariant
# counts in both packages, invariant 8 counting plan transitions
# --------------------------------------------------------------------------
def _summary(result):
    inv = result.invariants.to_dict() if result.invariants else None
    return {
        "ok": result.ok,
        "workload_error": repr(result.workload_error) if result.workload_error else None,
        "violations": inv and inv["violations"],
        "faults": result.faults,
        "kinds": [e["kind"] for e in result.events_applied],
        "checked": inv and inv["checked"],
    }


def _retried_puts(s, n):
    refs = []
    for i in range(n):
        while True:  # each attempt consumes exactly one decision-stream index
            try:
                refs.append(s.rt.put(("blob", i)))
                break
            except s.fp.FailpointInjected:
                continue
    return refs


def scenario_schedule_stage_actor_kill_mid_plan(s, cluster):
    cluster.add_node({"CPU": 2, "stage": 4})
    chaos = s.chaos
    schedule = chaos.ChaosSchedule(
        [chaos.ChaosEvent(0.0, "arm", spec="object_store.put=raise(0.4)")],
        seed=29, name="plan-stage-kill")
    seen = {}

    def workload():
        @s.rt.remote
        class Stage:
            def __init__(self, k):
                self.k = k

            def step(self, x):
                return x + self.k

        head = dict(execution="inproc")
        other = dict(execution="inproc", resources={"stage": 1}, num_cpus=0)
        s0 = Stage.options(**head).remote(1)
        s1 = Stage.options(**other).remote(10)
        s2 = Stage.options(**head).remote(100)
        with s.dag.InputNode() as inp:
            d = s2.step.bind(s1.step.bind(s0.step.bind(inp)))
        plan = d.compile_plan(name="chaos")
        refs = _retried_puts(s, 6)
        seen["values"] = [plan.execute(i) for i in range(10)]
        s.rt.kill(s1)  # mid-plan: installed, channels live, between iterations
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                plan.execute(0)
            except (s.exc.ActorDiedError, s.exc.RayActorError) as exc:
                seen["raised"] = _error(exc)
                break
        seen["state"] = plan.state
        plan.teardown()
        return refs

    result = chaos.ChaosRunner(schedule, quiesce_timeout=90).run(workload)
    return {"summary": _summary(result), "seen": seen}


def test_schedule_stage_actor_kill_mid_plan_matches_jax():
    jax_out, port_out = _both(scenario_schedule_stage_actor_kill_mid_plan, CLUSTER)
    assert port_out == jax_out
    assert port_out["seen"] == {"values": [i + 111 for i in range(10)],
                                "raised": "ActorDiedError", "state": "BROKEN"}
    summary = port_out["summary"]
    assert summary["ok"] and summary["faults"]
    assert all(f["fp"] == "object_store.put" for f in summary["faults"])
    assert summary["checked"]["plan_transitions"] == 2  # READY->BROKEN->TORN_DOWN


def scenario_schedule_plan_stage_node_kill_auto_repair(s, cluster):
    node_b = cluster.add_node({"CPU": 1, "stage": 1})  # victim (index 0)
    cluster.add_node({"CPU": 1, "stage": 1})           # restart target
    chaos = s.chaos
    schedule = chaos.ChaosSchedule(
        [chaos.ChaosEvent(0.0, "arm", spec="object_store.put=raise(0.4)"),
         chaos.ChaosEvent(1.0, "kill_node", index=0)],
        seed=37, name="plan-node-kill-auto-repair")
    seen = {}

    def workload():
        @s.rt.remote
        class Stage:
            def __init__(self, k):
                self.k = k

            def step(self, x):
                return x + self.k

        head = dict(execution="inproc", scheduling_strategy=s.sched.NodeAffinitySchedulingStrategy(
            cluster.head_node.node_id))
        s0 = Stage.options(**head).remote(1)
        s1 = Stage.options(
            execution="inproc", num_cpus=0, resources={"stage": 1}, max_restarts=1,
            scheduling_strategy=s.sched.NodeAffinitySchedulingStrategy(node_b.node_id, soft=True),
        ).remote(10)
        s2 = Stage.options(**head).remote(100)
        with s.dag.InputNode() as inp:
            d = s2.step.bind(s1.step.bind(s0.step.bind(inp)))
        plan = d.compile_plan(name="self-healing", auto_repair=True)
        refs = _retried_puts(s, 4)
        saw_break, completed_after_break = False, 0
        deadline = time.monotonic() + 45
        while time.monotonic() < deadline and completed_after_break < 5:
            try:
                assert plan.execute(7) == 118
                if saw_break:
                    completed_after_break += 1
                elif node_b.dead:
                    saw_break = True  # raced: repair finished before an execute failed
            except (s.exc.ActorDiedError, s.exc.RayActorError, s.exc.WorkerCrashedError):
                saw_break = True
                time.sleep(0.05)
        seen.update(saw_break=saw_break, healed=completed_after_break >= 5, state=plan.state,
                    broke="BROKEN" in plan.state_history, last=plan.state_history[-1])
        plan.teardown()
        return refs

    result = chaos.ChaosRunner(schedule, quiesce_timeout=90).run(workload)
    killed = [e for e in result.events_applied if e["kind"] == "kill_node"]
    seen["killed_victim"] = bool(killed) and killed[0]["node"] == node_b.node_id.hex()[:8]
    return {"summary": _summary(result), "seen": seen}


def test_schedule_plan_stage_node_kill_auto_repair_matches_jax():
    jax_out, port_out = _both(scenario_schedule_plan_stage_node_kill_auto_repair, CLUSTER)
    assert port_out == jax_out
    assert port_out["seen"] == {"saw_break": True, "healed": True, "state": "READY",
                                "broke": True, "last": "READY", "killed_victim": True}
    summary = port_out["summary"]
    assert summary["ok"] and summary["faults"]
    assert summary["checked"]["plan_transitions"] == 3  # READY->BROKEN->READY->TORN_DOWN


def scenario_schedule_gang_member_kill_repair_byte_identical(s, cluster):
    chaos = s.chaos
    schedule = chaos.ChaosSchedule(
        [chaos.ChaosEvent(0.0, "arm", spec="object_store.put=raise(0.4)")],
        seed=53, name="gang-member-kill")
    seen = {}

    def workload():
        if s.is_jax:
            import jax

            step_fn = jax.jit(lambda x: x + 1.0)
        else:
            def step_fn(x):
                return x + 1.0

        @s.rt.remote
        class Member:
            def step(self, x):
                return step_fn(x)

        members = [Member.options(execution="inproc", max_restarts=1).remote()
                   for _ in range(2)]
        gang = s.dag.StageGroup(members, "step", split_axis=0, warmup=((4, 8), "float32"))
        with s.dag.InputNode() as inp:
            d = gang.bind(inp)
        plan = d.compile_plan(name="gang-chaos")
        refs = _retried_puts(s, 10)
        x = s.array(np.ones((4, 8)))
        seen["sums"] = [float(_host(plan.execute(x)).sum()) for _ in range(10)]
        fut = plan.execute_async(x)
        s.rt.kill(members[1], no_restart=False)
        raised = None
        try:
            fut.result(timeout=30)
        except (s.exc.ActorDiedError, s.exc.RayActorError) as exc:
            raised = exc
        deadline = time.monotonic() + 30
        while raised is None and time.monotonic() < deadline:
            try:
                plan.execute(x)
            except (s.exc.ActorDiedError, s.exc.RayActorError) as exc:
                raised = exc
        seen["raised"] = _error(raised) if raised is not None else None
        seen["broken"] = plan.state
        plan.repair(timeout=30)
        seen["repaired"] = plan.state
        seen["after"] = [float(_host(plan.execute(x)).sum()) for _ in range(5)]
        plan.teardown()
        return refs

    result = chaos.ChaosRunner(schedule, quiesce_timeout=90).run(workload)
    return {"summary": _summary(result), "seen": seen}


def test_schedule_gang_member_kill_repair_byte_identical_matches_jax():
    jax_out, port_out = _both(scenario_schedule_gang_member_kill_repair_byte_identical,
                              {"num_cpus": 2})
    assert port_out == jax_out
    assert port_out["seen"] == {"sums": [64.0] * 10, "raised": "ActorDiedError",
                                "broken": "BROKEN", "repaired": "READY", "after": [64.0] * 5}
    summary = port_out["summary"]
    assert summary["ok"] and summary["faults"]
    assert all(f["fp"] == "object_store.put" for f in summary["faults"])
