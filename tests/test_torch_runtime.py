"""The port's host runtime against the JAX package's, scenario by scenario.

Each scenario is a function of the package (``ray_tpu`` or
``ray_tpu_torch``): it starts a one-node runtime, drives it through the
public API and returns what a user sees (results, exception type names and
messages, id widths, ``object_store`` stats, fault logs, timeline event
names). Both packages run every scenario on the CPU and must return the same
outputs, after one normalization: the package's own name, ids and file paths
are masked in messages.

Task functions and actor classes live at module level in
``tests/torch_runtime_tasks.py``, which imports neither JAX, nor either
package, nor torch: worker processes unpickle them by module name (``tests/``
is on the driver's ``sys.path``, which the workers get), and a port worker
must load no JAX.  This module imports JAX inside the tests that use it.
"""

import importlib
import os
import re
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_runtime_tasks import (  # noqa: E402
    Counter,
    _boom,
    _checksum,
    _flaky,
    _host_view,
    _inc,
    _payload,
    _scale,
    _sleep,
    _squares,
    _squares_then_fail,
    _total,
)

PACKAGES = ("ray_tpu", "ray_tpu_torch")
MB = 1 << 20


def _pkg(name):
    return importlib.import_module(name)


# --------------------------------------------------------------------------
# normalization
# --------------------------------------------------------------------------
_HEX = re.compile(r"\b[0-9a-f]{8,}\b")
_PATH = re.compile(r"(/[^\s:'\"]+)+\.py")


def _norm(v):
    """Mask what legitimately differs between the packages: the package
    name, ids and source paths inside strings.  Arrays become lists."""
    if isinstance(v, str):
        v = v.replace("ray_tpu_torch", "ray_tpu")
        return _PATH.sub("<file>", _HEX.sub("<id>", v))
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_norm(x) for x in v)
    return v


def _error(exc):
    """What a caller sees of an exception: type names, message, cause."""
    out = {"type": type(exc).__name__, "mro": [c.__name__ for c in type(exc).__mro__]}
    cause = getattr(exc, "cause", None)
    if cause is not None:
        out["cause"] = _error(cause) if hasattr(cause, "traceback_str") else (
            type(cause).__name__, str(cause))
        out["function"] = exc.function_name
        # the remote traceback's last line: the original exception
        out["tb_last"] = exc.traceback_str.strip().splitlines()[-1]
    else:
        out["message"] = str(exc)
    return out


def _run_both(scenario, *args):
    outs = {}
    for name in PACKAGES:
        rt = _pkg(name)
        try:
            outs[name] = _norm(scenario(rt, *args))
        finally:
            rt.shutdown()
    return outs["ray_tpu"], outs["ray_tpu_torch"]


# --------------------------------------------------------------------------
# scenarios
# --------------------------------------------------------------------------
def scenario_fan_out_fan_in(rt):
    rt.init(num_cpus=4)
    big = np.arange(100_000, dtype=np.float64)  # 800 KB: over the 256 KB shm threshold
    ref = rt.put(big)
    parts = [rt.remote(_scale).options(execution="process").remote(ref, k) for k in range(6)]
    total = rt.remote(_total).remote(*parts)
    direct = rt.remote(_checksum).options(execution="process").remote(big)
    inproc = rt.remote(_checksum).options(execution="thread").remote(ref)
    ctx = rt.get_runtime_context()
    return {
        "total": rt.get(total),
        "parts": [float(p.sum()) for p in rt.get(parts)],
        "direct": rt.get(direct),
        "inproc": rt.get(inproc),
        "small": rt.get([rt.remote(_inc).remote(i) for i in range(8)]),
        "ids": {
            "object": len(ref.hex()),
            "task": len(parts[0].task_id().hex()),
            "job": len(ctx.get_job_id()),
            "node": len(ctx.get_node_id()),
            "task_ctx": ctx.get_task_id(),
        },
        "resources": {k: v for k, v in rt.cluster_resources().items() if k != "GPU"},
        "nodes": [(n["Alive"], sorted(n)) for n in rt.nodes()],
        "store": sorted(rt.get_cluster().head_node.store.stats()),
    }


def scenario_errors(rt):
    rt.init(num_cpus=2)
    out = {}
    for mode in ("process", "thread"):
        f = rt.remote(_boom).options(execution=mode, max_retries=0)
        ref = f.remote(3)
        try:
            rt.get(ref)
        except Exception as exc:  # noqa: BLE001 — the typed error is the output
            out[mode] = _error(exc)
        # a dependent task inherits the upstream failure
        try:
            rt.get(rt.remote(_inc).remote(ref))
        except Exception as exc:  # noqa: BLE001
            out[mode + "_dependent"] = _error(exc)
    try:
        rt.get(rt.remote(_sleep).remote(2.0), timeout=0.05)
    except Exception as exc:  # noqa: BLE001
        out["timeout"] = _error(exc)
    try:
        rt.get("not a ref")
    except Exception as exc:  # noqa: BLE001
        out["bad_get"] = _error(exc)
    try:
        rt.remote(_inc)(1)
    except Exception as exc:  # noqa: BLE001
        out["direct_call"] = _error(exc)
    try:
        rt.remote(_inc).options(bogus=1)
    except Exception as exc:  # noqa: BLE001
        out["bad_option"] = _error(exc)
    try:
        rt.init()
    except Exception as exc:  # noqa: BLE001
        out["reinit"] = _error(exc)
    return out


def scenario_retries_and_cancel(rt, tmp):
    rt.init(num_cpus=1)
    out = {}
    for name, retries, fails in (("recovers", 2, 2), ("exhausted", 1, 3)):
        path = os.path.join(tmp, f"{rt.__name__}_{name}")
        f = rt.remote(_flaky).options(max_retries=retries, retry_exceptions=True)
        try:
            out[name] = rt.get(f.remote(path, fails))
        except Exception as exc:  # noqa: BLE001
            out[name] = _error(exc)
        with open(path) as fh:
            out[name + "_attempts"] = len(fh.read())
    blocker = rt.remote(_sleep).remote(0.5)
    queued = rt.remote(_inc).remote(1)  # one CPU: waits behind the blocker
    rt.cancel(queued)
    try:
        out["cancelled"] = rt.get(queued, timeout=30)
    except Exception as exc:  # noqa: BLE001
        out["cancelled"] = _error(exc)
    out["blocker"] = rt.get(blocker)
    return out


def scenario_wait(rt):
    rt.init(num_cpus=2)
    fast = rt.remote(_inc).options(execution="thread").remote(1)
    slow = rt.remote(_sleep).remote(1.5)
    ready, rest = rt.wait([fast, slow], num_returns=1, timeout=10)
    out = {"first": ([r == fast for r in ready], [r == slow for r in rest])}
    ready, rest = rt.wait([slow], timeout=0.05)
    out["timed_out"] = (len(ready), len(rest))
    ready, rest = rt.wait([fast, slow], num_returns=2, timeout=0.05)
    out["partial"] = (len(ready), len(rest))
    ready, rest = rt.wait([fast, slow], num_returns=2, timeout=30)
    out["all"] = (len(ready), len(rest), rt.get(slow))
    try:
        rt.wait([fast], num_returns=2)
    except Exception as exc:  # noqa: BLE001
        out["too_many"] = _error(exc)
    return out


def scenario_named_actors(rt):
    rt.init(num_cpus=4)
    out = {}
    for mode in ("inproc", "process"):
        cls = rt.remote(Counter).options(name=f"counter_{mode}", execution=mode)
        h = cls.remote(10)
        first = rt.get(h.add.remote(5))
        again = rt.get_actor(f"counter_{mode}")
        second = rt.get(again.add.remote(1))
        in_driver = rt.get(h.pid.remote()) == os.getpid()
        rt.kill(h)
        try:
            rt.get(h.add.remote(1), timeout=30)
            after_kill = "answered"
        except Exception as exc:  # noqa: BLE001
            after_kill = _error(exc)
        out[mode] = {"first": first, "second": second, "in_driver": in_driver,
                     "after_kill": after_kill, "repr": repr(h)}
    try:
        rt.get_actor("missing")
    except Exception as exc:  # noqa: BLE001
        out["missing"] = _error(exc)
    try:
        Counter_cls = rt.remote(Counter)
        Counter_cls(1)
    except Exception as exc:  # noqa: BLE001
        out["direct_construct"] = _error(exc)
    return out


def scenario_streaming(rt):
    rt.init(num_cpus=2)
    gen = rt.remote(_squares).options(num_returns="streaming").remote(6)
    out = {"type": type(gen).__name__, "values": [rt.get(r) for r in gen],
           "finished": gen.is_finished()}
    items = []
    for r in rt.remote(_squares_then_fail).options(num_returns="streaming").remote(3):
        try:
            items.append(rt.get(r))
        except Exception as exc:  # noqa: BLE001
            items.append(_error(exc))
    out["error_mid_stream"] = items
    h = rt.remote(Counter).options(execution="inproc").remote(0)
    try:
        h.add.options(num_returns="streaming").remote(1)
    except Exception as exc:  # noqa: BLE001
        out["actor_streaming"] = _error(exc)
    return out


def scenario_spill_and_backpressure(rt, tmp):
    spill_dir = os.path.join(tmp, rt.__name__)
    rt.init(num_cpus=1, _system_config={
        "object_store_host_bytes": 3 * MB,
        "object_store_max_disk_bytes": 3 * MB,
        "store_put_backpressure_timeout_s": 0.2,
        "spill_dir": spill_dir,
    })
    store = rt.get_cluster().head_node.store
    out = {"stats": []}
    refs = []
    for i in range(6):  # bytes spill to disk (the shm tier takes only arrays)
        refs.append(rt.put(_payload(i, MB)))
        out["stats"].append(store.stats())
    try:
        rt.put(_payload(99, MB))
    except Exception as exc:  # noqa: BLE001
        out["full"] = {k: v for k, v in _error(exc).items() if k != "message"}
    out["after_full"] = store.stats()
    out["values_back"] = [rt.get(r) == _payload(i, MB) for i, r in enumerate(refs)]
    out["after_restore"] = store.stats()
    del refs
    out["spill_files_left"] = sorted(os.listdir(spill_dir)) if os.path.isdir(spill_dir) else []
    out["from_process_task"] = rt.get(rt.remote(len).options(execution="process").remote(rt.put(_payload(7, MB))))
    return out


def scenario_failpoints(rt):
    rt.init(num_cpus=2, _system_config={
        "failpoints": "scheduler.dispatch=delay(0.001,0.5)", "failpoint_seed": 1234,
    })
    fp = importlib.import_module(rt.__name__ + ".runtime.failpoints")
    fp.reset_log()
    results = [rt.get(rt.remote(_inc).options(execution="thread").remote(i)) for i in range(24)]
    return {"results": results, "log": fp.fault_log(), "spec": fp.armed_spec()}


def _timeline_quiet(rt, quiet_s: float = 0.5, timeout_s: float = 10.0) -> None:
    """Wait until the timeline has not grown for ``quiet_s``: the scenario
    reads it twice (records, then the chrome trace), and a record that
    lands between the two reads in one package only makes the packages'
    outputs differ."""
    last, since = -1, time.monotonic()
    deadline = since + timeout_s
    while time.monotonic() < deadline:
        n = len(rt.timeline())
        if n != last:
            last, since = n, time.monotonic()
        elif time.monotonic() - since >= quiet_s:
            return
        time.sleep(0.02)


def scenario_timeline(rt, tmp):
    rt.init(num_cpus=2)
    rt.get([rt.remote(_inc).options(execution=m).remote(1) for m in ("thread", "process")])
    h = rt.remote(Counter).options(execution="inproc").remote(0)
    rt.get(h.add.remote(2))
    try:
        rt.get(rt.remote(_boom).options(max_retries=0).remote(1))
    except Exception:  # noqa: BLE001 — its FAILED event is the point
        pass
    _timeline_quiet(rt)
    events = rt.timeline()
    path = os.path.join(tmp, rt.__name__ + "_trace.json")
    chrome = rt.timeline(filename=path)
    return {
        "events": sorted({(e.get("name"), e.get("state"), e.get("type")) for e in events},
                         key=repr),
        "event_keys": sorted({k for e in events for k in e}),
        "chrome": sorted({(c.get("name"), c.get("cat"), c.get("ph")) for c in chrome}, key=repr),
        "written": os.path.getsize(path) > 0,
    }


def scenario_overload_deadline_infeasible(rt):
    rt.init(num_cpus=4, _system_config={
        "max_inflight_tasks_per_caller": 2, "task_submit_overload_policy": "shed",
        "infeasible_task_timeout_s": 0.5,
    })
    out = {}
    running = [rt.remote(_sleep).remote(0.5) for _ in range(2)]
    try:
        rt.remote(_inc).remote(1)
        out["shed"] = "admitted"
    except Exception as exc:  # noqa: BLE001
        out["shed"] = {**_error(exc), "layer": exc.layer, "reason": exc.reason,
                       "retry_after_s": exc.retry_after_s}
    rt.get(running)
    events = list(rt.get_cluster().overload_events)
    out["audit"] = [(e["layer"], e["reason"]) for e in events]
    out["overload_snapshot"] = sorted(rt.get_cluster().overload_snapshot())
    try:
        rt.get(rt.remote(_sleep).options(deadline_s=0.2).remote(2.0), timeout=30)
    except Exception as exc:  # noqa: BLE001
        out["deadline"] = _error(exc)
    try:
        rt.get(rt.remote(_inc).options(num_tpus=1).remote(1), timeout=30)
    except Exception as exc:  # noqa: BLE001
        out["infeasible_tpu"] = _error(exc)
    return out


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------
@pytest.fixture(autouse=True)
def _fresh_configs():
    """Both packages' configs are rebuilt from the environment around each
    test (``init(_system_config=)`` installs its own; shutdown resets)."""
    for name in PACKAGES:
        importlib.import_module(name + ".core.config").reset_config()
    yield
    for name in PACKAGES:
        _pkg(name).shutdown()
        importlib.import_module(name + ".core.config").reset_config()


@pytest.mark.parametrize("scenario", [
    scenario_fan_out_fan_in, scenario_errors, scenario_wait, scenario_named_actors,
    scenario_streaming, scenario_failpoints, scenario_overload_deadline_infeasible,
], ids=lambda f: f.__name__.removeprefix("scenario_"))
def test_scenario_matches_jax(scenario):
    jax_out, port_out = _run_both(scenario)
    assert port_out == jax_out


@pytest.mark.parametrize("scenario", [
    scenario_retries_and_cancel, scenario_spill_and_backpressure, scenario_timeline,
], ids=lambda f: f.__name__.removeprefix("scenario_"))
def test_scenario_with_files_matches_jax(scenario, tmp_path):
    jax_out, port_out = _run_both(scenario, str(tmp_path))
    assert port_out == jax_out


def test_scenario_outputs_are_what_a_user_expects(tmp_path):
    """The shared outputs are right, not only equal: spot-check the port's."""
    rt = _pkg("ray_tpu_torch")
    try:
        out = scenario_fan_out_fan_in(rt)
    finally:
        rt.shutdown()
    big = np.arange(100_000, dtype=np.float64)
    assert out["total"] == float(sum(big.sum() * k for k in range(6)))
    assert out["direct"] == (big.sum(), "<f8", (100_000,))
    assert out["small"] == list(range(1, 9))
    assert out["ids"] == {"object": 48, "task": 40, "job": 8, "node": 32, "task_ctx": None}
    try:
        out = scenario_spill_and_backpressure(rt, str(tmp_path))
    finally:
        rt.shutdown()
    assert out["full"]["type"] == "StoreFullError"
    assert out["stats"][-1]["spills"] == 3 and out["stats"][-1]["disk_used"] == 3 * MB
    assert all(out["values_back"]) and out["spill_files_left"] == []
    assert out["after_full"]["puts_shed"] == 1


def test_metric_catalog_and_store_metrics_match_jax():
    """The same metric families exist in both packages, and a scenario moves
    the same object-store series."""
    jdefs = importlib.import_module("ray_tpu.observability.metric_defs")
    tdefs = importlib.import_module("ray_tpu_torch.observability.metric_defs")
    assert [(m.name, m.kind) for m in tdefs.ALL_METRICS] == [
        (m.name, m.kind) for m in jdefs.ALL_METRICS]

    def moved(name):
        reg = importlib.import_module(name + ".observability.metrics").global_registry()
        before = set(reg.render_prometheus().splitlines())
        rt = _pkg(name)
        rt.init(num_cpus=2)
        try:
            rt.get([rt.remote(_inc).remote(i) for i in range(4)])
            rt.get(rt.put(np.zeros(1000)))
        finally:
            rt.shutdown()
        after = reg.render_prometheus().splitlines()
        return sorted({line.split("{")[0].split(" ")[0] for line in after
                       if line not in before and not line.startswith("#")
                       and "object_store" in line})

    assert moved("ray_tpu_torch") == moved("ray_tpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_tensor_reaches_a_process_worker_as_the_jax_worker_sees_it(dtype):
    import jax.numpy as jnp

    host = np.random.default_rng(3).standard_normal((64, 96)).astype(np.float32)
    jarr = np.asarray(jnp.asarray(host, dtype=getattr(jnp, dtype)))
    tens = torch.from_numpy(host).to(getattr(torch, dtype))
    seen = {}
    for name, value in (("ray_tpu", jarr), ("ray_tpu_torch", tens)):
        rt = _pkg(name)
        rt.init(num_cpus=2)
        try:
            seen[name] = rt.get(rt.remote(_host_view).options(execution="process").remote(value))
        finally:
            rt.shutdown()
    kind, tdtype, values, cuda = seen["ray_tpu_torch"]
    assert (kind, tdtype, cuda) == ("tensor", dtype, False)
    assert seen["ray_tpu"][:2] == ("ndarray", dtype)
    np.testing.assert_array_equal(values, seen["ray_tpu"][2])
    # and a tensor returned from the worker comes back equal
    rt = _pkg("ray_tpu_torch")
    rt.init(num_cpus=2)
    try:
        back = rt.get(rt.remote(_scale).options(execution="process").remote(tens, 2))
    finally:
        rt.shutdown()
    assert back.dtype == tens.dtype and torch.equal(back, tens * 2)


def test_public_signatures_match_jax():
    import inspect

    jax_rt, port_rt = _pkg("ray_tpu"), _pkg("ray_tpu_torch")
    names = ["init", "shutdown", "is_initialized", "remote", "method", "get", "put", "wait",
             "kill", "cancel", "get_actor", "get_runtime_context", "cluster_resources",
             "available_resources", "nodes", "timeline", "ObjectRef", "ObjectRefGenerator"]
    for name in names:
        js, ts = inspect.signature(getattr(jax_rt, name)), inspect.signature(getattr(port_rt, name))
        if name == "init":
            # the one allowed difference: init names num_gpus (the JAX
            # package takes and ignores it through **_compat)
            params = [p for p in ts.parameters.values() if p.name != "num_gpus"]
            ts = ts.replace(parameters=params)
        assert str(ts) == str(js), name
    for name in ("ObjectRef", "ObjectRefGenerator"):
        jm = {m for m in dir(getattr(jax_rt, name)) if not m.startswith("__")}
        tm = {m for m in dir(getattr(port_rt, name)) if not m.startswith("__")}
        assert tm == jm, name
    # the JAX package may swap its ids for native types (no signatures):
    # the ids must round-trip between the packages byte for byte instead
    for name in ("ActorID", "JobID", "NodeID", "ObjectID", "TaskID", "WorkerID",
                 "UniqueID", "FunctionID", "ActorClassID", "PlacementGroupID"):
        jcls, tcls = getattr(jax_rt, name), getattr(port_rt, name)
        assert tcls.SIZE == jcls.SIZE, name
        jid = jcls.from_random()
        tid = tcls(jid.binary())
        assert (tid.hex(), tid.binary(), tid.is_nil()) == (jid.hex(), jid.binary(), jid.is_nil())
        assert tcls.nil().hex() == jcls.nil().hex()
    job = jax_rt.JobID.from_int(7)
    tjob = port_rt.JobID.from_int(7)
    assert tjob.hex() == job.hex()
    task = port_rt.TaskID.for_normal_task(tjob)
    oid = port_rt.ObjectID.for_task_return(task, 2)
    assert (oid.task_id(), oid.index()) == (task, 2)
    assert oid.hex()[:len(task.hex())] == task.hex()


def test_not_ported_features_raise_typed_errors():
    """The multi-node runtime is ported: ``init(head_port=)``, the head
    service and the relay tree work, and so does the thin client
    (``util.connect`` to a ``ClientServer``).  The name is historical: these
    raised ``NotPortedError`` before they were ported."""
    rt = _pkg("ray_tpu_torch")
    rt.init(num_cpus=1, head_port=0)
    try:
        host, _, port = rt.get_cluster().head_service.address.rpartition(":")
        assert host == "0.0.0.0" and int(port) > 0
    finally:
        rt.shutdown()
    assert not rt.is_initialized()
    rt.init(num_cpus=1)
    try:
        # .bind builds DAG nodes since the dag layer was ported
        assert rt.get(rt.remote(_inc).bind(1).execute()) == 2
        from ray_tpu_torch.runtime import data_plane

        tree = data_plane.build_relay_tree(["127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"], 2)
        assert [t["addr"] for t in tree] == ["127.0.0.1:1", "127.0.0.1:2"]
        assert [c["addr"] for c in tree[0]["children"]] == ["127.0.0.1:3"]
        # runtime envs are ported (tests/test_torch_runtime_env.py): the
        # task runs with its env in a process worker
        assert rt.get(rt.remote(_inc).options(runtime_env={"env_vars": {"A": "1"}}).remote(1)) == 2
        address = rt.get_cluster().start_head_service()
        assert address == rt.get_cluster().start_head_service()  # idempotent
        from ray_tpu_torch import util
        from ray_tpu_torch.util.client import ClientServer

        server = ClientServer(port=0).start()
        try:
            with util.connect(f"ray://{server.address}") as ctx:
                assert ctx.get(ctx.remote(_inc).remote(1)) == 2
        finally:
            server.stop()
        # a GPU request on a node without one is infeasible, as a TPU one is
        assert "GPU" not in rt.cluster_resources() and "TPU" not in rt.cluster_resources()
    finally:
        rt.shutdown()


def test_without_cloudpickle_module_level_functions_still_run(monkeypatch):
    """Without cloudpickle, functions and classes travel by reference; a
    closure fails at ``.remote()`` with a TypeError naming the package."""
    rt = _pkg("ray_tpu_torch")
    monkeypatch.setitem(sys.modules, "cloudpickle", None)  # import raises ImportError
    rt.init(num_cpus=2)
    try:
        assert rt.get(rt.remote(_inc).options(execution="process").remote(1)) == 2
        h = rt.remote(Counter).options(execution="process").remote(1)
        assert rt.get(h.add.remote(2)) == 3

        def local(x):
            return x

        with pytest.raises(TypeError, match="cloudpickle"):
            rt.remote(local).remote(1)
        with pytest.raises(TypeError, match="cloudpickle"):
            rt.remote(lambda x: x).remote(1)
    finally:
        rt.shutdown()


# --------------------------------------------------------------------------
# the slice: a tiny decoder held by an actor in each package
# --------------------------------------------------------------------------
TINY = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128)
TINY_PROMPTS = [[3, 5, 7, 11], [2] * 9, list(range(1, 20)), [8, 9]]


class EngineActor:
    """One package's LLMEngine on the CPU, built inside the actor."""

    def __init__(self, which, np_params):
        if which == "ray_tpu":
            import jax
            import jax.numpy as jnp

            from ray_tpu.models import TransformerConfig as JaxConfig
            from ray_tpu.serve.llm import LLMEngine as JaxEngine

            cfg = JaxConfig(**TINY, attention="dense", dtype=jnp.float32)
            self.engine = JaxEngine(cfg, jax.tree.map(jnp.asarray, np_params),
                                    max_batch_size=4, max_seq_len=64, cache_kind="paged")
        else:
            from ray_tpu_torch.convert import params_from_numpy
            from ray_tpu_torch.models.transformer import TransformerConfig
            from ray_tpu_torch.serve.llm import LLMEngine

            cfg = TransformerConfig(**TINY, attention="dense", dtype=torch.float32)
            self.engine = LLMEngine(cfg, params_from_numpy(np_params), device="cpu",
                                    max_batch_size=4, max_seq_len=64, cache_kind="paged")

    def generate(self, prompts, max_tokens):
        futs = [self.engine.submit(p, max_tokens=max_tokens) for p in prompts]
        return [f.result(timeout=120) for f in futs]

    def close(self):
        self.engine.shutdown()
        return True


def test_actor_held_tiny_engine_matches_jax_actor():
    import jax

    from ray_tpu.models import TransformerConfig as JaxConfig
    from ray_tpu.models import init_params

    cfg = JaxConfig(**TINY, attention="dense", dtype=jax.numpy.float32)
    np_params = jax.tree.map(np.asarray, init_params(cfg, jax.random.key(5)))
    tokens = {}
    for name in PACKAGES:
        rt = _pkg(name)
        rt.init(num_cpus=2)
        try:
            actor = rt.remote(EngineActor).options(execution="inproc").remote(name, np_params)
            tokens[name] = rt.get(actor.generate.remote(TINY_PROMPTS, 6), timeout=300)
            assert rt.get(actor.close.remote(), timeout=60)
        finally:
            rt.shutdown()
    assert tokens["ray_tpu_torch"] == tokens["ray_tpu"]
    assert [len(t) for t in tokens["ray_tpu"]] == [6] * len(TINY_PROMPTS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int64", "float8_e4m3fn", "bool"])
def test_tensors_cross_processes_as_host_numpy_never_torch_pickling(dtype):
    """Frames to and from a worker carry a tensor as numpy host bytes and its
    dtype name: torch's own pickling (which rebuilds a CUDA tensor on CUDA in
    the receiver) never appears in them."""
    import pickle

    from ray_tpu_torch.core import serialization

    g = torch.Generator().manual_seed(0)
    t = (torch.randn(6, 10, generator=g) * 4).to(getattr(torch, dtype)).t()  # non-contiguous
    if t.is_floating_point() and dtype == "float32":
        t.requires_grad_(True)
    for blob in (serialization.dumps(("args", {"x": t})),
                 serialization.dumps_by_value((t, [t])),
                 serialization.get_context().serialize(t).meta):
        assert b"_rebuild_tensor" in blob and b"torch._utils" not in blob
    back = pickle.loads(serialization.dumps({"x": t}))["x"]
    assert back.dtype == t.dtype and back.shape == t.shape and back.device.type == "cpu"
    assert back.requires_grad == t.requires_grad
    assert torch.equal(back.detach().view(torch.uint8) if dtype == "float8_e4m3fn" else back.detach(),
                       t.detach().contiguous().view(torch.uint8) if dtype == "float8_e4m3fn"
                       else t.detach())


def test_finished_request_trace_exports_the_same_spans(monkeypatch):
    """A finished request trace becomes a ``serve::request`` span with one
    child span a phase, through the tracing layer, in both packages."""
    spans = {}
    for name in PACKAGES:
        tracing = importlib.import_module(name + ".observability.tracing")
        reqtrace = importlib.import_module(name + ".observability.reqtrace")
        config = importlib.import_module(name + ".core.config")
        monkeypatch.setattr(config.get_config(), "tracing_enabled", True)
        tracing.drain_span_events()
        store = reqtrace.TraceStore(ring=4)
        tr = reqtrace.RequestTrace(route="/llm", deployment="LLMServer", tenant="acme")
        for mark in ("router_in", "replica_in", "engine_submit", "wfq_pop", "admitted",
                     "prefill_start", "first_token"):
            tr.mark(mark)
        store.finish(tr, "ok", "proxy")
        events = tracing.drain_span_events()
        root = [e for e in events if e.get("parent_id") is None]
        assert len(root) == 1
        spans[name] = {
            "names": [e["name"] for e in events],
            "root_attrs": root[0].get("attrs"),
            "children_of_root": sum(e.get("parent_id") == root[0]["span_id"] for e in events),
            "keys": sorted({k for e in events for k in e}),
        }
    assert spans["ray_tpu_torch"] == spans["ray_tpu"]
    assert spans["ray_tpu"]["names"][0] == "serve::request"
    assert spans["ray_tpu"]["children_of_root"] == len(spans["ray_tpu"]["names"]) - 1 > 0


def _worker_children():
    """Live (non-zombie) children of this process running the port's worker."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:
            continue
        if (int(stat[1]) == os.getpid() and stat[0] != "Z"
                and b"ray_tpu_torch.runtime.worker_main" in cmd):
            out.append(int(pid))
    return out


@pytest.mark.parametrize("pause_s", [0.0, 0.05, 0.3])
def test_shutdown_leaves_no_worker_process(pause_s):
    """``shutdown`` returns after every worker process is gone, a worker
    still being prestarted included (its spawn stands down)."""
    rt = _pkg("ray_tpu_torch")
    rt.init(num_cpus=2)
    try:
        time.sleep(pause_s)
        if pause_s > 0.1:
            assert rt.get(rt.remote(_inc).options(execution="process").remote(1)) == 2
    finally:
        rt.shutdown()
    assert _worker_children() == []


def test_shutdown_frees_what_the_runtime_held():
    """Once ``shutdown`` returns (and a gc pass runs), nothing the runtime
    held stays alive: on the card that is device memory."""
    import gc
    import weakref

    rt = _pkg("ray_tpu_torch")
    rt.init(num_cpus=2)
    try:
        t = torch.ones(1000)
        held = weakref.ref(t)
        cluster = weakref.ref(rt.get_cluster())
        ref = rt.put(t)
        rt.get(rt.remote(_scale).options(execution="thread").remote(ref, 2))
        rt.get(rt.remote(_scale).options(execution="process").remote(t, 2))
        del t, ref
    finally:
        rt.shutdown()
    gc.collect()
    assert cluster() is None and held() is None


def test_gpu_request_without_a_card_fails_as_a_tpu_request_does():
    """Nothing silently runs on the CPU: on a node without a GPU, a task or
    actor that asks for one is infeasible exactly as the JAX package treats
    a TPU request on a node without chips."""
    def infeasible(name, resource):
        rt = _pkg(name)
        rt.init(num_cpus=2, _system_config={"infeasible_task_timeout_s": 0.5})
        out = {}
        try:
            try:
                rt.get(rt.remote(_inc).options(**{resource: 1}).remote(1), timeout=30)
            except Exception as exc:  # noqa: BLE001
                out["task"] = _error(exc)
            # an actor's creation parks for a fixed 30 s before the same
            # failure (ray_tpu/runtime/cluster.py:1076): its call waits
            actor = rt.remote(Counter).options(**{resource: 1}).remote(0)
            try:
                rt.get(actor.add.remote(1), timeout=0.5)
            except Exception as exc:  # noqa: BLE001
                out["actor"] = _error(exc)
        finally:
            rt.shutdown()
        return _norm(out)

    want = infeasible("ray_tpu", "num_tpus")
    got = infeasible("ray_tpu_torch", "num_gpus")
    assert "TPU" in repr(want) and "GPU" in repr(got)
    assert _norm(repr(got).replace("GPU", "TPU")) == _norm(repr(want))
