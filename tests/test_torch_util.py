"""The port's utility layer (``ray_tpu_torch.util`` and
``ray_tpu_torch.experimental``) against the JAX package's, scenario by
scenario.

Each scenario is a function of one package: it starts a one-node runtime
(where it needs one), drives the utilities as a user would and returns what
the user sees. Both packages run every scenario on the CPU, one after the
other, and the outputs must be equal after the runtime tests' normalization
(``_norm`` of ``tests/test_torch_runtime.py``: the package's name, ids and
source paths masked in strings). The scenarios are those of the JAX
package's ``tests/test_util_shims.py``, ``test_util_api_tail.py``,
``test_util_dask.py``, the ``util`` parts of ``test_util_workflow.py``,
``test_observability.py::test_util_metrics_user_api`` and
``test_cluster.py::test_util_placement_group_api``.

Task functions here are lambdas or nested functions: they travel to process
workers by value (cloudpickle), so a worker never imports this module (and
with it JAX and torch).
"""

import contextlib
import importlib
import io
import operator
import pickle
import re
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_runtime import _error, _norm  # noqa: E402

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.{name}")


def _run_both(scenario, *args, init=None):
    """``scenario(rt, *args)`` in each package, the runtime started with
    ``init`` (None: no runtime) and shut down after; both outputs, masked."""
    outs = {}
    for name in PACKAGES:
        rt = importlib.import_module(name)
        if init is not None:
            rt.init(**init)
        try:
            outs[name] = _norm(scenario(rt, *args))
        finally:
            rt.shutdown()
    assert outs["ray_tpu_torch"] == outs["ray_tpu"]
    return outs["ray_tpu_torch"]


@pytest.fixture(autouse=True)
def _fresh_configs():
    for name in PACKAGES:
        importlib.import_module(name + ".core.config").reset_config()
    yield
    for name in PACKAGES:
        importlib.import_module(name).shutdown()
        importlib.import_module(name + ".core.config").reset_config()


# --------------------------------------------------------------------------
# util.multiprocessing.Pool (test_util_shims.py)
# --------------------------------------------------------------------------
def scenario_pool_map(rt):
    Pool = _mod(rt, "util.multiprocessing").Pool
    with Pool(processes=4) as pool:
        return pool.map(lambda x: x * x, range(20))


def scenario_pool_starmap_and_apply(rt):
    Pool = _mod(rt, "util.multiprocessing").Pool
    pool = Pool()
    out = {"starmap": pool.starmap(lambda a, b: a + b, [(1, 2), (3, 4)]),
           "apply": pool.apply(lambda a, b: a * b, (3, 4))}
    res = pool.apply_async(lambda: "async")
    out["async"] = res.get(timeout=30)
    out["successful"] = res.successful()
    out["ready"] = res.ready()
    out["map_async"] = pool.map_async(lambda x: -x, range(5), chunksize=2).get(timeout=30)
    pool.close()
    try:
        pool.map(lambda x: x, [1])
    except ValueError as exc:
        out["closed"] = _error(exc)
    return out


def scenario_pool_imap(rt):
    Pool = _mod(rt, "util.multiprocessing").Pool
    pool = Pool()
    return {"ordered": list(pool.imap(lambda x: x + 1, range(10), chunksize=3)),
            "unordered": sorted(pool.imap_unordered(lambda x: x * 2, range(10), chunksize=2))}


def scenario_pool_initializer(rt):
    Pool = _mod(rt, "util.multiprocessing").Pool

    def init(v):
        import builtins

        builtins._pool_test_v = v

    def use(x):
        import builtins

        return x + builtins._pool_test_v

    with Pool(initializer=init, initargs=(100,)) as pool:
        return pool.map(use, [1, 2])


@pytest.mark.parametrize("scenario", [
    scenario_pool_map, scenario_pool_starmap_and_apply, scenario_pool_imap,
    scenario_pool_initializer,
], ids=lambda f: f.__name__.removeprefix("scenario_"))
def test_pool_matches_jax(scenario):
    _run_both(scenario, init={"num_cpus": 4})


def test_pool_outputs_are_what_a_user_expects():
    rt = importlib.import_module("ray_tpu_torch")
    rt.init(num_cpus=4)
    try:
        assert scenario_pool_map(rt) == [x * x for x in range(20)]
        out = scenario_pool_starmap_and_apply(rt)
        assert out["starmap"] == [3, 7] and out["apply"] == 12 and out["async"] == "async"
        assert out["closed"]["message"] == "Pool is closed"
        assert scenario_pool_initializer(rt) == [101, 102]
    finally:
        rt.shutdown()


def scenario_joblib(rt):
    joblib = pytest.importorskip("joblib", reason="joblib is not installed")
    _mod(rt, "util.joblib").register_ray_tpu()
    with joblib.parallel_backend("ray_tpu"):
        return joblib.Parallel(n_jobs=4)(joblib.delayed(np.sqrt)(i**2) for i in range(10))


def test_joblib_backend_matches_jax():
    assert _run_both(scenario_joblib, init={"num_cpus": 4}) == [float(i) for i in range(10)]


def test_joblib_module_imports_without_joblib(monkeypatch):
    """The GPU machine has no joblib: the module imports, and only
    ``register_ray_tpu`` needs the package, as in the JAX package."""
    import sys

    monkeypatch.setitem(sys.modules, "joblib", None)
    monkeypatch.setitem(sys.modules, "joblib.parallel", None)
    errors = []
    for name in PACKAGES:
        mod = importlib.reload(importlib.import_module(name + ".util.joblib"))
        with pytest.raises(ImportError) as exc:
            mod.register_ray_tpu()
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


# --------------------------------------------------------------------------
# experimental: internal_kv, tqdm_ray; util.scheduling_strategies
# --------------------------------------------------------------------------
def scenario_internal_kv(rt):
    kv = _mod(rt, "experimental.internal_kv")
    return [
        kv._internal_kv_initialized(),
        kv._internal_kv_put(b"k1", b"v1"),
        kv._internal_kv_put(b"k1", b"v2"),
        kv._internal_kv_put("k2", "s", overwrite=False),
        kv._internal_kv_put("k2", "t", overwrite=False),
        kv._internal_kv_get(b"k2"),
        kv._internal_kv_get(b"k1"),
        kv._internal_kv_exists(b"k1"),
        sorted(kv._internal_kv_list(b"k")),
        kv._internal_kv_put(b"k1", b"other-ns", namespace="ns2"),
        kv._internal_kv_get(b"k1", namespace="ns2"),
        kv._internal_kv_del(b"k1"),
        kv._internal_kv_del(b"k1"),
        kv._internal_kv_get(b"k1"),
        # the KV is the control service's: a write shows through the cluster
        rt.get_cluster().control.kv.get(b"k2"),
    ]


def test_internal_kv_matches_jax():
    out = _run_both(scenario_internal_kv, init={"num_cpus": 1})
    assert out[:3] == [True, False, True] and out[5] == b"s" and out[-1] == b"s"


def scenario_tqdm(rt):
    tqdm_ray = _mod(rt, "experimental.tqdm_ray")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        bar = tqdm_ray.tqdm(desc="test", total=10)
        for _ in range(10):
            bar.update(1)
        bar.close()
        bar.close()  # a second close renders nothing
        final = err.getvalue()
        wrapped = list(tqdm_ray.tqdm(range(3), desc="it"))
        with tqdm_ray.tqdm(desc="open", position=2) as b:
            b.set_description("renamed")
            b.update(4)
        tqdm_ray.safe_print("hello")
    text = re.sub(r"\[[0-9.]+ it/s\]", "[<rate> it/s]", err.getvalue())
    last = re.sub(r"\[[0-9.]+ it/s\]", "[<rate> it/s]", final.split("\r\x1b[K")[-1])
    return {"final": last, "wrapped": wrapped, "tail": text[len(text) - 60:],
            "has_total": "10/10" in final}


def test_tqdm_renders_as_jax():
    out = _run_both(scenario_tqdm)
    assert out["has_total"] and out["wrapped"] == [0, 1, 2]


def test_scheduling_strategies_module_matches_jax():
    names = {}
    for name in PACKAGES:
        mod = importlib.import_module(name + ".util.scheduling_strategies")
        sched = importlib.import_module(name + ".runtime.scheduler")
        names[name] = sorted(mod.__all__)
        for n in mod.__all__:
            assert getattr(mod, n) is getattr(sched, n)
    assert names["ray_tpu_torch"] == names["ray_tpu"]


# --------------------------------------------------------------------------
# the util tail (test_util_api_tail.py)
# --------------------------------------------------------------------------
def scenario_parallel_iterator_sync_and_async(rt):
    rt_iter = _mod(rt, "util.iter")
    it = rt_iter.from_range(20, num_shards=3)
    doubled = it.for_each(lambda x: x * 2).filter(lambda x: x % 4 == 0)
    return {"shards": it.num_shards(), "repr": repr(doubled),
            "sync": list(doubled.gather_sync()),
            "async": sorted(doubled.gather_async()),
            "local": list(doubled.gather_sync().for_each(lambda x: x + 1)
                          .filter(lambda x: x % 3).batch(2).take(3))}


def scenario_parallel_iterator_batch_flatmap_union_take(rt):
    rt_iter = _mod(rt, "util.iter")
    a = rt_iter.from_items([1, 2, 3, 4], num_shards=2)
    b = rt_iter.from_items([10, 20], num_shards=1)
    u = a.union(b)
    out = {"shards": u.num_shards(), "union": sorted(u.gather_sync()),
           "flat": sorted(rt_iter.from_range(6, num_shards=2).flat_map(lambda x: [x, x])
                          .gather_sync()),
           "batches": list(rt_iter.from_range(10, num_shards=2).batch(3).gather_sync()),
           "take": rt_iter.from_range(100, num_shards=4).take(7),
           "iterators": sorted(rt_iter.from_iterators([lambda: "ab", lambda: "c"]).gather_sync())}
    try:
        a.for_each(str).union(b)
    except ValueError as exc:
        out["union_after_transform"] = _error(exc)
    return out


def scenario_list_named_actors(rt):
    class Named:
        def ping(self):
            return "ok"

    a = rt.remote(Named).options(name="util_named_actor").remote()
    rt.get(a.ping.remote())
    util = _mod(rt, "util")
    out = {"names": util.list_named_actors(),
           "detailed": util.list_named_actors(all_namespaces=True)}
    rt.kill(a)
    out["after_kill"] = util.list_named_actors()
    return out


def scenario_register_serializer(rt):
    from tests_util_helpers import Opaque

    util = _mod(rt, "util")
    util.register_serializer(Opaque, serializer=lambda o: o.v, deserializer=lambda v: Opaque(v))
    try:
        back = pickle.loads(pickle.dumps(Opaque(42), protocol=5))
        out = {"type": type(back).__name__, "v": back.v}
        # through the object store and a process worker: the copyreg hook
        # rides every pickle path
        out["task"] = rt.get(rt.remote(lambda o: o.v * 2).options(execution="thread")
                             .remote(Opaque(21)))
    finally:
        util.deregister_serializer(Opaque)
    try:
        pickle.dumps(Opaque(1))
    except TypeError as exc:
        out["after_deregister"] = str(exc)
    return out


def scenario_placement_group_lookup(rt):
    util = _mod(rt, "util")
    pg = util.placement_group([{"CPU": 1}], strategy="PACK", name="util_pg")
    out = {"waited": pg.wait(timeout_seconds=30), "bundles": pg.bundle_specs}
    out["found_same"] = util.get_placement_group("util_pg").id == pg.id
    try:
        util.get_placement_group("missing_pg")
    except ValueError as exc:
        out["missing"] = _error(exc)
    out["current_outside"] = util.get_current_placement_group()

    class Probe:
        def current(self):
            cur = _mod(rt, "util").get_current_placement_group()
            return None if cur is None else cur.bundle_specs

    strat = util.PlacementGroupSchedulingStrategy(pg, placement_group_bundle_index=0)
    actor = rt.remote(Probe).options(num_cpus=1, scheduling_strategy=strat,
                                     execution="inproc").remote()
    out["current_inside"] = rt.get(actor.current.remote(), timeout=30)
    rt.kill(actor)
    util.remove_placement_group(pg)
    out["state_after_remove"] = util.placement_group_table(pg)["state"]
    return out


_LOG_ONCE_KEYS = ("tail_key", "periodic_key", "fresh_key")


def _log_once_state(misc):
    return (set(misc._log_once_seen), dict(misc._last_logged), misc._periodic_s,
            misc._log_once_disabled)


def _set_log_once_state(misc, state):
    seen, last, misc._periodic_s, misc._log_once_disabled = state
    misc._log_once_seen.clear()
    misc._log_once_seen.update(seen)
    misc._last_logged.clear()
    misc._last_logged.update(last)


def scenario_node_ip_and_log_once(rt):
    """Runs on a fresh key space and leaves the package's log-once state as
    it found it: the JAX package's own ``test_node_ip_and_log_once`` may
    run before or after it in the same process, and expects ``tail_key``
    unseen."""
    util = _mod(rt, "util")
    ip = util.get_node_ip_address()
    misc = _mod(rt, "util.misc")
    saved = _log_once_state(misc)
    seen, last = saved[0] - set(_LOG_ONCE_KEYS), {
        k: t for k, t in saved[1].items() if k not in _LOG_ONCE_KEYS}
    _set_log_once_state(misc, (seen, last, 0.0, False))
    try:
        out = {"dotted_quad": bool(re.fullmatch(r"\d+\.\d+\.\d+\.\d+", ip)),
               "first": util.log_once("tail_key"), "again": util.log_once("tail_key")}
        util.enable_periodic_logging(1e-9)
        out["periodic"] = [util.log_once("periodic_key"), util.log_once("periodic_key")]
        util.disable_log_once_globally()
        out["disabled"] = util.log_once("fresh_key")
    finally:
        _set_log_once_state(misc, saved)
    port = misc.free_port()
    sock = misc.reserve_port()
    out["ports"] = [0 < port < 65536, sock.getsockname()[1] > 0]
    sock.close()
    return out


def scenario_pdb_shim(rt):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        _mod(rt, "util").pdb.set_trace()  # stdin under pytest is no tty: skip
    return err.getvalue()


@pytest.mark.parametrize("scenario", [
    scenario_parallel_iterator_sync_and_async,
    scenario_parallel_iterator_batch_flatmap_union_take,
    scenario_list_named_actors, scenario_register_serializer,
    scenario_placement_group_lookup, scenario_node_ip_and_log_once, scenario_pdb_shim,
], ids=lambda f: f.__name__.removeprefix("scenario_"))
def test_util_tail_matches_jax(scenario):
    _run_both(scenario, init={"num_cpus": 4})


def test_log_once_scenario_leaves_both_packages_key_space_as_found():
    """On a fresh key space the scenario leaves every key unseen in both
    packages, so a later test's first ``log_once("tail_key")`` is True."""
    miscs = {name: importlib.import_module(name + ".util.misc") for name in PACKAGES}
    saved = {name: _log_once_state(m) for name, m in miscs.items()}
    try:
        for m in miscs.values():
            _set_log_once_state(m, (set(), {}, 0.0, False))
        _run_both(scenario_node_ip_and_log_once, init={"num_cpus": 4})
        for m in miscs.values():
            assert _log_once_state(m) == (set(), {}, 0.0, False)
        assert importlib.import_module("ray_tpu.util").log_once("tail_key")
    finally:
        for name, m in miscs.items():
            _set_log_once_state(m, saved[name])


def test_util_tail_outputs_are_what_a_user_expects():
    rt = importlib.import_module("ray_tpu_torch")
    rt.init(num_cpus=4)
    try:
        out = scenario_parallel_iterator_sync_and_async(rt)
        assert sorted(out["sync"]) == sorted(x * 2 for x in range(20) if (x * 2) % 4 == 0)
        assert out["async"] == sorted(out["sync"])
        out = scenario_parallel_iterator_batch_flatmap_union_take(rt)
        assert out["union"] == [1, 2, 3, 4, 10, 20] and len(out["take"]) == 7
        assert sorted(x for b in out["batches"] for x in b) == list(range(10))
        out = scenario_list_named_actors(rt)
        assert "util_named_actor" in out["names"] and "util_named_actor" not in out["after_kill"]
        out = scenario_placement_group_lookup(rt)
        assert out["waited"] and out["found_same"] and out["current_inside"] == [{"CPU": 1.0}]
        assert out["state_after_remove"] == "REMOVED"
        assert "skipped" in scenario_pdb_shim(rt)
        assert scenario_register_serializer(rt)["task"] == 42
    finally:
        rt.shutdown()


# --------------------------------------------------------------------------
# util.dask: the graph scheduler (test_util_dask.py), hand-built graphs
# --------------------------------------------------------------------------
def _graph():
    return {
        "a": 1,
        "b": (operator.add, "a", 2),
        ("c", 0): (sum, ["a", "b"]),
        "d": (operator.mul, ("c", 0), 2),
    }


def _wide():
    dsk = {"src": 2}
    for i in range(20):
        dsk[("leaf", i)] = (operator.mul, "src", i)
    dsk["total"] = (sum, [("leaf", i) for i in range(20)])
    return dsk


def _chain(n):
    dsk = {"k0": 0}
    for i in range(1, n):
        dsk[f"k{i}"] = (operator.add, f"k{i-1}", 1)
    return dsk


def _dask_case(rt, case):
    dask = _mod(rt, "util.dask")
    if case == "executes_graph":
        return [dask.ray_dask_get(_graph(), "d"), dask.ray_dask_get(_graph(), ["d", "b"])]
    if case == "nested_key_lists":
        return dask.ray_dask_get(_graph(), [["d"], ["b", "a"]])
    if case == "sync_scheduler":
        return dask.ray_dask_get_sync(_graph(), ["d", ("c", 0)])
    if case == "persist_refs":
        refs = dask.ray_dask_get(_graph(), ["d", "b"], ray_persist=True)
        return [type(r).__name__ for r in refs] + [rt.get(refs)]
    if case == "nested_args_and_dicts":
        dsk = {"x": 10, "y": (dict, [["k", "x"]]), "z": (operator.getitem, "y", "k"),
               "w": (lambda d: sorted(d.items()), {"p": "x", "q": [1, "z"]})}
        return [dask.ray_dask_get(dsk, "z"), dask.ray_dask_get(dsk, "w")]
    if case == "wide_fan_out":
        return dask.ray_dask_get(_wide(), "total")
    if case == "cycle_detection":
        out = []
        for get in (dask.ray_dask_get_sync, dask.ray_dask_get):
            try:
                get({"a": (operator.add, "b", 1), "b": (operator.add, "a", 1)}, "a")
            except ValueError as exc:
                out.append(_error(exc))
        return out
    if case == "deep_chain":
        return dask.ray_dask_get_sync(_chain(3000), "k2999")
    if case == "enable_hook_gated":
        out = []
        for fn in (dask.enable_dask_on_ray, dask.disable_dask_on_ray):
            try:
                fn()
                out.append("dask installed")
            except ImportError as exc:
                out.append(str(exc))
        return out
    raise ValueError(case)


_DASK_EXPECTED = {
    "executes_graph": [8, [8, 3]],
    "nested_key_lists": [[8], [3, 1]],
    "sync_scheduler": [8, 4],
    "persist_refs": ["ObjectRef", "ObjectRef", [8, 3]],
    "nested_args_and_dicts": [10, [("p", 10), ("q", [1, 10])]],
    "wide_fan_out": 2 * sum(range(20)),
    "deep_chain": 2999,
}


@pytest.mark.parametrize("case", [
    "executes_graph", "nested_key_lists", "sync_scheduler", "persist_refs",
    "nested_args_and_dicts", "wide_fan_out", "cycle_detection", "deep_chain",
    "enable_hook_gated",
])
def test_dask_scheduler_matches_jax(case):
    out = _run_both(_dask_case, case, init={"num_cpus": 4})
    if case in _DASK_EXPECTED:
        assert out == _norm(_DASK_EXPECTED[case])
    if case == "cycle_detection":
        assert [e["type"] for e in out] == ["ValueError", "ValueError"]


# --------------------------------------------------------------------------
# util.metrics: user families in the shared registry, byte-equal text
# --------------------------------------------------------------------------
def scenario_user_metrics(rt, seed):
    metrics = _mod(rt, "util.metrics")
    registry = _mod(rt, "observability.metrics").global_registry()
    rng = np.random.default_rng(seed)
    prefix = f"app{seed}"
    c = metrics.Counter(f"{prefix}_requests_total", "requests", tag_keys=("route", "code"))
    c.set_default_tags({"route": "/"})
    g = metrics.Gauge(f"{prefix}_queue_depth")
    h = metrics.Histogram(f"{prefix}_latency_s", "latency", boundaries=[0.01, 0.1, 1.0],
                          tag_keys=("route",))
    for _ in range(40):
        c.inc(float(rng.integers(1, 3)), tags={"code": str(rng.choice(["200", "503"]))})
        g.set(float(rng.integers(0, 50)))
        h.observe(float(rng.lognormal(-3, 1.5)), tags={"route": str(rng.choice(["/a", "/b"]))})
    out = {"info": [c.info, g.info, h.info], "errors": []}
    for bad in (lambda: c.inc(0), lambda: c.inc(1, tags={"rout": "x"}),
                lambda: h.observe(1.0, tags={"code": "1"})):
        try:
            bad()
        except ValueError as exc:
            out["errors"].append(str(exc))
    text = registry.render_prometheus()
    out["text"] = "\n".join(line for line in text.splitlines() if prefix in line)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_util_metrics_exposition_is_byte_equal(seed):
    jout = scenario_user_metrics(importlib.import_module("ray_tpu"), seed)
    tout = scenario_user_metrics(importlib.import_module("ray_tpu_torch"), seed)
    assert tout["text"].encode() == jout["text"].encode()
    assert tout["info"] == jout["info"] and tout["errors"] == jout["errors"]
    assert f"app{seed}_queue_depth" in tout["text"] and len(tout["errors"]) == 3


# --------------------------------------------------------------------------
# placement groups through util (test_cluster.py::test_util_placement_group_api)
# --------------------------------------------------------------------------
def scenario_placement_group_api(rt):
    util = _mod(rt, "util")
    pg = util.placement_group([{"CPU": 1}], strategy="PACK", name="mygang")
    out = {"wait": pg.wait(5), "ready": rt.get(pg.ready())}
    table = util.placement_group_table(pg)
    out["table"] = {k: table[k] for k in ("state", "name", "strategy", "bundles")}
    out["placed_bundles"] = sorted(table["bundle_placements"])
    out["all_tables"] = len(util.placement_group_table())

    def inside():
        return "in-pg"

    strat = util.PlacementGroupSchedulingStrategy(pg, placement_group_bundle_index=0)
    out["inside"] = rt.get(rt.remote(inside).options(num_cpus=1, scheduling_strategy=strat)
                           .remote(), timeout=30)
    util.remove_placement_group(pg)
    out["after_remove"] = util.placement_group_table(pg)["state"]
    out["errors"] = []
    for kw in ({"bundles": []}, {"bundles": [{"CPU": 1}], "strategy": "NOT_A_STRATEGY"},
               {"bundles": [{"CPU": 1}], "lifetime": "bogus"}):
        try:
            util.placement_group(**kw)
        except ValueError as exc:
            out["errors"].append(str(exc))
    # a group bigger than the node waits PENDING, then is placed when a
    # node with room joins
    big = util.placement_group([{"CPU": 2}, {"CPU": 2}], strategy="STRICT_SPREAD")
    out["big_before"] = (big.wait(0.2), util.placement_group_table(big)["state"])
    rt.get_cluster().add_node({"CPU": 2})
    out["big_after"] = (big.wait(10), util.placement_group_table(big)["state"])
    util.remove_placement_group(big)
    return out


def test_util_placement_group_api_matches_jax():
    out = _run_both(scenario_placement_group_api, init={"num_cpus": 2})
    assert out["wait"] and out["ready"] is True and out["inside"] == "in-pg"
    assert out["table"]["state"] == "CREATED" and out["after_remove"] == "REMOVED"
    assert out["big_before"] == (False, "PENDING") and out["big_after"] == (True, "CREATED")


def scenario_bundle_demands(rt):
    """Actors under a group that reserves all of a node's ``accel``: in the
    port each takes its bundle's share; in the JAX package the demand goes
    to the node's free pool, which the group emptied, so the actors wait."""
    util = _mod(rt, "util")

    class Probe:
        def ping(self):
            return "placed"

    pg = util.placement_group([{"accel": 1, "CPU": 1}] * 2, strategy="STRICT_PACK")
    out = {"placed": pg.wait(10), "free_accel": rt.available_resources().get("accel", 0)}
    actors = [rt.remote(Probe).options(
        num_cpus=1, resources={"accel": 1}, execution="inproc",
        scheduling_strategy=util.PlacementGroupSchedulingStrategy(pg, i)).remote()
        for i in range(2)]
    refs = [a.ping.remote() for a in actors]
    ready, _ = rt.wait(refs, num_returns=2, timeout=3)
    out["ready"] = len(ready)
    for a in actors:
        rt.kill(a)
    util.remove_placement_group(pg)
    out["after_remove"] = rt.available_resources().get("accel", 0)
    return out


def test_actors_take_their_bundles_share_in_the_port_only():
    """ROADMAP F7: the port charges a task or actor under a
    ``PlacementGroupSchedulingStrategy`` to its bundle (as Ray does); the
    JAX package charges the node's free pool."""
    outs = {}
    for name in PACKAGES:
        rt = importlib.import_module(name)
        rt.init(num_cpus=4, resources={"accel": 2})
        try:
            outs[name] = scenario_bundle_demands(rt)
        finally:
            rt.shutdown()
    assert outs["ray_tpu"] == {"placed": True, "free_accel": 0, "ready": 0, "after_remove": 2}
    assert outs["ray_tpu_torch"] == {"placed": True, "free_accel": 0, "ready": 2,
                                     "after_remove": 2}


def test_bundle_demand_names_are_the_committed_bundle_names():
    from ray_tpu_torch.core.ids import JobID, PlacementGroupID
    from ray_tpu_torch.core.resources import ResourceSet
    from ray_tpu_torch.runtime import placement
    from ray_tpu_torch.runtime.scheduler import (
        NodeAffinitySchedulingStrategy,
        PlacementGroupSchedulingStrategy,
    )

    info = placement.PlacementGroupInfo(PlacementGroupID.of(JobID.from_int(1)),
                                        [ResourceSet({"GPU": 0.5, "CPU": 1})] * 2,
                                        placement.PlacementStrategy.PACK)
    committed = set(placement.PlacementGroupManager._bundle_resources(None, info, 1).to_dict())
    one = placement.bundle_demands({"GPU": 0.5, "CPU": 1, "TPU": 0},
                                   PlacementGroupSchedulingStrategy(info, 1))
    assert set(one) < committed and len(one) == 2 and all("_group_1_" in k for k in one)
    anyb = placement.bundle_demands(None, PlacementGroupSchedulingStrategy(info))
    assert list(anyb) == [f"CPU_group_{info.pg_id.hex()[:12]}"] and set(anyb) < committed
    demands = {"CPU": 2}
    assert placement.bundle_demands(demands, None) is demands
    assert placement.bundle_demands(demands, NodeAffinitySchedulingStrategy("n")) is demands


# --------------------------------------------------------------------------
# ActorPool, Queue, inspect_serializability (test_util_workflow.py)
# --------------------------------------------------------------------------
def scenario_actor_pool(rt):
    util = _mod(rt, "util")

    class Doubler:
        def double(self, x):
            return x * 2

    class Sleeper:
        def go(self, t):
            time.sleep(t)
            return t

    pool = util.ActorPool([rt.remote(Doubler).remote() for _ in range(2)])
    out = {"map": list(pool.map(lambda a, v: a.double.remote(v), range(8)))}
    slow = util.ActorPool([rt.remote(Sleeper).remote() for _ in range(2)])
    out["unordered"] = list(slow.map_unordered(lambda a, v: a.go.remote(v), [0.3, 0.01]))
    # the hand-driven API: submit past the pool's size queues, get_next in order
    for v in range(3):
        pool.submit(lambda a, x: a.double.remote(x), v)
    out["free_while_busy"] = pool.has_free()
    out["next"] = [pool.get_next(timeout=30) for _ in range(3)]
    out["has_next"] = pool.has_next()
    try:
        pool.get_next()
    except StopIteration as exc:
        out["exhausted"] = str(exc)
    idle = pool.pop_idle()
    out["after_pop"] = pool.has_free()
    pool.push(idle)
    # (a fresh pool: after map_unordered the ordered cursor no longer lines
    # up with the submissions, in both packages)
    late = util.ActorPool([rt.remote(Sleeper).remote()])
    late.submit(lambda a, t: a.go.remote(t), 1.0)
    try:
        late.get_next(timeout=0.05)
    except TimeoutError as exc:
        out["timeout"] = str(exc)
    out["still_pending"] = late.has_next()
    out["after_timeout"] = late.get_next(timeout=30)
    return out


def scenario_queue(rt):
    util = _mod(rt, "util")
    q = util.Queue(maxsize=2)
    q.put(1)
    q.put(2)
    out = {"size": q.qsize(), "full": q.full()}
    for call in (lambda: q.put(3, block=False), lambda: q.put(3, timeout=0.05)):
        try:
            call()
        except util.Full as exc:
            out.setdefault("raised", []).append(type(exc).__name__)
    out["got"] = [q.get(), q.get_nowait()]
    out["empty"] = q.empty()
    for call in (lambda: q.get(block=False), lambda: q.get(timeout=0.05)):
        try:
            call()
        except util.Empty as exc:
            out["raised"].append(type(exc).__name__)
    q.shutdown()

    # across a thread task: the task puts, the driver gets
    q2 = util.Queue()

    def producer(qq):
        for i in range(5):
            qq.put(i)
        return True

    out["producer"] = rt.get(rt.remote(producer).options(execution="thread").remote(q2))
    out["cross"] = [q2.get(timeout=5) for _ in range(5)]
    q2.put_nowait(np.arange(4))
    out["array"] = q2.get().tolist()
    q2.shutdown()
    return out


def scenario_inspect_serializability(rt):
    util = _mod(rt, "util")
    lock = threading.Lock()

    def closes_over_lock():
        return lock

    out = {"lambda": util.inspect_serializability(lambda x: x + 1)}
    ok, problems = util.inspect_serializability(lock, name="lock")
    out["lock"] = (ok, sorted(problems))
    ok, problems = util.inspect_serializability(closes_over_lock, name="fn")
    out["closure"] = (ok, sorted(p.split(":")[0] for p in problems))
    return out


@pytest.mark.parametrize("scenario", [
    scenario_actor_pool, scenario_queue, scenario_inspect_serializability,
], ids=lambda f: f.__name__.removeprefix("scenario_"))
def test_actor_pool_queue_and_serializability_match_jax(scenario):
    _run_both(scenario, init={"num_cpus": 8})


def test_actor_pool_and_queue_outputs_are_what_a_user_expects():
    rt = importlib.import_module("ray_tpu_torch")
    rt.init(num_cpus=8)
    try:
        out = scenario_actor_pool(rt)
        assert out["map"] == [i * 2 for i in range(8)] and out["unordered"] == [0.01, 0.3]
        assert out["next"] == [0, 2, 4] and out["timeout"] == "timed out waiting for result"
        out = scenario_queue(rt)
        assert out["got"] == [1, 2] and out["cross"] == [0, 1, 2, 3, 4]
        assert out["raised"] == ["Full", "Full", "Empty", "Empty"]
        out = scenario_inspect_serializability(rt)
        assert out["lambda"] == (True, set()) and out["lock"][0] is False
        assert out["closure"] == (False, ["fn", "fn.<closure>.lock"])
    finally:
        rt.shutdown()


# --------------------------------------------------------------------------
# the package surface
# --------------------------------------------------------------------------
def test_util_exports_the_jax_names_and_raises_for_what_is_not_ported():
    jutil = importlib.import_module("ray_tpu.util")
    tutil = importlib.import_module("ray_tpu_torch.util")
    exc = importlib.import_module("ray_tpu_torch.exceptions")
    # the JAX package's names, less the two that wait for later slices
    assert sorted(set(jutil.__all__) - {"collective"}) == sorted(tutil.__all__)
    for name in tutil.__all__:
        assert hasattr(tutil, name)
    with pytest.raises(exc.NotPortedError, match="ray_tpu/util/client/worker.py"):
        tutil.connect("ray://localhost:1")
    with pytest.raises(exc.NotPortedError, match="ray_tpu/util/collective.py"):
        tutil.collective  # noqa: B018
    tutil.disconnect()  # nothing connected: a no-op, as in the JAX package
    for name in ("internal_kv", "tqdm_ray"):
        assert hasattr(importlib.import_module("ray_tpu_torch.experimental"), name)
