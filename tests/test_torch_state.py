"""The port's state API (``ray_tpu_torch.state``) against the JAX package's,
case by case of ``tests/test_state_api_tail.py``, over one runtime of each
package (``init(num_cpus=2)``).

Each scenario drives the same tasks, actors and objects in each package and
returns what the listings, summaries, ``get_*`` accessors and
``StateApiClient`` give: row keys compared key for key, values where they
are not ids, pids or times.  One key is the port's own: an actor's row
carries ``resources`` (its demands, a GPU share on the card), which the JAX
package's rows lack; ``test_actor_rows_carry_their_resources_in_the_port``
holds both.
"""

import importlib
import os

import numpy as np
import pytest
from torch_runtime_tasks import Counter, _inc

torch = pytest.importorskip("torch")

PACKAGES = ("ray_tpu", "ray_tpu_torch")
PORT_ACTOR_KEYS = {"resources"}


def _keys(rows, drop=()):
    return sorted({k for r in rows for k in r} - set(drop))


def sc_get_accessors_and_client(rt, state):
    a = rt.remote(Counter).options(execution="process").remote(1)
    assert rt.get(a.add.remote(2)) == 3
    assert rt.get([rt.remote(_inc).remote(i) for i in range(3)]) == [1, 2, 3]
    ref = rt.put(np.zeros(1000))
    _settled(state)
    nodes = state.list_nodes()
    actor_row = next(r for r in state.list_actors() if r["class_name"] == "Counter")
    task_row = next(t for t in state.list_tasks() if t["name"].endswith("_inc"))
    objs = state.get_objects(ref.hex())
    client = state.StateApiClient()
    try:
        client.list("gremlins")
        unknown = None
    except ValueError as exc:
        unknown = str(exc)
    out = {
        "node_keys": _keys(nodes),
        "node_state": [n["state"] for n in nodes],
        "node_is_head": [n["is_head"] for n in nodes],
        "node_cpu": [n["resources_total"]["CPU"] for n in nodes],
        "get_node": state.get_node(nodes[0]["node_id"])["node_id"] == nodes[0]["node_id"],
        "actor_keys": _keys([actor_row], PORT_ACTOR_KEYS),
        "actor": {k: actor_row[k] for k in ("class_name", "name", "state", "restarts",
                                            "max_restarts", "death_cause")},
        "get_actor": state.get_actor(actor_row["actor_id"])["class_name"],
        "get_actor_prefix": state.get_actor(actor_row["actor_id"][:8]) is not None,
        "task_keys": _keys([task_row]),
        "task_states": sorted(t["state"] for t in state.list_tasks() if t["name"].endswith("_inc")),
        "get_task": state.get_task(task_row["task_id"]) is not None,
        "obj_keys": _keys(objs),
        "obj": [(o["size_bytes"] > 0, o["is_error"]) for o in objs],
        "client_nodes": len(client.list("nodes")) == len(nodes),
        "client_actor": client.get("actors", actor_row["actor_id"])["class_name"],
        "client_unknown": unknown,
        "client_get_unknown": type(_raises(lambda: client.get("gremlins", "x"))).__name__,
    }
    rt.kill(a)
    return out


def _settled(state, timeout_s=10.0):
    """Wait until no task is listed pending: a ``get`` returns once the
    value is stored, a moment before the task manager retires the task."""
    import time

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and any(
            t["state"].startswith("PENDING") for t in state.list_tasks()):
        time.sleep(0.02)


def _raises(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001
        return exc
    return None


def sc_list_workers_and_events(rt, state):
    assert rt.get(rt.remote(_inc).options(execution="process").remote(41)) == 42
    workers = state.list_workers()
    alive = state.list_workers(filters=[("is_alive", "=", "True")])
    events = state.list_cluster_events()
    jobs = state.list_jobs()
    return {
        "worker_keys": _keys(workers),
        "workers_have_node": bool(workers) and all(w["node_id"] for w in workers),
        "get_worker": state.get_worker(workers[0]["worker_id"])["pid"] == workers[0]["pid"],
        "alive_filtered": all(w["is_alive"] for w in alive),
        "event_keys_ok": all({"severity", "message"} <= set(e) for e in events[:3]),
        "logs": (state.list_logs(), state.list_logs("nope"), state.get_log("nope")),
        "job_keys": _keys(jobs),
        "job_status": [j["status"] for j in jobs],
        "job_entrypoint": [j["entrypoint"] for j in jobs],
        "get_job": state.get_job(jobs[0]["job_id"]) is not None if jobs else None,
        "bad_filter": type(_raises(lambda: state.list_workers(filters=[("pid", ">", 1)]))).__name__,
    }


def sc_summaries_and_groups(rt, state):
    refs = [rt.remote(_inc).remote(i) for i in range(4)]
    rt.get(refs)
    _settled(state)
    big = rt.put(np.ones(300_000))
    pg_mod = importlib.import_module(rt.__name__ + ".util")
    pg = pg_mod.placement_group([{"CPU": 1}], strategy="PACK")
    rt.get(pg.ready(), timeout=60)
    tasks = state.summarize_tasks()
    objs = state.summarize_objects()
    pgs = state.list_placement_groups()
    out = {
        "inc_counts": tasks["summary"]["_inc"]["state_counts"],
        "task_summary_keys": sorted(tasks),
        "actor_summary_keys": sorted(state.summarize_actors()),
        "object_summary_keys": sorted(objs),
        "object_tiers": sorted(objs["summary"]),
        "pg_keys": _keys(pgs),
        "pg": [(p["state"], p["strategy"], p["bundles"]) for p in pgs],
        "get_pg": state.get_placement_group(pgs[0]["placement_group_id"])["state"],
        "runtime_envs": state.list_runtime_envs(),
        "limit": len(state.list_tasks(limit=2)),
    }
    pg_mod.remove_placement_group(pg)
    del big
    return out


def sc_util_metrics_default_tags(rt, state):
    # names of its own: the registry is the process's, and the JAX test of
    # these families may run in this process before or after
    metrics = importlib.import_module(rt.__name__ + ".util.metrics")
    registry = importlib.import_module(rt.__name__ + ".observability.metrics").global_registry()
    c = metrics.Counter("parity_app_requests_total", "requests").set_default_tags({"deployment": "d1"})
    c.inc()
    c.inc(2.0, tags={"deployment": "d2"})
    by_tag = {frozenset(k): v
              for k, v in dict(registry.counter("parity_app_requests_total").series()).items()}
    g = metrics.Gauge("parity_app_inflight").set_default_tags({"app": "x"})
    g.set(3.0)
    gseries = {frozenset(k): v for k, v in registry.gauge("parity_app_inflight").series()}
    h = metrics.Histogram("parity_app_latency_s", boundaries=[0.1, 1.0],
                          tag_keys=("route",)).set_default_tags({"route": "/a"})
    h.observe(0.05)
    return {"d1": by_tag[frozenset({("deployment", "d1")})],
            "d2": by_tag[frozenset({("deployment", "d2")})],
            "gauge": gseries[frozenset({("app", "x")})],
            "typo": str(_raises(lambda: h.observe(0.05, tags={"rouet": "/a"}))),
            "zero": str(_raises(lambda: c.inc(0))),
            "info": (c.info["default_tags"], h.info["tag_keys"])}


def sc_job_models_roundtrip(rt, state):
    js = importlib.import_module(rt.__name__ + ".job_submission")
    d = {"submission_id": "raysubmit_abc", "entrypoint": "python x.py", "status": "SUCCEEDED",
         "message": "ok", "metadata": {"k": "v"}, "start_time": 1.0, "end_time": 2.0}
    info = js.JobInfo.from_dict(d)
    details = js.JobDetails.from_dict(dict(d, driver_info={"id": "d1", "pid": 7}))
    return {"status": info.status.value, "metadata": info.metadata,
            "type": details.type.value, "job_id": details.job_id,
            "driver_pid": details.driver_info.pid, "types": [t.value for t in js.JobType],
            "statuses": [s.value for s in js.JobStatus]}


SCENARIOS = [fn for n, fn in sorted(globals().items()) if n.startswith("sc_")]


@pytest.fixture(scope="module")
def runs():
    """Each package's scenarios over one runtime, with a runtime-env cache
    of their own: the cache is the process's, and a file run before this
    one in the same process (``test_torch_runtime_env.py``) leaves entries
    staged under each package's own root, which ``list_runtime_envs``
    would report."""
    out = {name: {} for name in PACKAGES}
    for name in PACKAGES:
        rt = importlib.import_module(name)
        state = importlib.import_module(name + ".state")
        plugin = importlib.import_module(name + ".runtime_env.plugin")
        uri_cache = importlib.import_module(name + ".runtime_env.uri_cache")
        kept, plugin._cache = plugin._cache, uri_cache.URICache()
        rt.init(num_cpus=2)
        try:
            for fn in SCENARIOS:
                try:
                    out[name][fn.__name__[3:]] = fn(rt, state)
                except Exception as exc:  # noqa: BLE001 - reported by the test
                    out[name][fn.__name__[3:]] = ("raised", repr(exc))
        finally:
            rt.shutdown()
            plugin._cache = kept
    return out


EXPECT = {
    "get_accessors_and_client": lambda o: (
        o["get_node"] and o["get_actor"] == "Counter" and o["get_actor_prefix"]
        and o["get_task"] and o["obj"] == [(True, False)] and o["client_nodes"]
        and o["client_actor"] == "Counter" and "unknown resource" in o["client_unknown"]
        and o["task_states"] == ["FINISHED"] * 3),
    "list_workers_and_events": lambda o: (
        o["workers_have_node"] and o["get_worker"] and o["alive_filtered"]
        and o["event_keys_ok"] and o["logs"] == ({}, {}, []) and o["get_job"]
        and o["bad_filter"] == "ValueError"),
    "summaries_and_groups": lambda o: (
        # _inc ran 3, 1 and 4 times in this scenario and the two before it
        o["inc_counts"] == {"FINISHED": 8} and o["get_pg"] == "CREATED" and o["limit"] == 2),
    "util_metrics_default_tags": lambda o: (
        o["d1"] == 1.0 and o["d2"] == 2.0 and o["gauge"] == 3.0 and "unknown tag" in o["typo"]
        and "value > 0" in o["zero"]),
    "job_models_roundtrip": lambda o: (
        o["status"] == "SUCCEEDED" and o["type"] == "SUBMISSION"
        and o["job_id"] == "raysubmit_abc" and o["driver_pid"] == 7),
}


def test_every_scenario_is_checked():
    assert {fn.__name__[3:] for fn in SCENARIOS} == set(EXPECT)


@pytest.mark.parametrize("key", sorted(EXPECT))
def test_state_scenario_matches_jax(runs, key):
    j, p = runs["ray_tpu"][key], runs["ray_tpu_torch"][key]
    assert not (isinstance(p, tuple) and p[:1] == ("raised",)), p
    assert not (isinstance(j, tuple) and j[:1] == ("raised",)), j
    assert p == j
    assert EXPECT[key](p), p


@pytest.mark.parametrize("module", ["state", "job", "job_submission", "air", "workflow",
                                    "dashboard", "usage"])
def test_library_exports_match_jax(module):
    j = importlib.import_module("ray_tpu." + module)
    p = importlib.import_module("ray_tpu_torch." + module)
    assert sorted(p.__all__) == sorted(j.__all__)
    for n in j.__all__:
        assert hasattr(p, n), n


def test_version_matches_jax():
    import ray_tpu
    import ray_tpu_torch
    from ray_tpu_torch._version import version

    assert ray_tpu_torch.__version__ == version == ray_tpu.__version__
    assert "__version__" in ray_tpu_torch.__all__


def test_actor_rows_carry_their_resources_in_the_port():
    """The port's actor rows name the demands an actor holds (a GPU share
    shows there); the JAX package's rows have no such key."""
    import ray_tpu as jrt
    import ray_tpu_torch as rt
    from ray_tpu import state as jstate
    from ray_tpu_torch import state as pstate

    jrt.init(num_cpus=2)
    try:
        a = jrt.remote(Counter).options(execution="inproc").remote(0)
        jrt.get(a.add.remote(1))
        jrow = next(r for r in jstate.list_actors() if r["class_name"] == "Counter")
    finally:
        jrt.shutdown()
    rt.init(num_cpus=2, num_gpus=1)
    try:
        a = rt.remote(Counter).options(num_gpus=0.5).remote(0)
        rt.get(a.add.remote(1))
        prow = next(r for r in pstate.list_actors() if r["class_name"] == "Counter")
        assert pstate.get_actor(prow["actor_id"])["resources"] == prow["resources"]
    finally:
        rt.shutdown()
    assert "resources" not in jrow
    assert set(prow) - set(jrow) == PORT_ACTOR_KEYS
    assert prow["resources"]["GPU"] == 0.5 and prow["state"] == "ALIVE"
