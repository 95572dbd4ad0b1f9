"""The port's dashboard head and job submission (``ray_tpu_torch.dashboard``,
``ray_tpu_torch.job``) against the JAX package's, case by case of
``tests/test_dashboard_jobs.py`` less its two CLI cases (``rt status`` and
``rt job`` wait for the port's CLI).

Each package runs every scenario once under one runtime of its own
(``init(num_cpus=2, include_dashboard=True)``): a job subprocess imports its
package, so the subprocess-heavy scenarios run once a package, not once a
case.  REST payloads are compared key for key (nested row keys too), and
value for value where a value is not an id, a pid, a path or a time.  A
job's ``PYTHONPATH`` starts with the root of the package that submitted it
(on purpose: the port's driver imports ``ray_tpu_torch``);
``test_job_pythonpath_names_each_package_root`` holds both.
"""

import importlib
import json
import os
import sys
import time
import urllib.error
import urllib.request

import pytest
from torch_runtime_tasks import _inc

torch = pytest.importorskip("torch")

PACKAGES = ("ray_tpu", "ray_tpu_torch")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: every GET route of the head whose payload is a JSON object
ROUTES = ("/api/version", "/api/healthz", "/api/nodes", "/api/actors", "/api/tasks",
          "/api/objects", "/api/placement_groups", "/api/cluster_status", "/api/transfers",
          "/api/pulls", "/api/leases", "/api/autoscaler", "/api/plans", "/api/train",
          "/api/memory", "/api/data/datasets", "/api/metrics_history",
          "/api/metrics/cluster_history", "/api/events", "/api/summary/tasks",
          "/api/summary/actors", "/api/summary/objects", "/api/serve/applications",
          "/api/jobs", "/api/logs/search?q=zzz")


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _shape(v, depth=0):
    """Keys of a payload, nested: a dict's keys with their values' shapes,
    a list of dicts as the union of its rows' shapes."""
    if depth > 3:
        return None
    if isinstance(v, dict):
        # a resource dict's names are values: the port's node always names
        # its GPU count (0 without a card), the JAX package's has no GPU
        return {k: None if k.startswith("resources") else _shape(x, depth + 1)
                for k, x in sorted(v.items()) if not (depth and _looks_like_id(k))}
    if isinstance(v, list) and v and all(isinstance(x, dict) for x in v):
        rows = {}
        for x in v:
            rows.update(_shape(x, depth + 1))
        return [rows]
    return None


def _looks_like_id(k):
    return len(k) >= 16 and all(c in "0123456789abcdef" for c in k)


def _wait_job(client, sid, timeout=120):
    return client.wait_until_finished(sid, timeout=timeout)


# --------------------------------------------------------------------------
# scenarios: (rt, package name, cluster, client, tmp) -> comparable output
# --------------------------------------------------------------------------
def sc_state_routes(rt, name, cluster, client, tmp):
    url = cluster.dashboard.url
    rt.get([rt.remote(_inc).remote(i) for i in range(3)])
    status = _get(url + "/api/cluster_status")
    tasks = _get(url + "/api/tasks")["tasks"]
    summary = _get(url + "/api/summary/tasks")
    timeline = _get(url + "/api/timeline")
    return {"healthz": _get(url + "/api/healthz"), "version": _get(url + "/api/version")["version"],
            "nodes": len(_get(url + "/api/nodes")["nodes"]), "num_nodes": status["num_nodes"],
            "cpu": status["resources_total"]["CPU"],
            "inc_tasks": sum(1 for t in tasks if t["name"].endswith("_inc")),
            "inc_finished": summary["summary"]["_inc"]["state_counts"]["FINISHED"],
            "timeline_x": bool(timeline) and all(ev["ph"] == "X" for ev in timeline)}


def sc_route_payload_keys(rt, name, cluster, client, tmp):
    url = cluster.dashboard.url
    a = rt.remote(importlib.import_module("torch_runtime_tasks").Counter).remote(0)
    rt.get(a.add.remote(1))
    time.sleep(2.2)  # one sample of the head's 2 s sampler
    out = {r: _shape(_get(url + r)) for r in ROUTES}
    rt.kill(a)
    return out


def sc_metrics_and_404(rt, name, cluster, client, tmp):
    url = cluster.dashboard.url
    rt.get(rt.remote(_inc).remote(1))
    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        text = r.read().decode()
        ctype = r.headers.get("Content-Type")
    codes = []
    for path, data in (("/api/nope", None), ("/api/jobs/nope", None),
                       ("/api/jobs/nope/logs", None), ("/api/nope", b"{}"),
                       ("/api/jobs/", b"{}"), ("/api/workflows/events/", b"{}")):
        try:
            urllib.request.urlopen(urllib.request.Request(url + path, data=data), timeout=30)
            codes.append(200)
        except urllib.error.HTTPError as exc:
            codes.append((exc.code, sorted(json.loads(exc.read()))))
    return {"terminal_total": "ray_tpu_tasks_terminal_total" in text, "ctype": ctype,
            "codes": codes}


def sc_ui_index(rt, name, cluster, client, tmp):
    with urllib.request.urlopen(cluster.dashboard.url + "/", timeout=30) as resp:
        body = resp.read().decode()
        ctype = resp.headers.get("Content-Type", "")
    return {"html": "text/html" in ctype, "names_package": "ray_tpu" in body,
            "polls": [r for r in ROUTES if r.split("?")[0] in body]}


def sc_job_success_and_logs(rt, name, cluster, client, tmp):
    sid = client.submit_job(entrypoint=f"{sys.executable} -c \"print('job ran ok')\"",
                            metadata={"k": "v"})
    info = _wait_job(client, sid, 60)
    listed = [j for j in client.list_jobs() if j["submission_id"] == sid]
    return {"info_keys": sorted(info), "status": info["status"], "message": info["message"],
            "metadata": info["metadata"], "logs": client.get_job_logs(sid),
            "listed_keys": [sorted(j) for j in listed], "status_call": client.get_job_status(sid),
            "ended": info["end_time"] >= info["start_time"], "prefix": sid.split("_")[0]}


def sc_job_failure(rt, name, cluster, client, tmp):
    sid = client.submit_job(entrypoint=f"{sys.executable} -c 'raise SystemExit(3)'")
    info = _wait_job(client, sid, 60)
    return {"status": info["status"], "message": info["message"]}


def sc_job_stop(rt, name, cluster, client, tmp):
    sid = client.submit_job(entrypoint=f"{sys.executable} -c 'import time; time.sleep(60)'")
    stopped = client.stop_job(sid)
    info = _wait_job(client, sid, 30)
    return {"stopped": stopped, "status": info["status"], "message": info["message"],
            "again": client.stop_job(sid), "unknown": client.stop_job("rtjob_missing")}


def sc_job_env_vars_and_driver_uses_framework(rt, name, cluster, client, tmp):
    script = os.path.join(tmp, "driver.py")
    with open(script, "w") as f:
        f.write(
            "import os\n"
            f"import {name} as rt\n"
            "from torch_runtime_tasks import _env_a\n"
            "rt.init(num_cpus=1)\n"
            "print('flag=' + str(rt.get(rt.remote(_env_a).remote())))\n"
            "print('submission=' + os.environ['RAY_TPU_SUBMISSION_ID'])\n"
            "rt.shutdown()\n")
    sid = client.submit_job(
        entrypoint=f"{sys.executable} {script}",
        runtime_env={"env_vars": {"MY_FLAG": "hello-env",
                                  "PYTHONPATH": os.pathsep.join([REPO, os.path.join(REPO, "tests")])}})
    info = _wait_job(client, sid, 120)
    logs = client.get_job_logs(sid)
    return {"status": info["status"], "flag": "flag=hello-env" in logs,
            "submission": f"submission={sid}" in logs}


def sc_job_working_dir(rt, name, cluster, client, tmp):
    workdir = os.path.join(tmp, "app")
    os.makedirs(workdir)
    with open(os.path.join(workdir, "data.txt"), "w") as f:
        f.write("payload42")
    sid = client.submit_job(entrypoint=f"{sys.executable} -c \"print(open('data.txt').read())\"",
                            runtime_env={"working_dir": workdir})
    info = _wait_job(client, sid, 60)
    return {"status": info["status"], "logs": client.get_job_logs(sid).strip()}


def sc_job_bad_runtime_env_fails_not_pending(rt, name, cluster, client, tmp):
    mgr = cluster.dashboard.job_manager
    sid = mgr.submit_job("echo hi", runtime_env={"working_dir": "/nonexistent-xyz"})
    info = mgr.get_job(sid)
    return {"status": info["status"], "runtime_env": "runtime_env" in info["message"],
            "logs": mgr.get_logs(sid)}


def sc_stop_pending_job_prevents_launch(rt, name, cluster, client, tmp):
    manager = importlib.import_module(name + ".job.manager")
    mgr = cluster.dashboard.job_manager
    sid = "rtjob_pending_stop"
    with mgr._lock:
        mgr._jobs[sid] = manager._JobEntry(sid, "echo never", None)
    ok = mgr.stop_job(sid)
    info = mgr.get_job(sid)
    return {"ok": ok, "status": info["status"], "ended": info["end_time"] is not None,
            "waited": mgr.wait_job(sid, timeout=1)["status"]}


def sc_job_duplicate_id_and_missing_entrypoint(rt, name, cluster, client, tmp):
    sid = client.submit_job(entrypoint="true", submission_id="rtjob_dup")
    _wait_job(client, sid, 30)
    out = []
    for body in ({"entrypoint": "true", "submission_id": "rtjob_dup"}, {}):
        try:
            client._request("POST", "/api/jobs/", body)
            out.append(None)
        except RuntimeError as exc:
            out.append(str(exc).split(":")[0])
    return out


SCENARIOS = [fn for n, fn in sorted(globals().items()) if n.startswith("sc_")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {name: {} for name in PACKAGES}
    for name in PACKAGES:
        rt = importlib.import_module(name)
        sdk = importlib.import_module(name + ".job.sdk")
        rt.init(num_cpus=2, include_dashboard=True)
        try:
            cluster = rt.get_cluster()
            client = sdk.JobSubmissionClient(cluster.dashboard.url)
            for fn in SCENARIOS:
                tmp = str(tmp_path_factory.mktemp(f"{name}_{fn.__name__}"))
                try:
                    out[name][fn.__name__[3:]] = fn(rt, name, cluster, client, tmp)
                except Exception as exc:  # noqa: BLE001 - reported by the test
                    out[name][fn.__name__[3:]] = ("raised", repr(exc))
        finally:
            rt.shutdown()
    return out


EXPECT = {
    # _inc ran once in metrics_and_404 (before it) and three times here
    "state_routes": lambda o: o == {
        "healthz": {"status": "ok"}, "version": "0.1.0", "nodes": 1, "num_nodes": 1, "cpu": 2,
        "inc_tasks": 4, "inc_finished": 4, "timeline_x": True},
    "route_payload_keys": lambda o: all(isinstance(o[r], dict) for r in ROUTES),
    "metrics_and_404": lambda o: (
        o["terminal_total"] and o["codes"] == [(404, ["error"])] * 4 + [(400, ["error"])] * 2),
    "ui_index": lambda o: o["html"] and o["names_package"] and "/api/cluster_status" in o["polls"],
    "job_success_and_logs": lambda o: (
        o["status"] == o["status_call"] == "SUCCEEDED" and "job ran ok" in o["logs"]
        and o["message"] == "exit code 0" and o["listed_keys"] == [o["info_keys"]]
        and o["metadata"] == {"k": "v"} and o["ended"]),
    "job_failure": lambda o: o == {"status": "FAILED", "message": "exit code 3"},
    "job_stop": lambda o: o == {"stopped": True, "status": "STOPPED", "message": "stopped by user",
                                "again": True, "unknown": False},
    "job_env_vars_and_driver_uses_framework": lambda o: o == {
        "status": "SUCCEEDED", "flag": True, "submission": True},
    "job_working_dir": lambda o: o == {"status": "SUCCEEDED", "logs": "payload42"},
    "job_bad_runtime_env_fails_not_pending": lambda o: o == {
        "status": "FAILED", "runtime_env": True, "logs": None},
    "stop_pending_job_prevents_launch": lambda o: o == {
        "ok": True, "status": "STOPPED", "ended": True, "waited": "STOPPED"},
    "job_duplicate_id_and_missing_entrypoint": lambda o: o == [
        "POST /api/jobs/ -> 500", "POST /api/jobs/ -> 400"],
}


def test_every_scenario_is_checked():
    assert {fn.__name__[3:] for fn in SCENARIOS} == set(EXPECT)


@pytest.mark.parametrize("key", sorted(EXPECT))
def test_dashboard_scenario_matches_jax(runs, key):
    j, p = runs["ray_tpu"][key], runs["ray_tpu_torch"][key]
    assert not (isinstance(p, tuple) and p[:1] == ("raised",)), p
    assert not (isinstance(j, tuple) and j[:1] == ("raised",)), j
    if key == "route_payload_keys":
        # the one key the port adds to a row: an actor's resources
        p = dict(p, **{"/api/actors": {"actors": [
            {k: v for k, v in p["/api/actors"]["actors"][0].items() if k != "resources"}]}})
    assert p == j
    assert EXPECT[key](p), p


@pytest.mark.parametrize("route", ROUTES)
def test_route_payload_keys_match_jax(runs, route):
    """One case a route, so a payload that drifts names its route."""
    j = runs["ray_tpu"]["route_payload_keys"][route]
    p = runs["ray_tpu_torch"]["route_payload_keys"][route]
    if route == "/api/actors":
        assert set(p["actors"][0]) - set(j["actors"][0]) == {"resources"}
        p = {"actors": [{k: v for k, v in p["actors"][0].items() if k != "resources"}]}
    assert p == j


def test_job_pythonpath_names_each_package_root(tmp_path):
    """Each package's job driver finds its own package first on
    ``PYTHONPATH``, whatever the job's working directory."""
    seen = {}
    for name in PACKAGES:
        rt = importlib.import_module(name)
        manager = importlib.import_module(name + ".job.manager")
        rt.init(num_cpus=1)
        try:
            mgr = manager.JobManager(rt.get_cluster())
            code = (f"import os, {name}; "
                    "print(os.environ['PYTHONPATH'].split(os.pathsep)[0]); "
                    f"print(os.path.dirname(os.path.dirname({name}.__file__)))")
            sid = mgr.submit_job(f"cd {tmp_path} && {sys.executable} -c \"{code}\"")
            info = mgr.wait_job(sid, timeout=120)
            lines = mgr.get_logs(sid).split()
            mgr.shutdown()
        finally:
            rt.shutdown()
        assert info["status"] == "SUCCEEDED", lines
        seen[name] = lines
        pkg = importlib.import_module(name)
        assert lines[0] == lines[1] == os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
    assert os.path.isdir(os.path.join(seen["ray_tpu_torch"][0], "ray_tpu_torch"))


def test_shutdown_leaves_no_job_process_in_the_port(tmp_path):
    """The port's ``shutdown`` waits for the job groups it signals (the JAX
    package's sends SIGTERM and returns): none of a job's processes is left
    once ``rt.shutdown()`` returns."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.job.manager import group_members
    from ray_tpu_torch.job.sdk import JobSubmissionClient

    ready = tmp_path / "ready"
    rt.init(num_cpus=1, include_dashboard=True)
    try:
        client = JobSubmissionClient(rt.get_cluster().dashboard.url)
        sid = client.submit_job(entrypoint=(
            f"{sys.executable} -c \"import time, pathlib; pathlib.Path('{ready}').touch(); "
            "time.sleep(120)\""))
        deadline = time.monotonic() + 60
        while not ready.exists() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert ready.exists()
        proc = rt.get_cluster().dashboard.job_manager._jobs[sid].proc
        pgid = os.getpgid(proc.pid)
        assert group_members(pgid)
    finally:
        rt.shutdown()
    assert group_members(pgid) == []
