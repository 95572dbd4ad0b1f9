"""The port's CLI (``python -m ray_tpu_torch``, ``ray_tpu_torch.scripts.cli``)
against the JAX package's.

The parsers must offer the same subcommands and options.  Each CLI test of
the JAX suite that runs on one node (``test_dashboard_jobs.py:192``,
``:214``; ``test_plans.py:451``, ``:740``; ``test_overload.py:863``,
``:874``; ``test_tracing.py:347``; ``test_leases.py:391``;
``test_drain.py:533``, ``:605``) runs here through both packages' heads,
its observations compared with the package name masked.  None of them
needs the multi-node runtime.  ``test_plans.py:740`` pushes a JAX array
through the plan; the port's scenario pushes a CPU tensor of the same
shape and values.  The port's address file and head check are its own;
``start --head`` and ``start --address`` start a head and a node agent as
processes here, and so does ``up`` with one ``local`` worker (the
launcher behind it is held in ``tests/test_torch_autoscaler.py``).
"""

import contextlib
import importlib
import io
import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

PACKAGES = ("ray_tpu", "ray_tpu_torch")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _walk(parser, path=()):
    """{subcommand path: sorted option strings and positional names}."""
    import argparse

    out = {}
    opts = []
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                out.update(_walk(sub, path + (name,)))
        elif isinstance(action, argparse._HelpAction):
            continue
        else:
            opts.append(",".join(action.option_strings) or action.dest)
            opts.append(repr(action.choices) if action.choices else "")
            opts.append(repr(action.default))
    out[" ".join(path)] = sorted(opts)
    return out


def test_parsers_have_the_same_subcommands_and_options():
    """The same subcommands and options; ``start`` has one more,
    ``--num-gpus`` (the node's GPU resource, beside the JAX package's
    ``--num-tpus``)."""
    j = importlib.import_module("ray_tpu.scripts.cli").build_parser()
    p = importlib.import_module("ray_tpu_torch.scripts.cli").build_parser()
    jw, pw = _walk(j), _walk(p)
    assert sorted(pw) == sorted(jw)
    extra = sorted(["--num-gpus", "", "None"])
    start = list(pw["start"])
    for item in extra:
        start.remove(item)
    pw["start"] = start
    for path in jw:
        assert pw[path] == jw[path], path
    assert p.prog == "ray_tpu_torch"


def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def _masked(text: str, name: str) -> str:
    return text.replace(name, "<pkg>")


@contextlib.contextmanager
def _runtime(rt, **kw):
    rt.init(**kw)
    try:
        yield rt.get_cluster()
    finally:
        rt.shutdown()


def sc_status_list_summary(name, rt, main, tmp):
    """test_dashboard_jobs.py:192."""
    with _runtime(rt, num_cpus=2, include_dashboard=True) as cluster:
        url = cluster.dashboard.url

        @rt.remote
        def h():
            return 1

        rt.get(h.remote())
        rc1, out1, _ = _cli(main, ["status", "--address", url])
        rc2, out2, _ = _cli(main, ["list", "nodes", "--address", url])
        rc3, out3, _ = _cli(main, ["summary", "tasks", "--address", url])
    return {"rcs": [rc1, rc2, rc3], "nodes_1": "Nodes: 1" in out1,
            "cpu_line": "0/2 CPU used" in out1, "node_id": "node_id" in out2,
            "h": '"h"' in out3 or "h" in out3}


def sc_timeline_and_job(name, rt, main, tmp):
    """test_dashboard_jobs.py:214."""
    with _runtime(rt, num_cpus=2, include_dashboard=True) as cluster:
        url = cluster.dashboard.url

        @rt.remote
        def k():
            return 1

        rt.get(k.remote())
        out_file = os.path.join(tmp, f"tl_{name}.json")
        rc1, _, _ = _cli(main, ["timeline", "--address", url, "-o", out_file])
        with open(out_file) as f:
            events = json.load(f)
        rc2, out2, _ = _cli(main, ["job", "submit", "--address", url, "--",
                                   sys.executable, "-c", "print('cli job')"])
    return {"rcs": [rc1, rc2], "timeline_nonempty": bool(events),
            "job_printed": "cli job" in out2, "status_line": "status: SUCCEEDED" in out2}


def sc_plans(name, rt, main, tmp):
    """test_plans.py:451."""
    dag = importlib.import_module(name + ".dag")
    with _runtime(rt, num_cpus=2, include_dashboard=True) as cluster:
        url = cluster.dashboard.url

        @rt.remote
        class Stage:
            def step(self, x):
                return x * 2

        a = Stage.options(execution="inproc").remote()
        b = Stage.options(execution="inproc").remote()
        with dag.InputNode() as inp:
            d = b.step.bind(a.step.bind(inp))
        plan = d.compile_plan(name="cli-smoke")
        try:
            value = plan.execute(3)
            rc1, out1, _ = _cli(main, ["plans", "--address", url])
            rc2, out2, _ = _cli(main, ["plans", "--address", url, "--format", "json"])
        finally:
            plan.teardown()
    data = json.loads(out2)
    return {"value": value, "rcs": [rc1, rc2],
            "text": all(s in out1 for s in ("cli-smoke", "READY", "step()")),
            "json_plans": [p["name"] for p in data["plans"]], "json_keys": sorted(data)}


def sc_plans_device_fields(name, rt, main, tmp):
    """test_plans.py:740: a JAX array in the JAX package, a CPU tensor in
    the port."""
    dag = importlib.import_module(name + ".dag")
    with _runtime(rt, num_cpus=2, include_dashboard=True) as cluster:
        url = cluster.dashboard.url

        @rt.remote
        class Stage:
            def step(self, x):
                return x * 2

        a = Stage.options(execution="inproc").remote()
        with dag.InputNode() as inp:
            d = a.step.bind(inp)
        plan = d.compile_plan(name="dev-smoke")
        try:
            if name == "ray_tpu":
                import jax.numpy as jnp

                x = jnp.ones(512, jnp.float32)
            else:
                x = torch.ones(512, dtype=torch.float32)
            total = float(plan.execute(x).sum())
            with urllib.request.urlopen(f"{url}/api/plans", timeout=10) as resp:
                data = json.loads(resp.read())
            rc, text, _ = _cli(main, ["plans", "--address", url])
        finally:
            plan.teardown()
    totals = data["totals"]
    return {"sum": total, "rc": rc,
            "totals": sorted(k for k in ("device_channel_bytes_sent",
                                         "device_channel_bytes_received",
                                         "device_channel_occupancy", "hbm_resident_bytes",
                                         "stage_group_executions") if k in totals),
            "channel_kinds": bool(data["plans"][0]["channel_kinds"]),
            "text": "device channels:" in text and "edge " in text and "device" in text}


def sc_chaos_validate_overload(name, rt, main, tmp):
    """test_overload.py:863 (the CLI round trip of a valid overload
    schedule)."""
    ok = {"seed": 5, "events": [{"t": 0.0, "kind": "overload", "tasks": 8, "cpus": 1,
                                 "hold_s": 0.1}]}
    path = os.path.join(tmp, f"overload_{name}.json")
    with open(path, "w") as f:
        json.dump(ok, f)
    rc, out, err = _cli(main, ["chaos", "validate", path])
    return {"rc": rc, "out": _masked(out, path)}


def sc_overload(name, rt, main, tmp):
    """test_overload.py:874."""
    exc = importlib.import_module(name + ".exceptions")
    with _runtime(rt, num_cpus=1, include_dashboard=True,
                  _system_config={"max_inflight_tasks_per_caller": 2,
                                  "task_submit_overload_policy": "shed"}) as cluster:
        url = cluster.dashboard.url

        @rt.remote
        def hold():
            time.sleep(0.3)
            return 1

        refs, sheds = [], 0
        for _ in range(5):
            try:
                refs.append(hold.remote())
            except exc.OverloadedError:
                sheds += 1
        rt.get(refs, timeout=60)
        rc1, out1, _ = _cli(main, ["overload", "--address", url, "--format", "json"])
        rc2, out2, _ = _cli(main, ["overload", "--address", url])
    data = json.loads(out1)
    return {"sheds": sheds >= 1, "rcs": [rc1, rc2],
            "inflight_cap": data["shed_totals"]["submission"]["inflight_cap"] >= 1,
            "cap": data["submission"]["cap"], "bound": data["demand_queue"]["bound"] > 0,
            "events": data["events_total"] >= 1,
            "text": "sheds:" in out2 and "submission gate" in out2}


def sc_metrics_and_tracing_timeline(name, rt, main, tmp):
    """test_tracing.py:347."""
    with _runtime(rt, num_cpus=2, include_dashboard=True) as cluster:
        url = cluster.dashboard.url

        @rt.remote(execution="process")
        def job(x):
            return x

        rt.get([job.remote(i) for i in range(3)])
        time.sleep(0.3)
        rc1, out1, _ = _cli(main, ["metrics", "--address", url])
        traced = os.path.join(tmp, f"trace_{name}.json")
        plain = os.path.join(tmp, f"plain_{name}.json")
        rc2, _, _ = _cli(main, ["timeline", "--tracing", "--address", url, "-o", traced])
        rc3, _, _ = _cli(main, ["timeline", "--address", url, "-o", plain])
    with open(traced) as f:
        spans = [e for e in json.load(f) if e.get("cat") == "span"]
    with open(plain) as f:
        plain_spans = [e for e in json.load(f) if e.get("cat") == "span"]
    return {"rcs": [rc1, rc2, rc3],
            "families": ["# TYPE ray_tpu_tasks_terminal_total counter" in out1,
                         "ray_tpu_scheduler_tasks_dispatched_total" in out1],
            "spans": bool(spans) and any(e["pid"].startswith("trace:") for e in spans),
            "plain_spans": len(plain_spans)}


def sc_leases(name, rt, main, tmp):
    """test_leases.py:391."""
    with _runtime(rt, num_cpus=2, include_dashboard=True) as cluster:
        url = cluster.dashboard.url

        @rt.remote
        def leased_fn():
            return None

        rt.get([leased_fn.remote() for _ in range(20)], timeout=60)
        rc1, out1, _ = _cli(main, ["leases", "--address", url])
        rc2, out2, _ = _cli(main, ["leases", "--address", url, "--format", "json"])
    data = json.loads(out2)
    return {"rcs": [rc1, rc2], "text": "leased_fn" in out1 and "reuse hits" in out1,
            "grants": data["leases"]["grants"] >= 1,
            "reuse_hits": data["leases"]["reuse_hits"] >= 10,
            "decisions": data["head"]["scheduling_decisions"] >= 1}


def sc_nodes_surface_drains(name, rt, main, tmp):
    """test_drain.py:533."""
    with _runtime(rt, num_cpus=2, include_dashboard=True) as cluster:
        cluster.kill_head()
        cluster.restart_head()
        node_b = cluster.add_node({"CPU": 1})
        cluster.drain_node(node_b.node_id)
        url = cluster.dashboard.url
        with urllib.request.urlopen(url + "/api/autoscaler", timeout=30) as resp:
            data = json.loads(resp.read())
        rc, out, _ = _cli(main, ["nodes", "--address", url])
    states = {n["node_id"]: n["state"] for n in data["nodes"]}
    return {"b_dead": states[node_b.node_id.hex()] == "DEAD",
            "head_alive": any(n["is_head"] and n["state"] == "ALIVE" for n in data["nodes"]),
            "head_restarts": data["head_restarts"],
            "drain_of_b": bool(data["drains"])
            and data["drains"][0]["node"] == node_b.node_id.hex()[:8],
            "rc": rc, "text": "DEAD" in out and "head restarts: 1" in out and "drains: 1" in out}


def sc_chaos_validate_cli(name, rt, main, tmp):
    """test_drain.py:605."""
    good = os.path.join(tmp, f"good_{name}.json")
    with open(good, "w") as f:
        json.dump({"seed": 3, "events": [{"t": 0.0, "kind": "arm",
                                          "spec": "rpc.call=delay(0.1,0.5)"}]}, f)
    bad = os.path.join(tmp, f"bad_{name}.json")
    with open(bad, "w") as f:
        json.dump({"seed": 3, "events": [{"t": 0, "kind": "nope"}]}, f)
    notjson = os.path.join(tmp, f"notjson_{name}.json")
    with open(notjson, "w") as f:
        f.write("{")
    r1, o1, _ = _cli(main, ["chaos", "validate", good])
    r2, _, e2 = _cli(main, ["chaos", "validate", bad])
    r3, _, e3 = _cli(main, ["chaos", "validate", notjson])
    return {"rcs": [r1, r2, r3], "ok": "ok (1 events" in o1, "unknown": "unknown kind" in e2,
            "notjson": "not valid JSON" in e3}


SCENARIOS = {n[3:]: fn for n, fn in sorted(globals().items()) if n.startswith("sc_")}

EXPECT = {
    "status_list_summary": {"rcs": [0, 0, 0], "nodes_1": True, "cpu_line": True,
                            "node_id": True, "h": True},
    "timeline_and_job": {"rcs": [0, 0], "timeline_nonempty": True, "job_printed": True,
                         "status_line": True},
    "plans": {"value": 12, "rcs": [0, 0], "text": True, "json_plans": ["cli-smoke"]},
    "plans_device_fields": {"sum": 1024.0, "rc": 0, "channel_kinds": True, "text": True,
                            "totals": sorted(["device_channel_bytes_sent",
                                              "device_channel_bytes_received",
                                              "device_channel_occupancy",
                                              "hbm_resident_bytes",
                                              "stage_group_executions"])},
    "chaos_validate_overload": {"rc": 0},
    "overload": {"sheds": True, "rcs": [0, 0], "inflight_cap": True, "cap": 2, "bound": True,
                 "events": True, "text": True},
    "metrics_and_tracing_timeline": {"rcs": [0, 0, 0], "families": [True, True],
                                     "spans": True, "plain_spans": 0},
    "leases": {"rcs": [0, 0], "text": True, "grants": True, "reuse_hits": True,
               "decisions": True},
    "nodes_surface_drains": {"b_dead": True, "head_alive": True, "head_restarts": 1,
                             "drain_of_b": True, "rc": 0, "text": True},
    "chaos_validate_cli": {"rcs": [0, 1, 1], "ok": True, "unknown": True, "notjson": True},
}


def test_every_scenario_is_checked():
    assert set(SCENARIOS) == set(EXPECT)


@pytest.mark.parametrize("key", sorted(EXPECT))
def test_cli_scenario_matches_jax(key, tmp_path):
    got = {}
    for name in PACKAGES:
        rt = importlib.import_module(name)
        main = importlib.import_module(name + ".scripts.cli").main
        got[name] = SCENARIOS[key](name, rt, main, str(tmp_path))
    j, p = got["ray_tpu"], got["ray_tpu_torch"]
    assert p == j
    for k, v in EXPECT[key].items():
        assert p[k] == v, (k, p)


# ---------------------------------------------------------------------------
# the port's own pieces
# ---------------------------------------------------------------------------
def test_address_file_and_head_check_are_the_ports_own():
    from ray_tpu.scripts import cli as jcli
    from ray_tpu_torch.scripts import cli as pcli

    assert pcli.ADDRESS_FILE != jcli.ADDRESS_FILE
    assert os.path.basename(os.path.dirname(pcli.ADDRESS_FILE)) == "ray_tpu_torch"
    # a JAX head is never taken for the port's, and the port's is
    jax_head = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(30)",
                                 "-m", "ray_tpu", "start"])
    port_head = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(30)",
                                  "ray_tpu_torch", "start"])
    try:
        time.sleep(0.2)
        assert not pcli._pid_is_head(jax_head.pid)
        assert pcli._pid_is_head(port_head.pid)
        assert not pcli._pid_is_head(os.getpid())
    finally:
        for p in (jax_head, port_head):
            p.kill()
            p.wait()


def test_stop_never_signals_a_stale_pid(tmp_path, monkeypatch):
    from ray_tpu_torch.scripts import cli

    path = tmp_path / "head.json"
    monkeypatch.setattr(cli, "ADDRESS_FILE", str(path))
    path.write_text(json.dumps({"pid": os.getpid(), "dashboard_url": "http://x"}))
    rc, out, _ = _cli(cli.main, ["stop"])
    assert rc == 0 and "stale address file" in out and not path.exists()
    rc, out, _ = _cli(cli.main, ["stop"])
    assert rc == 0 and "nothing to stop" in out


def test_stop_returns_once_the_head_has_exited_even_unreaped(tmp_path, monkeypatch):
    """A head that exits on SIGTERM stays a zombie until its parent reaps
    it; the port's ``stop`` sees it exit (the JAX package's waits 10 s)."""
    from ray_tpu_torch.scripts import cli

    monkeypatch.setattr(cli, "ADDRESS_FILE", str(tmp_path / "head.json"))
    head = subprocess.Popen([sys.executable, "-c",
                             "import signal, sys, time\n"
                             "signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))\n"
                             "print('up', flush=True)\n"
                             "time.sleep(60)\n", "ray_tpu_torch", "start"],
                            stdout=subprocess.PIPE, text=True)
    try:
        assert head.stdout.readline().strip() == "up"
        cli._write_address_file({"pid": head.pid, "dashboard_url": "http://x"})
        t0 = time.monotonic()
        rc, out, _ = _cli(cli.main, ["stop"])  # this process reaps the head only after
        took = time.monotonic() - t0
        assert rc == 0 and "sent SIGTERM" in out and "killed" not in out
        assert took < 5.0, took
        assert head.wait(timeout=30) == 0
    finally:
        if head.poll() is None:
            head.kill()
            head.wait()


def test_status_reads_the_ports_address_file(tmp_path, monkeypatch):
    import ray_tpu_torch as rt
    from ray_tpu_torch.scripts import cli

    monkeypatch.setattr(cli, "ADDRESS_FILE", str(tmp_path / "head.json"))
    monkeypatch.delenv("RAY_TPU_TORCH_ADDRESS", raising=False)
    # the JAX package's variable is not the port's: it names no head here
    monkeypatch.setenv("RAY_TPU_ADDRESS", "http://127.0.0.1:9")
    with pytest.raises(SystemExit, match="No running head found.*RAY_TPU_TORCH_ADDRESS"):
        _cli(cli.main, ["status"])
    with _runtime(rt, num_cpus=2, include_dashboard=True) as cluster:
        cli._write_address_file({"dashboard_url": cluster.dashboard.url, "pid": os.getpid()})
        rc, out, _ = _cli(cli.main, ["status"])
        assert rc == 0 and "Nodes: 1" in out
        os.unlink(cli.ADDRESS_FILE)
        monkeypatch.setenv("RAY_TPU_TORCH_ADDRESS", cluster.dashboard.url)
        rc, out, _ = _cli(cli.main, ["status"])
    assert rc == 0 and "Nodes: 1" in out


@pytest.mark.parametrize("argv", [["start", "--head"], ["start", "--address", "10.0.0.1:6380"]])
def test_multi_host_start_raises_not_ported(argv):
    """``start --head`` and ``start --address`` are ported with the
    multi-node core: a head process opens its control plane and prints its
    routable join address; an agent joins it, ``status`` counts two nodes,
    ``stop`` ends the head and the agent exits with it.  Each case starts
    both (``argv`` names the side whose output it checks); ``up`` is held in
    tests/test_torch_autoscaler.py.  The test's name is historical: it asserted the raise these commands
    gave before the multi-node core was ported."""
    import shutil
    import tempfile

    # a short TMPDIR of its own (the runtime's unix sockets live there): the
    # address file and the sessions of these processes, and no one else's
    tmp = tempfile.mkdtemp(prefix="rtcli")
    env = dict(os.environ, TMPDIR=tmp, PYTHONPATH=ROOT)
    # the agent leaves with its head instead of waiting to rejoin one
    env["RAY_TPU_AGENT_RECONNECT_TIMEOUT_S"] = "0"
    mod = [sys.executable, "-m", "ray_tpu_torch"]
    head = subprocess.Popen(mod + ["start", "--head", "--num-cpus", "1", "--num-gpus", "0",
                                   "--dashboard-port", "0"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    agent = None
    try:
        lines = []
        for line in head.stdout:
            lines.append(line)
            if line.startswith("Join more nodes with:"):
                break
        assert lines and lines[-1].startswith("Join more nodes with:"), (lines, head.wait(5))
        address = lines[-1].split("--address", 1)[1].strip()
        host, _, port = address.rpartition(":")
        assert host and host != "0.0.0.0" and int(port) > 0, lines
        agent = subprocess.Popen(mod + ["start", "--address", address, "--num-cpus", "1"],
                                 cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                                 stderr=subprocess.PIPE, text=True)
        deadline = time.monotonic() + 90
        out = ""
        while time.monotonic() < deadline:
            p = subprocess.run(mod + ["status"], cwd=ROOT, env=env, capture_output=True,
                               text=True, timeout=60)
            out = p.stdout
            if "Nodes: 2" in out:
                break
            time.sleep(0.2)
        assert "Nodes: 2" in out, out
        p = subprocess.run(mod + ["stop"], cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=60)
        assert p.returncode == 0 and "sent SIGTERM" in p.stdout, p.stdout
        assert head.wait(timeout=30) == 0
        assert agent.wait(timeout=60) == 0
        joined = agent.stderr.read()
        if argv[1] == "--address":
            assert f"joined {address}" in joined, joined
        else:
            assert f"start --address {address}" in "".join(lines)
    finally:
        for proc in (head, agent):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)


def _children(pid: int, module: str) -> list:
    """Pids of the live children of ``pid`` running ``python -m module``."""
    found = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                argv = f.read().decode(errors="replace").split("\x00")
        except OSError:
            continue
        if int(stat[1]) == pid and stat[0] != "Z" and module in argv:
            found.append(int(entry))
    return found


def _gone(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


@pytest.mark.skipif(not os.path.isdir("/proc"), reason="reads children from /proc")
def test_up_cli_process_joins_then_downs_on_sigterm(tmp_path):
    """``python -m ray_tpu_torch up <config>`` as a process, with one
    ``local`` worker: it starts the head, its provider spawns one port
    agent as its child, the agent joins (the ``cluster up`` line counts two
    nodes), and SIGTERM brings the cluster down: the command exits 0 and the
    agent exits with it."""
    import shutil
    import signal
    import tempfile

    tmp = tempfile.mkdtemp(prefix="rtup")
    env = dict(os.environ, TMPDIR=tmp, PYTHONPATH=ROOT)
    cfg = {"cluster_name": "t", "provider": {"type": "local"}, "head": {"num_cpus": 1},
           "available_node_types": {"w": {"resources": {"CPU": 1},
                                          "min_workers": 1, "max_workers": 1}},
           "max_workers": 1, "idle_timeout_s": 300}
    path = tmp_path / "cluster.json"
    path.write_text(json.dumps(cfg))
    up = subprocess.Popen([sys.executable, "-m", "ray_tpu_torch", "up", str(path)],
                          cwd=ROOT, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        for line in up.stdout:
            lines.append(line)
            if line.startswith("Join more nodes with:"):
                break
        assert any(ln.startswith("cluster up:") and ln.rstrip().endswith(", 2 nodes")
                   for ln in lines), (lines, up.poll())
        agents = _children(up.pid, "ray_tpu_torch.runtime.agent")
        assert len(agents) == 1, agents
        up.send_signal(signal.SIGTERM)
        assert up.wait(timeout=60) == 0, up.stdout.read()
        deadline = time.monotonic() + 30
        while not _gone(agents[0]) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert _gone(agents[0])
    finally:
        if up.poll() is None:
            up.kill()
            up.wait(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)


class Echo:
    def __call__(self, x):
        return x


def test_serve_cli_reuses_the_running_runtime(tmp_path):
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.scripts import cli

    global ECHO_APP
    ECHO_APP = serve.deployment(Echo).bind()
    cfg = tmp_path / "serve.yaml"  # YAML in its JSON form
    cfg.write_text(json.dumps({"applications": [
        {"name": "echo", "route_prefix": "/echo", "import_path": f"{__name__}:ECHO_APP"}]}))
    with _runtime(rt, num_cpus=2) as cluster:
        try:
            rc, out, _ = _cli(cli.main, ["serve", "deploy", str(cfg)])
            assert rc == 0 and json.loads(out)["deployed"]["echo"]["route_prefix"] == "/echo"
            assert rt.get_cluster() is cluster
            rc, out, _ = _cli(cli.main, ["serve", "status"])
            assert rc == 0 and "echo" in out
            assert serve.get_app_handle("echo").remote(7).result(timeout=30) == 7
        finally:
            rc, out, _ = _cli(cli.main, ["serve", "shutdown"])
        assert rc == 0 and "serve shut down" in out


def test_python_dash_m_help_exits_zero():
    p = subprocess.run([sys.executable, "-m", "ray_tpu_torch", "--help"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert "ray_tpu_torch" in p.stdout and "microbenchmark" in p.stdout
    assert np.all([c in p.stdout for c in ("start", "stop", "serve", "lint")])
