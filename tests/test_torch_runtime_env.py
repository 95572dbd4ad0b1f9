"""The port's runtime environments (``ray_tpu_torch.runtime_env``) against
the JAX package's, case by case of ``tests/test_runtime_env_plugins.py``
(less the thin-client proxy, held in ``tests/test_torch_client.py``) and the
runtime-env cases of ``tests/test_dashboard_jobs.py`` and
``tests/test_state_api_tail.py``.

Each scenario runs once in each package, the runtime scenarios under one
runtime of each (``init(num_cpus=2)``), and the outputs must be equal.  Two
behaviours differ on purpose, and a test holds each package to its own:
the port stages into a resource directory of its own (one package's
eviction never removes what the other staged, in one process), and a task
that holds a GPU share with a ``runtime_env`` runs in a worker that sees the
card, where it refuses to start without one (the JAX package has no card
to see: its GPU is a custom resource, the task runs in a plain worker).
"""

import importlib
import os
import pstats
import shutil
import subprocess
import sys
import time

import pytest
from torch_runtime_tasks import _crunch, _env_flag, _gpu_body, _read_a

torch = pytest.importorskip("torch")

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _mods(name):
    return (importlib.import_module(name), importlib.import_module(name + ".runtime_env"),
            importlib.import_module(name + ".runtime_env.plugin"),
            importlib.import_module(name + ".runtime_env.uri_cache"))


def _raised(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - the type is the output
        return type(exc).__name__
    return None


# --------------------------------------------------------------------------
# plugins without a runtime
# --------------------------------------------------------------------------
def sc_container_wrap(name, tmp):
    _, _, plugin, _ = _mods(name)
    real = shutil.which
    shutil.which = lambda exe: "/usr/bin/podman" if exe == "podman" else None
    try:
        value = {"image": "python:3.12", "run_options": ["--net=host"]}
        plugin.ContainerPlugin().validate(value)
        return plugin.wrap_entrypoint(
            {"container": value, "env_vars": {"WANDB_API_KEY": "k"}},
            "python train.py", {"PYTHONPATH": "/repo"}, "/work")
    finally:
        shutil.which = real


def sc_container_requires_engine(name, tmp):
    _, renv, _, _ = _mods(name)
    real = shutil.which
    shutil.which = lambda exe: None
    try:
        with pytest.raises(ValueError, match="podman or docker") as info:
            renv.validate_runtime_env({"container": {"image": "x"}})
        return str(info.value)
    finally:
        shutil.which = real


def sc_mpi_wrap_then_container(name, tmp):
    _, _, plugin, _ = _mods(name)
    real = shutil.which
    shutil.which = lambda exe: f"/usr/bin/{exe}" if exe in ("mpirun", "podman") else None
    try:
        plugin.MPIPlugin().validate({"processes": 4})
        return [plugin.wrap_entrypoint({"mpi": {"processes": 4}}, "python step.py", {}, None),
                plugin.wrap_entrypoint({"mpi": {"processes": 2}, "container": {"image": "img"}},
                                       "python x.py", {}, "/w")]
    finally:
        shutil.which = real


def sc_validation(name, tmp):
    _, renv, _, _ = _mods(name)
    renv.validate_runtime_env({"env_vars": {"A": "1"}})
    renv.validate_runtime_env({"profiling": True})
    renv.validate_runtime_env({"profiling": {"dir": "/x"}})
    bad = [{"env_vars": {"A": 1}}, {"bogus_field": 1}, {"not_a_plugin": 1},
           {"profiling": {"nope": 1}}, {"profiling": "yes"}, {"working_dir": 3},
           {"py_modules": "x"}, {"pip": 3}, {"conda": 3}, {"mpi": 3}]
    return [_raised(lambda b=b: renv.validate_runtime_env(b)) for b in bad]


def sc_runtime_env_class(name, tmp):
    _, renv, _, _ = _mods(name)
    env = renv.RuntimeEnv(env_vars={"A": "hello"}, config={"setup_timeout_seconds": 5})
    return {"dict": {k: dict(v) for k, v in env.to_dict().items()},
            "timeout": env["config"].setup_timeout_seconds,
            "eager": env["config"].eager_install,
            "uris": renv.RuntimeEnv(working_dir="/a", env_vars={}).plugin_uris(),
            "unknown": _raised(lambda: renv.RuntimeEnv(not_a_field=1)),
            "mpi_init": _raised(renv.mpi_init)}


def sc_py_modules_import(name, tmp):
    _, _, plugin, _ = _mods(name)
    pkg = os.path.join(tmp, "mypkg_rt_test")
    os.makedirs(pkg)
    with open(os.path.join(pkg, "__init__.py"), "w") as f:
        f.write("VALUE = 7\n")
    env, cwd = plugin.apply_to_process_env({"py_modules": [pkg]}, {})
    code = "import sys; sys.path[:0]=%r.split(%r); import mypkg_rt_test; print(mypkg_rt_test.VALUE)" % (
        env["PYTHONPATH"], os.pathsep)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60)
    staged = env["PYTHONPATH"].split(os.pathsep)
    return {"value": out.stdout.strip(), "cwd": cwd,
            "staged_in_resource_dir": all(p.startswith(plugin._resource_dir()) for p in staged),
            "kinds": [os.path.basename(p).split("-")[0] for p in staged]}


def sc_working_dir_restages_on_change(name, tmp):
    _, _, plugin, _ = _mods(name)
    src = os.path.join(tmp, "wd")
    os.makedirs(src)
    with open(os.path.join(src, "f.txt"), "w") as f:
        f.write("one")
    _env, cwd1 = plugin.apply_to_process_env({"working_dir": src}, {})
    time.sleep(0.01)
    with open(os.path.join(src, "f.txt"), "w") as f:
        f.write("two-changed")
    os.utime(os.path.join(src, "f.txt"))
    _env, cwd2 = plugin.apply_to_process_env({"working_dir": src}, {})
    with open(os.path.join(cwd2, "f.txt")) as f:
        text = f.read()
    return {"restaged": cwd1 != cwd2, "text": text, "basename": os.path.basename(cwd2)}


def sc_uri_cache_eviction(name, tmp):
    _, _, _, uc = _mods(name)
    cache = uc.URICache(max_total_size_bytes=100)

    def make(n, size):
        p = os.path.join(tmp, n)
        with open(p, "wb") as f:
            f.write(b"x" * size)
        return p

    cache.get_or_create("uri://a", lambda: make("a", 80))
    cache.add_reference("uri://a")
    cache.get_or_create("uri://b", lambda: make("b", 80))
    pinned = cache.get("uri://a") is not None
    cache.remove_reference("uri://a")
    cache.get_or_create("uri://c", lambda: make("c", 80))
    return {"pinned": pinned, "total": cache.total_size(),
            "rows": [(r["uri"], r["ref_count"], r["size_bytes"]) for r in cache.describe()],
            "left": sorted(n for n in "abc" if os.path.exists(os.path.join(tmp, n)))}


# --------------------------------------------------------------------------
# tasks under one runtime of each package
# --------------------------------------------------------------------------
def rsc_profiling_dumps_pstats(rt, name, tmp):
    out = os.path.join(tmp, "profs")
    crunch = rt.remote(_crunch).options(
        execution="process", runtime_env={"profiling": {"dir": out}})
    value = rt.get(crunch.remote(50_000), timeout=120)
    profs = sorted(f for f in os.listdir(out) if "_crunch_" in f and f.endswith(".prof"))
    stats = pstats.Stats(os.path.join(out, profs[0]))
    return {"value": value, "profiles": len(profs), "calls": stats.total_calls > 0}


def rsc_task_env_vars_apply_and_restore(rt, name, tmp):
    with_env = rt.remote(_env_flag).options(
        execution="process", runtime_env={"env_vars": {"MY_TASK_FLAG": "on"}})
    without_env = rt.remote(_env_flag).options(execution="process")
    pid, flag = rt.get(with_env.remote(), timeout=120)
    deadline = time.monotonic() + 60
    restored = None
    while time.monotonic() < deadline:
        pid2, flag2 = rt.get(without_env.remote(), timeout=120)
        if pid2 == pid:
            restored = flag2 is None
            break
    bad = rt.remote(_env_flag).options(execution="process", runtime_env={"env_vars": {"N": 1}})
    return {"flag": flag, "in_worker": pid != os.getpid(), "restored": restored,
            "bad_at_submit": _raised(bad.remote)}


def rsc_runtime_env_object_runs(rt, name, tmp):
    renv = importlib.import_module(name + ".runtime_env")
    env = renv.RuntimeEnv(env_vars={"A": "hello"}, config={"setup_timeout_seconds": 5})
    return rt.get(rt.remote(_read_a).options(execution="process", runtime_env=env).remote(),
                  timeout=60)


SCENARIOS = [fn for n, fn in sorted(globals().items()) if n.startswith("sc_")]
RUNTIME_SCENARIOS = [fn for n, fn in sorted(globals().items()) if n.startswith("rsc_")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{package: {scenario: output}} (an exception is the scenario's output)."""
    out = {name: {} for name in PACKAGES}
    for name in PACKAGES:
        for fn in SCENARIOS:
            tmp = str(tmp_path_factory.mktemp(f"{name}_{fn.__name__}"))
            try:
                out[name][fn.__name__[3:]] = fn(name, tmp)
            except Exception as exc:  # noqa: BLE001 - reported by the test
                out[name][fn.__name__[3:]] = ("raised", repr(exc))
        rt = importlib.import_module(name)
        rt.init(num_cpus=2)
        try:
            for fn in RUNTIME_SCENARIOS:
                tmp = str(tmp_path_factory.mktemp(f"{name}_{fn.__name__}"))
                try:
                    out[name][fn.__name__[4:]] = fn(rt, name, tmp)
                except Exception as exc:  # noqa: BLE001
                    out[name][fn.__name__[4:]] = ("raised", repr(exc))
        finally:
            rt.shutdown()
    return out


EXPECT = {
    "container_wrap": lambda o: (o.startswith("podman run --rm --net=host") and "python:3.12" in o
                                 and "'python train.py'" in o and "-e WANDB_API_KEY=k" in o
                                 and "PYTHONPATH" not in o),
    "container_requires_engine": lambda o: "podman or docker" in o,
    "mpi_wrap_then_container": lambda o: (o[0].startswith("mpirun -n 4") and "'python step.py'" in o[0]
                                          and o[1].startswith("podman run") and "mpirun -n 2" in o[1]),
    "validation": lambda o: o == ["TypeError", "ValueError", "ValueError", "ValueError",
                                  "ValueError", "TypeError", "TypeError", "TypeError",
                                  "TypeError", "ValueError"],
    "runtime_env_class": lambda o: (o["dict"]["env_vars"] == {"A": "hello"} and o["timeout"] == 5
                                    and o["unknown"] == "ValueError"
                                    and o["mpi_init"] == "ImportError"),
    "py_modules_import": lambda o: (o["value"] == "7" and o["staged_in_resource_dir"]
                                    and o["kinds"] == ["py_modules"]),
    "working_dir_restages_on_change": lambda o: (o["restaged"] and o["text"] == "two-changed"
                                                 and o["basename"] == "wd"),
    "uri_cache_eviction": lambda o: o["pinned"] and o["total"] <= 160,
    "profiling_dumps_pstats": lambda o: (o["value"] == sum(i * i for i in range(50_000))
                                         and o["profiles"] == 1 and o["calls"]),
    "task_env_vars_apply_and_restore": lambda o: (o["flag"] == "on" and o["in_worker"]
                                                  and o["restored"] is True
                                                  and o["bad_at_submit"] == "TypeError"),
    "runtime_env_object_runs": lambda o: o == "hello",
}


def test_every_scenario_is_checked():
    assert {fn.__name__[3:] for fn in SCENARIOS} | {fn.__name__[4:] for fn in RUNTIME_SCENARIOS} \
        == set(EXPECT)


@pytest.mark.parametrize("key", sorted(EXPECT))
def test_runtime_env_scenario_matches_jax(runs, key):
    j, p = runs["ray_tpu"][key], runs["ray_tpu_torch"][key]
    assert not (isinstance(p, tuple) and p[:1] == ("raised",)), p
    assert not (isinstance(j, tuple) and j[:1] == ("raised",)), j
    assert p == j
    assert EXPECT[key](p), p


@pytest.mark.parametrize("module", ["runtime_env", "runtime_env.plugin", "usage"])
def test_runtime_env_exports_match_jax(module):
    j = importlib.import_module("ray_tpu." + module)
    p = importlib.import_module("ray_tpu_torch." + module)
    names = getattr(j, "__all__", None) or [n for n in vars(j) if not n.startswith("__")]
    assert sorted(getattr(p, "__all__", names)) == sorted(names)
    for n in names:
        assert hasattr(p, n), n


def test_staging_and_eviction_in_one_process_keep_each_package_apart(tmp_path):
    """One working dir staged by both packages in this one process: each
    copy lands in its own package's resource directory, and evicting one
    package's cache deletes its copy only, whichever goes first."""
    src = tmp_path / "app"
    src.mkdir()
    (src / "data.txt").write_text("payload42")
    sides = {name: _mods(name)[2] for name in PACKAGES}
    staged, uris = {}, {}
    for name, plugin in sides.items():
        uris[name] = []
        _env, staged[name] = plugin.apply_to_process_env(
            {"working_dir": str(src)}, {}, uris_out=uris[name])
    assert staged["ray_tpu"] != staged["ray_tpu_torch"]
    assert os.path.basename(os.path.dirname(os.path.dirname(staged["ray_tpu_torch"]))) \
        == f"rt_torch_runtime_env_{os.getpid()}"
    assert os.path.basename(os.path.dirname(os.path.dirname(staged["ray_tpu"]))) \
        == f"rt_runtime_env_{os.getpid()}"
    for first, second in (PACKAGES, PACKAGES[::-1]):
        cache = sides[first]._cache
        limit = cache.max_total_size_bytes
        cache.max_total_size_bytes = 0
        try:
            sides[first].remove_references(uris[first])  # unpinned: evicted at once
        finally:
            cache.max_total_size_bytes = limit
        assert not os.path.exists(staged[first])
        assert (open(os.path.join(staged[second], "data.txt")).read()) == "payload42"
        # stage the evicted side again for the reverse order
        uris[first] = []
        _env, staged[first] = sides[first].apply_to_process_env(
            {"working_dir": str(src)}, {}, uris_out=uris[first])
    for name in PACKAGES:
        sides[name].remove_references(uris[name])


def test_profile_dirs_differ_per_package():
    from ray_tpu_torch.runtime_env import plugin as pplugin

    env, _ = pplugin.apply_to_process_env({"profiling": True}, {})
    assert env["RAY_TPU_TASK_PROFILING"] == pplugin.PROFILE_DIR
    assert os.path.basename(pplugin.PROFILE_DIR) == "rt_torch_task_profiles"
    from ray_tpu.runtime_env import plugin as jplugin

    jenv, _ = jplugin.apply_to_process_env({"profiling": True}, {})
    assert jenv["RAY_TPU_TASK_PROFILING"] != env["RAY_TPU_TASK_PROFILING"]


# --------------------------------------------------------------------------
# the device seam: a GPU share with a runtime_env
# --------------------------------------------------------------------------
@pytest.mark.parametrize("hide", [False, True], ids=["no_card", "env_hides_card"])
def test_gpu_share_task_with_runtime_env_refuses_without_the_card(tmp_path, hide):
    """The port runs the task in a worker spawned to see the card; with no
    CUDA device (this host), or with ``env_vars`` that hide it, the task
    raises before its body runs, naming why.  The JAX package, whose GPU is
    a custom resource, runs it in a plain process worker with the env."""
    env = {"MY_GPU_FLAG": "on", **({"CUDA_VISIBLE_DEVICES": ""} if hide else {})}
    import ray_tpu as jrt

    jrt.init(num_cpus=2, resources={"GPU": 1})
    try:
        marker = str(tmp_path / "jax_ran")
        pid, flag, visible = jrt.get(jrt.remote(_gpu_body).options(
            num_gpus=1, runtime_env={"env_vars": env}).remote(marker), timeout=120)
        assert pid != os.getpid() and flag == "on" and os.path.exists(marker)
    finally:
        jrt.shutdown()

    import ray_tpu_torch as rt

    rt.init(num_cpus=2, num_gpus=1)
    try:
        marker = str(tmp_path / "port_ran")
        ref = rt.remote(_gpu_body).options(num_gpus=1, runtime_env={"env_vars": env}).remote(marker)
        with pytest.raises(rt.RayTaskError) as info:
            rt.get(ref, timeout=120)
        why = "hides the card" if hide else "no CUDA device is available"
        assert "holds a GPU share and" in str(info.value) and why in str(info.value)
        assert "does not run on the CPU" in str(info.value)
        assert not os.path.exists(marker)
        # the card worker is retired with its task; the plain pool is untouched
        pool = rt.get_cluster().head_node.worker_pool
        deadline = time.monotonic() + 10
        while any(w.dedicated for w in pool._all.values()) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not any(w.dedicated for w in pool._all.values())
    finally:
        rt.shutdown()
