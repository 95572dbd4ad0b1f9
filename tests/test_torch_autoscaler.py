"""The port's autoscaler (``ray_tpu_torch.autoscaler``) against the JAX
package's.

Every case of ``test_autoscaler.py``, ``test_kuberay_provider.py`` and
``test_gcp_tpu_provider.py`` (with their fake ``kubectl`` / ``gcloud``
runners), and ``test_cluster_launcher.py:81`` and ``:88``, runs here
through both packages: the JAX test's own body, once as written and once
with its module globals and imports bound to the port's (``ray_tpu`` ->
``ray_tpu_torch``; the agent module a provider ships names the port's).
``demand.get_nodes_to_launch`` gives equal outputs in both on the same
inputs, drawn from one numpy seed.  The two cases marked ``full``, whose
nodes are real node agents (``test_cluster_launcher.py:43``,
``test_gcp_tpu_provider.py:111``), run the same way and keep their marker
(``--full``); an unmarked case runs ``up`` on the ``local`` provider with
one worker and then ``down`` through both packages, and the port's ``up``
drives each provider kind (``local``, ``ssh`` with its commands recorded,
``gcp-tpu`` on the fake with a real agent).
"""

import importlib
import inspect
import time

import numpy as np
import pytest
from torch_ported import ported

torch = pytest.importorskip("torch")

import test_autoscaler as jax_autoscaler  # noqa: E402
import test_cluster_launcher as jax_launcher  # noqa: E402
import test_gcp_tpu_provider as jax_gcp  # noqa: E402
import test_kuberay_provider as jax_kuberay  # noqa: E402
from test_cluster_launcher import cluster_yaml  # noqa: E402,F401 — a full case's fixture

PACKAGES = ("ray_tpu", "ray_tpu_torch")
#: string constants of the JAX tests that name the JAX package's modules
PORT_STRINGS = {"ray_tpu.runtime.agent": "ray_tpu_torch.runtime.agent"}


def _cases(module):
    return [(module, n) for n in sorted(vars(module)) if n.startswith("test_")
            and not any(m.name == "full" for m in getattr(getattr(module, n), "pytestmark", []))]


CASES = (_cases(jax_autoscaler) + _cases(jax_kuberay) + _cases(jax_gcp)
         + [(jax_launcher, "test_config_validation"),
            (jax_launcher, "test_ssh_provider_command_shape")])
#: the ``full`` cases: their nodes are real node agents
AGENT_CASES = [(jax_launcher, "test_up_provisions_min_workers_and_down_terminates"),
               (jax_gcp, "test_rt_up_gcp_tpu_fake_full_lifecycle")]


def test_left_out_cases_are_the_agent_ones():
    """The ``full`` cases are the agent ones, held below with their marker
    (the name is historical: they were left out until the agent-spawning
    providers were ported)."""
    full = {(m.__name__, n) for m in (jax_autoscaler, jax_kuberay, jax_gcp, jax_launcher)
            for n in vars(m) if n.startswith("test_")
            and any(x.name == "full" for x in getattr(getattr(m, n), "pytestmark", []))}
    assert full == {(m.__name__, n) for m, n in AGENT_CASES}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", [f"{m.__name__}::{n}" for m, n in CASES]
                         + [pytest.param(f"{m.__name__}::{n}", marks=pytest.mark.full)
                            for m, n in AGENT_CASES])
def test_reference_case_through_both_packages(case, pkg, tmp_path, request):
    mod_name, fn_name = case.split("::")
    fn = getattr(importlib.import_module(mod_name), fn_name)
    if pkg == "ray_tpu_torch":
        fn = ported(fn, lambda c: PORT_STRINGS.get(c, c))
    params = inspect.signature(fn).parameters
    kw = {}
    if "tmp_path" in params:
        kw["tmp_path"] = tmp_path
    if "cluster_yaml" in params:
        kw["cluster_yaml"] = request.getfixturevalue("cluster_yaml")
    if "ray_start_cluster" in params:
        rt = importlib.import_module(pkg)
        cluster = rt.init(num_cpus=2)
        try:
            fn(ray_start_cluster=(rt, cluster), **kw)
        finally:
            rt.shutdown()
    else:
        fn(**kw)


def test_ported_globals_are_the_ports():
    fn = ported(jax_autoscaler.test_idle_nodes_terminate, lambda c: PORT_STRINGS.get(c, c))
    from ray_tpu_torch import autoscaler

    assert fn.__globals__["Monitor"] is autoscaler.Monitor
    assert fn.__globals__["InProcessNodeProvider"] is autoscaler.InProcessNodeProvider
    assert fn.__globals__["AutoscalerConfig"] is autoscaler.AutoscalerConfig


def _demand_inputs(seed: int, n: int):
    rng = np.random.default_rng(seed)
    kinds = ["CPU", "GPU", "TPU", "memory"]
    for _ in range(n):
        types_ = {}
        for t in range(rng.integers(1, 4)):
            res = {k: float(rng.integers(1, 9)) for k in rng.choice(kinds, rng.integers(1, 3),
                                                                   replace=False)}
            types_[f"t{t}"] = dict(resources=res, min_workers=int(rng.integers(0, 2)),
                                   max_workers=int(rng.integers(1, 5)))
        running = {k: int(rng.integers(0, 3)) for k in types_}
        free = [{k: float(rng.integers(0, 5)) for k in rng.choice(kinds, 2, replace=False)}
                for _ in range(rng.integers(0, 3))]
        demands = [{k: float(rng.integers(1, 6)) for k in rng.choice(kinds, rng.integers(1, 3),
                                                                     replace=False)}
                   for _ in range(rng.integers(0, 8))]
        yield types_, running, free, demands, int(rng.integers(1, 10))


def test_get_nodes_to_launch_equal_on_the_same_inputs():
    outs = {}
    for name in PACKAGES:
        demand = importlib.import_module(name + ".autoscaler.demand")
        outs[name] = [
            demand.get_nodes_to_launch(
                {k: demand.NodeTypeConfig(k, **v) for k, v in types_.items()},
                running, free, demands, max_total_workers=cap)
            for types_, running, free, demands, cap in _demand_inputs(19, 200)]
    assert outs["ray_tpu_torch"] == outs["ray_tpu"]
    assert any(outs["ray_tpu"])  # the draws do launch nodes


def _live(cluster) -> list:
    return [n for n in cluster.nodes.values() if not n.dead]


def _wait_live(cluster, n: int, timeout_s: float = 60.0) -> None:
    deadline = time.monotonic() + timeout_s
    while len(_live(cluster)) != n:
        assert time.monotonic() < deadline, f"{len(_live(cluster))} live nodes, want {n}"
        time.sleep(0.1)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_up_local_one_worker_then_down(pkg, tmp_path):
    """``up`` on the ``local`` provider with ``min_workers`` 1 (a config
    file in JSON, which is YAML too) provisions one agent process of the
    package, which joins with its provider label and runs a task of its
    custom resource; ``down`` terminates it and the head sees it die."""
    import json

    rt = importlib.import_module(pkg)
    launcher_mod = importlib.import_module(pkg + ".autoscaler.launcher")
    cfg = {"cluster_name": "t", "provider": {"type": "local"}, "head": {"num_cpus": 1},
           "available_node_types": {"w": {"resources": {"CPU": 1, "pool": 1},
                                          "min_workers": 1, "max_workers": 1}},
           "max_workers": 1, "idle_timeout_s": 300}
    path = tmp_path / "cluster.yaml"
    path.write_text(json.dumps(cfg))
    t0 = time.monotonic()
    launcher = launcher_mod.up(str(path), timeout_s=60)
    try:
        cluster = rt.get_cluster()
        live = _live(cluster)
        assert len(live) == 2
        assert sum(1 for n in live if (getattr(n, "labels", None) or {}).get("rt_provider_id")) == 1

        @rt.remote(resources={"pool": 1})
        def where():
            import os

            return os.getpid()

        import os

        assert rt.get(where.remote(), timeout=60) != os.getpid()
        launcher.down()
        _wait_live(cluster, 1, timeout_s=30)
    finally:
        launcher.down()
        rt.shutdown()
    assert time.monotonic() - t0 < 30


@pytest.mark.parametrize("kind", ["local", "ssh", "gcp-tpu"])
def test_up_on_an_agent_provider_raises_not_ported(kind, monkeypatch):
    """The port's ``up`` on each provider kind starts the head and reaches
    its backend with the port's agent: ``local`` and ``gcp-tpu`` (the fake:
    a real agent process a host, with the slice labels) join an agent and
    ``down`` ends it; ``ssh`` runs the agent command on the host (recorded
    here, no ssh) and ``down`` kills its PID there.  An unknown kind is
    refused.  The name is historical: ``up`` raised ``NotPortedError`` on
    these providers until they were ported."""
    import subprocess

    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler.launcher import ClusterLauncher

    types_ = {"local": ("w", {"CPU": 1}), "ssh": ("w", {"CPU": 1}),
              "gcp-tpu": ("v5e-8", {"TPU": 8})}
    name, res = types_[kind]
    cfg = {"cluster_name": "t", "head": {"num_cpus": 1},
           "provider": {"type": kind, "zone": "z", "fake": True, "hosts": ["h1"],
                        "gang_join_timeout_s": 60},
           "available_node_types": {name: {"resources": res, "min_workers": 1,
                                           "max_workers": 1}}}
    ran = []
    if kind == "ssh":
        def fake_run(argv, **kw):
            ran.append(argv)
            return subprocess.CompletedProcess(argv, 0, stdout="4242\n", stderr="")

        monkeypatch.setattr(subprocess, "run", fake_run)
    with pytest.raises(ValueError, match="unknown provider type"):
        ClusterLauncher(dict(cfg, provider={"type": "nimbus"})).up()
    launcher = ClusterLauncher(cfg)
    try:
        launcher.up(wait_for_min_workers=kind != "ssh", timeout_s=60)
        cluster = rt.get_cluster()
        assert cluster.head_service is not None
        if kind == "ssh":
            assert "ray_tpu_torch.runtime.agent" in ran[0][-1] and "h1" in ran[0][-2]
            launcher.down()
            assert ran[-1][-1] == "kill 4242 || true"
        else:
            labels = [n.labels for n in _live(cluster) if (n.labels or {}).get("rt_provider_id")]
            assert len(labels) == 1
            if kind == "gcp-tpu":
                assert labels[0].get("ray_tpu.io/pod-type") == "v5e-8"
            launcher.down()
            _wait_live(cluster, 1, timeout_s=30)
    finally:
        launcher.down()
        if rt.is_initialized():
            rt.shutdown()


def test_agent_spawning_providers_raise_not_ported(monkeypatch):
    """Every backend that starts agents reaches its command runner with the
    port's agent: ``kubectl create`` with the pod manifest, ``gcloud ...
    tpu-vm create``, the ssh provider's remote command, the subprocess
    provider's argv.  The name is historical: each raised
    ``NotPortedError`` until the agent-spawning providers were ported."""
    import json

    from ray_tpu_torch.autoscaler.demand import NodeTypeConfig
    from ray_tpu_torch.autoscaler.gcp import GcloudCLI
    from ray_tpu_torch.autoscaler.kuberay import KubectlAPI, KubernetesNodeProvider
    from ray_tpu_torch.autoscaler.node_provider import SSHNodeProvider, SubprocessNodeProvider

    calls = []
    monkeypatch.setattr(KubectlAPI, "_run", lambda self, args, stdin=None: calls.append(
        ("kubectl", args, stdin)) or "")
    monkeypatch.setattr(GcloudCLI, "_run", lambda self, args: calls.append(("gcloud", args)) or "")
    nt = NodeTypeConfig("w", {"CPU": 1})
    kp = KubernetesNodeProvider("h:1", api=KubectlAPI())
    KubectlAPI().create_pod(kp.pod_manifest("p-1", nt))
    GcloudCLI("p").create_tpu_vm("n", "z", "v5e-8", "v", {"a/b": "c"})
    ((_, args, stdin), (_, gargs)) = calls
    assert args == ["create", "-f", "-"]
    assert "ray_tpu_torch.runtime.agent" in json.loads(stdin)["spec"]["containers"][0]["command"][-1]
    assert gargs[:5] == ["compute", "tpus", "tpu-vm", "create", "n"] and "a_b=c" in gargs
    assert "-m ray_tpu_torch.runtime.agent" in SSHNodeProvider("h:1", ["w1"]).agent_command(nt, "w1")
    assert SubprocessNodeProvider("h:1").command(nt, "proc-1")[1:3] == [
        "-m", "ray_tpu_torch.runtime.agent"]
