"""The port's autoscaler (``ray_tpu_torch.autoscaler``) against the JAX
package's.

Every case of ``test_autoscaler.py``, ``test_kuberay_provider.py`` and
``test_gcp_tpu_provider.py`` (with their fake ``kubectl`` / ``gcloud``
runners), and ``test_cluster_launcher.py:81`` and ``:88``, runs here
through both packages: the JAX test's own body, once as written and once
with its module globals and imports bound to the port's (``ray_tpu`` ->
``ray_tpu_torch``; the agent module a provider ships names the port's).
``demand.get_nodes_to_launch`` gives equal outputs in both on the same
inputs, drawn from one numpy seed.  Left out: the cases marked ``full``,
whose nodes are real node agents (ROADMAP item 10):
``test_cluster_launcher.py:42`` and ``test_gcp_tpu_provider.py:111``; the
port's ``up`` on each agent-spawning provider raises ``NotPortedError``.
"""

import importlib
import inspect

import numpy as np
import pytest
from torch_ported import ported

torch = pytest.importorskip("torch")

import test_autoscaler as jax_autoscaler  # noqa: E402
import test_cluster_launcher as jax_launcher  # noqa: E402
import test_gcp_tpu_provider as jax_gcp  # noqa: E402
import test_kuberay_provider as jax_kuberay  # noqa: E402

PACKAGES = ("ray_tpu", "ray_tpu_torch")
#: string constants of the JAX tests that name the JAX package's modules
PORT_STRINGS = {"ray_tpu.runtime.agent": "ray_tpu_torch.runtime.agent"}


def _cases(module):
    return [(module, n) for n in sorted(vars(module)) if n.startswith("test_")
            and not any(m.name == "full" for m in getattr(getattr(module, n), "pytestmark", []))]


CASES = (_cases(jax_autoscaler) + _cases(jax_kuberay) + _cases(jax_gcp)
         + [(jax_launcher, "test_config_validation"),
            (jax_launcher, "test_ssh_provider_command_shape")])
NEEDS_ITEM_10 = {("test_cluster_launcher", "test_up_provisions_min_workers_and_down_terminates"),
                 ("test_gcp_tpu_provider", "test_rt_up_gcp_tpu_fake_full_lifecycle")}


def test_left_out_cases_are_the_agent_ones():
    full = {(m.__name__, n) for m in (jax_autoscaler, jax_kuberay, jax_gcp, jax_launcher)
            for n in vars(m) if n.startswith("test_")
            and any(x.name == "full" for x in getattr(getattr(m, n), "pytestmark", []))}
    assert full == NEEDS_ITEM_10


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", [f"{m.__name__}::{n}" for m, n in CASES])
def test_reference_case_through_both_packages(case, pkg, tmp_path):
    mod_name, fn_name = case.split("::")
    fn = getattr(importlib.import_module(mod_name), fn_name)
    if pkg == "ray_tpu_torch":
        fn = ported(fn, lambda c: PORT_STRINGS.get(c, c))
    params = inspect.signature(fn).parameters
    kw = {}
    if "tmp_path" in params:
        kw["tmp_path"] = tmp_path
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


@pytest.mark.parametrize("kind", ["local", "ssh", "gcp-tpu"])
def test_up_on_an_agent_provider_raises_not_ported(kind, tmp_path):
    import json

    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler.launcher import ClusterLauncher
    from ray_tpu_torch.exceptions import NotPortedError

    cfg = {"cluster_name": "t", "provider": {"type": kind, "zone": "z", "fake": True},
           "head": {"num_cpus": 2},
           "available_node_types": {"w": {"resources": {"CPU": 1}, "min_workers": 1}}}
    with pytest.raises(NotPortedError, match="item 10"):
        ClusterLauncher(cfg).up()
    assert not rt.is_initialized()  # refused before anything started
    with pytest.raises(ValueError, match="unknown provider type"):
        ClusterLauncher(dict(cfg, provider={"type": "nimbus"})).up()
    path = tmp_path / "cluster.yaml"  # YAML in its JSON form
    path.write_text(json.dumps(cfg))
    from ray_tpu_torch.scripts import cli

    with pytest.raises(NotPortedError, match="item 10"):
        cli.main(["up", str(path)])


def test_agent_spawning_providers_raise_not_ported():
    from ray_tpu_torch.autoscaler.demand import NodeTypeConfig
    from ray_tpu_torch.autoscaler.gcp import FakeGcloudTpuAPI, GcloudCLI, GcpTpuNodeProvider
    from ray_tpu_torch.autoscaler.kuberay import KubectlAPI
    from ray_tpu_torch.autoscaler.node_provider import SSHNodeProvider, SubprocessNodeProvider
    from ray_tpu_torch.exceptions import NotPortedError

    nt = NodeTypeConfig("w", {"CPU": 1})
    for call in (lambda: SubprocessNodeProvider("h:1").create_nodes(nt, 1),
                 lambda: SSHNodeProvider("h:1", ["w1"]).create_nodes(nt, 1),
                 lambda: KubectlAPI().create_pod({}),
                 lambda: GcloudCLI("p").create_tpu_vm("n", "z", "v5e-8", "v", {}),
                 lambda: GcpTpuNodeProvider("h:1", zone="z", api=FakeGcloudTpuAPI()).create_nodes(
                     NodeTypeConfig("v5e-8", {"TPU": 8.0}), 1)):
        with pytest.raises(NotPortedError, match="item 10"):
            call()
