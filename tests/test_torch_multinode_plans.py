"""The port's compiled plans with stages on a node agent, and the device
envelope across processes, against the JAX package's.

The JAX scenarios are ``test_plans.py:345``
(``test_plan_install_and_execute_across_processes``: two of four stages in
an agent's process, 100 iterations with no TaskSpec, pipelined executes,
a reinstall after teardown) and ``:403``
(``test_plan_agent_kill9_yields_typed_error_and_broken``).  Each runs as
written against the JAX head and a JAX agent and ported
(``tests/torch_multinode.py``) against the port's head and agent on the
CPU.

``test_device_plane.py:222`` (a device array made by a task on an agent
reaches the driver and a peer task through the device envelope) uses
``jnp`` in its tasks, so its body cannot be bound mechanically: it runs as
written for the JAX package, and the port's counterpart below makes a CPU
tensor on the agent and holds the same facts.
"""

import pytest
from torch_multinode import PACKAGES, helper_module, run_case, two_process_cluster

torch = pytest.importorskip("torch")

PLAN_CASES = ["test_plan_install_and_execute_across_processes",
              "test_plan_agent_kill9_yields_typed_error_and_broken"]


def test_the_scenarios_are_in_the_jax_files():
    import test_device_plane as jax_dp
    import test_plans as jax_plans

    assert all(callable(getattr(jax_plans, n)) for n in PLAN_CASES)
    assert callable(jax_dp.test_device_array_crosses_processes_without_host_pickle)


@pytest.mark.parametrize("case", PLAN_CASES)
@pytest.mark.parametrize("pkg", PACKAGES)
def test_plan_across_processes_case(case, pkg, request):
    run_case("test_plans", case, pkg, request,
             modules={"test_multihost": helper_module(pkg)})


def test_device_array_crosses_processes_jax(request):
    run_case("test_device_plane", "test_device_array_crosses_processes_without_host_pickle",
             "ray_tpu", request)


def test_tensor_crosses_processes_without_host_pickle():
    """The port's counterpart: a 4 MB CPU tensor made by a task on the agent
    reaches the driver as a tensor rebuilt by the envelope (its bytes out of
    band, never through the pickle stream), and a peer task on the agent
    receives a tensor too.  The object store's device tier takes CUDA
    tensors only, so the directory does not mark a CPU tensor as
    device-resident (the JAX package's marks every ``jax.Array``)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.runtime import device_plane

    with two_process_cluster("ray_tpu_torch") as (cluster, _proc):

        @rt.remote(resources={"remote": 1})
        def produce():
            import torch as _torch

            return _torch.arange(1_000_000, dtype=_torch.float32) + 1.0

        @rt.remote(resources={"remote": 1})
        def norm(x):
            import os

            import torch as _torch

            assert isinstance(x, _torch.Tensor), f"consumer got {type(x)}, not a tensor"
            return float(x.max()), os.getpid()

        restored_before = device_plane.stats.snapshot()["arrays_restored"]
        ref = produce.remote()
        arr = rt.get(ref, timeout=120)
        assert isinstance(arr, torch.Tensor), type(arr)
        assert float(arr[0]) == 1.0 and float(arr[-1]) == 1_000_000.0
        assert device_plane.stats.snapshot()["arrays_restored"] > restored_before
        peak, pid = rt.get(norm.remote(ref), timeout=120)
        assert peak == 1_000_000.0
        import os

        assert pid != os.getpid()
        assert not cluster.directory.is_device(ref.id())


def test_stage_push_failure_breaks_plan_with_typed_error():
    """A driver stage whose push into an agent fails (the agent was killed,
    its node's death sweep has not yet run) breaks the plan with
    ``WorkerCrashedError``, the transport error chained, so the pending
    execute gets the typed error too (ROADMAP Queue 3, F28: the raw
    ``DataPlaneError`` reached the drainer first under load).  The stage
    executor's ``on_broken`` is the hook the stage loop calls."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.exceptions import WorkerCrashedError
    from ray_tpu_torch.runtime.data_plane import DataPlaneError

    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=2)
    try:

        @rt.remote
        class Stage:
            def step(self, x):
                return x + 1

        a, b = (Stage.options(execution="inproc").remote() for _ in range(2))
        with InputNode() as inp:
            d = b.step.bind(a.step.bind(inp))
        plan = d.compile_plan()
        assert plan.execute(0) == 2
        raw = DataPlaneError("channel push to 127.0.0.1:1 failed: [Errno 32] Broken pipe")
        plan._executor._on_broken(raw)
        assert plan.state == "BROKEN"
        with pytest.raises(WorkerCrashedError) as info:
            plan.execute(1)
        assert info.value.__cause__ is not None and "Broken pipe" in str(info.value)
        plan.teardown()
    finally:
        rt.shutdown()
