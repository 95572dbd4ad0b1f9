"""The chaos schedules of ``tests/test_chaos.py`` left for the multi-node
runtime, through both packages.

The JAX scenarios are ``test_schedule_heartbeat_partition_during_actor_calls``
(``:305``, a real agent under ``agent.heartbeat=drop(0.7)``),
``test_schedule_relay_node_kill_mid_broadcast`` (``:429``),
``test_schedule_relay_node_drain_mid_broadcast`` (``:607``),
``test_schedule_plan_stage_node_kill_auto_repair`` (``:807``) and
``test_schedule_full_elasticity_byte_identical_through_restart`` (``:913``).
Each runs as written against the JAX package and ported
(``tests/torch_multinode.py``: the agent it spawns is the port's) against
the port on the CPU.  Each body runs its schedule twice on the same seed
and holds the two fault logs to each other (entry by entry, or on the hit
range both runs reached for the time-driven heartbeat failpoint), so the
same-seed logs agree within each package.
"""

import importlib

import pytest
from torch_multinode import PACKAGES, run_case

torch = pytest.importorskip("torch")

SCHEDULES = ["test_schedule_heartbeat_partition_during_actor_calls",
             "test_schedule_relay_node_kill_mid_broadcast",
             "test_schedule_relay_node_drain_mid_broadcast",
             "test_schedule_plan_stage_node_kill_auto_repair",
             "test_schedule_full_elasticity_byte_identical_through_restart"]


@pytest.fixture(autouse=True)
def _clean_failpoints():
    """``test_chaos.py``'s autouse fixture, for both packages."""
    for name in PACKAGES:
        importlib.import_module(name + ".runtime.failpoints").reset()
    yield
    for name in PACKAGES:
        importlib.import_module(name + ".runtime.failpoints").reset()


def test_the_schedules_are_in_the_jax_file():
    import test_chaos as jax_chaos

    assert all(callable(getattr(jax_chaos, n)) for n in SCHEDULES)


@pytest.mark.parametrize("case", SCHEDULES)
@pytest.mark.parametrize("pkg", PACKAGES)
def test_schedule_case(case, pkg, request):
    run_case("test_chaos", case, pkg, request)
