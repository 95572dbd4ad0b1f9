"""The port's actor collective groups (``ray_tpu_torch.parallel.collective``
layer 2 and ``ray_tpu_torch.util.collective``) against the JAX package's:
``tests/test_parallel.py`` (the two actor-group cases),
``tests/test_util_workflow.py`` (the three collective cases) and
``tests/test_collective_transport.py::test_local_mixed_group_no_agent``.

Each scenario runs once in each package on the same numpy inputs, under a
fresh runtime of that package (``init(num_cpus=4)``) where the JAX test has
one; values compare exactly (sums of small integers in f32 and f64).
"""

import importlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _both(scenario, runtime=True):
    outs = {}
    for name in PACKAGES:
        rt = importlib.import_module(name)
        if runtime:
            rt.init(num_cpus=4)
        try:
            outs[name] = scenario(name)
        finally:
            if runtime:
                rt.shutdown()
    return outs["ray_tpu"], outs["ray_tpu_torch"]


def _threads(fn, n):
    threads = [threading.Thread(target=fn, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)


def _plain(v):
    if isinstance(v, torch.Tensor):
        return ("tensor", v.tolist())
    if isinstance(v, np.ndarray) or type(v).__module__.startswith("jax"):
        return ("array", np.asarray(v).tolist())
    if isinstance(v, list):
        return [_plain(x) for x in v]
    return v


# --------------------------------------------------------------------------
# tests/test_parallel.py
# --------------------------------------------------------------------------
def scenario_actor_collective_group(pkg):
    collective = importlib.import_module(pkg + ".parallel.collective")
    collective.init_collective_group(world_size=4, rank=0, group_name="g1")
    results = {}

    def participant(rank):
        collective.init_collective_group(4, rank, group_name="g1")
        out = collective.allreduce_tensor(np.full((4,), float(rank + 1)), rank, "g1")
        results[rank] = np.asarray(out).tolist()

    _threads(participant, 4)
    collective.destroy_collective_group("g1")
    return results


def test_actor_collective_group_matches_jax():
    j, p = _both(scenario_actor_collective_group, runtime=False)
    assert p == j == {r: [10.0] * 4 for r in range(4)}  # 1+2+3+4


def scenario_broadcast_and_gather(pkg):
    collective = importlib.import_module(pkg + ".parallel.collective")
    results = {}

    def participant(rank):
        collective.init_collective_group(3, rank, group_name="g2")
        results[rank] = (
            collective.broadcast_tensor(rank * 10, rank, src_rank=1, group_name="g2"),
            collective.allgather_tensor(rank, rank, group_name="g2"),
        )

    _threads(participant, 3)
    collective.destroy_collective_group("g2")
    return results


def test_actor_collective_broadcast_and_gather_matches_jax():
    j, p = _both(scenario_broadcast_and_gather, runtime=False)
    assert p == j == {r: (10, [0, 1, 2]) for r in range(3)}


# --------------------------------------------------------------------------
# tests/test_util_workflow.py
# --------------------------------------------------------------------------
def scenario_allreduce_threads(pkg):
    col = importlib.import_module(pkg + ".util.collective")
    col.init_collective_group(world_size=4, rank=0, group_name="g1")
    results = {}

    def worker(rank):
        results[rank] = _plain(col.allreduce(np.full(4, rank + 1.0), group_name="g1", rank=rank))

    _threads(worker, 4)
    col.destroy_collective_group("g1")
    return results


def test_collective_allreduce_threads_matches_jax():
    j, p = _both(scenario_allreduce_threads)
    assert p == j == {r: ("array", [10.0] * 4) for r in range(4)}


def scenario_send_recv(pkg):
    col = importlib.import_module(pkg + ".util.collective")
    out = {}

    def sender():
        col.send(np.arange(3), dst_rank=1, group_name="p2p", rank=0)

    def receiver():
        out["v"] = _plain(col.recv(src_rank=0, group_name="p2p", rank=1, timeout=10))

    t1, t2 = threading.Thread(target=sender), threading.Thread(target=receiver)
    t2.start()
    t1.start()
    t1.join()
    t2.join()
    return out


def test_collective_send_recv_matches_jax():
    j, p = _both(scenario_send_recv)
    assert p == j == {"v": ("array", [0, 1, 2])}


def scenario_collective_in_actors(pkg):
    rt = importlib.import_module(pkg)
    col = importlib.import_module(pkg + ".util.collective")
    col.init_collective_group(world_size=3, rank=0, group_name="ag")

    class Member:
        def __init__(self, rank):
            self.rank = rank

        def gather(self, value):
            return col.allgather(value, group_name="ag", rank=self.rank)

    members = [rt.remote(Member).options(execution="inproc").remote(r) for r in range(3)]
    outs = rt.get([m.gather.remote(i * 10) for i, m in enumerate(members)])
    col.destroy_collective_group("ag")
    return outs


def test_collective_in_actors_matches_jax():
    j, p = _both(scenario_collective_in_actors)
    assert p == j == [[0, 10, 20]] * 3


# --------------------------------------------------------------------------
# tests/test_collective_transport.py::test_local_mixed_group_no_agent
# --------------------------------------------------------------------------
def scenario_local_mixed_group(pkg):
    """A thread actor (driver process) and a process actor (spawned
    worker) share a group: the thread rank's first collective can run
    before the worker spawns, and its unproven in-process wait must
    re-route onto the data-plane transport mid-round."""
    rt = importlib.import_module(pkg)
    collective = importlib.import_module(pkg + ".util.collective")

    class T:
        def __init__(self, rank):
            collective.init_collective_group(2, rank, group_name="lmix")
            self.rank = rank

        def step(self, x):
            out = collective.allreduce(np.array([x], np.float32), group_name="lmix",
                                       rank=self.rank)
            return np.asarray(out).tolist()

    class P:
        def __init__(self, rank, pkg):
            import importlib as _il

            self.col = _il.import_module(pkg + ".util.collective")
            self.col.init_collective_group(2, rank, group_name="lmix")
            self.rank = rank

        def step(self, x):
            import numpy as _np

            out = self.col.allreduce(_np.array([x], _np.float32), group_name="lmix",
                                     rank=self.rank)
            return _np.asarray(out).tolist()

    t = rt.remote(T).options(execution="thread").remote(0)
    p = rt.remote(P).options(execution="process").remote(1, pkg)
    a, b = t.step.remote(1.0), p.step.remote(2.0)
    first = [rt.get(a, timeout=90), rt.get(b, timeout=90)]
    # the second round rides the latched transport route
    a2, b2 = t.step.remote(10.0), p.step.remote(20.0)
    second = [rt.get(a2, timeout=90), rt.get(b2, timeout=90)]
    routing = collective._registry.get("lmix").routing
    return {"first": first, "second": second, "routing": routing}


def test_local_mixed_group_no_agent_matches_jax():
    j, p = _both(scenario_local_mixed_group)
    assert p == j == {"first": [[3.0], [3.0]], "second": [[30.0], [30.0]],
                      "routing": "transport"}


# --------------------------------------------------------------------------
# a rank's death fails the others' waits at once (the death notice)
# --------------------------------------------------------------------------
def scenario_rank_death_notice(pkg):
    """A thread actor and a process actor bound by
    ``create_collective_group``: the thread rank waits in an allreduce on
    the transport; the process rank's worker is SIGKILLed; the wait ends
    with ``CollectiveGroupDeadError`` (the cluster's death notice), not at
    the collective timeout."""
    import os
    import signal
    import time

    rt = importlib.import_module(pkg)
    col = importlib.import_module(pkg + ".util.collective")

    class T:
        def step(self, x):
            try:
                out = col.allreduce(np.array([x], np.float32), group_name="dead")
                return ("ok", np.asarray(out).tolist())
            except Exception as exc:  # noqa: BLE001 - the error is the output
                return (type(exc).__name__,)

    class P:
        def pid(self):
            import os as _os

            return _os.getpid()

    t = rt.remote(T).options(execution="thread").remote()
    p = rt.remote(P).options(execution="process").remote()
    pid = rt.get(p.pid.remote(), timeout=60)
    col.create_collective_group([t, p], 2, [0, 1], group_name="dead")
    ref = t.step.remote(1.0)
    time.sleep(1.0)  # rank 0 is waiting for rank 1's contribution
    t0 = time.monotonic()
    os.kill(pid, signal.SIGKILL)
    out = rt.get(ref, timeout=60)
    return {"out": out, "fast": time.monotonic() - t0 < 10}


def test_rank_death_fails_the_group_at_once_matches_jax():
    j, p = _both(scenario_rank_death_notice)
    assert p == j == {"out": ("CollectiveGroupDeadError",), "fast": True}


# --------------------------------------------------------------------------
# the port's own: tensors reduce on their device, in member order
# --------------------------------------------------------------------------
def test_tensor_allreduce_is_the_member_order_sum_on_the_tensors_device():
    """In-process ranks reduce torch tensors where they lie (the card on a
    GPU: ``tests/test_torch_cuda.py -k trainer``): the result is bitwise
    ``t0 + t1 + t2``, a tensor, shared by every rank; ``max`` and
    ``reducescatter`` keep tensors too."""
    from ray_tpu_torch.parallel import collective

    g = torch.Generator().manual_seed(3)
    xs = [torch.randn(1000, generator=g) for _ in range(3)]
    got = {}

    def rank(r):
        collective.init_collective_group(3, r, group_name="tsum")
        got[r] = (collective.allreduce_tensor(xs[r], r, "tsum"),
                  collective.allreduce_tensor(xs[r], r, "tsum", op="max"),
                  collective.reducescatter_tensor(xs[r][:999], r, "tsum"))

    _threads(rank, 3)
    collective.destroy_collective_group("tsum")
    want = xs[0] + xs[1] + xs[2]
    for r in range(3):
        total, top, chunk = got[r]
        assert isinstance(total, torch.Tensor) and torch.equal(total, want)
        assert torch.equal(top, torch.stack(xs).amax(0))
        assert torch.equal(chunk, (xs[0][:999] + xs[1][:999] + xs[2][:999])[r * 333:(r + 1) * 333])


def test_util_exports_collective_as_jax_does():
    import ray_tpu.util as jutil

    import ray_tpu_torch.util as tutil

    assert sorted(tutil.__all__) == sorted(jutil.__all__)
    assert "collective" in tutil.__all__
    assert sorted(tutil.collective.__all__) == sorted(jutil.collective.__all__)


def test_rendezvous_via_cluster_publishes_rank0s_address():
    """``rendezvous_via_cluster`` over the control KV: rank 0 publishes a
    loopback ``host:port`` (one host) and the other ranks read it; the
    address is ``initialize``'s ``coordinator_address``."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.parallel.distributed import rendezvous_via_cluster

    rt.init(num_cpus=2)
    try:
        got = {}

        def rank(r):
            got[r] = rendezvous_via_cluster(r, 3, group_name="gang-x", timeout_s=10)

        _threads(rank, 3)
    finally:
        rt.shutdown()
    addr = got[0][0]
    host, port = addr.rsplit(":", 1)
    assert host == "127.0.0.1" and int(port) > 0
    assert got == {r: (addr, 3, r) for r in range(3)}
    with pytest.raises(RuntimeError, match="init"):
        rendezvous_via_cluster(0, 1)


def test_agent_kv_waits_for_the_multi_node_runtime():
    from ray_tpu_torch.exceptions import NotPortedError
    from ray_tpu_torch.runtime import kv_client

    with pytest.raises(NotPortedError):
        kv_client.register_agent_kv(object())
    with pytest.raises(NotPortedError):
        kv_client._RpcKV(object())
    assert kv_client.head_peer_ip() is None and kv_client.get_kv() is None
