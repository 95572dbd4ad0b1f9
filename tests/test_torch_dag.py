"""The port's DAG layer (``ray_tpu_torch.dag``) against the JAX package's,
test by test of ``tests/test_dag.py``.

Each scenario runs once in each package (a fresh ``init(num_cpus=4)``
runtime each, as the ``ray_start_regular`` fixture makes) on the same
inputs, and returns what a caller sees: values (arrays as lists), modes,
error types, and the checks the JAX test makes, as booleans.  The test
holds the port's output to the JAX package's, and both to the JAX test's
expectations.  Where the JAX test reads a ``jax.Array``, the port's reads a
``torch.Tensor``; ``fuse="jit"`` is the port's inline tensor walk
(``dag/compiled.py``).
"""

import importlib
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

PACKAGES = ("ray_tpu", "ray_tpu_torch")


class _Side:
    """One package's modules and array type, for a scenario."""

    def __init__(self, name):
        self.name = name
        self.rt = importlib.import_module(name)
        self.dag = importlib.import_module(name + ".dag")
        self.exc = importlib.import_module(name + ".exceptions")
        self.is_jax = name == "ray_tpu"

    def array(self, value):
        if self.is_jax:
            import jax.numpy as jnp

            return jnp.asarray(value)
        return torch.as_tensor(np.asarray(value))

    def relu(self, x):
        if self.is_jax:
            import jax

            return jax.nn.relu(x)
        return torch.relu(x)

    def is_array(self, x):
        if self.is_jax:
            import jax

            return isinstance(x, jax.Array)
        return isinstance(x, torch.Tensor)

    def device(self):
        if self.is_jax:
            import jax

            return jax.devices()[0]
        return torch.device("cpu")


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().tolist()
    return np.asarray(x).tolist()


def _both(scenario, runtime=True):
    outs = {}
    for name in PACKAGES:
        side = _Side(name)
        if runtime:
            side.rt.init(num_cpus=4)
        try:
            outs[name] = scenario(side)
        finally:
            if runtime:
                side.rt.shutdown()
    return outs["ray_tpu"], outs["ray_tpu_torch"]


# --------------------------------------------------------------------------
# interpreted and compiled execution
# --------------------------------------------------------------------------
def scenario_interpreted_dag(s):
    rt, InputNode = s.rt, s.dag.InputNode

    @rt.remote
    def plus(x, y):
        return x + y

    @rt.remote
    def times(x, k):
        return x * k

    with InputNode() as inp:
        d = times.bind(plus.bind(inp, 10), 2)
    ref = d.execute(5)
    return {"ref": type(ref).__name__, "value": rt.get(ref)}


def test_interpreted_dag_matches_jax():
    jax_out, port_out = _both(scenario_interpreted_dag)
    assert port_out == jax_out == {"ref": "ObjectRef", "value": 30}


def scenario_interpreted_multi_output(s):
    rt, InputNode, MultiOutputNode = s.rt, s.dag.InputNode, s.dag.MultiOutputNode

    @rt.remote
    def double(x):
        return 2 * x

    @rt.remote
    def square(x):
        return x * x

    with InputNode() as inp:
        d = MultiOutputNode([double.bind(inp), square.bind(inp)])
    return rt.get(d.execute(3))


def test_interpreted_multi_output_matches_jax():
    jax_out, port_out = _both(scenario_interpreted_multi_output)
    assert port_out == jax_out == [6, 9]


def scenario_compiled_jit_fusion(s):
    rt, InputNode = s.rt, s.dag.InputNode

    @rt.remote
    def matmul(x, w):
        return x @ w

    @rt.remote
    def act(x):
        return s.relu(x)

    with InputNode() as inp:
        d = act.bind(matmul.bind(inp.x, inp.w))
    compiled = d.experimental_compile()
    mode = compiled.mode
    x = s.array(np.ones((4, 8), np.float32))
    w = s.array(np.full((8, 2), -1.0, np.float32))
    out = compiled.execute(x=x, w=w)
    out2 = compiled.execute(x=x, w=w)
    rng = np.random.default_rng(0)
    xr = rng.standard_normal((4, 8)).astype(np.float32)
    wr = rng.standard_normal((8, 2)).astype(np.float32)
    out3 = compiled.execute(x=s.array(xr), w=s.array(wr))
    return {"mode": mode, "out": _host(out), "is_array": s.is_array(out),
            "shape2": list(out2.shape), "random": np.asarray(_host(out3))}


def test_compiled_jit_fusion_matches_jax():
    jax_out, port_out = _both(scenario_compiled_jit_fusion)
    rand_j, rand_p = jax_out.pop("random"), port_out.pop("random")
    np.testing.assert_allclose(rand_p, rand_j, rtol=1e-5, atol=1e-6)  # f32 matmul order
    assert port_out == jax_out
    assert port_out["mode"] == "jit" and port_out["out"] == np.zeros((4, 2)).tolist()
    assert port_out["is_array"] and port_out["shape2"] == [4, 2]


def scenario_compiled_auto_fallback(s):
    rt, InputNode = s.rt, s.dag.InputNode

    @rt.remote
    def shout(text):
        return text.upper()  # not a tensor function

    with InputNode() as inp:
        d = shout.bind(inp)
    compiled = d.experimental_compile()
    return {"out": compiled.execute("hi"), "mode": compiled.mode}


def test_compiled_auto_fallback_matches_jax():
    jax_out, port_out = _both(scenario_compiled_auto_fallback)
    assert port_out == jax_out == {"out": "HI", "mode": "direct"}


def scenario_compiled_actor_direct(s):
    rt, InputNode = s.rt, s.dag.InputNode

    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def add(self, x):
            self.n += x
            return self.n

    counter = Counter.options(execution="inproc").remote()
    rt.get(counter.add.remote(0))  # wait alive
    with InputNode() as inp:
        d = counter.add.bind(inp)
    compiled = d.experimental_compile(fuse="none")
    out = {"mode": compiled.mode, "first": compiled.execute(5), "second": compiled.execute(7)}
    t0 = time.perf_counter()
    for _ in range(100):
        compiled.execute(1)
    out["fast"] = time.perf_counter() - t0 < 1.0
    out["last"] = compiled.execute(0)
    compiled.teardown()
    return out


def test_compiled_actor_direct_matches_jax():
    jax_out, port_out = _both(scenario_compiled_actor_direct)
    assert port_out == jax_out == {"mode": "direct", "first": 5, "second": 12,
                                   "fast": True, "last": 112}


def scenario_compiled_actor_serializes_with_remote_calls(s):
    rt, InputNode = s.rt, s.dag.InputNode

    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def add(self, x):
            n = self.n
            time.sleep(0)  # widen the read-modify-write window
            self.n = n + x
            return self.n

        def total(self):
            return self.n

    counter = Counter.options(execution="inproc").remote()
    rt.get(counter.total.remote())
    with InputNode() as inp:
        d = counter.add.bind(inp)
    compiled = d.experimental_compile(fuse="none")
    refs = []

    def via_remote():
        for _ in range(200):
            refs.append(counter.add.remote(1))

    t = threading.Thread(target=via_remote)
    t.start()
    for _ in range(200):
        compiled.execute(1)
    t.join()
    rt.get(refs)
    total = rt.get(counter.total.remote())
    compiled.teardown()
    return total


def test_compiled_actor_serializes_with_remote_calls_matches_jax():
    jax_out, port_out = _both(scenario_compiled_actor_serializes_with_remote_calls)
    assert port_out == jax_out == 400


def scenario_compiled_fuse_jit_rejects_actors(s):
    rt, InputNode = s.rt, s.dag.InputNode

    @rt.remote
    class A:
        def f(self, x):
            return x

    a = A.options(execution="inproc").remote()
    rt.get(a.f.remote(0))
    with InputNode() as inp:
        d = a.f.bind(inp)
    try:
        d.experimental_compile(fuse="jit")
    except ValueError as exc:
        return {"raised": "ValueError", "names_jit": "jit" in str(exc)}
    return {"raised": None}


def test_compiled_fuse_jit_rejects_actors_matches_jax():
    jax_out, port_out = _both(scenario_compiled_fuse_jit_rejects_actors)
    assert port_out == jax_out == {"raised": "ValueError", "names_jit": True}


def scenario_execute_async(s):
    rt, InputNode = s.rt, s.dag.InputNode

    @rt.remote
    def inc(x):
        return x + 1

    with InputNode() as inp:
        d = inc.bind(inp)
    compiled = d.experimental_compile(fuse="none")
    futs = [compiled.execute_async(i) for i in range(10)]
    out = [f.result() for f in futs]
    compiled.teardown()
    return out


def test_execute_async_matches_jax():
    jax_out, port_out = _both(scenario_execute_async)
    assert port_out == jax_out == list(range(1, 11))


def scenario_compiled_jit_fallback_only_on_first_trace(s):
    rt, InputNode = s.rt, s.dag.InputNode

    @rt.remote
    def double(x):
        return x * 2

    with InputNode() as inp:
        d = double.bind(inp)
    compiled = d.experimental_compile()
    out = {"mode": compiled.mode, "first": _host(compiled.execute(s.array(np.arange(3))))}

    class Poison:
        def __mul__(self, other):
            raise RuntimeError("poisoned operand")

        __rmul__ = __mul__

    try:
        compiled.execute(Poison())
        out["poison_raised"] = False
    except Exception:  # noqa: BLE001 — any error: the JAX test's pytest.raises(Exception)
        out["poison_raised"] = True
    out["mode_after"] = compiled.mode
    out["again"] = _host(compiled.execute(s.array(np.arange(3))))
    return out


def test_compiled_jit_fallback_only_on_first_trace_matches_jax():
    jax_out, port_out = _both(scenario_compiled_jit_fallback_only_on_first_trace)
    assert port_out == jax_out == {"mode": "jit", "first": [0, 2, 4], "poison_raised": True,
                                   "mode_after": "jit", "again": [0, 2, 4]}


def scenario_compiled_teardown_idempotent_and_execute_after(s):
    rt, InputNode = s.rt, s.dag.InputNode

    @rt.remote
    def inc(x):
        return x + 1

    @rt.remote
    class A:
        def m(self, x):
            return x

    out = {}
    with InputNode() as inp:
        d = inc.bind(inp)
    compiled = d.experimental_compile()
    out["jit_mode"] = compiled.mode
    compiled.teardown()
    compiled.teardown()  # idempotent
    try:
        compiled.execute(1)
    except RuntimeError as exc:
        out["jit_after"] = "torn down" in str(exc)
    a = A.options(execution="inproc").remote()
    rt.get(a.m.remote(0))
    with InputNode() as inp:
        d = a.m.bind(inp)
    direct = d.experimental_compile(fuse="none")
    out["direct_mode"] = direct.mode
    out["direct_value"] = direct.execute(7)
    direct.teardown()
    direct.teardown()
    try:
        direct.execute(1)
    except RuntimeError as exc:
        out["direct_after"] = "torn down" in str(exc)
    return out


def test_compiled_teardown_idempotent_and_execute_after_matches_jax():
    jax_out, port_out = _both(scenario_compiled_teardown_idempotent_and_execute_after)
    assert port_out == jax_out == {"jit_mode": "jit", "jit_after": True, "direct_mode": "direct",
                                   "direct_value": 7, "direct_after": True}


def scenario_compiled_actor_kill_surfaces_immediately(s):
    rt, InputNode, ActorDiedError = s.rt, s.dag.InputNode, s.exc.ActorDiedError

    @rt.remote
    class Slow:
        def snooze(self, sec):
            time.sleep(sec)
            return sec

        def quick(self, x):
            return x

    a = Slow.options(execution="inproc").remote()
    rt.get(a.quick.remote(0))
    with InputNode() as inp:
        d = a.quick.bind(inp)
    compiled = d.experimental_compile(fuse="none")
    a.snooze.remote(5.0)  # occupy the actor thread: the direct call stays QUEUED
    time.sleep(0.1)
    out = {}

    def run():
        t0 = time.perf_counter()
        try:
            compiled.execute(1)
        except ActorDiedError:
            out["latency"] = time.perf_counter() - t0

    t = threading.Thread(target=run, daemon=True)
    t.start()
    time.sleep(0.2)
    t_kill = time.perf_counter()
    rt.kill(a)
    t.join(3)
    surfaced = "latency" in out
    prompt = time.perf_counter() - t_kill < 0.5
    compiled.teardown()
    return {"surfaced": surfaced, "prompt": prompt}


def test_compiled_actor_kill_surfaces_immediately_matches_jax():
    jax_out, port_out = _both(scenario_compiled_actor_kill_surfaces_immediately)
    assert port_out == jax_out == {"surfaced": True, "prompt": True}


# --------------------------------------------------------------------------
# channels (no runtime)
# --------------------------------------------------------------------------
def scenario_channel_close_while_blocked_stress(s):
    Channel, ChannelClosed = s.dag.Channel, s.dag.ChannelClosed
    channels = [Channel() for _ in range(8)]
    for ch in channels[4:]:
        ch.write("occupied")  # writers on these will block on the full slot
    results = []
    lock = threading.Lock()

    def blocked_reader(ch):
        try:
            ch.read(timeout=10)
            outcome = "value"
        except ChannelClosed:
            outcome = "closed"
        with lock:
            results.append(outcome)

    def blocked_writer(ch):
        try:
            ch.write("late", timeout=10)
            outcome = "wrote"
        except ChannelClosed:
            outcome = "closed"
        with lock:
            results.append(outcome)

    threads = [threading.Thread(target=blocked_reader, args=(ch,), daemon=True)
               for ch in channels[:4]]
    threads += [threading.Thread(target=blocked_writer, args=(ch,), daemon=True)
                for ch in channels[4:]]
    for t in threads:
        t.start()
    time.sleep(0.1)
    t0 = time.perf_counter()
    for ch in channels:
        ch.close()
    for t in threads:
        t.join(5)
    return {"prompt": time.perf_counter() - t0 < 2.0, "closed": results.count("closed")}


def test_channel_close_while_blocked_stress_matches_jax():
    jax_out, port_out = _both(scenario_channel_close_while_blocked_stress, runtime=False)
    assert port_out == jax_out == {"prompt": True, "closed": 8}


def scenario_device_channel_places_after_slot_acquired(s):
    placed = []

    class CountingChannel(s.dag.DeviceChannel):
        def _place(self, value):
            placed.append(True)
            return super()._place(value)

    ch = CountingChannel(s.device())
    ch.write(s.array(np.arange(4)))
    out = {"after_first": len(placed)}
    done = threading.Event()

    def second_write():
        ch.write(s.array(np.arange(4)))
        done.set()

    t = threading.Thread(target=second_write, daemon=True)
    t.start()
    time.sleep(0.1)
    # the writer is blocked on the full slot: placement must NOT have happened
    out["while_blocked"] = (len(placed), done.is_set())
    ch.read()
    t.join(2)
    out["after_read"] = (len(placed), done.is_set())
    got = ch.read()
    out["value"] = _host(got)
    out["is_array"] = s.is_array(got)
    return out


def test_device_channel_places_after_slot_acquired_matches_jax():
    jax_out, port_out = _both(scenario_device_channel_places_after_slot_acquired, runtime=False)
    assert port_out == jax_out == {"after_first": 1, "while_blocked": (1, False),
                                   "after_read": (2, True), "value": [0, 1, 2, 3],
                                   "is_array": True}


def scenario_channel_roundtrip(s):
    ch = s.dag.Channel()
    out = []
    t = threading.Thread(target=lambda: out.append(ch.read()))
    t.start()
    ch.write(42)
    t.join(2)
    ch.close()
    try:
        ch.read()
        closed = False
    except s.dag.ChannelClosed:
        closed = True
    return {"read": out, "closed": closed}


def test_channel_roundtrip_matches_jax():
    jax_out, port_out = _both(scenario_channel_roundtrip, runtime=False)
    assert port_out == jax_out == {"read": [42], "closed": True}


def scenario_device_channel(s):
    ch = s.dag.DeviceChannel(s.device())
    ch.write(s.array(np.arange(4)))
    got = ch.read()
    return {"value": _host(got), "is_array": s.is_array(got)}


def test_device_channel_matches_jax():
    jax_out, port_out = _both(scenario_device_channel, runtime=False)
    assert port_out == jax_out == {"value": [0, 1, 2, 3], "is_array": True}


# --------------------------------------------------------------------------
# the port's own
# --------------------------------------------------------------------------
def test_bind_round_trip_builds_the_jax_node_types():
    """``.bind`` on a remote function and on an actor method builds the
    same node types, with the same arguments and traversal order, in both
    packages; interpreted, the graph gives the same value."""
    def scenario(s):
        rt, dag = s.rt, s.dag

        @rt.remote
        def f(x, k=1):
            return x * k

        @rt.remote
        class A:
            def g(self, x, y):
                return x - y

        a = A.options(execution="inproc").remote()
        with dag.InputNode() as inp:
            first = f.bind(inp.x, k=3)
            d = dag.MultiOutputNode([a.g.bind(first, inp.y), f.bind(first)])
        order = [type(n).__name__ for n in d.topological()]
        method = next(n for n in d.topological() if isinstance(n, dag.ClassMethodNode))
        return {"order": order, "method": method.method_name,
                "kwargs": sorted(first._bound_kwargs), "value": rt.get(d.execute(x=2, y=1))}

    jax_out, port_out = _both(scenario)
    assert port_out == jax_out
    assert port_out["value"] == [5, 6] and port_out["method"] == "g"


def test_inline_walk_refuses_values_that_are_not_tensors():
    """``fuse="jit"`` holds inputs and node results to tensors, numbers and
    containers of them: a string is refused with ``TypeError`` on the first
    walk (``fuse="auto"`` falls back on it instead)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import InputNode

    rt.init(num_cpus=2)
    try:
        @rt.remote
        def tag(x):
            return "tagged"

        with InputNode() as inp:
            d = tag.bind(inp)
        strict = d.experimental_compile(fuse="jit")
        with pytest.raises(TypeError, match="tagged|str"):
            strict.execute(torch.ones(2))
        auto = d.experimental_compile()
        assert auto.execute(torch.ones(2)) == "tagged" and auto.mode == "direct"
    finally:
        rt.shutdown()


# --------------------------------------------------------------------------
# the gang's split and assemble (parallel/mesh.py)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n,axis", [(2, 0), (4, 1), (1, 0)])
def test_split_for_group_and_assemble_match_jax(n, axis):
    """``split_for_group`` gives the JAX function's parts, and
    ``assemble_from_group`` with no mesh (or a layout-only mesh of the
    member count) gives the JAX function's whole array."""
    import jax
    from jax.sharding import Mesh as JaxMesh

    from ray_tpu.parallel import mesh as jmesh
    from ray_tpu_torch.parallel import mesh as tmesh

    x = np.random.default_rng(n).standard_normal((8, 12)).astype(np.float32)
    jparts = jmesh.split_for_group(jax.numpy.asarray(x), n, axis=axis)
    tparts = tmesh.split_for_group(torch.as_tensor(x), n, axis=axis)
    assert [tuple(p.shape) for p in tparts] == [tuple(p.shape) for p in jparts]
    for jp, tp in zip(jparts, tparts):
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tmesh.assemble_from_group(tparts, axis=axis).numpy(),
                                  np.asarray(jmesh.assemble_from_group(jparts, axis=axis)))
    if n > 1:
        jm = JaxMesh(np.array(jax.devices()[:n]), ("dp",))
        tm = tmesh.Mesh(np.arange(n), ("dp",))  # a layout: no process group here
        np.testing.assert_array_equal(
            tmesh.assemble_from_group(tparts, mesh=tm, axis=axis).numpy(),
            np.asarray(jmesh.assemble_from_group(jparts, mesh=jm, axis=axis)))
    with pytest.raises(ValueError):
        tmesh.split_for_group(torch.zeros(6, 4), 4)
    with pytest.raises(ValueError):
        tmesh.assemble_from_group([])


def _assemble_on_a_rank():
    """One rank of two: the gang's parts assembled under a mesh over the
    process group are this rank's block."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import mesh as tmesh

    m = tmesh.Mesh(np.arange(2), ("dp",))
    parts = tmesh.split_for_group(torch.arange(8.0).reshape(4, 2), 2)
    return dist.get_rank(), tmesh.assemble_from_group(parts, mesh=m).tolist()


def test_assemble_from_group_gives_each_rank_its_block(tmp_path):
    from ray_tpu_torch.parallel import run_ranks

    out = run_ranks(_assemble_on_a_rank, 2, timeout_s=120,
                    address="file://" + str(tmp_path / "store"))
    assert out == [(0, [[0.0, 1.0], [2.0, 3.0]]), (1, [[4.0, 5.0], [6.0, 7.0]])]
