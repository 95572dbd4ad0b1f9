"""The port's parallel layer against the JAX package's.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``,
its SPMD functions inside ``shard_map``; the port runs as spawned gloo ranks
on the CPU (one process a rank, ``ray_tpu_torch.parallel.run_ranks``), the
flash kernels on their plain versions. Same numpy inputs on both sides, f32.
Each spawn runs every check that shares its rank count, and joins within a
deadline. Limits: the collectives' values and gradients atol 1e-6 (sums of
a few f32 numbers), ring attention's forward 2e-5 and gradients 5e-4 and
Ulysses' 2e-5 (``tests/test_parallel.py``'s own), the pipeline's values
atol 1e-5 and gradients rtol 1e-4 / atol 1e-5 (the same).

JAX is imported inside the functions that use it: the spawned ranks import
this module to find their function, and must not load JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ray_tpu_torch.parallel import (  # noqa: E402
    MeshManager,
    collective as C,
    gather_array,
    multihost_mesh,
    pipeline_sharded,
    ring_attention_sharded,
    run_ranks,
    ulysses_attention_sharded,
)

DEADLINE_S = 150.0
_rng = np.random.default_rng(0)
X = _rng.standard_normal((16, 3)).astype(np.float32)        # [4 ranks x 4, 3]
QKV = _rng.standard_normal((3, 1, 4, 64, 32)).astype(np.float32)
PIPE_W = (_rng.standard_normal((4, 8, 8)) * 0.3).astype(np.float32)
PIPE_X = _rng.standard_normal((4, 2, 8)).astype(np.float32)

# name -> (port function of (x_local), JAX function of (x_local)) factories
PERM = [(0, 2), (2, 1), (1, 3), (3, 0)]
OPS = ("allreduce", "allreduce_mean", "allgather", "allgather_axis1", "allgather_untiled",
       "reducescatter", "broadcast", "ppermute", "send_recv", "all_to_all",
       "all_to_all_untiled")


def _port_op(name, x):
    return {
        "allreduce": lambda: C.allreduce(x, "x"),
        "allreduce_mean": lambda: C.allreduce_mean(x, "x"),
        "allgather": lambda: C.allgather(x, "x"),
        "allgather_axis1": lambda: C.allgather(x, "x", axis=1),
        "allgather_untiled": lambda: C.allgather(x, "x", tiled=False),
        "reducescatter": lambda: C.reducescatter(x, "x"),
        "broadcast": lambda: C.broadcast(x, "x", root=2),
        "ppermute": lambda: C.ppermute(x, "x", PERM),
        "send_recv": lambda: C.send_recv(x, "x", shift=1),
        "all_to_all": lambda: C.all_to_all(x, "x", 0, 1),
        "all_to_all_untiled": lambda: C.all_to_all(x, "x", 0, 1, tiled=False),
    }[name]()


def _jax_op(name, x):
    from ray_tpu.parallel import collective as J

    return {
        "allreduce": lambda: J.allreduce(x, "x"),
        "allreduce_mean": lambda: J.allreduce_mean(x, "x"),
        "allgather": lambda: J.allgather(x, "x"),
        "allgather_axis1": lambda: J.allgather(x, "x", axis=1),
        "allgather_untiled": lambda: J.allgather(x, "x", tiled=False),
        "reducescatter": lambda: J.reducescatter(x, "x"),
        "broadcast": lambda: J.broadcast(x, "x", root=2),
        "ppermute": lambda: J.ppermute(x, "x", PERM),
        "send_recv": lambda: J.send_recv(x, "x", shift=1),
        "all_to_all": lambda: J.all_to_all(x, "x", 0, 1),
        "all_to_all_untiled": lambda: J.all_to_all(x, "x", 0, 1, tiled=False),
    }[name]()


def _cotangent(shape):
    return np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------------------
# rank functions (run in the spawned ranks)
# --------------------------------------------------------------------------
def _ring_checks(n):
    """Ring attention (causal and not) and Ulysses on an sp mesh of n
    ranks: the gathered output and the full q/k/v gradients of sum(out^2)."""
    import torch.distributed as dist

    mesh = MeshManager().create_mesh({"sp": n})
    q, k, v = (torch.from_numpy(a) for a in QKV)
    out = {}
    for name, fn in (("ring_causal", lambda *a: ring_attention_sharded(*a, mesh, "sp")),
                     ("ring_noncausal",
                      lambda *a: ring_attention_sharded(*a, mesh, "sp", causal=False)),
                     ("ulysses", lambda *a: ulysses_attention_sharded(*a, mesh, "sp"))):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*ins)
        torch.sum(o.float() ** 2).backward()
        with mesh:
            grads = [C.allreduce(t.grad, "sp") for t in ins]  # each rank's share summed
        out[name] = (gather_array(o, mesh, None, None, "sp", None).numpy(),
                     [g.numpy() for g in grads])
    return out if dist.get_rank() == 0 else None


def _collective_checks():
    """Every layer-1 collective on a 4-rank axis "x": value and gradient
    of sum(out * cotangent) per op, the index, size and barrier; then the
    pipeline on a 4-stage "pp" mesh and the ring checks at sp = 4."""
    import torch.distributed as dist

    mesh = MeshManager().create_mesh({"x": 4})
    r = dist.get_rank()
    res = {}
    with mesh:
        for name in OPS:
            x = torch.from_numpy(X[4 * r:4 * r + 4]).clone().requires_grad_()
            y = _port_op(name, x)
            c = _cotangent((4 * y.shape[0], *y.shape[1:]))[r * y.shape[0]:(r + 1) * y.shape[0]]
            torch.sum(y * torch.from_numpy(c)).backward()
            res[name] = (y.detach().numpy(), x.grad.numpy())
        res["meta"] = (C.axis_index("x"), C.axis_size("x"), int(C.barrier("x")))
    pp = MeshManager().create_mesh({"pp": 4})
    w = torch.from_numpy(PIPE_W).clone().requires_grad_()
    out = pipeline_sharded(lambda p, x: torch.tanh(x @ p), w, torch.from_numpy(PIPE_X), pp)
    torch.sum(out ** 2).backward()
    with pp:
        res["pipeline"] = (out.detach().numpy(), C.allreduce(w.grad, "pp").numpy())
    res["ring4"] = _ring_checks(4)
    return res


def _two_rank_checks():
    return _ring_checks(2)


# --------------------------------------------------------------------------
# the spawns
# --------------------------------------------------------------------------
def _store(tmp_path_factory):
    """A file store of the test's own: parallel test workers never share a
    rendezvous."""
    return "file://" + str(tmp_path_factory.mktemp("rendezvous") / "store")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return run_ranks(_collective_checks, 4, timeout_s=DEADLINE_S,
                     address=_store(tmp_path_factory))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return run_ranks(_two_rank_checks, 2, timeout_s=DEADLINE_S,
                     address=_store(tmp_path_factory))[0]


# --------------------------------------------------------------------------
# mesh layout (no process group)
# --------------------------------------------------------------------------
def test_mesh_construction_and_inference():
    mm = MeshManager(devices=range(8))
    mesh = mm.create_mesh({"dp": 2, "tp": -1}, name="train")
    assert mesh.shape["dp"] == 2 and mesh.shape["tp"] == 4
    assert mm.get_mesh("train") is mesh and mm.list_meshes() == {"train": mesh}
    assert mesh.devices.tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    with pytest.raises(ValueError):
        mm.create_mesh({"dp": 3})
    with pytest.raises(ValueError, match="at most one"):
        mm.create_mesh({"dp": -1, "tp": -1})
    with pytest.raises(ValueError, match="not divisible"):
        mm.create_mesh({"dp": 3, "tp": -1})
    with pytest.raises(KeyError):
        mm.get_mesh("eval")
    assert mm.auto_mesh().shape == {"dp": 8}
    assert mm.auto_mesh(tp=2).shape == {"dp": 4, "tp": 2}


def test_canonical_axis_order():
    mesh = MeshManager(devices=range(8)).create_mesh({"tp": 2, "dp": 2, "sp": 2})
    assert mesh.axis_names == ("dp", "sp", "tp")
    mesh = MeshManager(devices=range(8)).create_mesh({"tp": 2, "pp": 2, "ep": 2})
    assert mesh.axis_names == ("pp", "ep", "tp")


@pytest.mark.parametrize("names,sizes", [
    (("dp", "tp"), (2, -1)), (("a", "dp", "b"), (2, 2, 2)), (("tp", "dp"), (4, 2)),
    (("x", "y"), (2, 4))], ids=["dp_first", "dcn_middle", "dcn_last", "no_dcn_axis"])
def test_multihost_mesh_layout_matches_jax(names, sizes):
    """The rank layout is the reference's device layout: the dcn axis owns
    whole, contiguous host blocks (moveaxis regression included)."""
    from ray_tpu.parallel.distributed import multihost_mesh as jax_multihost_mesh

    ref = jax_multihost_mesh(names, sizes, dcn_axis="dp")
    got = multihost_mesh(names, sizes, dcn_axis="dp", devices=range(8))
    assert got.axis_names == tuple(ref.axis_names)
    assert got.shape == dict(ref.shape)
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    np.testing.assert_array_equal(got.devices, ids)


def test_multihost_mesh_errors():
    with pytest.raises(ValueError, match="not divisible"):
        multihost_mesh(("dp", "tp"), (3, -1), devices=range(8))
    with pytest.raises(ValueError, match="!="):
        multihost_mesh(("dp", "tp"), (3, 2), devices=range(8))


def test_a_layout_mesh_has_no_groups():
    mesh = MeshManager(devices=range(4)).create_mesh({"sp": 4})
    with pytest.raises(RuntimeError, match="layout only"):
        mesh.group("sp")
    with pytest.raises(RuntimeError, match="no current mesh"):
        C.axis_size("sp")


# --------------------------------------------------------------------------
# collectives against the JAX ones in a shard_map
# --------------------------------------------------------------------------
def _jax_collective(name):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from ray_tpu.parallel._compat import shard_map_unchecked

    mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    f = shard_map_unchecked(lambda x: _jax_op(name, x), mesh, (P("x"),), P("x"))
    out = f(jnp.asarray(X))
    if name == "all_to_all_untiled":  # JAX's own transpose of it fails (a VJP shape error)
        return np.asarray(out), None
    c = jnp.asarray(_cotangent(out.shape))
    grad = jax.grad(lambda x: jnp.sum(f(x) * c))(jnp.asarray(X))
    return np.asarray(out), np.asarray(grad)


@pytest.mark.parametrize("name", OPS)
def test_collective_matches_jax(four_ranks, name):
    want_out, want_grad = _jax_collective(name)
    got_out = np.concatenate([r[name][0] for r in four_ranks])
    got_grad = np.concatenate([r[name][1] for r in four_ranks])
    np.testing.assert_allclose(got_out, want_out, atol=1e-6, rtol=0)
    if want_grad is None:  # the reverse swap: chunk j of rank r came back from c_j[:, r]
        c = np.split(_cotangent(got_out.shape), 4)
        want_grad = np.stack([c[j][:, r] for r in range(4) for j in range(4)])
    np.testing.assert_allclose(got_grad, want_grad, atol=1e-6, rtol=0)


def test_axis_index_size_and_barrier(four_ranks):
    assert [r["meta"] for r in four_ranks] == [(i, 4, 0) for i in range(4)]


# --------------------------------------------------------------------------
# ring attention and Ulysses
# --------------------------------------------------------------------------
def _jax_attention(n, name):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from ray_tpu.parallel import ring_attention_sharded as jring, ulysses_attention_sharded as july

    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    fn = {"ring_causal": lambda *a: jring(*a, mesh, "sp", causal=True),
          "ring_noncausal": lambda *a: jring(*a, mesh, "sp", causal=False),
          "ulysses": lambda *a: july(*a, mesh, "sp", causal=True)}[name]
    @jax.jit
    def run(q, k, v):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(2 * out)  # the gradients of sum(out^2)

    out, grads = run(*(jnp.asarray(a) for a in QKV))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", ["ring_causal", "ring_noncausal", "ulysses"])
@pytest.mark.parametrize("n", [2, 4], ids=["sp2", "sp4"])
def test_sequence_parallel_attention_matches_jax(two_ranks, four_ranks, n, name):
    got_out, got_grads = (two_ranks if n == 2 else four_ranks[0]["ring4"])[name]
    want_out, want_grads = _jax_attention(n, name)
    np.testing.assert_allclose(got_out, want_out, atol=2e-5, rtol=0)
    for g, w in zip(got_grads, want_grads):
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=0)


def test_ring_matches_plain_attention(two_ranks):
    """The reference's own check: ring attention equals dense attention."""
    from ray_tpu_torch.ops.attention import mha

    q, k, v = (torch.from_numpy(a) for a in QKV)
    for name, causal in (("ring_causal", True), ("ring_noncausal", False)):
        np.testing.assert_allclose(two_ranks[name][0], mha(q, k, v, causal=causal).numpy(),
                                   atol=2e-5, rtol=0)


# --------------------------------------------------------------------------
# the pipeline
# --------------------------------------------------------------------------
def test_pipeline_matches_jax(four_ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from ray_tpu.parallel import pipeline_sharded as jpipe

    mesh = Mesh(np.array(jax.devices()[:4]), ("pp",))

    def stage(w, x):
        return jnp.tanh(x @ w)

    w, mb = jnp.asarray(PIPE_W), jnp.asarray(PIPE_X)
    want, want_grad = jax.jit(jax.value_and_grad(
        lambda w: jnp.sum(jpipe(stage, w, mb, mesh, "pp") ** 2)))(w)
    want = jpipe(stage, w, mb, mesh, "pp")
    expected = PIPE_X
    for s in range(4):
        expected = np.tanh(expected @ PIPE_W[s])
    for r in four_ranks:  # every stage holds the outputs
        np.testing.assert_allclose(r["pipeline"][0], np.asarray(want), atol=1e-5, rtol=0)
        np.testing.assert_allclose(r["pipeline"][0], expected, atol=1e-5, rtol=0)
    np.testing.assert_allclose(four_ranks[0]["pipeline"][1], np.asarray(want_grad),
                               rtol=1e-4, atol=1e-5)
    assert np.abs(four_ranks[0]["pipeline"][1]).sum() > 0
