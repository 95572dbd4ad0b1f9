"""The port's tensor-parallel engine (``LLMEngine(mesh=)``) against the JAX
package's.

The JAX side serves on the 8 virtual CPU devices of ``tests/conftest.py``
(``Mesh(devices[:n], ("tp",))``, one process driving them all); the port
serves on n gloo ranks on the CPU (``run_ranks``), each building the engine
from the JAX weights converted by ``convert.py``: rank 0 drives, the others
``follow()``. The scenarios are ``tests/test_serve_llm.py``'s
(``test_mesh_*``, ``test_tp_engine_with_chunked_decode``,
``test_llm_server_mesh_passthrough``): f32, greedy, so the port's tokens
must equal the JAX mesh engine's, which equal its single-device engine's.
At the layout level, ``forward_with_cache`` on each rank's shards (a
prefill and a decode step) must be within 1e-5 of the JAX forward's logits,
relative to their largest magnitude; the shard specs must be the JAX
package's ``shard_params`` specs. Each rank count is spawned once for all
of its scenarios; the two scenarios that lose a rank, the one whose driver
idles past the collective timeout and the one that leaves the group with
its driver running spawn their own pair.

JAX is imported inside the functions that use it: the spawned ranks import
this module to find their function, and must not load JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ray_tpu_torch.convert import params_from_numpy  # noqa: E402
from ray_tpu_torch.exceptions import CollectiveGroupDeadError  # noqa: E402
from ray_tpu_torch.models import transformer as ttr  # noqa: E402
from ray_tpu_torch.parallel import run_ranks  # noqa: E402
from ray_tpu_torch.parallel.mesh import Mesh  # noqa: E402

DEADLINE_S = 150.0
SMALL = dict(vocab_size=89, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
             attention="dense")
MOE = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=2, d_ff=64, num_experts=2,
           expert_top_k=1, attention="dense")
PROMPTS = [[3, 14, 15], [7, 8]]
CHUNK_PROMPT = [3, 14, 15, 9, 2]
LAYOUT_PROMPT = [5, 1, 57, 42, 8, 8, 30, 2]  # < both vocabularies
REL = 1e-5


def _tcfg(kw):
    return ttr.TransformerConfig(**kw, dtype=torch.float32)


# --------------------------------------------------------------------------
# rank functions (run in the spawned ranks)
# --------------------------------------------------------------------------
def _rank():
    import torch.distributed as dist

    return dist.get_rank()


def _tp_mesh(n):
    from ray_tpu_torch.parallel import MeshManager

    return MeshManager().create_mesh({"tp": n})


def _serve_on_mesh(cfg, np_params, mesh, prompts, max_tokens, **kw):
    """Every rank builds the engine; rank 0 serves ``prompts`` (each run
    of the list in turn) and returns the tokens and facts of its engine,
    the others follow."""
    from ray_tpu_torch.serve.llm import LLMEngine

    eng = LLMEngine(cfg, params_from_numpy(np_params), device="cpu", max_batch_size=2,
                    mesh=mesh, **kw)
    if _rank() != 0:
        eng.follow()
        return {"follower_thread": eng._thread, "stopped": eng._stop}
    try:
        out = [[eng.generate(p, max_tokens=max_tokens) for p in run] for run in prompts]
        facts = {"tokens": out, "stats": eng.stats(), "wq_spec": eng._lay.specs["layers"]["wq"],
                 "wq_shape": tuple(eng.params["layers"]["wq"].shape),
                 "cache_shape": tuple(eng._cache["k"].shape),
                 "broadcasts": eng._tp.broadcasts}
    finally:
        eng.shutdown()
    return facts


def _forward_on_shards(cfg, np_params, mesh):
    """Prefill of LAYOUT_PROMPT then one decode step through
    ``forward_with_cache`` on this rank's shards: both logits."""
    from ray_tpu_torch.models.generation import forward_with_cache, init_cache
    from ray_tpu_torch.parallel.mesh import shard_tree

    lay = ttr._layout(cfg, mesh, dp=None, sp=None, tp="tp")
    params = shard_tree(params_from_numpy(np_params), lay.specs, mesh)
    cache = init_cache(cfg, 1, 16, lay=lay)
    toks = torch.tensor([LAYOUT_PROMPT])
    T = toks.shape[1]
    pre, cache = forward_with_cache(cfg, params, cache, toks, torch.arange(T)[None, :], lay=lay)
    dec, _ = forward_with_cache(cfg, params, cache, toks[:, -1:], torch.tensor([[T]]), lay=lay)
    return pre.numpy(), dec.numpy()


def _served_by_serve_run(cfg, np_params, mesh):
    """``LLMServer(mesh=)`` deployed with ``serve.run`` on rank 0; its
    peers run the follower of their own ``LLMServer``."""
    from ray_tpu_torch.serve.llm import LLMServer

    kw = dict(max_batch_size=2, max_seq_len=48, mesh=mesh, device="cpu")

    def factory():
        return cfg, params_from_numpy(np_params)

    if _rank() != 0:
        LLMServer(factory, **kw).engine.follow()
        return None
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    rt.init(num_cpus=4)
    serve.start(http_port=0)
    try:
        app = serve.deployment(LLMServer, name="tp_llm").bind(factory, **kw)
        handle = serve.run(app, route_prefix=None)
        return handle.remote({"prompt": PROMPTS[0], "max_tokens": 4}).result()
    finally:
        serve.shutdown()
        rt.shutdown()


def _two_rank_scenarios(np_small, np_moe):
    cfg, moe = _tcfg(SMALL), _tcfg(MOE)
    mesh = _tp_mesh(2)
    return {
        "sharded": _serve_on_mesh(cfg, np_small, mesh, [PROMPTS], 6, max_seq_len=64),
        "chunked": _serve_on_mesh(cfg, np_small, mesh, [[CHUNK_PROMPT] * 2], 7, max_seq_len=64,
                                  decode_chunk=3),
        "moe": _serve_on_mesh(moe, np_moe, mesh, [[[1, 2, 3]]], 3, max_seq_len=32),
        "forward": _forward_on_shards(cfg, np_small, mesh),
        "forward_moe": _forward_on_shards(moe, np_moe, mesh),
        "server": _served_by_serve_run(cfg, np_small, mesh),
    }


def _four_rank_scenarios(np_small):
    cfg = _tcfg(SMALL)
    mesh = _tp_mesh(4)
    return {
        "replicated": _serve_on_mesh(cfg, np_small, mesh, [[[5, 6, 7]]], 4, max_seq_len=48),
        "forward": _forward_on_shards(cfg, np_small, mesh),
    }


def _idle_then_serve(np_small, timeout_s, idle_s):
    """The tp group's collective timeout cut to ``timeout_s``; rank 0's
    engine stays idle for ``idle_s`` (longer) before it serves, while its
    peer waits in ``follow()``."""
    import datetime
    import time

    from torch.distributed.distributed_c10d import _set_pg_timeout

    from ray_tpu_torch.serve.llm import LLMEngine

    mesh = _tp_mesh(2)
    _set_pg_timeout(datetime.timedelta(seconds=timeout_s), mesh.group("tp"))
    eng = LLMEngine(_tcfg(SMALL), params_from_numpy(np_small), device="cpu", max_batch_size=2,
                    max_seq_len=64, mesh=mesh)
    if _rank() != 0:
        eng.follow()
        return {"follower_thread": eng._thread, "stopped": eng._stop}
    try:
        time.sleep(idle_s)
        idle_broadcasts = eng._tp.broadcasts
        tokens = [eng.generate(p, max_tokens=6) for p in PROMPTS]
    finally:
        eng.shutdown()
    return {"tokens": [tokens], "idle_broadcasts": idle_broadcasts,
            "keepalive_s": eng._tp.keepalive_s}


_LEFT_RUNNING = []


def _leave_with_a_running_driver(np_small):
    """Rank 0 serves, then returns with its engine still running (as a
    replica not yet collected would leave it); leaving the group
    (``distributed.shutdown``) must stop it first, so its peer returns."""
    from ray_tpu_torch.serve.llm import LLMEngine

    eng = LLMEngine(_tcfg(SMALL), params_from_numpy(np_small), device="cpu", max_batch_size=2,
                    max_seq_len=64, mesh=_tp_mesh(2))
    if _rank() != 0:
        eng.follow()
        return {"follower_thread": eng._thread, "stopped": eng._stop}
    _LEFT_RUNNING.append(eng)
    return {"tokens": [[eng.generate(p, max_tokens=6) for p in PROMPTS]], "stopped": eng._stop}


def _rank_lost(np_small, lost):
    """Rank ``lost`` builds its engine and leaves the group without
    following (or, as rank 0, without serving or stopping its engine, as a
    crashed process would); the other rank reports what its engine raised."""
    import torch.distributed as dist

    from ray_tpu_torch.serve.llm import LLMEngine

    eng = LLMEngine(_tcfg(SMALL), params_from_numpy(np_small), device="cpu", max_batch_size=2,
                    max_seq_len=48, mesh=_tp_mesh(2))
    if _rank() == lost:
        dist.destroy_process_group()
        return "left"
    if _rank() != 0:
        try:
            eng.follow()
        except CollectiveGroupDeadError as exc:
            return {"follow": type(exc).__name__, "stopped": eng._stop}
        return {"follow": "returned"}
    try:
        eng.generate(PROMPTS[0], max_tokens=4)
        first = "served"
    except CollectiveGroupDeadError as exc:
        first = type(exc).__name__
    try:
        eng.submit(PROMPTS[1], max_tokens=2)
        later = "accepted"
    except CollectiveGroupDeadError as exc:
        later = type(exc).__name__
    eng.shutdown()
    return {"first": first, "later": later, "loop_alive": eng._thread.is_alive()}


# --------------------------------------------------------------------------
# the JAX side and the spawns
# --------------------------------------------------------------------------
def _jax_setup(kw, seed):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import TransformerConfig, init_params

    jcfg = TransformerConfig(**kw, dtype=jnp.float32)
    jp = init_params(jcfg, jax.random.key(seed))
    return jcfg, jp, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def small():
    return _jax_setup(SMALL, 11)


@pytest.fixture(scope="module")
def moe():
    return _jax_setup(MOE, 5)


def _jax_mesh(n):
    import jax
    from jax.sharding import Mesh as JMesh

    return JMesh(np.array(jax.devices()[:n]), ("tp",))


def _jax_tokens(jcfg, jp, runs, max_tokens, mesh_n=None, **kw):
    from ray_tpu.serve.llm import LLMEngine as JaxEngine

    mesh = _jax_mesh(mesh_n) if mesh_n else None
    eng = JaxEngine(jcfg, jp, max_batch_size=2, mesh=mesh, **kw)
    try:
        return [[eng.generate(p, max_tokens=max_tokens) for p in run] for run in runs]
    finally:
        eng.shutdown()


def _store(tmp_path_factory):
    return "file://" + str(tmp_path_factory.mktemp("rendezvous") / "store")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, small, moe):
    return run_ranks(_two_rank_scenarios, 2, small[2], moe[2], timeout_s=DEADLINE_S,
                     address=_store(tmp_path_factory))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, small):
    return run_ranks(_four_rank_scenarios, 4, small[2], timeout_s=DEADLINE_S,
                     address=_store(tmp_path_factory))


def _check_served(facts, followers, want):
    assert facts["tokens"] == want
    st = facts["stats"]
    assert st["cache_kind"] == "dense" and st["prefix_cache_enabled"] is False
    for f in followers:  # every peer left follow() on rank 0's shutdown
        assert f == {"follower_thread": None, "stopped": True}


def test_mesh_sharded_engine(two_ranks, small):
    jcfg, jp, _ = small
    want = _jax_tokens(jcfg, jp, [PROMPTS], 6, mesh_n=2, max_seq_len=64)
    assert want == _jax_tokens(jcfg, jp, [PROMPTS], 6, max_seq_len=64)
    facts = two_ranks[0]["sharded"]
    _check_served(facts, [r["sharded"] for r in two_ranks[1:]], want)
    # params and cache really sharded over tp: 2 of 4 query heads, 1 of 2 kv heads
    assert facts["wq_spec"][2] == "tp" and facts["wq_shape"] == (2, 32, 2, 8)
    assert facts["cache_shape"] == (2, 2, 1, 64, 8)


def test_tp_engine_with_chunked_decode(two_ranks, small):
    jcfg, jp, _ = small
    runs = [[CHUNK_PROMPT] * 2]
    want = _jax_tokens(jcfg, jp, runs, 7, mesh_n=2, max_seq_len=64, decode_chunk=3)
    assert want == _jax_tokens(jcfg, jp, runs, 7, max_seq_len=64)
    _check_served(two_ranks[0]["chunked"], [r["chunked"] for r in two_ranks[1:]], want)


def test_mesh_moe_engine(two_ranks, moe):
    jcfg, jp, _ = moe
    runs = [[[1, 2, 3]]]
    want = _jax_tokens(jcfg, jp, runs, 3, mesh_n=2, max_seq_len=32)
    assert want == _jax_tokens(jcfg, jp, runs, 3, max_seq_len=32)
    facts = two_ranks[0]["moe"]
    _check_served(facts, [r["moe"] for r in two_ranks[1:]], want)


def test_mesh_engine_kv_replicated_when_indivisible(four_ranks, small):
    jcfg, jp, _ = small
    runs = [[[5, 6, 7]]]
    want = _jax_tokens(jcfg, jp, runs, 4, mesh_n=4, max_seq_len=48)
    assert want == _jax_tokens(jcfg, jp, runs, 4, max_seq_len=48)
    facts = four_ranks[0]["replicated"]
    _check_served(facts, [r["replicated"] for r in four_ranks[1:]], want)
    # 1 of 4 query heads a rank, both kv heads on every rank (tp=4 > 2)
    assert facts["wq_shape"] == (2, 32, 1, 8) and facts["cache_shape"] == (2, 2, 2, 48, 8)


def test_llm_server_mesh_passthrough(two_ranks, small):
    jcfg, jp, _ = small
    want = _jax_tokens(jcfg, jp, [[PROMPTS[0]]], 4, max_seq_len=48)[0][0]
    r = two_ranks[0]["server"]
    assert r["tokens"] == want and r["num_generated"] == 4


def _jax_forward(jcfg, jp):
    import jax.numpy as jnp

    from ray_tpu.models.generation import forward_with_cache, init_cache

    toks = jnp.asarray([LAYOUT_PROMPT], jnp.int32)
    T = toks.shape[1]
    cache = init_cache(jcfg, 1, 16)
    pre, cache = forward_with_cache(jcfg, jp, cache, toks, jnp.arange(T)[None, :],
                                    use_decode_kernel=False)
    dec, _ = forward_with_cache(jcfg, jp, cache, toks[:, -1:], jnp.asarray([[T]]),
                                use_decode_kernel=False)
    return np.asarray(pre), np.asarray(dec)


@pytest.mark.parametrize("case", ["tp2", "tp4", "tp2_moe"])
def test_forward_with_cache_on_shards_matches_jax(case, two_ranks, four_ranks, small, moe):
    jcfg, jp, _ = moe if case.endswith("moe") else small
    ranks = {"tp2": two_ranks, "tp4": four_ranks, "tp2_moe": two_ranks}[case]
    key = "forward_moe" if case.endswith("moe") else "forward"
    want = _jax_forward(jcfg, jp)
    for r in ranks:  # the logits are gathered over the vocabulary on every rank
        for got, ref in zip(r[key], want):
            assert got.shape == ref.shape
            assert np.max(np.abs(got - ref)) <= REL * np.max(np.abs(ref))


def _spec_tuple(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


@pytest.mark.parametrize("case", ["small_tp2", "small_tp4", "moe_tp2", "moe_tp4"])
def test_shard_specs_match_jax(case, small, moe):
    import jax

    from ray_tpu.models.transformer import shard_params

    name, n = case.split("_tp")
    jcfg, jp, _ = small if name == "small" else moe
    cfg = _tcfg(SMALL if name == "small" else MOE)
    sharded = shard_params(jp, _jax_mesh(int(n)), jcfg, tp="tp", ep="tp")
    want = jax.tree.map(lambda a: _spec_tuple(a.sharding.spec, a.ndim), sharded)
    mesh = Mesh(np.arange(int(n)), ("tp",))  # a layout: no process group needed
    lay = ttr._layout(cfg, mesh, dp=None, sp=None, tp="tp")
    shapes = ttr.param_shapes(cfg)
    got = {k: ({n_: _spec_tuple(s, len(shapes[k][n_])) for n_, s in v.items()}
               if isinstance(v, dict) else _spec_tuple(v, len(shapes[k])))
           for k, v in lay.specs.items()}
    assert got == want


def test_mesh_quantize_rejected(small):
    mesh = Mesh(np.arange(2), ("tp",))
    with pytest.raises(ValueError, match="quantize"):
        _serve_mesh_engine(mesh, quantize=True)


def test_mesh_paged_cache_rejected():
    mesh = Mesh(np.arange(2), ("tp",))
    with pytest.raises(ValueError, match="paged"):
        _serve_mesh_engine(mesh, cache_kind="paged")


def test_mesh_without_the_tp_axis_rejected():
    with pytest.raises(ValueError, match="no 'tp' axis"):
        _serve_mesh_engine(Mesh(np.arange(2), ("dp",)))
    with pytest.raises(ValueError, match="no 'model' axis"):
        _serve_mesh_engine(Mesh(np.arange(2), ("tp",)), tp="model")


def _serve_mesh_engine(mesh, **kw):
    from ray_tpu_torch.serve.llm import LLMEngine

    return LLMEngine(_tcfg(SMALL), {}, device="cpu", mesh=mesh, **kw)


@pytest.mark.parametrize("lost", [0, 1], ids=["driver_lost", "follower_lost"])
def test_a_lost_rank_ends_the_other_with_a_typed_error(lost, tmp_path_factory, small):
    out = run_ranks(_rank_lost, 2, small[2], lost, timeout_s=DEADLINE_S,
                    address=_store(tmp_path_factory))
    other = out[1 - lost]
    if lost == 0:
        assert other == {"follow": "CollectiveGroupDeadError", "stopped": True}
    else:
        assert other == {"first": "CollectiveGroupDeadError",
                         "later": "CollectiveGroupDeadError", "loop_alive": False}


def test_an_idle_driver_keeps_its_peer(tmp_path_factory, small):
    """A quiet server is no dead rank: rank 0 idles for 2.5 collective
    timeouts, sending only keep-alive calls, then serves the JAX engine's
    tokens."""
    timeout_s, idle_s = 4.0, 10.0
    out = run_ranks(_idle_then_serve, 2, small[2], timeout_s, idle_s, timeout_s=DEADLINE_S,
                    address=_store(tmp_path_factory))
    jcfg, jp, _ = small
    assert out[0]["tokens"] == _jax_tokens(jcfg, jp, [PROMPTS], 6, max_seq_len=64)
    assert out[0]["keepalive_s"] == timeout_s / 4
    assert out[0]["idle_broadcasts"] >= idle_s / (timeout_s / 4) - 2  # one header each
    assert out[1] == {"follower_thread": None, "stopped": True}


def test_leaving_the_group_stops_a_running_driver(tmp_path_factory, small):
    out = run_ranks(_leave_with_a_running_driver, 2, small[2], timeout_s=DEADLINE_S,
                    address=_store(tmp_path_factory))
    jcfg, jp, _ = small
    assert out[0] == {"tokens": _jax_tokens(jcfg, jp, [PROMPTS], 6, max_seq_len=64),
                      "stopped": False}
    assert out[1] == {"follower_thread": None, "stopped": True}
