"""The port's sharded train steps against the JAX package's on the same mesh.

The JAX side runs ``make_train_step(mesh=...)`` (and the ViT and DiT steps)
on the 8 virtual CPU devices of ``tests/conftest.py``; the port runs the
same mesh as spawned gloo ranks on the CPU, from the JAX state converted by
``train_state_from_numpy`` and placed by the step's ``shard_state``, on the
batch placed by its ``shard_batch``. f32 activations on both sides, the same
numpy tokens. Limits: each of 3 losses within 1e-5 relative, and every leaf
of the params after the 3 steps within 1e-4 of that leaf's largest entry
(the two sides sum the shards' partial results in different orders), or
1e-6 where that is smaller (a leaf that starts at zero); the
sharded loss within 1e-5 relative of the one-device loss; ``shard_params``
then a gather gives the full tree back bit for bit.

JAX is imported inside the functions that use it: the spawned ranks import
this module to find their function, and must not load JAX.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ray_tpu_torch.convert import params_from_numpy, train_state_from_numpy  # noqa: E402
from ray_tpu_torch.models import dit as tdit  # noqa: E402
from ray_tpu_torch.models import transformer as ttr  # noqa: E402
from ray_tpu_torch.models import vit as tvit  # noqa: E402
from ray_tpu_torch.parallel import MeshManager, run_ranks  # noqa: E402
from ray_tpu_torch.parallel.mesh import gather_array, gather_tree  # noqa: E402

DEADLINE_S = 240.0
STEPS = 3
MOE = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, d_ff=64, num_experts=4,
           expert_top_k=2, attention="dense")
TINY = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, d_ff=64, attention="dense")
GQA = dict(vocab_size=127, d_model=32, n_layers=2, n_heads=4, n_kv_heads=1, d_ff=64)
RING = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, d_ff=64, max_seq_len=64,
            attention="ring")
VIT = dict(image_size=16, patch_size=4, channels=3, num_classes=10, d_model=32, n_layers=2,
           n_heads=2, d_ff=64, attention="dense")
DIT = dict(image_size=8, patch_size=4, channels=1, num_classes=3, d_model=32, n_layers=2,
           n_heads=2)
_rng = np.random.default_rng(0)
TOKENS = _rng.integers(0, 128, (4, 16)).astype(np.int32)
GQA_TOKENS = TOKENS % 127
RING_TOKENS = {T: _rng.integers(0, 128, (4, T)).astype(np.int32) for T in (32, 33)}
IMAGES = _rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
LABELS = _rng.integers(0, 10, (4,)).astype(np.int32)
DIT_IMAGES = _rng.standard_normal((4, 8, 8, 1)).astype(np.float32)
DIT_LABELS = np.array([0, 2, 1, 2], np.int32)


def _tcfg(kw, **extra):
    return ttr.TransformerConfig(**kw, dtype=torch.float32, **extra)


# --------------------------------------------------------------------------
# rank functions (run in the spawned ranks)
# --------------------------------------------------------------------------
def _is_rank0():
    import torch.distributed as dist

    return dist.get_rank() == 0


def _np(tree):
    return {k: _np(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.numpy()


def _train(make_step, jstate, batch, draws=None):
    """3 steps of a sharded step from a JAX state: the losses and (rank 0)
    the gathered params."""
    mesh, step, specs = make_step()
    adam = jstate["adam"]
    state = step.shard_state(train_state_from_numpy(jstate["params"], adam["mu"], adam["nu"],
                                                    adam["count"], jstate["step"]))
    local = step.shard_batch(*batch)
    local = local if isinstance(local, tuple) else (local,)
    losses = []
    for i in range(STEPS):
        extra = () if draws is None else (tuple(torch.from_numpy(d) for d in draws[i]),)
        state, loss = step(state, *local, *extra)
        losses.append(float(loss))
    params = gather_tree(state["params"], specs, mesh)
    return losses, (_np(params) if _is_rank0() else None)


_MESHES = {}


def _mesh(axes):
    """One mesh (and its process groups) a layout in each rank."""
    key = tuple(sorted(axes.items()))
    if key not in _MESHES:
        _MESHES[key] = MeshManager().create_mesh(axes)
    return _MESHES[key]


def _decoder(kw, axes, **step_kw):
    def make():
        mesh = _mesh(axes)
        cfg = _tcfg(kw)
        _, step = ttr.make_train_step(cfg, mesh=mesh, device="cpu", **step_kw)
        specs = ttr.mesh_param_specs(cfg, mesh, ep=step_kw.get("ep"))
        return mesh, step, specs
    return make


def _weights_round_trip(cases):
    """shard_params of each full tree, gathered back: equal bit for bit."""
    ok = {}
    for name, (kw, axes, full) in cases.items():
        mesh = _mesh(axes)
        cfg = _tcfg(kw)
        full = params_from_numpy(full)
        # a mesh without tp names none (the default "tp" would be a typo there)
        given = {} if "tp" in mesh.shape else {"tp": None}
        local = ttr.shard_params(full, mesh, cfg, **given)
        specs = ttr.fitted_specs(ttr.param_shapes(cfg), ttr.param_specs(
            cfg, **ttr._shard_axes(cfg, mesh, given)), mesh)
        back = gather_tree(local, specs, mesh)
        shapes = {k: tuple(v.shape) for k, v in local["layers"].items()}
        ok[name] = (all(torch.equal(a, b) for a, b in zip(ttr._leaves(back), ttr._leaves(full))),
                    shapes, specs)
    return ok


def _eight_ranks(moe, capacity, loss_case, weights):
    """On {dp: 2, sp: 2, tp: 2}: the MoE step (dense dispatch, ep = dp), the
    capacity-dispatch MoE step, the sharded loss (dense and flash attention,
    GQA with kv heads replicated over tp) and the weights' round trip."""
    out = {"moe": _train(_decoder(MOE, {"dp": 2, "sp": 2, "tp": 2}, ep="dp"), moe,
                         (torch.from_numpy(TOKENS),)),
           "capacity": _train(_decoder(dict(MOE, moe_capacity_factor=2.0),
                                       {"dp": 2, "sp": 2, "tp": 2}, ep="dp"), capacity,
                              (torch.from_numpy(TOKENS),))}
    mesh = _mesh({"dp": 2, "sp": 2, "tp": 2})
    full, tokens = loss_case
    losses = {}
    for attention in ("dense", "flash"):
        cfg = _tcfg(GQA, attention=attention)
        local = ttr.shard_params(params_from_numpy(full), mesh, cfg)
        rows = torch.from_numpy(tokens).chunk(2)[mesh.axis_index("dp")]
        losses[attention] = float(ttr.loss_fn(cfg, local, rows, mesh=mesh))
        # the logits' blocks, gathered, against the one-device forward
        logits = gather_array(ttr.forward(cfg, local, rows, mesh=mesh), mesh, "dp", "sp")
        want = ttr.forward(cfg, params_from_numpy(full), torch.from_numpy(tokens))
        losses[f"{attention}_logits_err"] = float((logits - want).abs().max())
    out["loss"] = losses
    out["weights"] = _weights_round_trip(weights)
    return out


def _four_ranks(ring, vit, weights):
    """{dp: 2, sp: 2} ring steps at T = 32 and 33 (tail pad); {dp: 2, tp: 2}
    the ViT step; the weights' round trip."""
    out = {}
    for T, jstate in ring.items():
        out[f"ring{T}"] = _train(_decoder(RING, {"dp": 2, "sp": 2}), jstate,
                                 (torch.from_numpy(RING_TOKENS[T]),))

    def make_vit():
        mesh = _mesh({"dp": 2, "tp": 2})
        cfg = tvit.ViTConfig(**VIT, dtype=torch.float32)
        _, step = tvit.make_vit_train_step(cfg, mesh=mesh, device="cpu")
        specs = ttr.fitted_specs(tvit.vit_param_shapes(cfg), tvit.vit_param_specs(cfg), mesh)
        return mesh, step, specs

    out["vit"] = _train(make_vit, vit, (torch.from_numpy(IMAGES), torch.from_numpy(LABELS)))
    out["weights"] = _weights_round_trip(weights)
    return out


REMAT = {"sp": ({"sp": 2}, dict(RING, remat="dots")), "tp": ({"tp": 2}, dict(TINY, remat="dots"))}


def _remat_grads(fulls):
    """``loss_fn(mesh=)`` under ``remat="dots"``, differentiated with
    ``.backward()`` outside any ``with mesh:`` (the checkpointed layers are
    recomputed there): the loss and (rank 0) the full gradient, each
    rank's share summed over the leaf's replicas and gathered."""
    from ray_tpu_torch.parallel.mesh import shard_tree

    out = {}
    for name, (axes, kw) in REMAT.items():
        mesh, cfg = _mesh(axes), _tcfg(kw)
        specs = ttr.mesh_param_specs(cfg, mesh)
        local = shard_tree(params_from_numpy(fulls[name]), specs, mesh)
        live = [p.requires_grad_() for p in ttr._leaves(local)]
        loss = ttr.loss_fn(cfg, local, torch.from_numpy(TOKENS), mesh=mesh)
        loss.backward()
        grads = ttr._rebuild(local, [torch.zeros_like(p) if p.grad is None else p.grad
                                     for p in live])
        ttr.sum_replicas_(grads, specs, mesh)
        full = gather_tree(grads, specs, mesh)
        out[name] = (float(loss), _np(full) if _is_rank0() else None)
    return out


def _two_ranks(dit, draws, weights, remat):
    """{dp: 2} the DiT step at the JAX draws; {tp: 2} MoE weights (experts
    folded into tp) and the other round trips; the remat backward on {sp: 2}
    and {tp: 2}."""
    def make_dit():
        mesh = _mesh({"dp": 2})
        cfg = tdit.DiTConfig(**DIT, dtype=torch.float32)
        _, step = tdit.make_dit_train_step(cfg, mesh=mesh, device="cpu")
        specs = {k: (ttr.P() if not isinstance(v, dict) else {n: ttr.P() for n in v})
                 for k, v in dit["params"].items()}
        return mesh, step, specs

    return {"dit": _train(make_dit, dit,
                          (torch.from_numpy(DIT_IMAGES), torch.from_numpy(DIT_LABELS)), draws),
            "weights": _weights_round_trip(weights),
            "remat": _remat_grads(remat)}


# --------------------------------------------------------------------------
# the JAX side
# --------------------------------------------------------------------------
def _jax_mesh(shape, names):
    import jax
    from jax.sharding import Mesh

    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _np_state(state):
    import jax

    adam = state["opt"][0]
    return {"params": jax.tree.map(np.asarray, state["params"]), "step": np.asarray(state["step"]),
            "adam": {"mu": jax.tree.map(np.asarray, adam.mu),
                     "nu": jax.tree.map(np.asarray, adam.nu), "count": np.asarray(adam.count)}}


def _jax_decoder_run(kw, mesh, tokens, **step_kw):
    """The JAX state before the first step, the 3 losses, the params after."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import transformer as jtr

    cfg = jtr.TransformerConfig(**kw, dtype=jnp.float32)
    with mesh:
        init_state, step = jtr.make_train_step(cfg, mesh=mesh, **step_kw)
        state = init_state(jax.random.key(0))
        start = _np_state(state)
        toks = step.shard_batch(jnp.asarray(tokens))
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, toks)
            losses.append(float(loss))
        return start, losses, jax.tree.map(np.asarray, state["params"])


def _jax_init(kw, seed=0):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import transformer as jtr

    cfg = jtr.TransformerConfig(**kw, dtype=jnp.float32)
    return cfg, jax.tree.map(np.asarray, jtr.init_params(cfg, jax.random.key(seed)))


def _weights_cases(names):
    kws = {"dense": TINY, "moe": MOE, "gqa": GQA}
    meshes = {"dp2_sp2_tp2": {"dp": 2, "sp": 2, "tp": 2}, "dp2_sp2": {"dp": 2, "sp": 2},
              "dp2_tp2": {"dp": 2, "tp": 2}, "tp2": {"tp": 2}, "dp2": {"dp": 2}}
    return {f"{m}/{k}": (kws[k], meshes[m], _jax_init(kws[k], 5)[1]) for m, k in names}


@pytest.fixture(scope="module")
def jax_runs():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import dit as jdit, transformer as jtr, vit as jvit

    runs = {}
    mesh3 = _jax_mesh((2, 2, 2), ("dp", "sp", "tp"))
    runs["moe"] = _jax_decoder_run(MOE, mesh3, TOKENS, ep="dp")
    runs["capacity"] = _jax_decoder_run(dict(MOE, moe_capacity_factor=2.0), mesh3, TOKENS,
                                        ep="dp")
    ring_mesh = _jax_mesh((2, 2, 1), ("dp", "sp", "tp"))
    for T, toks in RING_TOKENS.items():
        runs[f"ring{T}"] = _jax_decoder_run(RING, ring_mesh, toks)
    # the one-device loss of the GQA config
    cfg, full = _jax_init(GQA, 3)
    runs["loss"] = (full, float(jtr.loss_fn(cfg, jax.tree.map(jnp.asarray, full),
                                            jnp.asarray(GQA_TOKENS))))
    # ViT on {dp: 2, tp: 2}
    vmesh = _jax_mesh((2, 2), ("dp", "tp"))
    vcfg = jvit.ViTConfig(**VIT, dtype=jnp.float32)
    with vmesh:
        init_state, step = jvit.make_vit_train_step(vcfg, mesh=vmesh)
        state = init_state(jax.random.key(0))
        start = _np_state(state)
        imgs, labels = step.shard_batch(jnp.asarray(IMAGES), jnp.asarray(LABELS))
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, imgs, labels)
            losses.append(float(loss))
        runs["vit"] = (start, losses, jax.tree.map(np.asarray, state["params"]))
    # DiT on {dp: 2}: its keys' draws go to the port's step
    dmesh = _jax_mesh((2,), ("dp",))
    dcfg = jdit.DiTConfig(**DIT, dtype=jnp.float32)
    init_state, step = jdit.make_dit_train_step(dcfg, mesh=dmesh)
    state = init_state(jax.random.key(1))
    start = _np_state(state)
    imgs, labels = step.shard_batch(jnp.asarray(DIT_IMAGES), jnp.asarray(DIT_LABELS))
    losses, draws = [], []
    for i in range(STEPS):
        key = jax.random.key(10 + i)
        k_t, k_eps, k_drop = jax.random.split(key, 3)
        draws.append((np.asarray(jax.random.randint(k_t, (4,), 0, dcfg.timesteps)),
                      np.asarray(jax.random.normal(k_eps, DIT_IMAGES.shape, jnp.float32)),
                      np.asarray(jax.random.uniform(k_drop, (4,)) < 0.1)))
        state, loss = step(state, imgs, labels, key)
        losses.append(float(loss))
    runs["dit"] = (start, losses, jax.tree.map(np.asarray, state["params"]), draws)
    # one device's loss and gradient of the remat configs
    for name, (_, kw) in REMAT.items():
        cfg, full = _jax_init(kw, 7)
        loss, grads = jax.value_and_grad(lambda p: jtr.loss_fn(cfg, p, jnp.asarray(TOKENS)))(
            jax.tree.map(jnp.asarray, full))
        runs[f"remat_{name}"] = (full, float(loss), jax.tree.map(np.asarray, grads))
    return runs


def _store(tmp_path_factory):
    """A file store of the test's own: parallel test workers never share a
    rendezvous."""
    return "file://" + str(tmp_path_factory.mktemp("rendezvous") / "store")


@pytest.fixture(scope="module")
def eight(jax_runs, tmp_path_factory):
    return run_ranks(_eight_ranks, 8, jax_runs["moe"][0], jax_runs["capacity"][0],
                     jax_runs["loss"][0:1] + (GQA_TOKENS,),
                     _weights_cases([("dp2_sp2_tp2", "dense"), ("dp2_sp2_tp2", "moe"),
                                     ("dp2_sp2_tp2", "gqa")]),
                     timeout_s=DEADLINE_S, address=_store(tmp_path_factory))


@pytest.fixture(scope="module")
def four(jax_runs, tmp_path_factory):
    return run_ranks(_four_ranks, 4, {T: jax_runs[f"ring{T}"][0] for T in RING_TOKENS},
                     jax_runs["vit"][0],
                     _weights_cases([("dp2_sp2", "dense"), ("dp2_sp2", "moe"),
                                     ("dp2_tp2", "gqa"), ("dp2_tp2", "moe")]),
                     timeout_s=DEADLINE_S, address=_store(tmp_path_factory))


@pytest.fixture(scope="module")
def two(jax_runs, tmp_path_factory):
    return run_ranks(_two_ranks, 2, jax_runs["dit"][0], jax_runs["dit"][3],
                     _weights_cases([("tp2", "moe"), ("tp2", "gqa"), ("dp2", "moe")]),
                     {name: jax_runs[f"remat_{name}"][0] for name in REMAT},
                     timeout_s=DEADLINE_S, address=_store(tmp_path_factory))


# --------------------------------------------------------------------------
# the checks
# --------------------------------------------------------------------------
def _assert_leaves_close(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_leaves_close(got[k], want[k], f"{what}/{k}")
        return
    want = np.asarray(want)
    err = float(np.abs(got - want).max())
    # a leaf that starts at zero (DiT's adaLN-Zero modulations and head)
    # holds only Adam's normalised steps, ~lr each: there the one-device
    # tests' limit on params after AdamW steps, 1e-6, applies
    assert err <= max(1e-4 * float(np.abs(want).max()), 1e-6), f"{what}: max err {err}"


def _assert_run(ranks, key, jax_run):
    _, want_losses, want_params = jax_run[:3]
    for losses, _ in (r[key] for r in ranks):  # the loss is the whole batch's on every rank
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=0)
    _assert_leaves_close(ranks[0][key][1], want_params, key)


def test_sharded_moe_train_step_matches_jax(eight, jax_runs):
    """{dp: 2, sp: 2, tp: 2}, MoE with ep = dp (tests/test_models.py:76)."""
    _assert_run(eight, "moe", jax_runs["moe"])


def test_moe_capacity_sharded_train_step_matches_jax(eight, jax_runs):
    _assert_run(eight, "capacity", jax_runs["capacity"])


@pytest.mark.parametrize("T", [32, 33], ids=["even", "tail_pad"])
def test_ring_mode_train_step_matches_jax(four, jax_runs, T):
    """attention="ring" on {dp: 2, sp: 2} (tests/test_models.py:135); T = 33
    does not divide over sp and takes the tail pad."""
    _assert_run(four, f"ring{T}", jax_runs[f"ring{T}"])


def test_vit_sharded_train_step_matches_jax(four, jax_runs):
    _assert_run(four, "vit", jax_runs["vit"])


def test_dit_sharded_train_step_matches_jax(two, jax_runs):
    _assert_run(two, "dit", jax_runs["dit"])


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_sharded_loss_matches_single_device(eight, jax_runs, attention):
    """The loss on {dp: 2, sp: 2, tp: 2} (GQA: kv heads replicated over tp,
    an odd vocabulary replicated) equals the JAX one-device loss."""
    want = jax_runs["loss"][1]
    for r in eight:
        assert abs(r["loss"][attention] - want) <= 1e-5 * abs(want)
        # forward(mesh=): each rank's logit block (vocabulary 127 is replicated
        # over tp) gathered over dp and sp equals the one-device logits
        assert r["loss"][f"{attention}_logits_err"] <= 1e-5


@pytest.mark.parametrize("axis", list(REMAT))
def test_loss_fn_backward_under_remat_matches_jax(two, jax_runs, axis):
    """``loss_fn(mesh=)`` with ``remat="dots"`` on {sp: 2} (ring) and
    {tp: 2}, differentiated outside the mesh as the JAX loss_fn is: the
    recomputed layers find their process groups, and the summed gradient
    is the JAX one-device gradient."""
    _, want_loss, want_grads = jax_runs[f"remat_{axis}"]
    for r in two:
        assert abs(r["remat"][axis][0] - want_loss) <= 1e-5 * abs(want_loss)
    _assert_leaves_close(two[0]["remat"][axis][1], want_grads, f"remat_{axis}")


def _round_trips(*ranks_lists):
    return {k: v for ranks in ranks_lists for k, v in ranks[0]["weights"].items()}


def test_shard_params_round_trip_is_bit_exact(eight, four, two):
    trips = _round_trips(eight, four, two)
    assert len(trips) == 10
    assert all(ok for ok, _, _ in trips.values()), {k: v[0] for k, v in trips.items()}


def test_shard_params_layouts(eight, four, two):
    """Where the leaves land: heads and d_ff over tp, experts over dp, and
    on a dp-less mesh the experts folded into tp (tests/test_models.py:253)."""
    trips = _round_trips(eight, four, two)
    _, shapes, specs = trips["dp2_sp2_tp2/moe"]
    assert shapes["wq"] == (2, 32, 2, 8) and shapes["we1"] == (2, 2, 32, 32)
    assert tuple(specs["layers"]["we1"]) == (None, "dp", None, "tp")
    _, shapes, specs = trips["tp2/moe"]
    assert tuple(specs["layers"]["we1"]) == (None, "tp", None, None)
    assert shapes["we1"] == (2, 2, 32, 64)
    _, shapes, specs = trips["tp2/gqa"]  # 1 kv head does not split; vocab 127 neither
    assert tuple(specs["layers"]["wk"]) == (None, None, None, None)
    assert tuple(specs["embed"]) == (None, None)
    _, shapes, specs = trips["dp2_sp2/dense"]  # no tp axis: everything replicated
    assert all(not any(s) for s in ttr._leaves(specs))


# --------------------------------------------------------------------------
# refusals (no process group needed)
# --------------------------------------------------------------------------
def test_shard_params_typo_axis_raises():
    mesh = MeshManager(devices=range(2)).create_mesh({"tp": 2})
    cfg = _tcfg(dict(TINY, vocab_size=64))
    params = ttr.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="not a mesh axis"):
        ttr.shard_params(params, mesh, cfg, tp="model")


def test_ring_without_a_sequence_axis_raises():
    mesh = MeshManager(devices=range(2)).create_mesh({"dp": 2})
    with pytest.raises(ValueError, match="sequence-parallel mesh axis"):
        ttr.make_train_step(_tcfg(RING), mesh=mesh, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        ttr.make_train_step(_tcfg(RING), mesh=object(), device="cpu")
    # without a mesh, ring is the einsum attention (the JAX package's forward)
    tokens = torch.from_numpy(TOKENS[:1])
    params = ttr.init_params(_tcfg(RING), torch.Generator().manual_seed(0))
    assert torch.equal(ttr.forward(_tcfg(RING), params, tokens),
                       ttr.forward(dataclasses.replace(_tcfg(RING), attention="dense"), params,
                                   tokens))
