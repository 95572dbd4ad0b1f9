"""The port's train step against the JAX package's, and its checkpoints.

Same numpy inputs on both sides, f32: the JAX side runs ``loss_fn`` and
``make_train_step`` with ``attention="flash"`` (its Pallas forward and
backward kernels in interpret mode), the port the same with its autograd
Function on the plain versions. JAX params and optimizer states cross by
``train_state_from_numpy``. Limits: loss and every gradient leaf atol 1e-5,
params after an AdamW step atol 1e-6 (only the summation order and the two
BLAS libraries differ; Adam normalises the gradients, so a step moves each
param by about the learning rate, 1e-3).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import transformer as jtr  # noqa: E402
from ray_tpu_torch.convert import train_state_from_numpy  # noqa: E402
from ray_tpu_torch.models import transformer as ttr  # noqa: E402
from ray_tpu_torch.models.checkpoint import load_model, save_model  # noqa: E402
from ray_tpu_torch.train.checkpoint import Checkpoint, load_framed, save_framed  # noqa: E402

SMALL = dict(vocab_size=89, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64)
JCFG = jtr.TransformerConfig(**SMALL, attention="flash", dtype=jnp.float32)
TCFG = ttr.TransformerConfig(**SMALL, attention="flash", dtype=torch.float32)
LR = 1e-3
TOKENS = np.random.default_rng(1).integers(0, 89, size=(2, 37)).astype(np.int32)


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX train states before each of 3 steps and after the last (as
    numpy), and the 3 losses."""
    init_state, train_step = jtr.make_train_step(JCFG, learning_rate=LR)
    state = init_state(jax.random.key(0))
    states, losses = [], []
    for _ in range(3):
        states.append(_np_tree(state))
        state, loss = train_step(state, jnp.asarray(TOKENS))
        losses.append(float(loss))
    states.append(_np_tree(state))
    return states, losses


def _port_state(jstate):
    adam = jstate["opt"][0]  # optax.adamw: (ScaleByAdamState, EmptyState, EmptyState)
    return train_state_from_numpy(jstate["params"], adam.mu, adam.nu, adam.count,
                                  jstate["step"], device="cpu")


def _assert_tree_close(port_tree, jax_tree, atol, what):
    leaves, _ = jax.tree_util.tree_flatten_with_path(jax_tree)
    assert len(leaves) == len(ttr._leaves(port_tree))
    for path, want in leaves:
        got = port_tree
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


# --------------------------------------------------------------------------
# (b) loss and gradients
# --------------------------------------------------------------------------
def test_loss_and_grads_match_jax(jax_run):
    states, _ = jax_run
    jp = jax.tree.map(jnp.asarray, states[0]["params"])
    toks = jnp.asarray(TOKENS)
    ref_loss, ref_grads = jax.value_and_grad(lambda p: jtr.loss_fn(JCFG, p, toks))(jp)
    loss, grads = ttr.loss_and_grads(TCFG, _port_state(states[0])["params"],
                                  torch.from_numpy(TOKENS))
    assert abs(float(loss) - float(ref_loss)) <= 1e-5
    _assert_tree_close(grads, ref_grads, 1e-5, "grad")


# --------------------------------------------------------------------------
# (c), (d) AdamW steps, from step 0 and from a JAX state after 2 steps
# --------------------------------------------------------------------------
@pytest.mark.parametrize("start", [0, 2], ids=["from_init", "resume_jax_step2"])
def test_train_steps_match_jax(jax_run, start):
    states, ref_losses = jax_run
    init_state, train_step = ttr.make_train_step(TCFG, learning_rate=LR, device="cpu")
    state = _port_state(states[start])
    for i in range(start, 3):
        state, loss = train_step(state, torch.from_numpy(TOKENS))
        assert abs(float(loss) - ref_losses[i]) <= 1e-5, i
    assert int(state["step"]) == int(state["opt"]["count"]) == 3
    _assert_tree_close(state["params"], states[3]["params"], 1e-6, "params")
    adam = states[3]["opt"][0]
    _assert_tree_close(state["opt"]["mu"], adam.mu, 1e-6, "mu")
    _assert_tree_close(state["opt"]["nu"], adam.nu, 1e-6, "nu")


# --------------------------------------------------------------------------
# (e) remat
# --------------------------------------------------------------------------
# ids: a test whose keywords hold "full" is skipped as the slow tier
@pytest.mark.parametrize("remat", [True, "full", "dots"], ids=["true", "whole_layer", "dots"])
def test_remat_gives_bitwise_equal_loss_and_grads(jax_run, remat):
    params = _port_state(jax_run[0][0])["params"]
    toks = torch.from_numpy(TOKENS)
    ref_loss, ref = ttr.loss_and_grads(TCFG, params, toks)
    cfg = ttr.TransformerConfig(**SMALL, attention="flash", dtype=torch.float32, remat=remat)
    loss, got = ttr.loss_and_grads(cfg, params, toks)
    assert torch.equal(loss, ref_loss)
    for a, b in zip(ttr._leaves(got), ttr._leaves(ref)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# MoE: loss, gradients and AdamW steps, dense and capacity dispatch
# --------------------------------------------------------------------------
MOE_DISPATCH = {"dense_dispatch": 0.0, "capacity0.5": 0.5}


def _moe_cfgs(factor, remat=False):
    kw = dict(SMALL, num_experts=4, expert_top_k=2, moe_capacity_factor=factor,
              attention="flash", remat=remat)
    return (jtr.TransformerConfig(**kw, dtype=jnp.float32),
            ttr.TransformerConfig(**kw, dtype=torch.float32))


@pytest.mark.parametrize("dispatch", list(MOE_DISPATCH))
def test_moe_loss_and_grads_match_jax(dispatch):
    jc, tc = _moe_cfgs(MOE_DISPATCH[dispatch])
    jp = jtr.init_params(jc, jax.random.key(4))
    toks = jnp.asarray(TOKENS)
    ref_loss, ref_grads = jax.value_and_grad(lambda p: jtr.loss_fn(jc, p, toks))(jp)
    tp = train_state_from_numpy(_np_tree(jp), _np_tree(jp), _np_tree(jp), 0, 0)["params"]
    loss, grads = ttr.loss_and_grads(tc, tp, torch.from_numpy(TOKENS))
    assert abs(float(loss) - float(ref_loss)) <= 1e-5
    _assert_tree_close(grads, ref_grads, 1e-5, "grad")
    assert float(grads["layers"]["router"].abs().max()) > 0  # the gates are trained


@pytest.mark.parametrize("dispatch", list(MOE_DISPATCH))
@pytest.mark.parametrize("remat", [False, "dots"], ids=["no_remat", "dots"])
def test_moe_train_steps_match_jax(dispatch, remat):
    """Three AdamW steps from the JAX init on both sides, under the same
    remat policy: losses atol 1e-5, moments atol 1e-6, params atol 1e-4 (a
    tenth of a step at lr 1e-3). The params' limit is wider than the dense
    decoder's because a few expert weights (2 of 16,384 here) see a gradient
    that sums to almost zero over the batch (~1e-5 against a median of
    ~1e-4); there the summation order can flip the first moment's sign, and
    Adam's normalised step follows it."""
    jc, tc = _moe_cfgs(MOE_DISPATCH[dispatch], remat)
    init_state, train_step = jtr.make_train_step(jc, learning_rate=LR)
    jstate = init_state(jax.random.key(5))
    state = _port_state(_np_tree(jstate))
    _, port_step = ttr.make_train_step(tc, learning_rate=LR, device="cpu")
    for i in range(3):
        jstate, ref_loss = train_step(jstate, jnp.asarray(TOKENS))
        state, loss = port_step(state, torch.from_numpy(TOKENS))
        assert abs(float(loss) - float(ref_loss)) <= 1e-5, i
    jstate = _np_tree(jstate)
    _assert_tree_close(state["params"], jstate["params"], 1e-4, "params")
    adam = jstate["opt"][0]
    _assert_tree_close(state["opt"]["mu"], adam.mu, 1e-6, "mu")
    _assert_tree_close(state["opt"]["nu"], adam.nu, 1e-6, "nu")


def test_remat_and_unported_options_are_validated(monkeypatch):
    from ray_tpu_torch.parallel import MeshManager

    with pytest.raises(ValueError, match="remat"):
        ttr.TransformerConfig(**SMALL, remat="Dots")
    # without a mesh the axis names name nothing, as in the JAX package
    for kw in ({"dp": "dp"}, {"sp": "sp"}, {"tp": "tp"}, {"ep": "ep"}):
        ttr.make_train_step(TCFG, device="cpu", **kw)
    with pytest.raises(TypeError, match="Mesh"):
        ttr.make_train_step(TCFG, device="cpu", mesh=object())
    ring = ttr.TransformerConfig(**SMALL, attention="ring")
    mesh = MeshManager(devices=range(2)).create_mesh({"dp": 2})
    with pytest.raises(ValueError, match="sequence-parallel"):
        ttr.make_train_step(ring, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="not a mesh axis"):  # a typo'd expert axis
        ttr.make_train_step(ttr.TransformerConfig(**SMALL, num_experts=2), device="cpu",
                            mesh=mesh, ep="experts")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.make_train_step(TCFG)


# --------------------------------------------------------------------------
# (f) checkpoints
# --------------------------------------------------------------------------
def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {
        "f32": torch.randn(3, 4, generator=g),
        "bf16": torch.randn(5, generator=g).to(torch.bfloat16),
        "nested": {"i32": torch.arange(7, dtype=torch.int32), "scalar": torch.tensor(3)},
        "seq": [torch.randn(2, generator=g), (torch.zeros(0), 1.5)],
        "meta": "kept",
    }
    ckpt = Checkpoint.from_pytree(tree, base_dir=str(tmp_path))
    for got in (ckpt.to_pytree(), ckpt.to_pytree(device="cpu")):
        assert got["meta"] == "kept" and got["seq"][1][1] == 1.5
        assert isinstance(got["seq"][1], tuple)
        for a, b in zip(ttr._leaves({k: tree[k] for k in ("f32", "bf16", "nested")}),
                        ttr._leaves({k: got[k] for k in ("f32", "bf16", "nested")})):
            assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
        for a, b in ((tree["seq"][0], got["seq"][0]), (tree["seq"][1][0], got["seq"][1][0])):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_train_state_resumes_bitwise_from_a_checkpoint(tmp_path):
    """Save after step 1, restore into a fresh state: step 2 from both gives
    the same loss and params, bit for bit (the chip run checks the same at
    full width with deterministic algorithms on)."""
    init_state, train_step = ttr.make_train_step(TCFG, learning_rate=LR, device="cpu")
    toks = torch.from_numpy(TOKENS)
    state, _ = train_step(init_state(7), toks)
    ckpt = Checkpoint.from_pytree(state, base_dir=str(tmp_path))
    restored = ckpt.to_pytree(device="cpu")
    state, loss_a = train_step(state, toks)
    restored, loss_b = train_step(restored, toks)
    assert torch.equal(loss_a, loss_b)
    for a, b in zip(ttr._leaves(state), ttr._leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_torn_checkpoint_falls_back_to_prev(tmp_path):
    path = str(tmp_path / "state.pkl")
    save_framed(path, {"gen": 1, "t": torch.ones(3)})
    save_framed(path, {"gen": 2, "t": torch.zeros(3)})
    assert load_framed(path)["gen"] == 2
    with open(path, "r+b") as f:  # torn write: the payload is cut short
        f.truncate(os.path.getsize(path) - 5)
    assert load_framed(path)["gen"] == 1
    with open(path + ".prev", "r+b") as f:  # a flipped bit fails the digest
        f.seek(40)
        byte = f.read(1)
        f.seek(40)
        f.write(bytes([byte[0] ^ 1]))
    assert load_framed(path) is None
    ckpt = Checkpoint.from_dict({"a": 1}, base_dir=str(tmp_path))
    os.remove(os.path.join(ckpt.path, "data.pkl"))
    with pytest.raises(FileNotFoundError):
        ckpt.to_dict()


def test_dict_and_directory_checkpoints(tmp_path):
    ckpt = Checkpoint.from_dict({"epoch": 3, "w": torch.ones(2)}, base_dir=str(tmp_path))
    with ckpt.as_directory() as d:
        assert d == ckpt.path and os.path.isdir(d)
    copy = Checkpoint.from_directory(ckpt.to_directory(str(tmp_path / "copy")))
    assert copy.to_dict()["epoch"] == 3 and torch.equal(copy.to_dict()["w"], torch.ones(2))
    assert ckpt.to_directory() == ckpt.path


def test_save_and_load_model_round_trip(tmp_path):
    cfg = ttr.TransformerConfig(**SMALL, dtype=torch.bfloat16, remat="dots", scan_layers=False)
    params = ttr.init_params(cfg, torch.Generator().manual_seed(3))
    save_model(str(tmp_path / "m"), cfg, params)
    got_cfg, got = load_model(str(tmp_path / "m"), device="cpu")
    assert got_cfg == cfg
    for a, b in zip(ttr._leaves(params), ttr._leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
