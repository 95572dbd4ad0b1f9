"""The port's ViT and MLP against the JAX package's.

Same numpy inputs on both sides, f32, a small config (as tests/test_models.py's
tiny ViT: 16-pixel images of 4-pixel patches, 17 tokens with the CLS token).
JAX params and train states cross by ``params_from_numpy`` /
``train_state_from_numpy``. The JAX side's ``attention="flash"`` runs its
Pallas kernels in interpret mode (non-causal), the port's its autograd
Function on the plain versions. Limits: logits and the loss atol 1e-4, every
gradient leaf atol 1e-5, params after AdamW steps atol 1e-6 (only the
summation order and the two BLAS libraries differ; Adam normalises the
gradients, so a step moves each param by about the learning rate), and each
Adam moment within 1e-4 of its leaf's largest element (the moments carry
the gradients' own scale: the CLS token's and the position embeddings'
gradients, summed over the batch, reach ~10).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import common as jcommon  # noqa: E402
from ray_tpu.models import mlp as jmlp  # noqa: E402
from ray_tpu.models import vit as jvit  # noqa: E402
from ray_tpu_torch.convert import params_from_numpy, train_state_from_numpy  # noqa: E402
from ray_tpu_torch.models import common as tcommon  # noqa: E402
from ray_tpu_torch.models import mlp as tmlp  # noqa: E402
from ray_tpu_torch.models import transformer as ttr  # noqa: E402
from ray_tpu_torch.models import vit as tvit  # noqa: E402

SMALL = dict(image_size=16, patch_size=4, channels=3, num_classes=10, d_model=32, n_layers=2,
             n_heads=2, d_ff=64)
ATOL = 1e-4
LR = 1e-3
_rng = np.random.default_rng(0)
IMAGES = _rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
LABELS = _rng.integers(0, 10, (3,)).astype(np.int32)


def _cfgs(attention, **kw):
    return (jvit.ViTConfig(**SMALL, attention=attention, dtype=jnp.float32, **kw),
            tvit.ViTConfig(**SMALL, attention=attention, dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def params():
    jp = jvit.init_vit_params(_cfgs("dense")[0], jax.random.key(4))
    # the CLS token starts at zero: give it values so its path is compared
    jp["cls_token"] = jnp.asarray(np.random.default_rng(5).normal(size=(1, 1, 32)) * 0.1,
                                  jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _assert_tree_close(port_tree, jax_tree, atol, what, of_largest=False):
    """Every leaf within ``atol`` (``of_largest``: within ``atol`` times the
    leaf's largest magnitude)."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(jax_tree)
    assert len(leaves) == len(ttr._leaves(port_tree))
    for path, want in leaves:
        got = port_tree
        for key in path:
            got = got[key.key]
        want = np.asarray(want)
        tol = atol * float(np.abs(want).max()) if of_largest else atol
        np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=0,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


# --------------------------------------------------------------------------
# patches
# --------------------------------------------------------------------------
def test_patchify_and_unpatchify_match_jax():
    images = np.random.default_rng(1).standard_normal((2, 12, 12, 5)).astype(np.float32)
    ref = jcommon.patchify(jnp.asarray(images), 3)
    got = tcommon.patchify(torch.from_numpy(images), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    back = tcommon.unpatchify(got, 12, 3, 5)
    np.testing.assert_array_equal(back.numpy(), images)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jcommon.unpatchify(ref, 12, 3, 5)))
    jc, tc = _cfgs("dense")
    np.testing.assert_array_equal(tvit.patchify(tc, torch.from_numpy(IMAGES)).numpy(),
                                  np.asarray(jvit.patchify(jc, jnp.asarray(IMAGES))))


# --------------------------------------------------------------------------
# forward, loss, gradients
# --------------------------------------------------------------------------
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_vit_forward_matches_jax(params, attention):
    jp, tp = params
    jc, tc = _cfgs(attention)
    ref = jvit.vit_forward(jc, jp, jnp.asarray(IMAGES))
    got = tvit.vit_forward(tc, tp, torch.from_numpy(IMAGES))
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_vit_bf16_forward_rounds_like_jax(params):
    """bf16 activations: the port casts at the JAX code's points (atol 2e-2,
    bf16 keeps about 3 digits)."""
    jp, tp = params
    jc = jvit.ViTConfig(**SMALL, attention="dense")
    tc = tvit.ViTConfig(**SMALL, attention="dense")
    ref = jvit.vit_forward(jc, jp, jnp.asarray(IMAGES))
    got = tvit.vit_forward(tc, tp, torch.from_numpy(IMAGES))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("remat", [False, True], ids=["saved", "recomputed"])
def test_vit_loss_and_grads_match_jax(params, remat):
    jp, tp = params
    jc, tc = _cfgs("flash", remat=remat)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jvit.vit_loss_fn(jc, p, jnp.asarray(IMAGES), jnp.asarray(LABELS)))(jp)
    loss, grads = ttr.value_and_grad(
        lambda p: tvit.vit_loss_fn(tc, p, torch.from_numpy(IMAGES), torch.from_numpy(LABELS)),
        tp)
    assert abs(float(loss) - float(ref_loss)) <= ATOL
    _assert_tree_close(grads, ref_grads, 1e-5, "grad")


# --------------------------------------------------------------------------
# train step
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_run():
    """The JAX train states before each of 3 steps and after the last (as
    numpy), and the 3 losses."""
    jc, _ = _cfgs("flash")
    init_state, train_step = jvit.make_vit_train_step(jc, learning_rate=LR)
    state = init_state(jax.random.key(0))
    states, losses = [], []
    for _ in range(3):
        states.append(jax.tree.map(np.array, state))
        state, loss = train_step(state, jnp.asarray(IMAGES), jnp.asarray(LABELS))
        losses.append(float(loss))
    states.append(jax.tree.map(np.array, state))
    return states, losses


def _port_state(jstate):
    adam = jstate["opt"][0]  # optax.adamw: (ScaleByAdamState, EmptyState, EmptyState)
    return train_state_from_numpy(jstate["params"], adam.mu, adam.nu, adam.count,
                                  jstate["step"], device="cpu")


@pytest.mark.parametrize("start", [0, 1], ids=["from_init", "resume_jax_step1"])
def test_vit_train_steps_match_jax(jax_run, start):
    states, ref_losses = jax_run
    _, tc = _cfgs("flash")
    _, train_step = tvit.make_vit_train_step(tc, learning_rate=LR, device="cpu")
    state = _port_state(states[start])
    for i in range(start, 3):
        state, loss = train_step(state, torch.from_numpy(IMAGES), torch.from_numpy(LABELS))
        assert abs(float(loss) - ref_losses[i]) <= ATOL, i
    assert int(state["step"]) == int(state["opt"]["count"]) == 3
    _assert_tree_close(state["params"], states[3]["params"], 1e-6, "params")
    adam = states[3]["opt"][0]
    _assert_tree_close(state["opt"]["mu"], adam.mu, 1e-4, "mu", of_largest=True)
    _assert_tree_close(state["opt"]["nu"], adam.nu, 1e-4, "nu", of_largest=True)


def test_vit_train_step_learns_and_refuses_a_mesh(monkeypatch):
    _, tc = _cfgs("dense")
    init_state, train_step = tvit.make_vit_train_step(
        dataclasses.replace(tc, attention="auto"), learning_rate=1e-2, device="cpu")
    state = init_state(0)
    assert {k: tuple(v.shape) for k, v in state["params"].items() if k != "layers"} == {
        "patch_embed": (48, 32), "cls_token": (1, 1, 32), "pos_embed": (1, 17, 32),
        "final_norm": (32,), "head": (32, 10)}
    losses = [float(train_step(state, torch.from_numpy(IMAGES), torch.from_numpy(LABELS))[1])
              for _ in range(20)]
    assert losses[-1] < 0.5 * losses[0]  # memorises the tiny batch
    with pytest.raises(TypeError, match="Mesh"):  # a mesh is the port's Mesh
        tvit.make_vit_train_step(tc, mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvit.make_vit_train_step(tc)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------
def test_mlp_forward_matches_jax():
    jc = jmlp.MLPConfig(in_dim=8, hidden=16, depth=2, out_dim=4)
    tc = tmlp.MLPConfig(in_dim=8, hidden=16, depth=2, out_dim=4)
    jp = jmlp.mlp_init(jc, jax.random.key(0))
    jp = [{"w": l["w"], "b": l["b"] + 0.1 * i} for i, l in enumerate(jp)]  # non-zero biases
    tp = [params_from_numpy({k: np.asarray(v) for k, v in l.items()}) for l in jp]
    x = np.random.default_rng(2).standard_normal((5, 8)).astype(np.float32)
    np.testing.assert_allclose(tmlp.mlp_apply(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(jmlp.mlp_apply(jp, jnp.asarray(x))), atol=1e-6)
    fresh = tmlp.mlp_init(tc, torch.Generator().manual_seed(0))
    assert [tuple(l["w"].shape) for l in fresh] == [(8, 16), (16, 16), (16, 4)]
    assert all(not l["b"].any() for l in fresh)


def test_models_export_the_jax_packages_api():
    """``ray_tpu_torch.models`` exports what ``ray_tpu.models`` does, less
    the sharding helpers (not ported: one device only)."""
    import ray_tpu.models as jmodels
    import ray_tpu_torch.models as tmodels

    missing = set(jmodels.__all__) - set(tmodels.__all__)
    assert missing == {"vit_param_specs", "param_specs", "shard_params"}
    assert all(hasattr(tmodels, name) for name in tmodels.__all__)
