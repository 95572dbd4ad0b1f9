"""The port's DiT against the JAX package's.

Same numpy inputs on both sides, f32, the tiny config of tests/test_dit.py.
adaLN-Zero makes a fresh model's output identically 0, so every zero leaf
(``ada``, ``ada_b``, ``final_ada``, ``final_ada_b``, ``head``) is perturbed
from a numpy seed before the two packages are compared. Random draws (t,
noise, label dropout; the sampler's initial noise) are the JAX package's,
fed to the port's compute-on-draws functions (``_dit_loss_at``,
``_ddim_loop``). Limits: the schedule atol 1e-6 (its DDIM steps
identical), the timestep embedding atol 1e-4 (its angles reach 999 rad,
where the two math libraries' f32 exp and cos differ by an ulp or two of
the angle), the forward's noise prediction and the loss atol 1e-4,
gradients atol 1e-5, the DDIM samples atol 1e-4 (each step divides by
sqrt(alpha_bar), ~0.03 at the first step of this 50-step schedule).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import dit as jdit  # noqa: E402
from ray_tpu_torch.convert import params_from_numpy  # noqa: E402
from ray_tpu_torch.models import dit as tdit  # noqa: E402
from ray_tpu_torch.models import transformer as ttr  # noqa: E402
from ray_tpu_torch.models.checkpoint import load_model, save_model  # noqa: E402

TINY = dict(image_size=8, patch_size=4, channels=1, num_classes=3, d_model=32, n_layers=2,
            n_heads=2, timesteps=50)
JCFG = jdit.DiTConfig(**TINY, dtype=jnp.float32)
TCFG = tdit.DiTConfig(**TINY, dtype=torch.float32)
ATOL = 1e-4
_rng = np.random.default_rng(0)
IMAGES = _rng.standard_normal((4, 8, 8, 1)).astype(np.float32)
LABELS = np.array([0, 2, 1, 2], np.int32)
ZERO_INIT = ("ada", "ada_b", "final_ada", "final_ada_b", "head")


def _perturbed(cfg, seed):
    """JAX params with every zero-initialised leaf given values (numpy seed
    ``seed``), and the same params converted."""
    jp = jdit.init_dit_params(cfg, jax.random.key(seed))
    rng = np.random.default_rng(100 + seed)

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else
                (jnp.asarray(rng.normal(size=v.shape) * 0.05, v.dtype) if k in ZERO_INIT else v)
                for k, v in tree.items()}

    jp = fill(jp)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def params():
    return _perturbed(JCFG, 0)


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
# schedule, embeddings, modulated LayerNorm
# --------------------------------------------------------------------------
@pytest.mark.parametrize("timesteps", [50, 1000])
def test_alpha_bar_and_ddim_timesteps_match_jax(timesteps):
    jc = jdit.DiTConfig(**{**TINY, "timesteps": timesteps})
    tc = tdit.DiTConfig(**{**TINY, "timesteps": timesteps})
    np.testing.assert_allclose(tdit.alpha_bar(tc).numpy(), np.asarray(jdit.alpha_bar(jc)),
                               atol=1e-6)
    for steps in (1, 2, 3, 7, 10, 50, 64, 250):
        want = np.asarray(jnp.linspace(timesteps - 1, 0, steps).astype(jnp.int32))
        np.testing.assert_array_equal(tdit._ddim_timesteps(tc, steps).numpy(), want,
                                      err_msg=str(steps))


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 17, 499, 999], np.int32)
    for dim in (256, 64):
        np.testing.assert_allclose(
            tdit._timestep_embedding(torch.from_numpy(t), dim).numpy(),
            np.asarray(jdit._timestep_embedding(jnp.asarray(t), dim)), atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_modulated_ln_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x, shift, scale = (rng.normal(size=s).astype(np.float32) * 2 + 0.5
                       for s in ((2, 5, 16), (2, 16), (2, 16)))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jdit._modulated_ln(*(jnp.asarray(a, jd) for a in (x, shift, scale)))
    got = tdit._modulated_ln(*(torch.from_numpy(a).to(td) for a in (x, shift, scale)))
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=1e-6 if dtype == "float32" else 2e-2, rtol=0)


# --------------------------------------------------------------------------
# forward and loss
# --------------------------------------------------------------------------
@pytest.mark.parametrize("conditional", [True, False], ids=["labels", "no_labels"])
def test_dit_forward_matches_jax(params, conditional):
    jp, tp = params
    t = np.array([0, 7, 30, 49], np.int32)
    labels = LABELS if conditional else None
    ref = jdit.dit_forward(JCFG, jp, jnp.asarray(IMAGES), jnp.asarray(t),
                           None if labels is None else jnp.asarray(labels))
    got = tdit.dit_forward(TCFG, tp, torch.from_numpy(IMAGES), torch.from_numpy(t),
                           None if labels is None else torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.shape == IMAGES.shape
    assert float(np.abs(np.asarray(ref)).max()) > 0.1  # the perturbation reached the output
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_dit_forward_unconditional_config_matches_jax():
    jc = jdit.DiTConfig(**{**TINY, "num_classes": 0}, dtype=jnp.float32)
    tc = tdit.DiTConfig(**{**TINY, "num_classes": 0}, dtype=torch.float32)
    jp, tp = _perturbed(jc, 1)
    assert "label_embed" not in tp
    t = np.array([3, 3, 40, 12], np.int32)
    ref = jdit.dit_forward(jc, jp, jnp.asarray(IMAGES), jnp.asarray(t))
    got = tdit.dit_forward(tc, tp, torch.from_numpy(IMAGES), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_fresh_dit_predicts_zero_noise():
    tp = tdit.init_dit_params(TCFG, torch.Generator().manual_seed(0))
    eps = tdit.dit_forward(TCFG, tp, torch.from_numpy(IMAGES), torch.zeros(4, dtype=torch.int32),
                           torch.zeros(4, dtype=torch.int32))
    assert float(eps.abs().max()) == 0.0


def _jax_draws(key, B, shape, label_dropout=0.1):
    """The draws of ``ray_tpu.models.dit.dit_loss_fn`` for ``key``."""
    k_t, k_eps, k_drop = jax.random.split(key, 3)
    t = jax.random.randint(k_t, (B,), 0, JCFG.timesteps)
    eps = jax.random.normal(k_eps, shape, jnp.float32)
    drop = jax.random.uniform(k_drop, (B,)) < label_dropout
    return tuple(torch.from_numpy(np.array(a)) for a in (t, eps, drop))


@pytest.mark.parametrize("label_dropout", [0.5, 0.0], ids=["dropout", "no_dropout"])
def test_dit_loss_and_grads_at_jax_draws(params, label_dropout):
    jp, tp = params
    key = jax.random.key(9)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jdit.dit_loss_fn(JCFG, p, jnp.asarray(IMAGES), jnp.asarray(LABELS), key,
                                   label_dropout=label_dropout))(jp)
    t, eps, drop = _jax_draws(key, 4, IMAGES.shape, label_dropout)
    assert drop.any() == (label_dropout > 0)  # the null label is on the path
    loss, grads = ttr.value_and_grad(
        lambda p: tdit._dit_loss_at(TCFG, p, torch.from_numpy(IMAGES), torch.from_numpy(LABELS),
                                    t, eps, drop if label_dropout > 0 else None), tp)
    assert abs(float(loss) - float(ref_loss)) <= ATOL
    _assert_tree_close(grads, ref_grads, 1e-5, "grad")


def test_dit_train_step_learns_and_draws_from_the_generator():
    init_state, step = tdit.make_dit_train_step(TCFG, learning_rate=2e-3, device="cpu")
    state = init_state(1)
    g = torch.Generator().manual_seed(3)
    imgs, labels = torch.from_numpy(IMAGES), torch.from_numpy(LABELS)
    losses = [float(step(state, imgs, labels, g)[1]) for _ in range(30)]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.9
    a = tdit.dit_loss_fn(TCFG, state["params"], imgs, labels, torch.Generator().manual_seed(4))
    b = tdit.dit_loss_fn(TCFG, state["params"], imgs, labels, torch.Generator().manual_seed(4))
    assert torch.equal(a, b)
    with pytest.raises(TypeError, match="Mesh"):  # a mesh is the port's Mesh
        tdit.make_dit_train_step(TCFG, mesh=object(), device="cpu")


# --------------------------------------------------------------------------
# DDIM
# --------------------------------------------------------------------------
@pytest.mark.parametrize("guidance", [0.0, 4.0], ids=["unguided", "guided"])
def test_ddim_loop_from_jax_noise_matches_jax(params, guidance):
    jp, tp = params
    key = jax.random.key(5)
    labels = np.array([1, 0, 2], np.int32)
    ref = jdit.ddim_sample(JCFG, jp, key, num=3, steps=6, labels=jnp.asarray(labels),
                           guidance_scale=guidance)
    x = torch.from_numpy(np.array(jax.random.normal(key, (3, 8, 8, 1), jnp.float32)))
    got = tdit._ddim_loop(TCFG, tp, x, steps=6, labels=torch.from_numpy(labels),
                          guidance_scale=guidance)
    assert got.shape == (3, 8, 8, 1) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    g = torch.Generator().manual_seed(0)
    drawn = tdit.ddim_sample(TCFG, tp, g, num=3, steps=6, labels=torch.from_numpy(labels),
                             guidance_scale=guidance)
    x0 = torch.randn((3, 8, 8, 1), generator=torch.Generator().manual_seed(0))
    assert torch.equal(drawn, tdit._ddim_loop(TCFG, tp, x0, steps=6,
                                              labels=torch.from_numpy(labels),
                                              guidance_scale=guidance))


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------
def test_dit_and_vit_checkpoints_round_trip(tmp_path, params):
    from ray_tpu_torch.models import vit as tvit

    _, tp = params
    cfg = tdit.DiTConfig(**TINY, dtype=torch.bfloat16, param_dtype=torch.float32)
    save_model(str(tmp_path / "dit"), cfg, tp)
    got_cfg, got = load_model(str(tmp_path / "dit"), device="cpu")
    assert got_cfg == cfg and got_cfg.dtype is torch.bfloat16
    for a, b in zip(ttr._leaves(tp), ttr._leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    vcfg = tvit.ViTConfig(image_size=16, patch_size=4, d_model=32, n_layers=1, n_heads=2,
                          d_ff=64, num_classes=10, param_dtype=torch.bfloat16, remat=True)
    vp = tvit.init_vit_params(vcfg, torch.Generator().manual_seed(0))
    save_model(str(tmp_path / "vit"), vcfg, vp)
    got_cfg, got = load_model(str(tmp_path / "vit"), device="cpu")
    assert got_cfg == vcfg and got_cfg.param_dtype is torch.bfloat16
    assert all(torch.equal(a, b) for a, b in zip(ttr._leaves(vp), ttr._leaves(got)))
