"""The port's RL losses against the JAX package's, given the same batch and
the same noise, on the CPU.

GAE and V-trace within 1e-5; each loss within 1e-5 and its gradients
within 1e-4 of their leaf's largest magnitude, from a JAX module's params
converted by ``ray_tpu_torch.convert``: PPO, IMPALA, APPO, DQN, BC and
MARWIL (beta 0 and 1) through each package's loss function; SAC and CQL,
whose losses live inside their learners' updates, through three updates of
each learner from the same state, with the JAX update's key draws fed to
the port as tensors (the first update's Adam ``mu`` is a tenth of the
gradients).
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ray_tpu.rllib import rl_module as jmod  # noqa: E402
from ray_tpu.rllib.algorithms import bc as jbc  # noqa: E402
from ray_tpu.rllib.algorithms import cql as jcql  # noqa: E402
from ray_tpu.rllib.algorithms import dqn as jdqn  # noqa: E402
from ray_tpu.rllib.algorithms import impala as jimpala  # noqa: E402
from ray_tpu.rllib.algorithms import marwil as jmarwil  # noqa: E402
from ray_tpu.rllib.algorithms import ppo as jppo  # noqa: E402
from ray_tpu.rllib.algorithms import sac as jsac  # noqa: E402
from ray_tpu_torch import convert  # noqa: E402
from ray_tpu_torch.rllib import learner as tlearner  # noqa: E402
from ray_tpu_torch.rllib import rl_module as tmod  # noqa: E402
from ray_tpu_torch.rllib.algorithms import bc as tbc  # noqa: E402
from ray_tpu_torch.rllib.algorithms import cql as tcql  # noqa: E402
from ray_tpu_torch.rllib.algorithms import dqn as tdqn  # noqa: E402
from ray_tpu_torch.rllib.algorithms import impala as timpala  # noqa: E402
from ray_tpu_torch.rllib.algorithms import marwil as tmarwil  # noqa: E402
from ray_tpu_torch.rllib.algorithms import ppo as tppo  # noqa: E402
from ray_tpu_torch.rllib.algorithms import sac as tsac  # noqa: E402
from ray_tpu_torch.rllib.sample_batch import SampleBatch  # noqa: E402

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the RL tensors are small, and torch's thread pool
    beside the other test workers' slows each small op by orders of
    magnitude (spinning threads wait for descheduled ones)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def npt(tree):
    return jax.tree.map(np.asarray, tree)


def t(x):
    return torch.as_tensor(np.array(x))


def n(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close_trees(got, want, rel, what=""):
    g, w = tmod.tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        a, b = n(a), np.asarray(b)
        assert a.shape == b.shape, (what, i)
        err = float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)
        assert err <= rel, (what, i, err)


# --------------------------------------------------------------------------
# GAE and V-trace
# --------------------------------------------------------------------------
def _time_major(rng, T=24, B=5):
    return dict(rewards=rng.normal(size=(T, B)).astype(np.float32),
                values=rng.normal(size=(T, B)).astype(np.float32),
                dones=rng.random((T, B)) < 0.15,
                final_value=rng.normal(size=B).astype(np.float32))


def test_gae_matches():
    d = _time_major(np.random.default_rng(0))
    want = jppo._gae(*(jnp.asarray(d[k]) for k in ("rewards", "values", "dones", "final_value")),
                     0.99, 0.95)
    got = tppo._gae(*(t(d[k]) for k in ("rewards", "values", "dones", "final_value")), 0.99, 0.95)
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), np.asarray(b), **FWD)


def test_attach_gae_and_flatten_matches():
    rng = np.random.default_rng(1)
    T, B = 16, 4
    jm, tm = jmod.ActorCriticModule(4, 2, (16,)), tmod.ActorCriticModule(4, 2, (16,))
    jp = jm.init(jax.random.key(2))
    tp = convert.rllib_params_from_jax(npt(jp))
    batch = {"obs": rng.normal(size=(T, B, 4)).astype(np.float32),
             "next_obs": rng.normal(size=(T, B, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, (T, B)).astype(np.int32),
             "rewards": rng.normal(size=(T, B)).astype(np.float32),
             "values": rng.normal(size=(T, B)).astype(np.float32),
             "dones": rng.random((T, B)) < 0.1,
             "truncateds": rng.random((T, B)) < 0.1}
    final_obs = rng.normal(size=(B, 4)).astype(np.float32)
    want = jppo.attach_gae_and_flatten(SampleBatch(dict(batch)), final_obs,
                                       jax.jit(jm.value), jp, 0.99, 0.95)
    got = tppo.attach_gae_and_flatten(SampleBatch(dict(batch)), final_obs, tm.value, tp,
                                      0.99, 0.95)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], **FWD)


@pytest.mark.parametrize("clips", [(1.0, 1.0), (0.8, 1.2)])
def test_vtrace_matches(clips):
    rng = np.random.default_rng(3)
    d = _time_major(rng)
    behavior = np.log(rng.uniform(0.2, 0.8, d["rewards"].shape)).astype(np.float32)
    target = np.log(rng.uniform(0.2, 0.8, d["rewards"].shape)).astype(np.float32)
    args = (behavior, target, d["rewards"], d["values"], d["dones"], d["final_value"])
    want = jimpala.vtrace(*(jnp.asarray(a) for a in args), 0.99, *clips)
    got = timpala.vtrace(*(t(a) for a in args), 0.99, *clips)
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), np.asarray(b), **FWD)


# --------------------------------------------------------------------------
# losses and gradients through each package's loss function
# --------------------------------------------------------------------------
def _flat_batch(rng, m, obs_size=4, num_actions=2):
    return {"obs": rng.normal(size=(m, obs_size)).astype(np.float32),
            "next_obs": rng.normal(size=(m, obs_size)).astype(np.float32),
            "actions": rng.integers(0, num_actions, m).astype(np.int32),
            "rewards": rng.normal(size=m).astype(np.float32),
            "dones": rng.random(m) < 0.2,
            "logp": np.log(rng.uniform(0.3, 0.7, m)).astype(np.float32),
            "advantages": rng.normal(size=m).astype(np.float32),
            "returns": rng.uniform(0, 10, m).astype(np.float32)}


def _impala_batch(rng, T=12, B=6):
    return {"obs": rng.normal(size=(T, B, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, (T, B)).astype(np.int32),
            "rewards": rng.normal(size=(T, B)).astype(np.float32),
            "dones": rng.random((T, B)) < 0.1,
            "logp": np.log(rng.uniform(0.3, 0.7, (T, B))).astype(np.float32),
            "final_value": rng.normal(size=B).astype(np.float32)}


def _cfg(**kw):
    return types.SimpleNamespace(gamma=0.99, vtrace_rho_clip=1.0, vtrace_c_clip=1.0,
                                 entropy_coeff=0.01, vf_loss_coeff=0.5, **kw)


# name -> (module factory, loss factory per package, batch maker, aux maker)
_LOSSES = {
    "ppo": (lambda m: m.ActorCriticModule(4, 2, (32, 32)),
            lambda pkg, mod: pkg._ppo_loss(mod, 0.2, 0.01, 0.5), _flat_batch, None),
    "ppo_continuous": (lambda m: m.ContinuousActorCriticModule(4, 2, (32,)),
                       lambda pkg, mod: pkg._ppo_loss(mod, 0.3, 0.01, 0.5), "continuous", None),
    "impala": (lambda m: m.ActorCriticModule(4, 2, (32,)),
               lambda pkg, mod: pkg._impala_loss(mod, _cfg(), None), _impala_batch, None),
    "appo": (lambda m: m.ActorCriticModule(4, 2, (32,)),
             lambda pkg, mod: pkg._impala_loss(mod, _cfg(), 0.3), _impala_batch, None),
    "dqn": (lambda m: m.QModule(4, 3, (32, 32)),
            lambda pkg, mod: pkg._dqn_loss(mod, 0.99), "dqn", "target"),
    "bc": (lambda m: m.ActorCriticModule(4, 2, (32,)),
           lambda pkg, mod: pkg._bc_loss(mod), _flat_batch, None),
    "marwil_beta0": (lambda m: m.ActorCriticModule(4, 2, (32,)),
                     lambda pkg, mod: pkg._marwil_loss(mod, 0.0, 1.0), "marwil", None),
    "marwil_beta1": (lambda m: m.ActorCriticModule(4, 2, (32,)),
                     lambda pkg, mod: pkg._marwil_loss(mod, 1.0, 1.0), "marwil", None),
}
_PKG = {"ppo": (jppo, tppo), "ppo_continuous": (jppo, tppo), "impala": (jimpala, timpala),
        "appo": (jimpala, timpala), "dqn": (jdqn, tdqn), "bc": (jbc, tbc),
        "marwil_beta0": (jmarwil, tmarwil), "marwil_beta1": (jmarwil, tmarwil)}


def _loss_batch(kind, rng):
    if callable(kind):
        return kind(rng) if kind is _impala_batch else kind(rng, 48)
    b = _flat_batch(rng, 48, num_actions=3 if kind == "dqn" else 2)
    if kind == "continuous":
        b["actions"] = rng.normal(size=(48, 2)).astype(np.float32)
    if kind == "marwil":
        b["adv_sqd_norm"] = np.float32(2.5)
    return b


@pytest.mark.parametrize("name", sorted(_LOSSES))
def test_loss_and_gradients_match(name):
    make_module, make_loss, batch_kind, aux_kind = _LOSSES[name]
    jpkg, tpkg = _PKG[name]
    jm, tm = make_module(jmod), make_module(tmod)
    jp = jm.init(jax.random.key(4))
    if "log_std" in jp:  # a non-zero log_std exercises its gradient path
        jp["log_std"] = jnp.asarray([0.3, -0.2])
    tp = convert.rllib_params_from_jax(npt(jp))
    rng = np.random.default_rng(5)
    batch = _loss_batch(batch_kind, rng)
    jaux, taux = {}, {}
    if aux_kind == "target":
        jt = jm.init(jax.random.key(6))
        jaux = {"target_params": jt}
        taux = {"target_params": convert.rllib_params_from_jax(npt(jt))}
    (jl, jstats), jg = jax.value_and_grad(make_loss(jpkg, jm), has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, **jaux)
    tb = {k: tlearner.to_tensor(v, "cpu") for k, v in batch.items()}
    (tl, tstats), tg = tlearner.value_and_grad(make_loss(tpkg, tm), tp, tb, **taux)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5, abs=1e-5)
    assert sorted(tstats) == sorted(jstats)
    for k in jstats:
        np.testing.assert_allclose(n(tstats[k]), np.asarray(jstats[k]), **FWD, err_msg=k)
    close_trees(tg, jg, GRAD_REL, "grads")
    assert float(tlearner.global_norm(tg)) > 0


# --------------------------------------------------------------------------
# SAC and CQL: updates from the same state and the same draws
# --------------------------------------------------------------------------
def _sac_cql_batch(rng, m=64):
    """Observations at a tenth of unit scale keep the policy's draws off
    tanh's float32 saturation, where log(1 - tanh^2) magnifies tanh's
    rounding (``test_module_forward_pieces_match[sac]`` bounds that
    region)."""
    return {"obs": 0.1 * rng.normal(size=(m, 3)).astype(np.float32),
            "next_obs": 0.1 * rng.normal(size=(m, 3)).astype(np.float32),
            "actions": rng.uniform(-2, 2, (m, 1)).astype(np.float32),
            "rewards": rng.normal(size=m).astype(np.float32),
            "dones": rng.random(m) < 0.1}


def _adam_of(state):
    """The port's Adam state of a JAX optax adam state."""
    return convert.adam_state_from_jax(npt(state))


@pytest.mark.parametrize("learn_alpha", [True, False])
def test_sac_updates_match(learn_alpha):
    cfg = types.SimpleNamespace(seed=0, lr=3e-3, gamma=0.99, target_update_tau=0.05,
                                initial_alpha=0.2, learn_alpha=learn_alpha)
    jm, tm = jmod.SACModule(3, 1, -2.0, 2.0, (32, 32)), tmod.SACModule(3, 1, -2.0, 2.0, (32, 32))
    jl = jsac._SACLearner(jm, cfg)
    tl = tsac._SACLearner(tm, cfg, "cpu")
    tl.set_state({"params": convert.rllib_params_from_jax(npt(jl.params)),
                  "target_params": convert.rllib_params_from_jax(npt(jl.target_params)),
                  "log_alpha": t(np.asarray(jl.log_alpha)),
                  "opt_state": _adam_of(jl.opt_state),
                  "alpha_opt_state": _adam_of(jl.alpha_opt_state)})
    rng = np.random.default_rng(7)
    for step in range(3):
        batch = _sac_cql_batch(rng)
        key = jax.random.key(100 + step)
        knext, kpi = jax.random.split(key)
        noise = np.stack([np.asarray(jax.random.normal(k, (64, 1))) for k in (knext, kpi)])
        js = jl.update(SampleBatch(batch), key)
        ts = tl.update(SampleBatch(batch), t(noise))
        assert sorted(ts) == sorted(js)
        for k in js:
            assert ts[k] == pytest.approx(js[k], rel=1e-4, abs=1e-5), (step, k)
        if step == 0:  # the first update's mu is a tenth of the gradients
            close_trees(tl.opt_state["mu"], jl.opt_state[0].mu, GRAD_REL, "grads")
        close_trees(tl.params, jl.params, GRAD_REL, "params")
        close_trees(tl.target_params, jl.target_params, GRAD_REL, "target_params")
        assert float(tl.log_alpha) == pytest.approx(float(jl.log_alpha), rel=1e-5)


def test_cql_updates_match():
    cfg = types.SimpleNamespace(seed=0, lr=3e-3, gamma=0.99, target_update_tau=0.05,
                                initial_alpha=0.1, cql_alpha=1.0, num_ood_actions=4)
    jm, tm = jmod.SACModule(3, 1, -2.0, 2.0, (32, 32)), tmod.SACModule(3, 1, -2.0, 2.0, (32, 32))
    jl = jcql._CQLLearner(jm, cfg)
    tl = tcql._CQLLearner(tm, cfg, "cpu")
    tl.set_state({"params": convert.rllib_params_from_jax(npt(jl.params)),
                  "target_params": convert.rllib_params_from_jax(npt(jl.target_params)),
                  "opt_state": _adam_of(jl.opt_state)})
    rng = np.random.default_rng(8)
    B, N = 64, 4
    for step in range(3):
        batch = _sac_cql_batch(rng, B)
        key = jax.random.key(200 + step)
        # the draws of the JAX update (cql.py: critic_loss, actor_loss, update)
        kc, ka = jax.random.split(key)
        knext, krand, kpi = jax.random.split(kc, 3)
        noise = {"next": jax.random.normal(knext, (B, 1)),
                 "rand": jax.random.uniform(krand, (N, B, 1), minval=-2.0, maxval=2.0),
                 "pi": jnp.stack([jax.random.normal(k, (B, 1))
                                  for k in jax.random.split(kpi, N)]),
                 "actor": jax.random.normal(ka, (B, 1))}
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jl.params, jl.target_params, jl.opt_state, jstats = jl._update(
            jl.params, jl.target_params, jl.opt_state, jbatch, key)
        ts = tl.update(SampleBatch(batch), {k: t(np.asarray(v)) for k, v in noise.items()})
        assert sorted(ts) == sorted(jstats)
        for k in jstats:
            assert ts[k] == pytest.approx(float(jstats[k]), rel=1e-4, abs=1e-5), (step, k)
        if step == 0:
            close_trees(tl.opt_state["mu"], jl.opt_state[0].mu, GRAD_REL, "grads")
        close_trees(tl.params, jl.params, GRAD_REL, "params")
        close_trees(tl.target_params, jl.target_params, GRAD_REL, "target_params")
    # the port's own draws have the JAX draws' shapes and ranges
    drawn = tl.draw_noise(B)
    assert {k: tuple(v.shape) for k, v in drawn.items()} == {
        k: tuple(v.shape) for k, v in noise.items()}
    assert float(drawn["rand"].min()) >= -2.0 and float(drawn["rand"].max()) <= 2.0
