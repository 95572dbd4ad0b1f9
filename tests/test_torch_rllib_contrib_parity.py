"""The port's ``rllib`` part 2 (PG/A2C, SimpleQ/Ape-X, DDPG/TD3, ES/ARS, the
linear bandits, CRR, R2D2, MADDPG, QMIX, DT, DreamerV3) against the JAX
package's, on the CPU.

The same inputs, made from numpy seeds, go through both packages; weights
and optax states cross through ``ray_tpu_torch.convert``. Tolerances:
1e-5 (absolute and relative) for forwards and losses; gradients (the first
Adam step's ``mu`` is a tenth of them) and params after up to five
optimizer steps within 1e-4 of their leaf's largest magnitude. Env flags,
bandit arm choices, replay windows, ES ranks and greedy actions compare
exactly. Sampled values never compare across the packages (``jax.random``
against ``torch.Generator``): every port function whose JAX counterpart
draws from a key inside itself takes the draws as tensors, and the tests
feed it the JAX key's draws, walking the same key splits.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ray_tpu.rllib import envs as jenvs  # noqa: E402
from ray_tpu.rllib import rl_module as jmod  # noqa: E402
from ray_tpu.rllib.algorithms import bandit as jbandit  # noqa: E402
from ray_tpu.rllib.algorithms import crr as jcrr  # noqa: E402
from ray_tpu.rllib.algorithms import ddpg as jddpg  # noqa: E402
from ray_tpu.rllib.algorithms import dreamerv3 as jdream  # noqa: E402
from ray_tpu.rllib.algorithms import dt as jdt  # noqa: E402
from ray_tpu.rllib.algorithms import es as jes  # noqa: E402
from ray_tpu.rllib.algorithms import maddpg as jmaddpg  # noqa: E402
from ray_tpu.rllib.algorithms import pg as jpg  # noqa: E402
from ray_tpu.rllib.algorithms import qmix as jqmix  # noqa: E402
from ray_tpu.rllib.algorithms import r2d2 as jr2d2  # noqa: E402
from ray_tpu.rllib.algorithms import simple_q as jsq  # noqa: E402
from ray_tpu_torch import convert  # noqa: E402
from ray_tpu_torch.rllib import envs as tenvs  # noqa: E402
from ray_tpu_torch.rllib import learner as tlearner  # noqa: E402
from ray_tpu_torch.rllib import rl_module as tmod  # noqa: E402
from ray_tpu_torch.rllib.algorithms import bandit as tbandit  # noqa: E402
from ray_tpu_torch.rllib.algorithms import crr as tcrr  # noqa: E402
from ray_tpu_torch.rllib.algorithms import ddpg as tddpg  # noqa: E402
from ray_tpu_torch.rllib.algorithms import dreamerv3 as tdream  # noqa: E402
from ray_tpu_torch.rllib.algorithms import dt as tdt  # noqa: E402
from ray_tpu_torch.rllib.algorithms import es as tes  # noqa: E402
from ray_tpu_torch.rllib.algorithms import maddpg as tmaddpg  # noqa: E402
from ray_tpu_torch.rllib.algorithms import pg as tpg  # noqa: E402
from ray_tpu_torch.rllib.algorithms import qmix as tqmix  # noqa: E402
from ray_tpu_torch.rllib.algorithms import r2d2 as tr2d2  # noqa: E402
from ray_tpu_torch.rllib.algorithms import simple_q as tsq  # noqa: E402
from ray_tpu_torch.rllib.sample_batch import SampleBatch  # noqa: E402

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-4
CPU = "cpu"


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
    """A JAX tree as numpy."""
    return jax.tree.map(np.asarray, tree)


def t(x):
    return torch.as_tensor(np.array(x))


def n(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def conv(tree):
    """A JAX params tree or state (optax states inside) -> the port's."""
    return convert.rllib_params_from_jax(npt(tree))


def close_rel(got, want, rel, what=""):
    """|got - want| within ``rel`` of the largest |want|."""
    got, want = n(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    assert err <= rel, (what, err)


def close_trees(got, want, rel, what=""):
    g, w = tmod.tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        close_rel(a, b, rel, f"{what}[{i}]")


def close_stats(got: dict, want: dict, what=""):
    assert sorted(got) == sorted(want), what
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-4, abs=1e-5), (what, k)


def tbatch(batch):
    return {k: tlearner.to_tensor(v, CPU) for k, v in batch.items()}


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# --------------------------------------------------------------------------
# envs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["simple", "discrete"])
def test_spread_envs_step_for_step(kind):
    """64 envs of 3 agents, 30 steps (through the 25-step truncation): each
    step starts both packages from the JAX env's state with the same numpy
    actions; observations, rewards, states and the global state within
    1e-5, flags equal."""
    E, N = 64, 3
    jcls, tcls = ((jmaddpg.SimpleSpread, tmaddpg.SimpleSpread) if kind == "simple"
                  else (jqmix.DiscreteSpread, tqmix.DiscreteSpread))
    jenv, tenv = jcls(n_agents=N), tcls(n_agents=N)
    assert tenv.observation_size == jenv.observation_size
    jstep = jax.jit(jax.vmap(jenv.step))
    state, jobs = npt(jax.vmap(jenv.reset)(jax.random.split(jax.random.key(0), E)))
    np.testing.assert_allclose(n(tenv._obs({k: t(v) for k, v in state.items()})), jobs, **FWD)
    rng = np.random.default_rng(2)
    truncs = collisions = 0
    for _ in range(30):
        if kind == "simple":
            action = rng.uniform(-1.5, 1.5, (E, N, 2)).astype(np.float32)
        else:
            action = rng.integers(0, 5, (E, N)).astype(np.int32)
        ts = {k: t(v) for k, v in state.items()}
        if kind == "discrete":
            np.testing.assert_allclose(n(tenv.global_state(ts)),
                                       npt(jax.vmap(jenv.global_state)(state)), **FWD)
        js, jo, jr, jterm, jtrunc = npt(jstep(state, jnp.asarray(action)))
        ts2, to, tr, tterm, ttrunc = tenv.step(ts, t(action))
        np.testing.assert_array_equal(n(tterm), jterm)
        np.testing.assert_array_equal(n(ttrunc), jtrunc)
        np.testing.assert_allclose(n(to), jo, **FWD)
        np.testing.assert_allclose(n(tr), jr, **FWD)
        for k in js:
            np.testing.assert_allclose(n(ts2[k]), js[k], **FWD)
            assert n(ts2[k]).dtype == js[k].dtype, k
        truncs += int(jtrunc.sum())
        # a collision costs 1: the cover cost alone is never an integer step
        d = np.linalg.norm(js["pos"][:, :, None] - js["pos"][:, None], axis=-1)
        collisions += int((np.triu(d < jenv.collision_radius, 1)).sum())
        state = js
    assert truncs == 6 * E and collisions > 0


def _jax_bandit_draws(keys, dim):
    """The JAX env step's draws of each env key: its noise, then its next
    context (``bandit.py:55-58``)."""
    def one(k):
        kn, knext = jax.random.split(jax.random.fold_in(k, 1))
        return jnp.concatenate([jax.random.normal(kn)[None], jax.random.normal(knext, (dim,))])

    return np.asarray(jax.vmap(one)(keys))


def test_linear_bandit_env_steps_with_the_jax_draws(monkeypatch):
    """With the JAX env's arm weights and step draws in place of its own
    (D5), the port's bandit steps 32 envs as the JAX env does for 20 steps:
    rewards and the best expected reward within 1e-5, next contexts and
    flags equal."""
    E, D, A = 32, 6, 4
    jenv = jbandit.LinearBanditEnv(num_arms=A, context_dim=D, noise=0.1, env_seed=3)
    tenv = tbandit.LinearBanditEnv(num_arms=A, context_dim=D, noise=0.1, env_seed=3)
    w = np.asarray(jenv._weights())
    monkeypatch.setattr(tbandit.LinearBanditEnv, "_weights", lambda self, device: t(w))
    state, ctx = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(0), E))
    rng = np.random.default_rng(3)
    for _ in range(20):
        z = _jax_bandit_draws(state["key"], D)
        monkeypatch.setattr(tbandit.LinearBanditEnv, "_draws",
                            lambda self, key, k, z=z: (t(z), key))
        action = rng.integers(0, A, E).astype(np.int32)
        js, jo, jr, jterm, jtrunc = jax.vmap(jenv.step)(state, jnp.asarray(action))
        tstate = {"ctx": t(np.asarray(ctx)), "key": torch.ones(E, dtype=torch.int64)}
        ts, to, tr, tterm, ttrunc = tenv.step(tstate, t(action))
        np.testing.assert_allclose(n(tr), np.asarray(jr), **FWD)
        np.testing.assert_array_equal(n(to), np.asarray(jo))
        np.testing.assert_array_equal(n(tterm), np.asarray(jterm))
        np.testing.assert_array_equal(n(ttrunc), np.asarray(jtrunc))
        np.testing.assert_allclose(n(tenv.best_expected_reward(t(np.asarray(ctx)))),
                                   np.asarray(jax.vmap(jenv.best_expected_reward)(ctx)), **FWD)
        state, ctx = js, jo


# --------------------------------------------------------------------------
# losses and gradients through each package's loss function
# --------------------------------------------------------------------------
def _flat_batch(rng, m=48, num_actions=2):
    return {"obs": rng.normal(size=(m, 4)).astype(np.float32),
            "next_obs": rng.normal(size=(m, 4)).astype(np.float32),
            "actions": rng.integers(0, num_actions, m).astype(np.int32),
            "rewards": rng.normal(size=m).astype(np.float32),
            "dones": rng.random(m) < 0.2,
            "advantages": rng.normal(size=m).astype(np.float32),
            "returns": rng.uniform(0, 10, m).astype(np.float32),
            "weights": rng.uniform(0.2, 1.0, m).astype(np.float32)}


# name -> (module factory, loss factory per package, package pair, uses target params)
_LOSSES = {
    "pg": (lambda m: m.ActorCriticModule(4, 2, (32, 32)),
           lambda pkg, mod: pkg._pg_loss(mod), (jpg, tpg), False),
    "pg_continuous": (lambda m: m.ContinuousActorCriticModule(4, 2, (32,)),
                      lambda pkg, mod: pkg._pg_loss(mod), (jpg, tpg), False),
    "a2c": (lambda m: m.ActorCriticModule(4, 2, (32, 32)),
            lambda pkg, mod: pkg._a2c_loss(mod, 0.01, 0.5), (jpg, tpg), False),
    "simple_q": (lambda m: m.QModule(4, 3, (32, 32)),
                 lambda pkg, mod: pkg._simple_q_loss(mod, 0.99), (jsq, tsq), True),
    "apex": (lambda m: m.QModule(4, 3, (32, 32)),
             lambda pkg, mod: pkg._apex_loss(mod, 0.99), (jsq, tsq), True),
}


@pytest.mark.parametrize("name", sorted(_LOSSES))
def test_loss_and_gradients_match(name):
    make_module, make_loss, (jpkg, tpkg), target = _LOSSES[name]
    jm, tm = make_module(jmod), make_module(tmod)
    jp = jm.init(jax.random.key(4))
    if "log_std" in jp:  # a non-zero log_std exercises its gradient path
        jp["log_std"] = jnp.asarray([0.3, -0.2])
    rng = np.random.default_rng(5)
    batch = _flat_batch(rng, num_actions=getattr(jm, "num_actions", 2))
    if name == "pg_continuous":
        batch["actions"] = rng.normal(size=(48, 2)).astype(np.float32)
    jaux, taux = {}, {}
    if target:
        jt = jm.init(jax.random.key(6))
        jaux, taux = {"target_params": jt}, {"target_params": conv(jt)}
    (jl, jstats), jg = jax.value_and_grad(make_loss(jpkg, jm), has_aux=True)(
        jp, jbatch(batch), **jaux)
    (tl, tstats), tg = tlearner.value_and_grad(make_loss(tpkg, tm), conv(jp), tbatch(batch),
                                               **taux)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5, abs=1e-5)
    assert sorted(tstats) == sorted(jstats)
    for k in jstats:
        np.testing.assert_allclose(n(tstats[k]), np.asarray(jstats[k]), **FWD, err_msg=k)
    close_trees(tg, jg, GRAD_REL, "grads")
    assert float(tlearner.global_norm(tg)) > 0


def _sequence_batch(rng, B=4, T=10, obs_size=4):
    """[B, T] sequences with terminations and truncations mid-sequence."""
    dones = rng.random((B, T)) < 0.1
    truncs = (rng.random((B, T)) < 0.1) & ~dones
    truncs[0, 5] = True  # at least one cut past the burn-in
    dones[1, 6] = True
    return {"obs": rng.normal(size=(B, T, obs_size)).astype(np.float32),
            "next_obs": rng.normal(size=(B, T, obs_size)).astype(np.float32),
            "actions": rng.integers(0, 2, (B, T)).astype(np.int32),
            "rewards": rng.normal(size=(B, T)).astype(np.float32),
            "dones": dones, "truncateds": truncs}


@pytest.mark.parametrize("burn_in", [0, 3])
def test_r2d2_loss_and_gradients_match(burn_in):
    """Burn-in masks, hidden resets at terminations and truncations, the
    truncation's bootstrap from next_obs, double-DQN targets."""
    jm, tm = jr2d2.GRUQModule(4, 2, 16), tr2d2.GRUQModule(4, 2, 16)
    jp = jm.init(jax.random.key(0))
    jt = jax.tree.map(lambda x: x * 0.9, jp)
    batch = _sequence_batch(np.random.default_rng(burn_in))
    (jl, jstats), jg = jax.value_and_grad(jr2d2._r2d2_loss(jm, 0.99, burn_in), has_aux=True)(
        jp, jbatch(batch), target_params=jt)
    (tl, tstats), tg = tlearner.value_and_grad(tr2d2._r2d2_loss(tm, 0.99, burn_in), conv(jp),
                                               tbatch(batch), target_params=conv(jt))
    assert float(tl) == pytest.approx(float(jl), rel=1e-5, abs=1e-5)
    close_stats(tstats, jstats, "r2d2")
    close_trees(tg, jg, GRAD_REL, "grads")


def test_gru_unroll_matches_stepwise_and_the_jax_unroll():
    """The unroll with a reset at t=3 equals the JAX scan, and stepping the
    cell by hand (zeroing h where ``reset_before`` is set)."""
    jm, tm = jr2d2.GRUQModule(3, 2, 8), tr2d2.GRUQModule(3, 2, 8)
    jp = jm.init(jax.random.key(0))
    tp = conv(jp)
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(6, 2, 3)).astype(np.float32)
    resets = np.zeros((6, 2), np.float32)
    resets[3, 0] = 1.0
    jq, jh = jm.unroll(jp, jm.initial_state((2,)), jnp.asarray(obs), jnp.asarray(resets),
                       return_hidden=True)
    tq, th = tm.unroll(tp, tm.initial_state((2,)), t(obs), t(resets), return_hidden=True)
    np.testing.assert_allclose(n(tq), np.asarray(jq), **FWD)
    np.testing.assert_allclose(n(th), np.asarray(jh), **FWD)
    h = tm.initial_state((2,))
    for step in range(6):
        h = h * (1.0 - t(resets[step]))[:, None]
        h, q = tm.step(tp, h, t(obs[step]))
        np.testing.assert_allclose(n(q), n(tq[step]), rtol=1e-6, atol=1e-6)
    # the greedy actions of the two unrolls are equal
    np.testing.assert_array_equal(n(tq.argmax(-1)), np.asarray(jq.argmax(-1)))


# --------------------------------------------------------------------------
# DDPG / TD3 and CRR: updates from the same state and the same draws
# --------------------------------------------------------------------------
def _continuous_batch(rng, m=64, obs_size=3):
    """Observations at a tenth of unit scale keep the policy's draws off
    tanh's float32 saturation (as the SAC parity tests do)."""
    return {"obs": 0.1 * rng.normal(size=(m, obs_size)).astype(np.float32),
            "next_obs": 0.1 * rng.normal(size=(m, obs_size)).astype(np.float32),
            "actions": rng.uniform(-1.9, 1.9, (m, 1)).astype(np.float32),
            "rewards": rng.normal(size=m).astype(np.float32),
            "dones": rng.random(m) < 0.1}


@pytest.mark.parametrize("td3", [False, True], ids=["ddpg", "td3"])
def test_ddpg_updates_match(td3):
    """Four updates (TD3: critic only at 1 and 3, with the delayed policy
    step at 2 and 4) from the same state, the smoothing noise the JAX key's
    normal draw."""
    base = jddpg.TD3Config() if td3 else jddpg.DDPGConfig()
    cfg = types.SimpleNamespace(**{k: getattr(base, k) for k in (
        "twin_q", "policy_delay", "target_noise", "target_noise_clip")},
        seed=0, lr=3e-3, critic_lr=5e-3, gamma=0.99, target_update_tau=0.05)
    jm, tm = (m.DDPGModule(3, 1, -2.0, 2.0, (32, 32)) for m in (jmod, tmod))
    jl, tl = jddpg._DDPGLearner(jm, cfg), tddpg._DDPGLearner(tm, cfg, CPU)
    tl.set_state({"params": conv(jl.params), "target_params": conv(jl.target_params),
                  "actor_opt_state": conv(jl.actor_opt_state),
                  "critic_opt_state": conv(jl.critic_opt_state), "step": 0})
    rng = np.random.default_rng(7)
    for step in range(4):
        batch = _continuous_batch(rng)
        key = jax.random.key(100 + step)
        js = jl.update(SampleBatch(batch), key)
        ts = tl.update(SampleBatch(batch), t(jax.random.normal(key, (64, 1))))
        close_stats(ts, js, f"step {step}")
        assert (ts["actor_loss"] == 0.0) == (js["actor_loss"] == 0.0)
        if step == 0:  # the first update's critic mu is a tenth of the gradients
            close_trees(tl.critic_opt_state["mu"], jl.critic_opt_state[0].mu, GRAD_REL, "mu")
        close_trees(tl.params, jl.params, GRAD_REL, "params")
        close_trees(tl.target_params, jl.target_params, GRAD_REL, "target_params")
    assert tl._step == jl._step == 4


def _crr_pair(batch, **training):
    jcfg = (jcrr.CRRConfig().environment(jenvs.Pendulum()).offline_data(SampleBatch(batch))
            .training(hidden=(32, 32), **training).debugging(seed=0))
    tcfg = (tcrr.CRRConfig().environment(tenvs.Pendulum()).offline_data(SampleBatch(batch))
            .training(hidden=(32, 32), **training).debugging(seed=0).resources(device=CPU))
    return jcfg.build(), tcfg.build()


@pytest.mark.parametrize("weight_fn", ["bin", "exp"])
def test_crr_updates_match(weight_fn):
    """Two critic-only warm-up updates, then three with the weighted-BC
    actor step; the next-state and baseline draws the JAX key's
    (``crr.py:121``, ``:162``)."""
    rng = np.random.default_rng(8)
    data = _continuous_batch(rng, 512)
    ja, ta = _crr_pair(data, weight_fn=weight_fn, advantage_samples=3)
    ta.set_state(conv({"params": ja.params, "target_params": ja.target_params,
                       "actor_opt": ja.actor_opt, "critic_opt": ja.critic_opt})
                 | {"updates": 0, "iteration": 0, "total_env_steps": 0})
    params, target, aopt, copt = ja.params, ja.target_params, ja.actor_opt, ja.critic_opt
    for step in range(5):
        idx = rng.integers(0, 512, 64)
        batch = {k: v[idx] for k, v in data.items()}
        key = jax.random.key(200 + step)
        knext, kadv = jax.random.split(key)
        noise = {"next": jax.random.normal(knext, (64, 1)),
                 "adv": jnp.stack([jax.random.normal(k, (64, 1))
                                   for k in jax.random.split(kadv, 3)])}
        params, target, aopt, copt, jstats = ja._update(params, target, aopt, copt,
                                                        jbatch(batch), key, do_actor=step >= 2)
        tstats = ta._update(tbatch(batch), {k: t(np.asarray(v)) for k, v in noise.items()},
                            do_actor=step >= 2)
        close_stats(tstats, jstats, f"step {step}")
        close_trees(ta.params, params, GRAD_REL, "params")
        close_trees(ta.target_params, target, GRAD_REL, "target_params")
        if step == 2:  # the actor's first step: its mu is a tenth of the gradients
            close_trees(ta.actor_opt["mu"], aopt[0].mu, GRAD_REL, "actor mu")
    assert 0.0 < float(jstats["weight_mean"]) < (1.0 if weight_fn == "bin" else 20.0)


# --------------------------------------------------------------------------
# MADDPG and QMIX: updates from the same state
# --------------------------------------------------------------------------
def _multi_agent_batch(rng, env, m=64, discrete=False):
    N, O = env.n_agents, env.observation_size
    batch = {"obs": rng.normal(size=(m, N, O)).astype(np.float32),
             "next_obs": rng.normal(size=(m, N, O)).astype(np.float32),
             "dones": np.broadcast_to(rng.random((m, 1)) < 0.1, (m, N)).copy()}
    if discrete:
        batch.update(actions=rng.integers(0, env.num_actions, (m, N)).astype(np.int32),
                     rewards=rng.normal(size=m).astype(np.float32),
                     dones=batch["dones"][:, 0],
                     global_state=rng.normal(size=(m, env.global_state_size)).astype(np.float32),
                     next_global_state=rng.normal(size=(m, env.global_state_size)
                                                  ).astype(np.float32))
    else:
        batch.update(actions=rng.uniform(-1, 1, (m, N, 2)).astype(np.float32),
                     rewards=np.repeat(rng.normal(size=(m, 1)), N, 1).astype(np.float32))
    return batch


def test_maddpg_updates_match():
    """Three updates of three agents' stacked actors and centralized
    critics: the agent axis second from last in observations and actions."""
    jenv, tenv = jmaddpg.SimpleSpread(n_agents=3), tmaddpg.SimpleSpread(n_agents=3)
    ja = jmaddpg.MADDPGConfig().environment(jenv).training(hidden=(32,)).debugging(seed=0).build()
    ta = (tmaddpg.MADDPGConfig().environment(tenv).training(hidden=(32,)).debugging(seed=0)
          .resources(device=CPU).build())
    assert [tuple(x.shape) for x in tmod.tree_leaves(ta.nets.params)] == [
        x.shape for x in jax.tree.leaves(ja.nets.params)]
    state = conv({"params": ja.nets.params, "target_params": ja.target_params,
                  "actor_opt": ja.actor_opt, "critic_opt": ja.critic_opt})
    params, target, aopt, copt = ja.nets.params, ja.target_params, ja.actor_opt, ja.critic_opt
    rng = np.random.default_rng(9)
    for step in range(3):
        batch = _multi_agent_batch(rng, jenv)
        params, target, aopt, copt, jstats = ja._update(params, target, aopt, copt, jbatch(batch))
        state, tstats = tmaddpg._maddpg_update(ta.config, ta.nets, (ta.actor_tx, ta.critic_tx),
                                               state, tbatch(batch))
        close_stats(tstats, jstats, f"step {step}")
        if step == 0:
            close_trees(state["critic_opt"]["mu"], copt[0].mu, GRAD_REL, "critic mu")
            close_trees(state["actor_opt"]["mu"], aopt[0].mu, GRAD_REL, "actor mu")
        close_trees(state["params"], params, GRAD_REL, "params")
        close_trees(state["target_params"], target, GRAD_REL, "target_params")
    obs = rng.normal(size=(16, 3, jenv.observation_size)).astype(np.float32)
    np.testing.assert_allclose(n(tmaddpg._MADDPGNets.actions(state["params"], t(obs))),
                               np.asarray(ja.nets.actions(params, jnp.asarray(obs))), **FWD)


def test_qmix_updates_match():
    """Three updates: per-agent utilities, team-level double Q, the
    monotone mixer of the global state; the mixer and greedy actions match."""
    jenv, tenv = jqmix.DiscreteSpread(n_agents=3), tqmix.DiscreteSpread(n_agents=3)
    ja = jqmix.QMIXConfig().environment(jenv).training(hidden=(32,)).debugging(seed=0).build()
    ta = (tqmix.QMIXConfig().environment(tenv).training(hidden=(32,)).debugging(seed=0)
          .resources(device=CPU).build())
    state = conv({"params": ja.nets.params, "target_params": ja.target_params,
                  "opt_state": ja.opt_state})
    params, target, opt = ja.nets.params, ja.target_params, ja.opt_state
    rng = np.random.default_rng(10)
    for step in range(3):
        batch = _multi_agent_batch(rng, jenv, discrete=True)
        params, target, opt, jstats = ja._update(params, target, opt, jbatch(batch))
        state, tstats = tqmix._qmix_update(ta.config, ta.nets, ta.tx, state, tbatch(batch))
        close_stats(tstats, jstats, f"step {step}")
        if step == 0:
            close_trees(state["opt_state"]["mu"], opt[0].mu, GRAD_REL, "mu")
        close_trees(state["params"], params, GRAD_REL, "params")
        close_trees(state["target_params"], target, GRAD_REL, "target_params")
    qs = rng.normal(size=(16, 3)).astype(np.float32)
    gs = rng.normal(size=(16, jenv.global_state_size)).astype(np.float32)
    np.testing.assert_allclose(n(ta.nets.mix(state["params"], t(qs), t(gs))),
                               np.asarray(ja.nets.mix(params, jnp.asarray(qs), jnp.asarray(gs))),
                               **FWD)
    obs = rng.normal(size=(16, 3, jenv.observation_size)).astype(np.float32)
    np.testing.assert_array_equal(
        n(tqmix._QMixNets.agent_qs(state["params"], t(obs)).argmax(-1)),
        np.asarray(jqmix._QMixNets.agent_qs(params, jnp.asarray(obs)).argmax(-1)))


# --------------------------------------------------------------------------
# ES and ARS: the population's episodes and the updates
# --------------------------------------------------------------------------
def _es_eps(theta, key, half):
    """The JAX step's perturbations of ``key`` (``es.py:148-153``)."""
    knoise, keval = jax.random.split(key)
    leaves = jax.tree.leaves(theta)
    nkeys = jax.random.split(knoise, len(leaves))
    return [jax.random.normal(k, (half,) + leaf.shape) for k, leaf in zip(nkeys, leaves)], keval


def _population_returns(jenv, tcfg, theta, eps, keval, P, length, norm=None):
    """The port's episodes of the population built from ``eps``, from the
    JAX step's own starting states."""
    env = tenvs.CartPole()
    policy = tes._DeterministicPolicy(env, tcfg.hidden)
    pop = tmod.tree_unflatten(conv(theta), tes._perturb(tmod.tree_leaves(conv(theta)),
                                                       [t(np.asarray(e)) for e in eps],
                                                       tcfg.noise_std))
    state, obs = npt(jax.vmap(jenv.reset)(jax.random.split(keval, P)))
    return tes._evaluate(env, policy, pop, {k: t(v) for k, v in state.items()}, t(obs), length,
                         norm)


def test_es_step_matches_from_the_same_perturbations_and_returns():
    """One ES step: the population's episodes from the JAX step's starts
    (returns and steps equal, observation sums within 1e-5), the centered
    ranks equal with ties among the returns, and the Adam step on theta."""
    jcfg = (jes.ESConfig().environment(jenvs.CartPole())
            .training(population_size=16, noise_std=0.1, lr=0.05, eval_length=60, hidden=(8,))
            .debugging(seed=0))
    tcfg = (tes.ESConfig().environment(tenvs.CartPole())
            .training(population_size=16, noise_std=0.1, lr=0.05, eval_length=60, hidden=(8,))
            .debugging(seed=0).resources(device=CPU))
    ja = jcfg.build()
    key = jax.random.key(5)
    theta, opt = ja.theta, ja.opt_state
    new_theta, new_opt, returns, steps = ja._es_step(theta, opt, key)
    eps, keval = _es_eps(theta, key, 8)
    tret, tsteps, _, _ = _population_returns(ja.config.env, tcfg, theta, eps, keval, 16, 60)
    np.testing.assert_array_equal(n(tret), np.asarray(returns))
    np.testing.assert_array_equal(n(tsteps), np.asarray(steps))
    r = np.asarray(returns)
    assert len(np.unique(r)) < len(r)  # ties: the stable sorts decide them
    # es.py:167-168, as its step computes them
    want_ranks = jnp.argsort(jnp.argsort(returns)).astype(jnp.float32) / 15 - 0.5
    np.testing.assert_array_equal(n(tes._centered_ranks(t(r))), np.asarray(want_ranks))
    tx = tlearner.adam(0.05)
    got_theta, got_opt = tes._es_update(tcfg, tx, conv(theta), conv(opt),
                                        [t(np.asarray(e)) for e in eps], t(r))
    close_trees(got_theta, new_theta, GRAD_REL, "theta")
    close_trees(got_opt["mu"], new_opt[0].mu, GRAD_REL, "mu")


def test_ars_step_matches_from_the_same_perturbations_and_returns():
    """Two ARS steps (the second with a trained normalizer): the episodes
    on normalized observations, the top directions (stable ties), the
    reward-std-scaled step and the normalizer's update."""
    jcfg = (jes.ARSConfig().environment(jenvs.CartPole())
            .training(population_size=16, noise_std=0.1, lr=0.1, top_directions=4,
                      eval_length=60).debugging(seed=0))
    tcfg = (tes.ARSConfig().environment(tenvs.CartPole())
            .training(population_size=16, noise_std=0.1, lr=0.1, top_directions=4,
                      eval_length=60).debugging(seed=0).resources(device=CPU))
    ja = jcfg.build()
    tnorm = tes._ObsNormalizer(4, CPU)
    for step in range(2):
        key = jax.random.key(40 + step)
        theta = ja.theta
        mean, std = ja.normalizer.mean, ja.normalizer.std
        new_theta, returns, steps, osum, osq = ja._ars_step(theta, mean, std, key)
        eps, keval = _es_eps(theta, key, 8)
        tret, tsteps, tsum, tsq = _population_returns(
            ja.config.env, tcfg, theta, eps, keval, 16, 60,
            (tnorm.mean, tnorm.std))
        np.testing.assert_allclose(n(tnorm.std), np.asarray(std), **FWD)
        np.testing.assert_array_equal(n(tret), np.asarray(returns))
        np.testing.assert_array_equal(n(tsteps), np.asarray(steps))
        np.testing.assert_allclose(n(tsum.sum(0)), np.asarray(osum), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(n(tsq.sum(0)), np.asarray(osq), rtol=1e-5, atol=1e-4)
        got = tes._ars_update(tcfg, conv(theta), [t(np.asarray(e)) for e in eps],
                              t(np.asarray(returns)))
        close_trees(got, new_theta, GRAD_REL, "theta")
        nsteps = float(jnp.sum(steps))
        ja.normalizer.update(osum, osq, nsteps)
        tnorm.update(t(np.asarray(osum)), t(np.asarray(osq)), nsteps)
        ja.theta = new_theta
        assert tnorm.count == ja.normalizer.count
        np.testing.assert_allclose(n(tnorm.mean), np.asarray(ja.normalizer.mean), **FWD)
        np.testing.assert_allclose(n(tnorm.m2), np.asarray(ja.normalizer.m2), rtol=1e-5)
    assert len(np.unique(np.asarray(returns))) < 16


# --------------------------------------------------------------------------
# LinUCB and LinTS: 200 pulls from the JAX env's contexts and rewards
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["LinUCB", "LinTS"])
def test_bandit_pulls_match(name):
    """Each pull's arm (exactly) from the same statistics, context and (for
    LinTS) posterior noise; the rank-1 statistics after 200 pulls."""
    env = jbandit.LinearBanditEnv(num_arms=4, context_dim=6, noise=0.05, env_seed=3)
    ja = getattr(jbandit, name + "Config")().environment(env).debugging(seed=0).build()
    tcfg = getattr(tbandit, name + "Config")().environment(
        tbandit.LinearBanditEnv(num_arms=4, context_dim=6, noise=0.05, env_seed=3)
    ).debugging(seed=0).resources(device=CPU)
    ta = tcfg.build()
    np.testing.assert_array_equal(n(ta.A), np.asarray(ja.A))
    key, A, b = ja._key, ja.A, ja.b
    arms = []
    for _ in range(200):
        key, kr, ks = jax.random.split(key, 3)
        state, ctx = env.reset(kr)
        arm = ja._select(A, b, ctx, ks)
        state, _, reward, _, _ = env.step(state, arm)
        A, b = ja._update(A, b, arm, ctx, reward)
        tarm = tbandit._select(tcfg, ta.A, ta.b, t(np.asarray(ctx)),
                               t(np.asarray(jax.random.normal(ks, (4,)))))
        assert int(tarm) == int(arm)
        ta.A, ta.b = tbandit._update(ta.A, ta.b, tarm, t(np.asarray(ctx)),
                                     t(np.asarray(reward)))
        arms.append(int(arm))
    assert len(set(arms)) > 1
    close_rel(ta.A, A, 1e-5, "A")
    close_rel(ta.b, b, 1e-5, "b")


# --------------------------------------------------------------------------
# Decision Transformer: windows, five AdamW steps
# --------------------------------------------------------------------------
def _dt_data(rng, T=60, B=4):
    return SampleBatch({"obs": rng.normal(size=(T, B, 4)).astype(np.float32),
                        "actions": rng.integers(0, 2, (T, B)).astype(np.int32),
                        "rewards": rng.uniform(0, 1, (T, B)).astype(np.float32),
                        "dones": rng.random((T, B)) < 0.06,
                        "truncateds": rng.random((T, B)) < 0.02})


def test_dt_windows_and_updates_match():
    """The return-to-go columns, the window index and gathered windows
    equal; five AdamW steps from the same params and windows: the loss
    within 1e-5, the first step's mu (a tenth of the gradients) and the
    params after each step within 1e-4; greedy actions equal."""
    data = _dt_data(np.random.default_rng(11))
    kw = dict(context_length=6, d_model=32, n_layers=2, n_heads=2, train_batch_size=16)
    ja = jdt.DTConfig().environment(jenvs.CartPole()).offline_data(data).training(**kw).build()
    ta = (tdt.DTConfig().environment(tenvs.CartPole()).offline_data(data).training(**kw)
          .resources(device=CPU).build())
    np.testing.assert_array_equal(ta._window_index, ja._window_index)
    np.testing.assert_array_equal(ta._rtg_col, ja._rtg_col)
    ta.set_state({"params": conv(ja.params), "opt_state": conv(ja.opt_state), "iteration": 0,
                  "total_env_steps": 0})
    params, opt = ja.params, ja.opt_state
    rng = np.random.default_rng(12)
    for step in range(5):
        idx = rng.integers(0, len(ja._window_index), 16)
        windows = ja._gather_windows(idx)
        for a, b in zip(ta._gather_windows(idx), windows):
            np.testing.assert_array_equal(a, b)
        params, opt, jloss = ja._update(params, opt, *(jnp.asarray(w) for w in windows))
        tloss = ta._update(*(tlearner.to_tensor(w, CPU) for w in windows))
        assert float(tloss) == pytest.approx(float(jloss), rel=1e-5, abs=1e-5), step
        if step == 0:
            close_trees(ta.opt_state["mu"], opt[0].mu, GRAD_REL, "mu")
        close_trees(ta.params, params, GRAD_REL, f"params {step}")
    rtg, obs, act, _ = ja._gather_windows(np.arange(16))
    want = jax.vmap(ja._act, in_axes=(None, 0, 0, 0, None))(
        params, jnp.asarray(rtg), jnp.asarray(obs), jnp.asarray(act), 2)
    got = [ta._act(ta.params, t(rtg[i]), t(obs[i]), t(act[i]), 2) for i in range(16)]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_adamw_matches_optax():
    """Five steps of ``adamw`` against ``optax.adamw`` (its defaults: decay
    1e-4 on every leaf) from a state converted from optax's."""
    rng = np.random.default_rng(13)
    jp = {"a": jnp.asarray(rng.normal(size=(5, 3)).astype(np.float32)),
          "b": [jnp.asarray(rng.normal(size=4).astype(np.float32))]}
    jtx, ttx = optax.adamw(1e-2), tlearner.adamw(1e-2)
    jstate = jtx.init(jp)
    tp, tstate = conv(jp), convert.adam_state_from_jax(npt(jstate))
    for _ in range(5):
        g = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)), jp)
        jupd, jstate = jtx.update(g, jstate, jp)
        tupd, tstate = ttx.update(conv(g), tstate, tp)
        close_trees(tupd, jupd, 1e-5, "updates")
        jp, tp = optax.apply_updates(jp, jupd), tlearner.apply_updates(tp, tupd)
    close_trees(tp, jp, 1e-6, "params")
    assert int(tstate["count"]) == int(jstate[0].count) == 5


# --------------------------------------------------------------------------
# DreamerV3 (small widths)
# --------------------------------------------------------------------------
def test_dreamer_symlog_twohot_gru_and_kl_match():
    x = np.asarray([-5000.0, -50.0, -1.0, 0.0, 0.3, 7.0, 300.0, 30000.0], np.float32)
    np.testing.assert_allclose(n(tdream.symlog(t(x))), np.asarray(jdream.symlog(x)), **FWD)
    np.testing.assert_allclose(n(tdream.symexp(tdream.symlog(t(x)))), x, rtol=1e-5)
    # the bins: XLA's float32 exp and linspace round otherwise than torch's
    # (up to 2e-6 relative; the middle bin -1.2e-7 against 0)
    np.testing.assert_allclose(n(tdream._BINS), np.asarray(jdream._BINS), rtol=2e-6, atol=2e-7)
    sl = np.asarray(jdream.symlog(x))
    np.testing.assert_allclose(n(tdream.twohot(t(sl))), np.asarray(jdream.twohot(sl)),
                               atol=1e-5)
    logits = np.random.default_rng(0).normal(size=(5, tdream.NUM_BINS)).astype(np.float32)
    np.testing.assert_allclose(n(tdream.twohot_mean(t(logits))),
                               np.asarray(jdream.twohot_mean(logits)), rtol=1e-5, atol=1e-4)
    p = jdream._gru_init(jax.random.key(0), 6, 5)
    h = np.random.default_rng(1).normal(size=(3, 5)).astype(np.float32)
    xin = np.random.default_rng(2).normal(size=(3, 6)).astype(np.float32)
    np.testing.assert_allclose(n(tdream._gru(conv(p), t(h), t(xin))),
                               np.asarray(jdream._gru(p, h, xin)), **FWD)
    ja, ta = _dreamer_pair()
    post, prior = (np.random.default_rng(s).normal(size=(7, 16)).astype(np.float32)
                   for s in (3, 4))
    np.testing.assert_allclose(n(ta._kl(t(post), t(prior))), np.asarray(ja._kl(post, prior)),
                               **FWD)


def _dreamer_cfg(pkg):
    cfg = pkg.DreamerV3Config().environment(
        (jenvs if pkg is jdream else tenvs).CartPole()).debugging(seed=0)
    cfg.num_envs, cfg.seq_len, cfg.batch_size_seqs = 3, 6, 2
    cfg.deter_size, cfg.units, cfg.latent_cats, cfg.latent_classes = 16, 16, 4, 4
    cfg.horizon = 5
    if pkg is tdream:
        cfg.resources(device=CPU)
    return cfg


def _dreamer_pair():
    ja = _dreamer_cfg(jdream).build()
    ta = _dreamer_cfg(tdream).build()
    # the reward head and the critics start at zero, where twohot_mean is
    # the rounding of the bins' sum: give their last layers a bias peaked
    # at a bin of symlog value c and small weights, so the imagined rewards
    # and values are O(1) and the update's own, not the rounding's
    rng = np.random.default_rng(14)
    lin = np.linspace(-10.0, 10.0, jdream.NUM_BINS)
    state = ja.state
    for head, c in ((state["wm"]["reward"], 1.0), (state["critic"], 0.5),
                    (state["critic_slow"], 0.6)):
        last = head[-1]
        last["w"] = jnp.asarray(0.01 * rng.normal(size=last["w"].shape).astype(np.float32))
        last["b"] = jnp.asarray((-2.0 * (lin - c) ** 2).astype(np.float32))
    ja.state = state
    ta.set_state({"params": conv(state), "iteration": 0})
    return ja, ta


def _dreamer_batch(rng, T=6, B=6):
    reset = rng.random((T, B)) < 0.15
    reset[0] = True
    return {"obs": rng.normal(size=(T, B, 4)).astype(np.float32),
            "action": rng.integers(0, 2, (T, B)).astype(np.int32),
            "reward": np.ones((T, B), np.float32),
            "cont": (rng.random((T, B)) > 0.1).astype(np.float32),
            "reset_prev": reset}


def _observe_gumbel(key, T, B, lat):
    """The posterior pass's draws of ``key`` (``dreamerv3.py:272``)."""
    out = []
    for _ in range(T):
        key, kz = jax.random.split(key)
        out.append(jax.random.gumbel(kz, (B,) + lat))
    return np.stack([np.asarray(x) for x in out])


def _imagine_gumbel(key, H, N, acts, lat):
    """Imagination's draws of ``key`` (``dreamerv3.py:312``)."""
    ga, gz = [], []
    for _ in range(H):
        key, ka, kz = jax.random.split(key, 3)
        ga.append(np.asarray(jax.random.gumbel(ka, (N, acts))))
        gz.append(np.asarray(jax.random.gumbel(kz, (N,) + lat)))
    return np.stack(ga), np.stack(gz)


def test_dreamer_observe_loss_and_update_match():
    """The world-model loss on a fixed batch and one whole update (world
    model, imagination, lambda-returns, percentile normalisation, the
    actor and critic steps, the slow critic) from the same state and the
    JAX key's Gumbel draws: losses and statistics within 1e-4, every leaf
    of the new state (params, the three Adam states, ret_scale) within
    1e-4 of its largest."""
    ja, ta = _dreamer_pair()
    batch = _dreamer_batch(np.random.default_rng(15))
    lat = (4, 4)
    key = jax.random.key(7)
    want = float(ja._observe_loss(ja.state["wm"], key, jbatch(batch)))
    got = ta._observe_loss(ta.state["wm"], t(_observe_gumbel(key, 6, 6, lat)), batch)
    assert float(got) == pytest.approx(want, rel=1e-5, abs=1e-5)
    k1, k2 = jax.random.split(key)
    ga, gz = _imagine_gumbel(k2, 5, 36, 2, lat)
    noise = {"obs_z": t(_observe_gumbel(k1, 6, 6, lat)), "im_a": t(ga), "im_z": t(gz)}
    jstate, jstats = ja._update(ja.state, key, jbatch(batch))
    tstate, tstats = ta._update(ta.state, ta._tensors(batch), noise)
    close_stats(tlearner.floats(tstats), {k: float(v) for k, v in jstats.items()}, "stats")
    for part in ("wm", "actor", "critic", "critic_slow"):
        close_trees(tstate[part], jstate[part], GRAD_REL, part)
    for opt in ("wm_opt", "actor_opt", "critic_opt"):
        close_trees(tstate[opt]["mu"], jstate[opt][0].mu, GRAD_REL, opt)
    close_rel(tstate["ret_scale"], jstate["ret_scale"], 1e-5, "ret_scale")
    assert abs(float(jstats["actor_loss"])) > 1e-6


# --------------------------------------------------------------------------
# whole algorithm states through convert
# --------------------------------------------------------------------------
def test_ars_and_bandit_states_cross_through_convert():
    """A JAX ARS state (theta and the normaliser's count, mean and m2) and a
    LinUCB state (`A`, `b`) convert leaf for leaf into the port's
    algorithms: equal theta, statistics and normaliser, the count a Python
    float as the JAX package keeps it."""
    ja = (jes.ARSConfig().environment(jenvs.CartPole())
          .training(population_size=8, eval_length=30).debugging(seed=0).build())
    ja.train()
    ta = (tes.ARSConfig().environment(tenvs.CartPole())
          .training(population_size=8, eval_length=30).debugging(seed=0)
          .resources(device=CPU).build())
    ta.set_state(convert.rllib_params_from_jax(ja.get_state()))
    close_trees(ta.theta, ja.theta, 0.0, "theta")
    assert isinstance(ta.normalizer.count, float) and ta.normalizer.count == ja.normalizer.count
    np.testing.assert_array_equal(n(ta.normalizer.mean), np.asarray(ja.normalizer.mean))
    np.testing.assert_array_equal(n(ta.normalizer.std), np.asarray(ja.normalizer.std))
    assert ta.iteration == ja.iteration == 1
    env = jbandit.LinearBanditEnv(num_arms=3, context_dim=4, env_seed=1)
    jb = jbandit.LinUCBConfig().environment(env).training(steps_per_iter=8).build()
    jb.train()
    tb = (tbandit.LinUCBConfig().environment(tbandit.LinearBanditEnv(num_arms=3, context_dim=4))
          .resources(device=CPU).build())
    tb.set_state(convert.rllib_params_from_jax(jb.get_state()))
    np.testing.assert_array_equal(n(tb.A), np.asarray(jb.A))
    np.testing.assert_array_equal(n(tb.b), np.asarray(jb.b))
    assert tb._total_env_steps == jb._total_env_steps == 8
