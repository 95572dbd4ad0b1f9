"""The port's ``rllib`` core (``ray_tpu_torch.rllib``) against the JAX
package's, module by module, on the CPU.

The same inputs, made from numpy seeds, go through both packages; weights
and optax states cross through ``ray_tpu_torch.convert``. Tolerances are
float32's: 1e-5 (absolute and relative) for forwards; gradients and params
after Adam steps within 1e-4 of the largest magnitude of their leaf. Flags,
replay indices and importance weights compare exactly. Sampled actions
never compare (the packages draw from different generators): where a
function draws, the JAX draw is fed to the port's counterpart, which takes
the noise as a tensor. The losses and ``vtrace`` are held in
``tests/test_torch_rllib_losses.py``, the algorithms' behaviour (the cases
of ``tests/test_rllib.py``) in ``tests/test_torch_rllib_algos.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ray_tpu import rllib as jrl  # noqa: E402
from ray_tpu.rllib import connectors as jconn  # noqa: E402
from ray_tpu.rllib import learner as jlearner  # noqa: E402
from ray_tpu.rllib import offline as joffline  # noqa: E402
from ray_tpu.rllib import rl_module as jmod  # noqa: E402
from ray_tpu_torch import convert  # noqa: E402
from ray_tpu_torch import rllib as trl  # noqa: E402
from ray_tpu_torch.rllib import connectors as tconn  # noqa: E402
from ray_tpu_torch.rllib import learner as tlearner  # noqa: E402
from ray_tpu_torch.rllib import offline as toffline  # noqa: E402
from ray_tpu_torch.rllib import rl_module as tmod  # noqa: E402

FWD = dict(rtol=1e-5, atol=1e-5)


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


def close_rel(got, want, rel, what=""):
    """|got - want| within ``rel`` of the largest |want| (per leaf)."""
    got, want = n(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rel, (what, err)


def close_trees(got, want, rel, what=""):
    g, w = tmod.tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        close_rel(a, b, rel, f"{what}[{i}]")


# --------------------------------------------------------------------------
# envs: step for step from the same states and numpy actions
# --------------------------------------------------------------------------
def _env_pair(name):
    if name == "cartpole":
        return jrl.CartPole(), trl.CartPole()
    # short episodes, so the truncation flag turns over many times
    return jrl.Pendulum(max_episode_steps=50), trl.Pendulum(max_episode_steps=50)


@pytest.mark.parametrize("name", ["cartpole", "pendulum"])
def test_env_steps_match_the_jax_envs_step_for_step(name):
    """64 envs, 300 steps: each step starts both packages from the JAX
    env's state (fresh numpy states where an episode ended) with the same
    numpy actions; observations, rewards and next states within 1e-5,
    terminated and truncated flags equal."""
    B, T = 64, 300
    rng = np.random.default_rng(7)
    jenv, tenv = _env_pair(name)
    jstep = jax.jit(jax.vmap(jenv.step))
    state, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(0), B))
    state = npt(state)
    ends = 0
    for _ in range(T):
        if name == "cartpole":
            action = rng.integers(0, 2, B).astype(np.int32)
        else:
            action = rng.uniform(-2.5, 2.5, (B, 1)).astype(np.float32)
        js, jobs, jr, jterm, jtrunc = npt(jstep({k: jnp.asarray(v) for k, v in state.items()},
                                                jnp.asarray(action)))
        ts, tobs, tr, tterm, ttrunc = tenv.step({k: t(v) for k, v in state.items()}, t(action))
        np.testing.assert_array_equal(n(tterm), jterm)
        np.testing.assert_array_equal(n(ttrunc), jtrunc)
        np.testing.assert_allclose(n(tobs), jobs, **FWD)
        np.testing.assert_allclose(n(tr), jr, **FWD)
        for k in js:
            if k == "t":
                np.testing.assert_array_equal(n(ts[k]), js[k])
            else:
                np.testing.assert_allclose(n(ts[k]), js[k], **FWD)
        done = jterm | jtrunc
        ends += int(done.sum())
        if name == "cartpole":
            fresh = rng.uniform(-0.05, 0.05, (B, 4)).astype(np.float32)
            state = {"s": np.where(done[:, None], fresh, js["s"]),
                     "t": np.where(done, 0, js["t"]).astype(np.int32)}
        else:
            th = np.where(done, rng.uniform(-np.pi, np.pi, B), js["th"])
            thdot = np.where(done, rng.uniform(-1, 1, B), js["thdot"])
            state = {"th": th.astype(np.float32), "thdot": thdot.astype(np.float32),
                     "t": np.where(done, 0, js["t"]).astype(np.int32)}
    assert ends > B  # the flags were exercised: episodes ended many times


@pytest.mark.parametrize("name", ["cartpole", "pendulum"])
def test_env_reset_draws_the_jax_envs_state_layout(name):
    jenv, tenv = _env_pair(name)
    jstate, jobs = npt(jax.vmap(jenv.reset)(jax.random.split(jax.random.key(0), 16)))
    g = torch.Generator().manual_seed(0)
    tstate, tobs = tenv.reset(g, 16, "cpu")
    assert sorted(tstate) == sorted(jstate)
    for k in jstate:
        assert tuple(tstate[k].shape) == jstate[k].shape
        assert n(tstate[k]).dtype == jstate[k].dtype
    assert tuple(tobs.shape) == jobs.shape and tobs.dtype == torch.float32
    if name == "cartpole":
        assert float(tobs.abs().max()) <= 0.05
    assert trl.JaxEnv is trl.envs.DeviceEnv


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------
_MODULES = {
    "actor_critic": (lambda m: m.ActorCriticModule(4, 3, (16, 8))),
    "continuous": (lambda m: m.ContinuousActorCriticModule(3, 2, (16,))),
    "q": (lambda m: m.QModule(4, 3, (16, 8))),
    "ddpg": (lambda m: m.DDPGModule(3, 2, -2.0, 2.0, (16,))),
    "sac": (lambda m: m.SACModule(3, 2, -2.0, 2.0, (16,))),
}


def _module_pair(kind, seed=0):
    jm, tm = _MODULES[kind](jmod), _MODULES[kind](tmod)
    jp = jm.init(jax.random.key(seed))
    return jm, tm, jp, convert.rllib_params_from_jax(npt(jp))


@pytest.mark.parametrize("kind", sorted(_MODULES))
def test_module_init_draws_the_jax_tree(kind):
    jm, tm, jp, _ = _module_pair(kind)
    tp = tm.init(torch.Generator().manual_seed(0))
    jleaves = jax.tree.leaves(jp)
    tleaves = tmod.tree_leaves(tp)
    assert jax.tree.structure(jp) == jax.tree.structure(jax.tree.map(np.asarray, npt(jp)))
    assert [tuple(x.shape) for x in tleaves] == [x.shape for x in jleaves]
    assert all(x.dtype == torch.float32 for x in tleaves)
    # the biases and log_std start at zero in both
    for a, b in zip(tleaves, jleaves):
        if not np.asarray(b).any():
            assert not a.any()


@pytest.mark.parametrize("kind", sorted(_MODULES))
def test_module_forward_pieces_match(kind):
    jm, tm, jp, tp = _module_pair(kind, seed=3)
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(32, jm.obs_size)).astype(np.float32)
    jo, to = jnp.asarray(obs), t(obs)
    key = jax.random.key(5)
    if kind == "actor_critic":
        np.testing.assert_allclose(n(tm.logits(tp, to)), jm.logits(jp, jo), **FWD)
        np.testing.assert_allclose(n(tm.value(tp, to)), jm.value(jp, jo), **FWD)
        actions = rng.integers(0, 3, 32).astype(np.int32)
        for a, b in zip(tm.logp_entropy(tp, to, t(actions)),
                        jm.logp_entropy(jp, jo, jnp.asarray(actions))):
            np.testing.assert_allclose(n(a), b, **FWD)
        np.testing.assert_array_equal(n(tm.inference_action(tp, to)),
                                      jm.inference_action(jp, jo))
        # a sampled action's logp and value are the module's own
        act, logp, value = tm.explore(tp, to, torch.Generator().manual_seed(0))
        want_logp, _ = jm.logp_entropy(jp, jo, jnp.asarray(n(act)))
        np.testing.assert_allclose(n(logp), want_logp, **FWD)
        np.testing.assert_allclose(n(value), jm.value(jp, jo), **FWD)
    elif kind == "continuous":
        np.testing.assert_allclose(n(tm.value(tp, to)), jm.value(jp, jo), **FWD)
        actions = rng.normal(size=(32, 2)).astype(np.float32)
        for a, b in zip(tm.logp_entropy(tp, to, t(actions)),
                        jm.logp_entropy(jp, jo, jnp.asarray(actions))):
            np.testing.assert_allclose(n(a), b, **FWD)
        np.testing.assert_allclose(n(tm.inference_action(tp, to)),
                                   jm.inference_action(jp, jo), **FWD)
        act, logp, _ = tm.explore(tp, to, torch.Generator().manual_seed(0))
        np.testing.assert_allclose(n(logp), jm.logp_entropy(jp, jo, jnp.asarray(n(act)))[0],
                                   **FWD)
    elif kind == "q":
        np.testing.assert_allclose(n(tm.q_values(tp, to)), jm.q_values(jp, jo), **FWD)
        np.testing.assert_array_equal(n(tm.inference_action(tp, to)),
                                      jm.inference_action(jp, jo))
        g = torch.Generator().manual_seed(0)
        np.testing.assert_array_equal(n(tm.explore(tp, to, g, 0.0)), jm.inference_action(jp, jo))
        assert set(n(tm.explore(tp, to, g, 1.0)).tolist()) <= {0, 1, 2}
    else:
        actions = rng.uniform(-2, 2, (32, 2)).astype(np.float32)
        for a, b in zip(tm.q_values(tp, to, t(actions)), jm.q_values(jp, jo, jnp.asarray(actions))):
            np.testing.assert_allclose(n(a), b, **FWD)
        np.testing.assert_allclose(n(tm.inference_action(tp, to)),
                                   jm.inference_action(jp, jo), **FWD)
        if kind == "ddpg":
            np.testing.assert_allclose(n(tm.action(tp, to)), jm.action(jp, jo), **FWD)
            got = n(tm.explore(tp, to, torch.Generator().manual_seed(0), 0.3))
            assert got.min() >= -2.0 and got.max() <= 2.0
        else:
            # the tanh-squashed draw and its corrected logp, given the JAX
            # package's own normal draw
            noise = jax.random.normal(key, (32, 2))
            ja, jl = jm.sample_action(jp, jo, key)
            ta, tl = tm.sample_action(tp, to, t(noise))
            np.testing.assert_allclose(n(ta), ja, **FWD)
            # the squash correction log((1 - tanh^2) * s + 1e-6) magnifies
            # tanh's float32 rounding (XLA's tanh is exactly 1 from |x| ~ 7.9
            # on): the bound adds 8 ulps of tanh times that derivative
            s = 0.5 * (2.0 - (-2.0))
            y = 1.0 - (np.asarray(ja) / s) ** 2
            tanh_err = 8 * np.finfo(np.float32).epsneg
            slack = np.sum(2 * s * tanh_err / (y * s + 1e-6), axis=-1)
            bound = 1e-5 * (1 + np.abs(np.asarray(jl))) + slack
            assert (np.abs(n(tl) - np.asarray(jl)) <= bound).all()
            assert (np.abs(n(tl) - np.asarray(jl))[slack < 1e-4] <= 1e-4).all()


# --------------------------------------------------------------------------
# connectors
# --------------------------------------------------------------------------
_CONNECTORS = {
    "normalize": (lambda c: c.NormalizeObs(mean=[0.5, -1.0, 0.0], std=[2.0, 0.0, 1.0])),
    "clip_obs": (lambda c: c.ClipObs(-0.7, 0.4)),
    "flatten": (lambda c: c.FlattenObs(batch_dims=1)),
    "cast": (lambda c: c.CastObs() if c is jconn else c.CastObs(torch.float32)),
    "clip_actions": (lambda c: c.ClipActions([-0.5, -1.0, 0.0], [0.5, 1.0, 0.2])),
    "unsquash": (lambda c: c.UnsquashActions([-2.0, 0.0, -1.0], [2.0, 10.0, 1.0])),
    "pipeline": (lambda c: c.env_to_module(c.NormalizeObs(1.0, 2.0), c.ClipObs(-1.0, 1.0))
                 .append(c.ClipActions(-0.25, 0.25)).prepend(c.CastObs())),
}


@pytest.mark.parametrize("name", sorted(_CONNECTORS))
def test_connector_matches(name):
    rng = np.random.default_rng(2)
    x = rng.normal(scale=3.0, size=(5, 3)).astype(np.float32)
    if name == "flatten":
        x = rng.normal(size=(5, 2, 3)).astype(np.float32)
    if name == "cast":
        x = rng.integers(-5, 5, (5, 3)).astype(np.int32)
    want = np.asarray(_CONNECTORS[name](jconn)(jnp.asarray(x)))
    got = n(_CONNECTORS[name](tconn)(t(x)))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, **FWD)


# --------------------------------------------------------------------------
# replay buffers: identical rows, indices and weights
# --------------------------------------------------------------------------
def _rows(rng, m):
    return {"obs": rng.normal(size=(m, 3)).astype(np.float32),
            "actions": rng.integers(0, 4, m).astype(np.int32),
            "dones": rng.random(m) < 0.1}


@pytest.mark.parametrize("prioritized", [False, True])
def test_replay_buffer_samples_identical_rows(prioritized):
    rng = np.random.default_rng(3)
    mk = ((lambda m: m.PrioritizedReplayBuffer(100, seed=4, alpha=0.7, beta=0.5))
          if prioritized else (lambda m: m.ReplayBuffer(100, seed=4)))
    jbuf, tbuf = mk(jrl), mk(trl)
    for m in (30, 250, 60):
        rows = _rows(rng, m)
        jbuf.add(jrl.SampleBatch(rows))
        tbuf.add(trl.SampleBatch(rows))
        assert len(jbuf) == len(tbuf)
        for _ in range(3):
            js, ts = jbuf.sample(32), tbuf.sample(32)
            assert sorted(js) == sorted(ts)
            for k in js:
                np.testing.assert_array_equal(ts[k], js[k])
            if prioritized:
                np.testing.assert_array_equal(ts.sampled_indices, js.sampled_indices)
                td = rng.normal(size=32)
                jbuf.update_priorities(js.sampled_indices, td)
                tbuf.update_priorities(ts.sampled_indices, td)
    if prioritized:
        np.testing.assert_array_equal(tbuf._priorities, jbuf._priorities)


def test_sample_batch_minibatches_match_row_for_row():
    rng = np.random.default_rng(5)
    cols = {"obs": rng.normal(size=(50, 2)).astype(np.float32), "a": np.arange(50)}
    jb, tb = jrl.SampleBatch(cols), trl.SampleBatch(cols)
    jm = list(jb.minibatches(16, np.random.default_rng(9)))
    tm = list(tb.minibatches(16, np.random.default_rng(9)))
    assert len(jm) == len(tm) == 3
    for a, b in zip(tm, jm):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    joined = trl.SampleBatch.concat_samples([tb.slice(0, 10), tb.slice(10, 50)])
    np.testing.assert_array_equal(joined["a"], cols["a"])
    assert tb.stats() == jb.stats() and tb.count == 50


# --------------------------------------------------------------------------
# Learner: five Adam updates, clipping active and inactive
# --------------------------------------------------------------------------
def _ppo_batch(rng, m=64):
    return {"obs": rng.normal(size=(m, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, m).astype(np.int32),
            "logp": np.log(rng.uniform(0.3, 0.7, m)).astype(np.float32),
            "advantages": rng.normal(size=m).astype(np.float32),
            "returns": rng.normal(size=m).astype(np.float32)}


@pytest.mark.parametrize("max_grad_norm", [0.01, 100.0], ids=["clipped", "unclipped"])
def test_learner_five_updates_match(max_grad_norm):
    from ray_tpu.rllib.algorithms.ppo import _ppo_loss as jloss
    from ray_tpu_torch.rllib.algorithms.ppo import _ppo_loss as tloss

    jm, tm = jmod.ActorCriticModule(4, 2, (32, 32)), tmod.ActorCriticModule(4, 2, (32, 32))
    jl = jlearner.Learner(jm, jloss(jm, 0.2, 0.01, 0.5), lr=1e-2, max_grad_norm=max_grad_norm,
                          seed=3)
    tl = tlearner.Learner(tm, tloss(tm, 0.2, 0.01, 0.5), lr=1e-2, max_grad_norm=max_grad_norm,
                          seed=3, device="cpu")
    tl.set_state({"params": convert.rllib_params_from_jax(npt(jl.params)),
                  "opt_state": ((), convert.adam_state_from_jax(npt(jl.opt_state)))})
    rng = np.random.default_rng(11)
    for _ in range(5):
        batch = _ppo_batch(rng)
        js = jl.update(jrl.SampleBatch(batch))
        ts = tl.update(trl.SampleBatch(batch))
        assert sorted(ts) == sorted(js)
        for k in js:
            assert ts[k] == pytest.approx(js[k], rel=1e-4, abs=1e-5), k
        # clipping is active exactly where the JAX learner's is
        assert (ts["grad_norm"] > max_grad_norm) == (js["grad_norm"] > max_grad_norm)
        assert (js["grad_norm"] > max_grad_norm) == (max_grad_norm < 1)
        close_trees(tl.params, jl.params, 1e-4, "params")
        jadam = jl.opt_state[1][0]
        assert int(tl.opt_state[1]["count"]) == int(jadam.count)
        close_trees(tl.opt_state[1]["mu"], jadam.mu, 1e-4, "mu")
        close_trees(tl.opt_state[1]["nu"], jadam.nu, 1e-4, "nu")


def test_optax_counterparts_match():
    rng = np.random.default_rng(12)
    tree = {"a": [rng.normal(size=(3, 2)).astype(np.float32)],
            "b": rng.normal(size=4).astype(np.float32)}
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = convert.rllib_params_from_jax(tree)
    assert float(tlearner.global_norm(ttree)) == pytest.approx(
        float(optax.global_norm(jtree)), rel=1e-6)
    for max_norm in (0.5, 50.0):
        jtx = optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(1e-3))
        ttx = tlearner.chain(tlearner.clip_by_global_norm(max_norm), tlearner.adam(1e-3))
        js, ts = jtx.init(jtree), ttx.init(ttree)
        jp, tp = jtree, ttree
        for _ in range(3):
            ju, js = jtx.update(jtree, js, jp)
            tu, ts = ttx.update(ttree, ts, tp)
            jp, tp = optax.apply_updates(jp, ju), tlearner.apply_updates(tp, tu)
            close_trees(tu, ju, 1e-5, "updates")
            close_trees(tp, jp, 1e-5, "params")


def test_learner_group_mesh_pads_as_the_jax_group():
    """A 10-row batch over a 4-device mesh: both pad to 12 rows by
    wrap-tiling, so the update is the padded batch's."""
    from jax.sharding import Mesh as JMesh

    from ray_tpu.rllib.algorithms.bc import _bc_loss as jloss
    from ray_tpu_torch.parallel import Mesh as TMesh
    from ray_tpu_torch.rllib.algorithms.bc import _bc_loss as tloss

    jm, tm = jmod.ActorCriticModule(4, 2, (8,)), tmod.ActorCriticModule(4, 2, (8,))
    jl = jlearner.Learner(jm, jloss(jm), lr=1e-2, seed=1)
    tl = tlearner.Learner(tm, tloss(tm), lr=1e-2, seed=1, device="cpu")
    tl.params = convert.rllib_params_from_jax(npt(jl.params))
    jg = jlearner.LearnerGroup(jl, JMesh(np.array(jax.devices()[:4]), ("data",)))
    tg = tlearner.LearnerGroup(tl, TMesh(np.arange(4), ("data",)))
    rng = np.random.default_rng(13)
    batch = {"obs": rng.normal(size=(10, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, 10).astype(np.int32)}
    js, ts = jg.update(jrl.SampleBatch(batch)), tg.update(trl.SampleBatch(batch))
    assert ts["neg_logp"] == pytest.approx(js["neg_logp"], rel=1e-5)
    close_trees(tg.params, jg.params, 1e-4, "params")
    with pytest.raises(TypeError, match="ray_tpu_torch.parallel.Mesh"):
        tlearner.LearnerGroup(tl, mesh=object())


# --------------------------------------------------------------------------
# EnvRunner: a greedy rollout from one converted state
# --------------------------------------------------------------------------
def test_greedy_rollout_matches_up_to_each_envs_first_reset():
    B, T = 16, 64
    env_j, env_t = jrl.CartPole(), trl.CartPole()
    jm, tm = jmod.ActorCriticModule(4, 2, (16, 8)), tmod.ActorCriticModule(4, 2, (16, 8))
    jp = jm.init(jax.random.key(4))
    tp = convert.rllib_params_from_jax(npt(jp))
    jr = jrl.EnvRunner(env_j, jm, policy="inference", num_envs=B, rollout_length=T, seed=0)
    tr = trl.EnvRunner(env_t, tm, policy="inference", num_envs=B, rollout_length=T, seed=0,
                       device="cpu")
    state, obs = jax.vmap(env_j.reset)(jax.random.split(jax.random.key(9), B))
    jr._env_state, jr._obs, jr._ep_ret = state, obs, jnp.zeros(B)
    jr._key = jax.random.key(1)
    tr._env_state = {k: t(v) for k, v in npt(state).items()}
    tr._obs, tr._ep_ret = t(np.asarray(obs)), torch.zeros(B)
    jb, _, jret = jr.sample(jp)
    tb, _, tret = tr.sample(tp)
    assert sorted(tb) == sorted(jb)
    for k in jb:
        assert tb[k].shape == jb[k].shape and tb[k].dtype == jb[k].dtype, k
    ended = (jb["dones"] | jb["truncateds"]).astype(bool)
    assert ended.any()
    first = np.where(ended.any(0), ended.argmax(0), T - 1)  # each env's first end
    live = np.arange(T)[:, None] <= first[None, :]
    for k in ("actions", "dones", "truncateds", "rewards"):
        np.testing.assert_array_equal(tb[k][live], jb[k][live], err_msg=k)
    for k in ("obs", "next_obs"):
        np.testing.assert_allclose(tb[k][live], jb[k][live], **FWD)
    # the episodes that ended before any env's first reset returned alike
    assert tret[:int(ended[0].sum())] == jret[:int(ended[0].sum())]
    assert trl.EnvRunner(env_t, tm, device="cpu", num_envs=2, rollout_length=3).sample(tp)[0][
        "actions"].dtype == np.int32


# --------------------------------------------------------------------------
# offline: .npz files across packages
# --------------------------------------------------------------------------
def test_npz_files_cross_packages(tmp_path):
    rng = np.random.default_rng(6)
    T, B = 12, 3
    batch = {"obs": rng.normal(size=(T, B, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, (T, B)).astype(np.int32),
             "rewards": rng.normal(size=(T, B)).astype(np.float32),
             "dones": rng.random((T, B)) < 0.2}
    jflat = joffline.flatten_time_major(joffline.with_montecarlo_returns(
        jrl.SampleBatch(batch), 0.9))
    tflat = toffline.flatten_time_major(toffline.with_montecarlo_returns(
        trl.SampleBatch(batch), 0.9))
    for k in jflat:
        np.testing.assert_array_equal(tflat[k], jflat[k])
    jpath = joffline.save_batch(jflat, str(tmp_path / "from_jax"))
    tpath = toffline.save_batch(tflat, str(tmp_path / "from_port.npz"))
    for got, want in ((toffline.load_batch(jpath), jflat), (joffline.load_batch(tpath), tflat)):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype


def test_record_rollouts_has_the_jax_columns():
    env = trl.CartPole()
    m = tmod.ActorCriticModule(4, 2, (8,))
    data = toffline.record_rollouts(env, m, m.init(torch.Generator().manual_seed(0)),
                                    num_iterations=2, num_envs=4, rollout_length=8, device="cpu")
    jm = jmod.ActorCriticModule(4, 2, (8,))
    want = joffline.record_rollouts(jrl.CartPole(), jm, jm.init(jax.random.key(0)),
                                    num_iterations=2, num_envs=4, rollout_length=8)
    assert sorted(data) == sorted(want)
    for k in want:
        assert data[k].shape == want[k].shape and data[k].dtype == want[k].dtype, k
