"""The 26 cases of ``tests/test_rllib_contrib.py`` and DreamerV3's three of
``tests/test_rllib.py`` as behaviour tests of the port, on the CPU.

Each case keeps its JAX counterpart's name, thresholds and ``full`` marker.
A body that draws no JAX key runs as written, bound to the port
(``tests/torch_ported.py``), with every algorithm config made here on the
CPU (the fixture below: what ``.resources(device="cpu")`` sets); the others
are written out, with the port's generators in the place of JAX keys and
its batched envs (D4) in the place of the JAX package's per-env functions.
The parity against the JAX package is in
``tests/test_torch_rllib_contrib_parity.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_rllib as jax_rllib  # noqa: E402
import test_rllib_contrib as jax_contrib  # noqa: E402
from torch_ported import ported  # noqa: E402

from ray_tpu_torch.rllib import (  # noqa: E402
    A3CConfig,
    CartPole,
    CRRConfig,
    DDPGConfig,
    DTConfig,
    ESConfig,
    GRUQModule,
    Pendulum,
    PGConfig,
    SampleBatch,
    SimpleSpread,
    TD3Config,
)
from ray_tpu_torch.rllib.algorithm import AlgorithmConfig  # noqa: E402
from ray_tpu_torch.rllib.rl_module import tree_leaves, tree_map  # noqa: E402

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


@pytest.fixture(autouse=True)
def _configs_on_the_cpu(monkeypatch):
    """Every algorithm config made in a case names the CPU, as
    ``.resources(device="cpu")`` does (there is no card here, and the port
    never falls back to the CPU by itself)."""
    init = AlgorithmConfig.__init__

    def on_cpu(self):
        init(self)
        self.device = CPU

    monkeypatch.setattr(AlgorithmConfig, "__init__", on_cpu)


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_registry_resolves_every_algorithm():
    ported(jax_contrib.test_registry_resolves_every_algorithm)()


@pytest.mark.full
def test_a2c_learns_cartpole():
    ported(jax_contrib.test_a2c_learns_cartpole)()


def test_pg_improves_cartpole():
    ported(jax_contrib.test_pg_improves_cartpole)()


def test_a3c_interleaves_runner_updates():
    config = (
        A3CConfig()
        .environment(CartPole())
        .env_runners(num_env_runners=2, num_envs_per_runner=4, rollout_length=32)
        .debugging(seed=0)
    )
    algo = config.build()
    before = tree_leaves(algo.learners.params)[0].clone()
    result = algo.train()
    after = tree_leaves(algo.learners.params)[0]
    assert not np.allclose(before.numpy(), after.numpy())
    # both runners' episodes landed in the metrics
    assert result["num_env_steps_sampled_lifetime"] == 2 * 4 * 32
    algo.stop()


def test_ddpg_runs_pendulum_with_bounded_actions():
    ported(jax_contrib.test_ddpg_runs_pendulum_with_bounded_actions)()


def test_td3_delays_policy_updates():
    from ray_tpu_torch.rllib.algorithms.ddpg import _DDPGLearner
    from ray_tpu_torch.rllib.rl_module import DDPGModule

    cfg = TD3Config().environment(Pendulum())
    assert cfg.twin_q and cfg.policy_delay == 2 and cfg.target_noise > 0
    module = DDPGModule(3, 1, -2.0, 2.0, (16,))
    learner = _DDPGLearner(module, cfg, CPU)
    batch = SampleBatch(
        {
            SampleBatch.OBS: np.random.randn(32, 3).astype(np.float32),
            SampleBatch.NEXT_OBS: np.random.randn(32, 3).astype(np.float32),
            SampleBatch.ACTIONS: np.random.uniform(-2, 2, (32, 1)).astype(np.float32),
            SampleBatch.REWARDS: np.random.randn(32).astype(np.float32),
            SampleBatch.DONES: np.zeros(32, bool),
        }
    )
    noise = torch.randn((32, 1), generator=gen(0))
    s1 = learner.update(batch, noise)
    s2 = learner.update(batch, noise)
    # step 1 of 2: critic-only (actor loss reported as 0); step 2: both
    assert s1["actor_loss"] == 0.0
    assert s2["actor_loss"] != 0.0


def test_td3_checkpoint_roundtrip():
    ported(jax_contrib.test_td3_checkpoint_roundtrip)()


def test_simple_q_hard_target_sync():
    ported(jax_contrib.test_simple_q_hard_target_sync)()


def test_prioritized_buffer_biases_and_reweights():
    ported(jax_contrib.test_prioritized_buffer_biases_and_reweights)()


def test_apex_epsilon_ladder_and_priority_writeback():
    ported(jax_contrib.test_apex_epsilon_ladder_and_priority_writeback)()


def _from_the_jax_initial_theta(build):
    """``build`` with each config's algorithm starting from the JAX
    package's initial theta of the same seed (``convert``): the JAX cases'
    criteria hold from their own seed-0 policy, which the port's generator
    does not draw (its seed-0 draw is a constant-action CartPole policy that
    stays near 9.5 through ten iterations; the JAX package's own draws give
    such a policy at other seeds)."""
    import jax

    import ray_tpu.rllib as jrl
    from ray_tpu_torch import convert

    def with_theta(self):
        build(self)
        jcfg = getattr(jrl, type(self.config).__name__)()
        jcfg.__dict__.update({k: v for k, v in self.config.__dict__.items()
                              if k not in ("env", "device")})
        jtheta = jcfg.environment(jrl.CartPole()).build().theta
        self.theta = convert.rllib_params_from_jax(jax.tree.map(np.asarray, jtheta), self.device)

    return with_theta


@pytest.mark.full
def test_es_learns_cartpole(monkeypatch):
    from ray_tpu_torch.rllib.algorithms.es import _EvolutionBase

    monkeypatch.setattr(_EvolutionBase, "_setup_policy",
                        _from_the_jax_initial_theta(_EvolutionBase._setup_policy))
    ported(jax_contrib.test_es_learns_cartpole)()


@pytest.mark.full
def test_ars_learns_cartpole_with_obs_normalization(monkeypatch):
    from ray_tpu_torch.rllib.algorithms.es import _EvolutionBase

    monkeypatch.setattr(_EvolutionBase, "_setup_policy",
                        _from_the_jax_initial_theta(_EvolutionBase._setup_policy))
    ported(jax_contrib.test_ars_learns_cartpole_with_obs_normalization)()


def test_linucb_regret_shrinks():
    ported(jax_contrib.test_linucb_regret_shrinks)()


def test_lints_runs_and_checkpoints():
    ported(jax_contrib.test_lints_runs_and_checkpoints)()


def test_algorithm_evaluate_greedy():
    """Algorithm.evaluate (parity: evaluation with explore=False): greedy
    rollouts on a fresh env set, training state untouched."""
    config = (
        PGConfig()
        .environment(CartPole())
        .env_runners(num_envs_per_runner=8, rollout_length=64)
        .debugging(seed=0)
    )
    algo = config.build()
    algo.train()
    before = tree_leaves(algo.learners.params)[0].clone()
    out = algo.evaluate(num_episodes=5)
    ev = out["evaluation"]
    assert ev["num_episodes"] == 5
    assert ev["episode_return_min"] <= ev["episode_return_mean"] <= ev["episode_return_max"]
    # evaluation must not have trained
    after = tree_leaves(algo.learners.params)[0]
    np.testing.assert_array_equal(before.numpy(), after.numpy())
    algo.stop()

    # continuous-control modules evaluate deterministically: same seed,
    # same returns
    cfg2 = (
        DDPGConfig()
        .environment(Pendulum())
        .env_runners(num_envs_per_runner=2, rollout_length=32)
        .debugging(seed=1)
    )
    algo2 = cfg2.build()
    e1 = algo2.evaluate(num_episodes=3)["evaluation"]["episode_return_mean"]
    e2 = algo2.evaluate(num_episodes=3)["evaluation"]["episode_return_mean"]
    assert e1 == e2
    algo2.stop()


def test_es_evaluate_deterministic():
    config = ESConfig().environment(CartPole()).training(
        population_size=8, eval_length=100
    ).debugging(seed=0)
    algo = config.build()
    algo.train()
    ev = algo.evaluate(num_episodes=4)["evaluation"]
    assert ev["num_episodes"] == 4
    assert ev["episode_return_min"] <= ev["episode_return_max"] <= 100
    # evaluation is repeatable AND does not advance the training draws
    state_before = algo._generator.get_state()
    assert algo.evaluate(num_episodes=4)["evaluation"] == ev
    assert torch.equal(algo._generator.get_state(), state_before)


def test_r2d2_recurrent_rollout_and_sequence_replay():
    ported(jax_contrib.test_r2d2_recurrent_rollout_and_sequence_replay)()


def test_gru_unroll_resets_hidden_at_episode_boundaries():
    """The learner's unroll must zero the hidden state where reset_before
    is set — the mirror of the rollout's reset-at-done."""
    m = GRUQModule(obs_size=3, num_actions=2, hidden_size=8)
    params = m.init(gen(0))
    obs = torch.randn((6, 1, 3), generator=gen(1))
    resets = torch.zeros((6, 1))
    resets[3, 0] = 1.0  # episode ended at t=2
    q = m.unroll(params, m.initial_state((1,)), obs, resets)
    # steps 3..5 must equal a fresh unroll of just obs[3:]
    q_fresh = m.unroll(params, m.initial_state((1,)), obs[3:])
    np.testing.assert_allclose(q[3:].numpy(), q_fresh.numpy(), rtol=1e-6)
    # ...and must differ from the no-reset unroll (history contaminated)
    q_noreset = m.unroll(params, m.initial_state((1,)), obs)
    assert not np.allclose(q[3:].numpy(), q_noreset[3:].numpy())


def test_gru_module_unroll_matches_stepwise():
    """The learner's unroll must equal stepping the cell manually."""
    m = GRUQModule(obs_size=3, num_actions=2, hidden_size=8)
    params = m.init(gen(0))
    obs_seq = torch.randn((5, 2, 3), generator=gen(1))  # [T, B, O]
    q_scan = m.unroll(params, m.initial_state((2,)), obs_seq)
    h = m.initial_state((2,))
    for step in range(5):
        h, q = m.step(params, h, obs_seq[step])
        np.testing.assert_allclose(q.numpy(), q_scan[step].numpy(), rtol=1e-5)


@pytest.mark.full
def test_maddpg_learns_simple_spread():
    ported(jax_contrib.test_maddpg_learns_simple_spread)()


def test_simple_spread_env_shapes_and_reward():
    env = SimpleSpread(n_agents=3)
    state, obs = env.reset(gen(0), 1, CPU)
    assert obs.shape == (1, 3, env.observation_size)
    actions = torch.zeros((1, 3, 2))
    state, obs2, rewards, term, trunc = env.step(state, actions)
    # cooperative: every agent sees the SAME shared reward, <= 0
    assert rewards.shape == (1, 3)
    assert float(rewards[0, 0]) == float(rewards[0, 1]) == float(rewards[0, 2])
    assert float(rewards[0, 0]) <= 0.0
    assert not bool(term[0])
    # truncates at the horizon
    for _ in range(env.max_episode_steps):
        state, obs2, rewards, term, trunc = env.step(state, actions)
    assert bool(trunc[0])


def test_r2d2_loss_consumes_truncations():
    """Truncations inside a sequence must change the loss (hidden resets +
    bootstrap-from-next_obs correction) — DONES alone is not enough."""
    from ray_tpu_torch.rllib.algorithms.r2d2 import _r2d2_loss
    from ray_tpu_torch.rllib.learner import to_tensor

    m = GRUQModule(obs_size=4, num_actions=2, hidden_size=8)
    params = m.init(gen(0))
    target = tree_map(lambda x: x * 0.9, params)
    B, T = 3, 6
    rng = np.random.default_rng(0)
    base = {
        SampleBatch.OBS: rng.normal(size=(B, T, 4)).astype(np.float32),
        SampleBatch.NEXT_OBS: rng.normal(size=(B, T, 4)).astype(np.float32),
        SampleBatch.ACTIONS: rng.integers(0, 2, (B, T)).astype(np.int32),
        SampleBatch.REWARDS: rng.normal(size=(B, T)).astype(np.float32),
        SampleBatch.DONES: np.zeros((B, T), bool),
        SampleBatch.TRUNCATEDS: np.zeros((B, T), bool),
    }
    loss_fn = _r2d2_loss(m, gamma=0.99, burn_in=0)
    l_plain, _ = loss_fn(params, {k: to_tensor(v, CPU) for k, v in base.items()},
                         target_params=target)
    trunc = dict(base)
    tr = np.zeros((B, T), bool)
    tr[:, 2] = True  # episode cut mid-sequence
    trunc[SampleBatch.TRUNCATEDS] = tr
    l_trunc, _ = loss_fn(params, {k: to_tensor(v, CPU) for k, v in trunc.items()},
                         target_params=target)
    assert float(l_plain) != float(l_trunc)


@pytest.mark.full
def test_decision_transformer_conditions_on_return():
    """DT trains on mixed-quality offline data and, conditioned on a HIGH
    target return, clearly beats the random half of its training data."""
    # the JAX test's data: its scripted and random CartPole episodes (numpy)
    data = jax_contrib._cartpole_offline_data()
    config = (
        DTConfig()
        .environment(CartPole())
        .training(
            context_length=16,
            d_model=64,
            n_layers=2,
            updates_per_iter=60,
            train_batch_size=64,
            target_return=200.0,
        )
        .debugging(seed=0)
        .offline_data(data)
    )
    algo = config.build()
    first = algo.train()["learners"]["bc_loss"]
    last = None
    for _ in range(4):
        last = algo.train()["learners"]["bc_loss"]
    assert last < first  # sequence model fits the data
    ev = algo.evaluate(num_episodes=5)["evaluation"]
    # random CartPole averages ~20; return-conditioned DT must do far better
    assert ev["episode_return_mean"] > 60.0, ev
    # checkpoint roundtrip
    algo2 = config.copy().build()
    algo2.set_state(algo.get_state())
    for a, b in zip(tree_leaves(algo.params), tree_leaves(algo2.params)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.full
def test_qmix_learns_discrete_spread_with_monotone_mixer():
    """QMIX: per-agent argmax policy improves the SHARED return, and the
    mixer is monotone in every agent utility (the QMIX constraint)."""
    from ray_tpu_torch.rllib import DiscreteSpread, QMIXConfig

    env = DiscreteSpread(n_agents=2)
    config = (
        QMIXConfig()
        .environment(env)
        .training(
            learning_starts=200,
            num_updates_per_iter=8,
            train_batch_size=128,
            hidden=(64, 64),
        )
        .debugging(seed=0)
    )
    algo = config.build()
    first = None
    result = None
    for _ in range(30):
        result = algo.train()
        if first is None and not np.isnan(result["episode_return_mean"]):
            first = result["episode_return_mean"]
    assert result["episode_return_mean"] > first
    assert np.isfinite(result["learners"]["loss"])

    # monotonicity: dQ_tot/dQ_i >= 0 for every agent at random inputs
    gs = torch.randn((env.global_state_size,), generator=gen(1))
    qs = torch.randn((env.n_agents,), generator=gen(2)).requires_grad_()
    (grad,) = torch.autograd.grad(algo.nets.mix(algo.nets.params, qs, gs), qs)
    assert (grad.numpy() >= 0).all()

    ev = algo.evaluate(num_episodes=4)["evaluation"]
    assert ev["num_episodes"] == 4
    algo2 = config.copy().build()
    algo2.set_state(algo.get_state())
    for a, b in zip(tree_leaves(algo.nets.params), tree_leaves(algo2.nets.params)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_crr_weights_good_actions_above_bc_mean():
    """CRR's advantage weighting must recover the GOOD action from a
    dataset whose actions are uniform: one-step episodes on a bandit-like
    continuous env with reward -(a-0.5)^2. Plain BC would regress to the
    data mean (~0); CRR's critic-endorsed imitation lands near +0.5."""

    class OneStepEnv:
        """Horizon-1 continuous env, batched: reward peaks at a = +0.5."""

        discrete = False
        observation_size = 2
        action_size = 1
        action_low = -1.0
        action_high = 1.0
        max_episode_steps = 1

        def reset(self, generator, num_envs, device=None):
            obs = torch.randn((num_envs, 2), generator=generator, device=device) * 0.1
            return {"o": obs}, obs

        def step(self, state, action):
            a = action.reshape(-1)
            r = -((a - 0.5) ** 2)
            n = a.shape[0]
            return (state, state["o"], r, torch.ones(n, dtype=torch.bool),
                    torch.zeros(n, dtype=torch.bool))

    rng = np.random.default_rng(0)
    n = 4000
    # behavior actions stay off the exact bounds (a policy at the clip rail
    # would be atanh-degenerate for ANY squashed-gaussian learner)
    acts = rng.uniform(-0.95, 0.95, (n, 1)).astype(np.float32)
    obs = rng.normal(size=(n, 2)).astype(np.float32) * 0.1
    rews = -((acts[:, 0] - 0.5) ** 2).astype(np.float32)
    data = SampleBatch(
        {
            SampleBatch.OBS: obs,
            SampleBatch.ACTIONS: acts,
            SampleBatch.REWARDS: rews,
            SampleBatch.DONES: np.ones(n, bool),
            SampleBatch.NEXT_OBS: obs,
        }
    )
    config = (
        CRRConfig()
        .environment(OneStepEnv())
        .training(
            updates_per_iter=100,
            train_batch_size=256,
            hidden=(64, 64),
            critic_warmup_updates=400,
        )
        .debugging(seed=0)
        .offline_data(data)
    )
    algo = config.build()
    result = None
    for _ in range(8):
        result = algo.train()
    assert np.isfinite(result["learners"]["critic_loss"])
    # the selective weight keeps only profitable actions
    assert 0.0 < result["learners"]["weight_mean"] < 0.9
    # deterministic policy mean sits near the optimum, far from the BC
    # mean (plain behavior cloning on this data would land at ~0)
    with torch.no_grad():
        a = float(algo.module.inference_action(algo.params, torch.zeros((2,)))[0])
    assert 0.3 < a < 0.75, a
    ev = algo.evaluate(num_episodes=5)["evaluation"]
    assert ev["episode_return_mean"] > -0.1  # near the 0 optimum
    # checkpoint roundtrip
    algo2 = config.copy().build()
    algo2.set_state(algo.get_state())
    for x, y in zip(tree_leaves(algo.params), tree_leaves(algo2.params)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_direct_param_algorithms_expose_inference_api():
    ported(jax_contrib.test_direct_param_algorithms_expose_inference_api)()


# --------------------------------------------------------------------------
# DreamerV3 (tests/test_rllib.py:764-822)
# --------------------------------------------------------------------------
_tiny_dreamer = ported(jax_rllib._tiny_dreamer)


@pytest.mark.full
def test_dreamerv3_world_model_learns():
    """The world-model loss on a FIXED probe batch must drop with training
    (same data and Gumbel draws before and after isolates learning from
    replay drift)."""
    algo = _tiny_dreamer().build()
    algo.train()  # fill replay
    probe = algo._replay[0]
    T, B = probe["action"].shape
    gz = algo.draw_noise(T, B, gen(123))["obs_z"]
    before = float(algo._observe_loss(algo.state["wm"], gz, probe))
    last = {}
    for _ in range(8):
        last = algo.train()["learners"]
    after = float(algo._observe_loss(algo.state["wm"], gz, probe))
    assert np.isfinite(list(last.values())).all()
    assert after < before
    algo.stop()


@pytest.mark.full
def test_dreamerv3_checkpoint_roundtrip(tmp_path):
    ported(jax_rllib.test_dreamerv3_checkpoint_roundtrip)(tmp_path)


def test_dreamerv3_symlog_twohot_roundtrip():
    from ray_tpu_torch.rllib.algorithms.dreamerv3 import _BINS, symexp, symlog, twohot

    x = torch.tensor([-50.0, -1.0, 0.0, 0.5, 7.0, 300.0])
    np.testing.assert_allclose(symexp(symlog(x)).numpy(), x.numpy(), rtol=1e-5)
    # twohot encoding is exact for in-range scalars: decode via bin atoms
    enc = twohot(symlog(x))
    dec = symexp(torch.sum(enc * _BINS, -1))
    np.testing.assert_allclose(dec.numpy(), x.numpy(), rtol=1e-4, atol=1e-4)
