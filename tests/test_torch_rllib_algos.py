"""The cases of ``tests/test_rllib.py`` (DreamerV3's three apart, ROADMAP
item 12), ``tests/test_rllib_external.py`` and
``tests/test_tune_api_tail.py::test_register_env_reaches_rllib`` as
behaviour tests of the port, given ``device="cpu"``.

Each case keeps its JAX counterpart's name, thresholds and ``full`` marker.
A body that draws no JAX key runs as written, bound to the port
(``tests/torch_ported.py``); the others are written out here, with the
port's generators in the place of JAX keys and ``device="cpu"`` (or
``.resources(device="cpu")``) where the port would take the card.
"""

import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_rllib as jax_rllib  # noqa: E402
from torch_ported import ported  # noqa: E402

from ray_tpu_torch.rllib import (  # noqa: E402
    BCConfig,
    CartPole,
    DQNConfig,
    EnvRunner,
    GymEnvRunner,
    MultiAgentEnv,
    MultiAgentEnvRunner,
    Pendulum,
    PPOConfig,
    SACConfig,
    SampleBatch,
)
from ray_tpu_torch.rllib.rl_module import ActorCriticModule, tree_leaves  # noqa: E402

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


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_cartpole_dynamics():
    env = CartPole()
    state, obs = env.reset(gen(0), 1, CPU)
    assert obs.shape == (1, 4)
    one = torch.ones(1, dtype=torch.int64)
    for _ in range(5):
        state, obs, reward, terminated, truncated = env.step(state, one)
    assert float(reward) == 1.0
    assert not bool(terminated)
    # pushing one way forever tips the pole over — a true terminal
    for _ in range(200):
        state, obs, reward, terminated, truncated = env.step(state, one)
    assert bool(terminated)
    assert not bool(truncated)


def test_pendulum_truncates_not_terminates():
    env = Pendulum(max_episode_steps=10)
    state, obs = env.reset(gen(1), 1, CPU)
    assert obs.shape == (1, 3)
    for _ in range(10):
        state, obs, reward, terminated, truncated = env.step(state, torch.tensor([[0.5]]))
    assert float(reward) <= 0.0
    # time-limit cut is reported as truncation, never termination
    assert not bool(terminated)
    assert bool(truncated)


def test_env_runner_rollout_shapes_and_autoreset():
    env = CartPole(max_episode_steps=20)
    module = ActorCriticModule(env.observation_size, env.num_actions, (16,))
    runner = EnvRunner(env, module, num_envs=4, rollout_length=64, seed=0, device=CPU)
    params = module.init(gen(0))
    batch, final_obs, ep_returns = runner.sample(params)
    assert batch[SampleBatch.OBS].shape == (64, 4, 4)
    assert batch[SampleBatch.ACTIONS].shape == (64, 4)
    assert batch[SampleBatch.LOGP].shape == (64, 4)
    assert final_obs.shape == (4, 4)
    # 64 steps x 4 envs with <=20-step episodes must finish many episodes
    assert len(ep_returns) >= 8
    assert all(r <= 20 for r in ep_returns)


def test_replay_buffer_wraps():
    ported(jax_rllib.test_replay_buffer_wraps)()


def test_ppo_learns_cartpole():
    config = (
        PPOConfig()
        .environment(CartPole())
        .env_runners(num_envs_per_runner=16, rollout_length=128)
        .training(lr=3e-4, num_epochs=4, minibatch_size=512)
        .debugging(seed=0)
        .resources(device=CPU)
    )
    algo = config.build()
    first = None
    result = None
    for _ in range(15):
        result = algo.train()
        if first is None and not np.isnan(result["episode_return_mean"]):
            first = result["episode_return_mean"]
    assert result["episode_return_mean"] > max(60.0, first * 1.5)
    assert result["num_env_steps_sampled_lifetime"] == 15 * 16 * 128
    algo.stop()


def test_dqn_runs_and_improves():
    config = (
        DQNConfig()
        .environment(CartPole())
        .env_runners(num_envs_per_runner=8, rollout_length=64)
        .training(
            learning_starts=500,
            num_updates_per_iter=32,
            epsilon_decay_steps=2500,
        )
        .debugging(seed=0)
        .resources(device=CPU)
    )
    algo = config.build()
    result = None
    for _ in range(25):
        result = algo.train()
    assert "td_error_mean" in result["learners"]
    assert result["episode_return_mean"] > 15.0
    algo.stop()


@pytest.mark.full
def test_sac_runs_on_pendulum():
    config = (
        SACConfig()
        .environment(Pendulum())
        .env_runners(num_envs_per_runner=4, rollout_length=64)
        .training(learning_starts=200, num_updates_per_iter=4)
        .debugging(seed=0)
        .resources(device=CPU)
    )
    algo = config.build()
    result = None
    for _ in range(4):
        result = algo.train()
    assert "critic_loss" in result["learners"]
    assert np.isfinite(result["learners"]["critic_loss"])
    algo.stop()


def test_bc_fits_expert_actions():
    # expert: push toward upright (action = theta > 0)
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(2000, 4)).astype(np.float32)
    actions = (obs[:, 2] > 0).astype(np.int32)
    data = SampleBatch({SampleBatch.OBS: obs, SampleBatch.ACTIONS: actions})
    config = (BCConfig().environment(CartPole()).offline(data).training(lr=1e-2)
              .resources(device=CPU))
    algo = config.build()
    first = algo.train()["learners"]["neg_logp"]
    last = None
    for _ in range(5):
        last = algo.train()["learners"]["neg_logp"]
    assert last < first * 0.5


def test_checkpoint_roundtrip(tmp_path):
    config = PPOConfig().environment(CartPole()).env_runners(
        num_envs_per_runner=4, rollout_length=32
    ).resources(device=CPU)
    algo = config.build()
    algo.train()
    path = algo.save(str(tmp_path / "ckpt.pkl"))
    algo2 = config.copy().build()
    algo2.restore(path)
    assert algo2.iteration == 1
    p1 = tree_leaves(algo.learners.params)
    p2 = tree_leaves(algo2.learners.params)
    for a, b in zip(p1, p2):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    algo.stop()


def test_algorithm_as_tune_trainable():
    import ray_tpu_torch as rt
    from ray_tpu_torch import tune

    config = PPOConfig().environment(CartPole()).env_runners(
        num_envs_per_runner=4, rollout_length=32
    ).resources(device=CPU)
    trainable = PPOConfig.algo_class.as_trainable(config, stop_iters=2)
    rt.init(num_cpus=4)
    try:
        tuner = tune.Tuner(
            trainable,
            param_space={"lr": tune.grid_search([1e-3, 3e-4])},
            tune_config=tune.TuneConfig(metric="episode_return_mean", mode="max"),
        )
        results = tuner.fit()
    finally:
        rt.shutdown()
    assert len(results) == 2


@pytest.mark.full
def test_remote_env_runners():
    import ray_tpu_torch as rt

    config = (
        PPOConfig()
        .environment(CartPole())
        .env_runners(
            num_env_runners=2, num_envs_per_runner=4, rollout_length=32, remote=True
        )
        .resources(device=CPU)
    )
    rt.init(num_cpus=4)
    try:
        algo = config.build()
        result = algo.train()
        assert result["num_env_steps_sampled_lifetime"] == 2 * 4 * 32
        algo.stop()
    finally:
        rt.shutdown()


# ---------------------------------------------------------------------------
# IMPALA / APPO (V-trace)
# ---------------------------------------------------------------------------
def test_vtrace_matches_gae_when_on_policy():
    from ray_tpu_torch.rllib.algorithms.impala import vtrace

    T, B = 16, 4
    rng = np.random.default_rng(0)
    logp = torch.as_tensor(rng.normal(size=(T, B)).astype(np.float32))
    rewards = torch.as_tensor(rng.normal(size=(T, B)).astype(np.float32))
    values = torch.as_tensor(rng.normal(size=(T, B)).astype(np.float32))
    dones = torch.zeros((T, B), dtype=torch.bool)
    final_v = torch.zeros((B,))
    vs, pg = vtrace(logp, logp, rewards, values, dones, final_v, 0.99, 1.0, 1.0)
    assert vs.shape == (T, B) and pg.shape == (T, B)
    assert bool(torch.isfinite(vs).all()) and bool(torch.isfinite(pg).all())
    # rho==1: vs should equal discounted lambda=1 corrected values
    np.testing.assert_allclose(vs[-1].numpy(), rewards[-1].numpy(), rtol=1e-5, atol=1e-5)


def test_impala_learns_cartpole():
    from ray_tpu_torch.rllib import IMPALAConfig

    config = (
        IMPALAConfig()
        .environment(CartPole())
        .env_runners(num_envs_per_runner=16, rollout_length=128)
        .training(lr=2e-3, entropy_coeff=0.005, broadcast_interval=2)
        .debugging(seed=0)
        .resources(device=CPU)
    )
    algo = config.build()
    first = None
    result = None
    for _ in range(25):
        result = algo.train()
        if first is None and not np.isnan(result["episode_return_mean"]):
            first = result["episode_return_mean"]
    assert result["episode_return_mean"] > max(60.0, first * 1.5)
    algo.stop()


def test_appo_runs_and_improves():
    from ray_tpu_torch.rllib import APPOConfig

    config = (
        APPOConfig()
        .environment(CartPole())
        .env_runners(num_envs_per_runner=16, rollout_length=64)
        .training(lr=5e-4, clip_param=0.3)
        .debugging(seed=1)
        .resources(device=CPU)
    )
    algo = config.build()
    first = None
    result = None
    for _ in range(15):
        result = algo.train()
        if first is None and not np.isnan(result["episode_return_mean"]):
            first = result["episode_return_mean"]
    assert np.isfinite(result["learners"]["policy_loss"])
    assert result["episode_return_mean"] > first
    algo.stop()


# ---------------------------------------------------------------------------
# offline: MARWIL / CQL / offline module
# ---------------------------------------------------------------------------
_expert_cartpole_data = ported(jax_rllib._expert_cartpole_data)


def test_marwil_fits_expert():
    from ray_tpu_torch.rllib import MARWILConfig

    data = _expert_cartpole_data()
    config = (MARWILConfig().environment(CartPole()).offline(data).training(lr=1e-2, beta=1.0)
              .resources(device=CPU))
    algo = config.build()
    first = algo.train()["learners"]["policy_loss"]
    last = None
    for _ in range(5):
        last = algo.train()["learners"]["policy_loss"]
    assert last < first


def test_marwil_beta_zero_is_bc():
    from ray_tpu_torch.rllib import MARWILConfig

    data = _expert_cartpole_data()
    config = (MARWILConfig().environment(CartPole()).offline(data).training(lr=1e-2, beta=0.0)
              .resources(device=CPU))
    algo = config.build()
    first = algo.train()["learners"]["policy_loss"]
    for _ in range(5):
        last = algo.train()["learners"]["policy_loss"]
    assert last < first * 0.7


def test_cql_offline_pendulum(tmp_path):
    from ray_tpu_torch.rllib import CQLConfig

    rng = np.random.default_rng(0)
    n = 2000
    data = SampleBatch(
        {
            SampleBatch.OBS: rng.normal(size=(n, 3)).astype(np.float32),
            SampleBatch.NEXT_OBS: rng.normal(size=(n, 3)).astype(np.float32),
            SampleBatch.ACTIONS: rng.uniform(-2, 2, size=(n, 1)).astype(np.float32),
            SampleBatch.REWARDS: rng.normal(size=n).astype(np.float32),
            SampleBatch.DONES: np.zeros(n, bool),
        }
    )
    config = (
        CQLConfig()
        .environment(Pendulum())
        .offline(data)
        .training(num_updates_per_iter=4, cql_alpha=1.0)
        .resources(device=CPU)
    )
    algo = config.build()
    result = None
    for _ in range(3):
        result = algo.train()
    stats = result["learners"]
    assert np.isfinite(stats["bellman"]) and np.isfinite(stats["cql_penalty"])
    # conservative penalty must be active (logsumexp > dataset Q on average)
    assert stats["cql_penalty"] != 0.0
    # checkpoint roundtrip through the custom learner state
    p = algo.save(os.path.join(tmp_path, "ckpt.pkl"))
    algo2 = config.build()
    algo2.restore(p)
    for a, b in zip(tree_leaves(algo.learner.params), tree_leaves(algo2.learner.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy())


def test_offline_record_save_load_roundtrip(tmp_path):
    from ray_tpu_torch.rllib import offline

    env = CartPole()
    module = ActorCriticModule(env.observation_size, env.num_actions, (32,))
    params = module.init(gen(0))
    data = offline.record_rollouts(
        env, module, params, num_iterations=2, num_envs=4, rollout_length=32, device=CPU
    )
    assert len(data) == 2 * 4 * 32
    assert SampleBatch.RETURNS in data
    path = offline.save_batch(data, str(tmp_path / "data.npz"))
    loaded = offline.load_batch(path)
    np.testing.assert_array_equal(
        np.asarray(data[SampleBatch.OBS]), loaded[SampleBatch.OBS]
    )


# --------------------------------------------------------------------------
# Connectors (parity: rllib/connectors env-to-module / module-to-env)
# --------------------------------------------------------------------------
def test_connector_pipeline_composition():
    from ray_tpu_torch.rllib.connectors import (
        CastObs,
        ClipActions,
        ClipObs,
        ConnectorPipeline,
        FlattenObs,
        NormalizeObs,
        UnsquashActions,
        env_to_module,
    )

    pipe = env_to_module(NormalizeObs(mean=1.0, std=2.0), ClipObs(-1.0, 1.0))
    out = pipe(torch.tensor([1.0, 5.0, -9.0]))
    assert out.tolist() == [0.0, 1.0, -1.0]

    flat = FlattenObs(batch_dims=1)(torch.ones((4, 2, 3)))
    assert flat.shape == (4, 6)

    clip = ClipActions(-0.5, 0.5)(torch.tensor([-2.0, 0.1, 3.0]))
    assert clip.tolist() == pytest.approx([-0.5, 0.1, 0.5])

    unsq = UnsquashActions(0.0, 10.0)(torch.tensor([-100.0, 0.0, 100.0]))
    assert float(unsq[0]) == pytest.approx(0.0, abs=1e-3)
    assert float(unsq[1]) == pytest.approx(5.0)
    assert float(unsq[2]) == pytest.approx(10.0, abs=1e-3)

    # pipelines compose and extend
    p2 = ConnectorPipeline([CastObs(torch.float32)]).append(NormalizeObs(0.0, 1.0))
    assert p2(torch.tensor([1, 2], dtype=torch.int32)).dtype == torch.float32


def test_env_runner_with_connectors():
    """An observation-normalizing connector inside the rollout must still
    produce learnable PPO batches."""
    from ray_tpu_torch.rllib.connectors import NormalizeObs, env_to_module

    env = CartPole()
    module = ActorCriticModule(env.observation_size, env.num_actions, hidden=(32,))
    runner = EnvRunner(
        env,
        module,
        num_envs=4,
        rollout_length=16,
        env_to_module=env_to_module(NormalizeObs(mean=0.0, std=1.0)),
        device=CPU,
    )
    params = module.init(gen(0))
    batch, final_obs, returns = runner.sample(params)
    assert batch["obs"].shape[:2] == (16, 4)


# --------------------------------------------------------------------------
# Algorithm API tail (parity: compute_single_action / weights / checkpoint)
# --------------------------------------------------------------------------
def _small_ppo():
    return (
        PPOConfig()
        .environment(CartPole())
        .env_runners(num_envs_per_runner=4, rollout_length=32)
        .resources(device=CPU)
    )


def test_algorithm_inference_and_weights_api():
    algo = _small_ppo().build()
    try:
        algo.train()
        obs = np.zeros(4, np.float32)
        a = algo.compute_single_action(obs)
        assert a in (0, 1)
        acts = algo.compute_actions(np.zeros((5, 4), np.float32))
        assert acts.shape == (5,)
        # module/policy accessors and the weights roundtrip
        assert algo.get_policy() is algo.get_module()
        w = algo.get_weights()
        algo.set_weights(w)
        assert algo.compute_single_action(obs) == a  # same weights, same action
        # step() is the Trainable alias for train()
        r = algo.step()
        assert r["training_iteration"] == 2
    finally:
        algo.stop()


def test_algorithm_from_checkpoint_roundtrip(tmp_path):
    algo = _small_ppo().build()
    try:
        algo.train()
        path = algo.save(str(tmp_path / "ckpt.pkl"))
        obs = np.linspace(-0.1, 0.1, 4).astype(np.float32)
        want = algo.compute_single_action(obs)
    finally:
        algo.stop()
    from ray_tpu_torch.rllib.algorithm import Algorithm

    revived = Algorithm.from_checkpoint(path)
    try:
        assert revived.iteration == 1
        assert revived.compute_single_action(obs) == want
    finally:
        revived.stop()


def test_offline_checkpoint_strips_dataset(tmp_path):
    rng = np.random.default_rng(0)
    big = SampleBatch({
        "obs": rng.normal(size=(4096, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, size=4096).astype(np.int32),
    })
    config = BCConfig().environment(CartPole()).offline(big).training(lr=1e-2).resources(
        device=CPU)
    algo = config.build()
    try:
        algo.train()
        path = algo.save(str(tmp_path / "bc.pkl"))
    finally:
        algo.stop()
    with open(path, "rb") as f:
        blob = pickle.load(f)
    assert blob["stripped_config_attrs"] == ["offline_data"]
    assert blob["config"].offline_data is None
    from ray_tpu_torch.rllib.algorithm import Algorithm

    with pytest.raises(ValueError, match="offline datasets are not serialized"):
        Algorithm.from_checkpoint(path)
    # passing a config with data attached revives it
    revived = Algorithm.from_checkpoint(path, config=config)
    try:
        assert revived.iteration == 1
    finally:
        revived.stop()


def test_periodic_evaluation_in_train():
    algo = _small_ppo().evaluation(evaluation_interval=2, evaluation_duration=3).build()
    try:
        r1 = algo.train()
        assert "evaluation" not in r1          # iteration 1: off-interval
        r2 = algo.train()
        ev = r2["evaluation"]                   # iteration 2: evaluated
        assert ev["num_episodes"] == 3
        assert "episode_return_mean" in ev
    finally:
        algo.stop()
    from ray_tpu_torch.rllib.algorithm import AlgorithmConfig

    with pytest.raises(ValueError, match="positive"):
        AlgorithmConfig().evaluation(evaluation_interval=0)
    with pytest.raises(ValueError, match="positive"):
        AlgorithmConfig().evaluation(evaluation_duration=-1)


# --------------------------------------------------------------------------
# tests/test_rllib_external.py: gym-API and multi-agent runners
# --------------------------------------------------------------------------
class TinyGymEnv:
    """Gymnasium-API env without the gymnasium dependency: 1D position
    walk; +1 reward for action 1, episode ends after 10 steps."""

    def __init__(self):
        self.t = 0

    def reset(self, *, seed=None, options=None):
        self.t = 0
        return np.zeros(4, np.float32), {}

    def step(self, action):
        self.t += 1
        obs = np.full(4, self.t / 10.0, np.float32)
        reward = float(action == 1)
        terminated = self.t >= 10
        return obs, reward, terminated, False, {}


def _module():
    return ActorCriticModule(obs_size=4, num_actions=2, hidden=(16,))


def test_gym_runner_samples_batches():
    module = _module()
    params = module.init(gen(0))
    runner = GymEnvRunner(
        [TinyGymEnv for _ in range(3)], module,
        rollout_length=25, num_actions=2, device=CPU,
    )
    batch, final_obs, returns = runner.sample(params)
    assert batch[SampleBatch.OBS].shape == (25, 3, 4)
    assert batch[SampleBatch.ACTIONS].shape == (25, 3)
    assert batch[SampleBatch.LOGP].shape == (25, 3)
    assert final_obs.shape == (3, 4)
    # 25 steps x 3 envs with 10-step episodes -> at least 6 completions
    assert len(returns) >= 6
    # terminals recorded at episode boundaries
    assert batch[SampleBatch.DONES].sum() >= 6
    runner.stop()


def test_gym_runner_classic_4tuple_api():
    class OldGym(TinyGymEnv):
        def step(self, action):  # classic gym: no truncated field
            obs, r, term, trunc, info = super().step(action)
            return obs, r, term, info

    module = _module()
    runner = GymEnvRunner([OldGym], module, rollout_length=12, num_actions=2, device=CPU)
    batch, _obs, returns = runner.sample(module.init(gen(0)))
    assert batch[SampleBatch.REWARDS].shape == (12, 1)
    assert len(returns) >= 1


class TwoAgentTag(MultiAgentEnv):
    """Two agents on a line; each gets its own reward; episode ends for
    all after 8 steps."""

    agents = ["a0", "a1"]

    def __init__(self):
        self.t = 0

    def reset(self):
        self.t = 0
        return {a: np.zeros(4, np.float32) for a in self.agents}, {}

    def step(self, action_dict):
        self.t += 1
        obs = {a: np.full(4, self.t / 8.0, np.float32) for a in self.agents}
        rewards = {a: float(act) for a, act in action_dict.items()}
        done = self.t >= 8
        terms = {a: done for a in self.agents}
        terms["__all__"] = done
        truncs = {"__all__": False}
        return obs, rewards, terms, truncs, {}


def test_multi_agent_runner_shared_policy():
    module = _module()
    params = module.init(gen(0))
    runner = MultiAgentEnvRunner(TwoAgentTag(), module, rollout_length=20, device=CPU)
    batch, final, returns = runner.sample(params)
    # [T, n_agents, obs]: both agents batched through one policy forward
    assert batch[SampleBatch.OBS].shape == (20, 2, 4)
    assert batch[SampleBatch.ACTIONS].shape == (20, 2)
    assert len(returns) >= 2  # 20 steps / 8-step episodes
    assert final.shape == (2, 4)


# --------------------------------------------------------------------------
# tests/test_tune_api_tail.py::test_register_env_reaches_rllib
# --------------------------------------------------------------------------
def test_register_env_reaches_rllib():
    from ray_tpu_torch import tune
    from ray_tpu_torch.rllib.algorithm import AlgorithmConfig

    class DummyEnv:
        pass

    tune.register_env("my_env", lambda cfg: DummyEnv())
    config = AlgorithmConfig().environment("my_env")
    assert isinstance(config.env, DummyEnv)
    with pytest.raises(ValueError):
        AlgorithmConfig().environment("unregistered_env")
