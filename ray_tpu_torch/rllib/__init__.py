"""The RL library — the port of the JAX package's ``rllib/`` (itself the
rebuild of the reference's RLlib).

Reference architecture (SURVEY §2.4): `Algorithm`/`AlgorithmConfig`
(`rllib/algorithms/algorithm.py:213`, `algorithm_config.py:117`), the new API
stack's `RLModule` (`rllib/core/rl_module/rl_module.py`), `Learner`/
`LearnerGroup` (`rllib/core/learner/learner.py:107`, `learner_group.py:69`),
and `EnvRunnerGroup` sampling (`rllib/env/env_runner_group.py`).

Envs are batched functions over device tensors, stepped by the runner from
Python: one set of launches an env step for thousands of envs (the JAX
package scans a whole rollout as one XLA program). Modules are plain
functions over params trees; learners take ``torch.autograd`` gradients and
step the port's own optax counterparts. Everything runs on CUDA unless
given ``device="cpu"`` (``AlgorithmConfig.resources``).
"""

from ray_tpu_torch.rllib.envs import CartPole, Pendulum, JaxEnv
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.rl_module import (
    ActorCriticModule,
    ContinuousActorCriticModule,
    QModule,
    SACModule,
)
from ray_tpu_torch.rllib.env_runner import EnvRunner, EnvRunnerGroup
from ray_tpu_torch.rllib.external_env import (
    GymEnvRunner,
    MultiAgentEnv,
    MultiAgentEnvRunner,
)
from ray_tpu_torch.rllib.learner import Learner, LearnerGroup
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig
from ray_tpu_torch.rllib.algorithms.bc import BC, BCConfig
from ray_tpu_torch.rllib.algorithms.impala import APPO, APPOConfig, IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.algorithms.marwil import MARWIL, MARWILConfig
from ray_tpu_torch.rllib.algorithms.cql import CQL, CQLConfig
from ray_tpu_torch.rllib.algorithms.pg import (
    A2C,
    A2CConfig,
    A3C,
    A3CConfig,
    PG,
    PGConfig,
)
from ray_tpu_torch.rllib.algorithms.ddpg import DDPG, DDPGConfig, TD3, TD3Config
from ray_tpu_torch.rllib.algorithms.simple_q import (
    ApexDQN,
    ApexDQNConfig,
    SimpleQ,
    SimpleQConfig,
)
from ray_tpu_torch.rllib.algorithms.es import ARS, ARSConfig, ES, ESConfig
from ray_tpu_torch.rllib.algorithms.r2d2 import GRUQModule, R2D2, R2D2Config
from ray_tpu_torch.rllib.algorithms.maddpg import MADDPG, MADDPGConfig, SimpleSpread
from ray_tpu_torch.rllib.algorithms.dt import DT, DTConfig, DTModule
from ray_tpu_torch.rllib.algorithms.qmix import DiscreteSpread, QMIX, QMIXConfig
from ray_tpu_torch.rllib.algorithms.crr import CRR, CRRConfig
from ray_tpu_torch.rllib.algorithms.bandit import (
    LinearBanditEnv,
    LinTS,
    LinTSConfig,
    LinUCB,
    LinUCBConfig,
)
from ray_tpu_torch.rllib.algorithms.registry import (
    get_algorithm_class,
    get_algorithm_config,
    list_algorithms,
)
from ray_tpu_torch.rllib.replay_buffer import PrioritizedReplayBuffer
from ray_tpu_torch.rllib import offline

__all__ = [
    "JaxEnv",
    "CartPole",
    "Pendulum",
    "SampleBatch",
    "ReplayBuffer",
    "ActorCriticModule",
    "ContinuousActorCriticModule",
    "QModule",
    "SACModule",
    "EnvRunner",
    "EnvRunnerGroup",
    "Learner",
    "LearnerGroup",
    "Algorithm",
    "AlgorithmConfig",
    "PPO",
    "PPOConfig",
    "DQN",
    "DQNConfig",
    "SAC",
    "SACConfig",
    "BC",
    "BCConfig",
    "IMPALA",
    "IMPALAConfig",
    "APPO",
    "APPOConfig",
    "MARWIL",
    "MARWILConfig",
    "CQL",
    "CQLConfig",
    "PG",
    "PGConfig",
    "A2C",
    "A2CConfig",
    "A3C",
    "A3CConfig",
    "DDPG",
    "DDPGConfig",
    "TD3",
    "TD3Config",
    "SimpleQ",
    "SimpleQConfig",
    "ApexDQN",
    "ApexDQNConfig",
    "ES",
    "ESConfig",
    "ARS",
    "ARSConfig",
    "R2D2",
    "R2D2Config",
    "GRUQModule",
    "MADDPG",
    "MADDPGConfig",
    "SimpleSpread",
    "DT",
    "DTConfig",
    "DTModule",
    "QMIX",
    "QMIXConfig",
    "DiscreteSpread",
    "CRR",
    "CRRConfig",
    "LinUCB",
    "LinUCBConfig",
    "LinTS",
    "LinTSConfig",
    "LinearBanditEnv",
    "PrioritizedReplayBuffer",
    "get_algorithm_class",
    "get_algorithm_config",
    "list_algorithms",
    "offline",
]

