from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig
from ray_tpu_torch.rllib.algorithms.bc import BC, BCConfig
from ray_tpu_torch.rllib.algorithms.impala import APPO, APPOConfig, IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.algorithms.marwil import MARWIL, MARWILConfig
from ray_tpu_torch.rllib.algorithms.cql import CQL, CQLConfig
from ray_tpu_torch.rllib.algorithms.dreamerv3 import DreamerV3, DreamerV3Config
from ray_tpu_torch.rllib.algorithms.pg import A2C, A2CConfig, A3C, A3CConfig, PG, PGConfig
from ray_tpu_torch.rllib.algorithms.ddpg import DDPG, DDPGConfig, TD3, TD3Config
from ray_tpu_torch.rllib.algorithms.simple_q import ApexDQN, ApexDQNConfig, SimpleQ, SimpleQConfig
from ray_tpu_torch.rllib.algorithms.es import ARS, ARSConfig, ES, ESConfig
from ray_tpu_torch.rllib.algorithms.bandit import LinTS, LinTSConfig, LinUCB, LinUCBConfig
from ray_tpu_torch.rllib.algorithms.registry import (
    get_algorithm_class,
    get_algorithm_config,
    list_algorithms,
)

__all__ = ["PPO", "PPOConfig", "DQN", "DQNConfig", "SAC", "SACConfig", "BC", "BCConfig", "IMPALA", "IMPALAConfig", "APPO", "APPOConfig", "MARWIL", "MARWILConfig", "CQL", "CQLConfig", "DreamerV3", "DreamerV3Config", "PG", "PGConfig", "A2C", "A2CConfig", "A3C", "A3CConfig", "DDPG", "DDPGConfig", "TD3", "TD3Config", "SimpleQ", "SimpleQConfig", "ApexDQN", "ApexDQNConfig", "ES", "ESConfig", "ARS", "ARSConfig", "LinUCB", "LinUCBConfig", "LinTS", "LinTSConfig", "get_algorithm_class", "get_algorithm_config", "list_algorithms"]

