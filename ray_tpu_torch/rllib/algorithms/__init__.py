from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig
from ray_tpu_torch.rllib.algorithms.bc import BC, BCConfig
from ray_tpu_torch.rllib.algorithms.impala import APPO, APPOConfig, IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.algorithms.marwil import MARWIL, MARWILConfig
from ray_tpu_torch.rllib.algorithms.cql import CQL, CQLConfig
from ray_tpu_torch.rllib.algorithms.registry import (
    NOT_PORTED_NAMES,
    get_algorithm_class,
    get_algorithm_config,
    list_algorithms,
    not_ported,
)

__all__ = ["PPO", "PPOConfig", "DQN", "DQNConfig", "SAC", "SACConfig", "BC", "BCConfig", "IMPALA", "IMPALAConfig", "APPO", "APPOConfig", "MARWIL", "MARWILConfig", "CQL", "CQLConfig", "DreamerV3", "DreamerV3Config", "PG", "PGConfig", "A2C", "A2CConfig", "A3C", "A3CConfig", "DDPG", "DDPGConfig", "TD3", "TD3Config", "SimpleQ", "SimpleQConfig", "ApexDQN", "ApexDQNConfig", "ES", "ESConfig", "ARS", "ARSConfig", "LinUCB", "LinUCBConfig", "LinTS", "LinTSConfig", "get_algorithm_class", "get_algorithm_config", "list_algorithms"]


def __getattr__(name: str):
    # the JAX package's algorithms that are not ported yet (ROADMAP item 12)
    if name in NOT_PORTED_NAMES:
        raise not_ported(name, NOT_PORTED_NAMES[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
