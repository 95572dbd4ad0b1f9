"""Algorithm registry: name -> (Algorithm class, default config factory).

Parity: `rllib/algorithms/registry.py` (POLICIES/ALGORITHMS name maps used
by `rllib train --run=PPO` and Tune's string-run resolution). The same
names as the JAX package's registry.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Type


def _load() -> Dict[str, Tuple[type, Callable]]:
    from ray_tpu_torch.rllib.algorithms.bandit import (
        LinTS,
        LinTSConfig,
        LinUCB,
        LinUCBConfig,
    )
    from ray_tpu_torch.rllib.algorithms.bc import BC, BCConfig
    from ray_tpu_torch.rllib.algorithms.cql import CQL, CQLConfig
    from ray_tpu_torch.rllib.algorithms.crr import CRR, CRRConfig
    from ray_tpu_torch.rllib.algorithms.ddpg import DDPG, DDPGConfig, TD3, TD3Config
    from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
    from ray_tpu_torch.rllib.algorithms.dreamerv3 import DreamerV3, DreamerV3Config
    from ray_tpu_torch.rllib.algorithms.dt import DT, DTConfig
    from ray_tpu_torch.rllib.algorithms.es import ARS, ARSConfig, ES, ESConfig
    from ray_tpu_torch.rllib.algorithms.impala import APPO, APPOConfig, IMPALA, IMPALAConfig
    from ray_tpu_torch.rllib.algorithms.maddpg import MADDPG, MADDPGConfig
    from ray_tpu_torch.rllib.algorithms.marwil import MARWIL, MARWILConfig
    from ray_tpu_torch.rllib.algorithms.pg import A2C, A2CConfig, A3C, A3CConfig, PG, PGConfig
    from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
    from ray_tpu_torch.rllib.algorithms.qmix import QMIX, QMIXConfig
    from ray_tpu_torch.rllib.algorithms.r2d2 import R2D2, R2D2Config
    from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig
    from ray_tpu_torch.rllib.algorithms.simple_q import (
        ApexDQN,
        ApexDQNConfig,
        SimpleQ,
        SimpleQConfig,
    )

    return {
        "PPO": (PPO, PPOConfig),
        "APPO": (APPO, APPOConfig),
        "IMPALA": (IMPALA, IMPALAConfig),
        "DQN": (DQN, DQNConfig),
        "SAC": (SAC, SACConfig),
        "BC": (BC, BCConfig),
        "MARWIL": (MARWIL, MARWILConfig),
        "CQL": (CQL, CQLConfig),
        "DreamerV3": (DreamerV3, DreamerV3Config),
        "PG": (PG, PGConfig),
        "A2C": (A2C, A2CConfig),
        "A3C": (A3C, A3CConfig),
        "DDPG": (DDPG, DDPGConfig),
        "TD3": (TD3, TD3Config),
        "SimpleQ": (SimpleQ, SimpleQConfig),
        "APEX": (ApexDQN, ApexDQNConfig),
        "ES": (ES, ESConfig),
        "ARS": (ARS, ARSConfig),
        "R2D2": (R2D2, R2D2Config),
        "MADDPG": (MADDPG, MADDPGConfig),
        "DT": (DT, DTConfig),
        "QMIX": (QMIX, QMIXConfig),
        "CRR": (CRR, CRRConfig),
        "BanditLinUCB": (LinUCB, LinUCBConfig),
        "BanditLinTS": (LinTS, LinTSConfig),
    }


_REGISTRY: Dict[str, Tuple[type, Callable]] = {}


def _registry() -> Dict[str, Tuple[type, Callable]]:
    if not _REGISTRY:
        _REGISTRY.update(_load())
    return _REGISTRY


def _lookup(name: str) -> Tuple[type, Callable]:
    reg = _registry()
    for k, entry in reg.items():
        if k.lower() == name.lower():
            return entry
    raise ValueError(f"unknown algorithm {name!r}; known: {sorted(reg)}")


def get_algorithm_class(name: str) -> Type:
    """Resolve an algorithm by its registry name (case-insensitive)."""
    return _lookup(name)[0]


def get_algorithm_config(name: str):
    """A fresh default config for the named algorithm."""
    return _lookup(name)[1]()


def list_algorithms():
    return sorted(_registry())
