"""Algorithm registry: name -> (Algorithm class, default config factory).

Parity: `rllib/algorithms/registry.py` (POLICIES/ALGORITHMS name maps used
by `rllib train --run=PPO` and Tune's string-run resolution). Every name of
the JAX package's registry is listed; a name whose algorithm is not ported
yet raises :class:`~ray_tpu_torch.exceptions.NotPortedError` on lookup.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Type

from ray_tpu_torch.exceptions import NotPortedError

# the JAX package's algorithms that are not ported yet (ROADMAP item 12):
# registry name -> the JAX package's module
NOT_PORTED = {
    "DreamerV3": "dreamerv3",
    "PG": "pg",
    "A2C": "pg",
    "A3C": "pg",
    "DDPG": "ddpg",
    "TD3": "ddpg",
    "SimpleQ": "simple_q",
    "APEX": "simple_q",
    "ES": "es",
    "ARS": "es",
    "R2D2": "r2d2",
    "MADDPG": "maddpg",
    "DT": "dt",
    "QMIX": "qmix",
    "CRR": "crr",
    "BanditLinUCB": "bandit",
    "BanditLinTS": "bandit",
}


# every exported name of those modules -> its module (``rllib`` and
# ``rllib.algorithms`` raise on access to one)
NOT_PORTED_NAMES = {
    **dict.fromkeys(("DreamerV3", "DreamerV3Config"), "dreamerv3"),
    **dict.fromkeys(("PG", "PGConfig", "A2C", "A2CConfig", "A3C", "A3CConfig"), "pg"),
    **dict.fromkeys(("DDPG", "DDPGConfig", "TD3", "TD3Config"), "ddpg"),
    **dict.fromkeys(("SimpleQ", "SimpleQConfig", "ApexDQN", "ApexDQNConfig"), "simple_q"),
    **dict.fromkeys(("ES", "ESConfig", "ARS", "ARSConfig"), "es"),
    **dict.fromkeys(("R2D2", "R2D2Config", "GRUQModule"), "r2d2"),
    **dict.fromkeys(("MADDPG", "MADDPGConfig", "SimpleSpread"), "maddpg"),
    **dict.fromkeys(("DT", "DTConfig", "DTModule"), "dt"),
    **dict.fromkeys(("QMIX", "QMIXConfig", "DiscreteSpread"), "qmix"),
    **dict.fromkeys(("CRR", "CRRConfig"), "crr"),
    **dict.fromkeys(("LinUCB", "LinUCBConfig", "LinTS", "LinTSConfig", "LinearBanditEnv"),
                    "bandit"),
}


def not_ported(name: str, module: str) -> NotPortedError:
    return NotPortedError(f"rllib {name} (ROADMAP item 12)",
                          f"ray_tpu/rllib/algorithms/{module}.py")


def _load() -> Dict[str, Tuple[type, Callable]]:
    from ray_tpu_torch.rllib.algorithms.bc import BC, BCConfig
    from ray_tpu_torch.rllib.algorithms.cql import CQL, CQLConfig
    from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
    from ray_tpu_torch.rllib.algorithms.impala import APPO, APPOConfig, IMPALA, IMPALAConfig
    from ray_tpu_torch.rllib.algorithms.marwil import MARWIL, MARWILConfig
    from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
    from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig

    return {
        "PPO": (PPO, PPOConfig),
        "APPO": (APPO, APPOConfig),
        "IMPALA": (IMPALA, IMPALAConfig),
        "DQN": (DQN, DQNConfig),
        "SAC": (SAC, SACConfig),
        "BC": (BC, BCConfig),
        "MARWIL": (MARWIL, MARWILConfig),
        "CQL": (CQL, CQLConfig),
        **{name: None for name in NOT_PORTED},
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
            if entry is None:
                raise not_ported(k, NOT_PORTED[k])
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
