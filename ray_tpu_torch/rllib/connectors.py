"""Connector pipelines: composable transforms between envs and modules.

Parity: the reference's new-API-stack connectors (``rllib/connectors/`` —
``ConnectorV2`` pieces chained into env-to-module and module-to-env
pipelines that own observation preprocessing, frame stacking, action
clipping/unsquashing etc., so RLModules stay pure).

Connectors here are plain functions over tensors, run by the runner on the
device inside its step loop. Stateless by construction, as in the JAX
package: stateful pieces (frame stacking) would need a slot in the
runner's per-env state, which it does not thread yet, so none ship.
"""

from __future__ import annotations

from typing import Sequence

import torch


class Connector:
    """One transform. Subclasses implement __call__(data) -> data."""

    def __call__(self, data):
        raise NotImplementedError


class ConnectorPipeline(Connector):
    """Composition (parity: ConnectorPipelineV2). Applies pieces in order."""

    def __init__(self, connectors: Sequence[Connector]):
        self.connectors = list(connectors)

    def __call__(self, data):
        for c in self.connectors:
            data = c(data)
        return data

    def prepend(self, connector: Connector) -> "ConnectorPipeline":
        return ConnectorPipeline([connector] + self.connectors)

    def append(self, connector: Connector) -> "ConnectorPipeline":
        return ConnectorPipeline(self.connectors + [connector])


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


# ----------------------------------------------------------- env-to-module
class NormalizeObs(Connector):
    """Running-stats-free normalization: (obs - mean) / std with fixed
    stats (computed offline or from env specs), as in the JAX package."""

    def __init__(self, mean, std):
        self.mean = _f32(mean)
        self.std = _f32(std)

    def __call__(self, obs):
        mean, std = self.mean.to(obs.device), self.std.to(obs.device)
        return (obs - mean) / torch.clamp(std, min=1e-6)


class ClipObs(Connector):
    def __init__(self, low: float, high: float):
        self.low = low
        self.high = high

    def __call__(self, obs):
        return torch.clamp(obs, self.low, self.high)


class FlattenObs(Connector):
    """Flatten trailing observation dims to a vector (keeps batch dims)."""

    def __init__(self, batch_dims: int = 1):
        self.batch_dims = batch_dims

    def __call__(self, obs):
        lead = obs.shape[: self.batch_dims]
        return obs.reshape(*lead, -1)


class CastObs(Connector):
    """Cast observations to a torch dtype."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        self.dtype = dtype

    def __call__(self, obs):
        return obs.to(self.dtype)


# ----------------------------------------------------------- module-to-env
class ClipActions(Connector):
    """Clip continuous actions to bounds (parity: clip_actions piece)."""

    def __init__(self, low, high):
        self.low = _f32(low)
        self.high = _f32(high)

    def __call__(self, action):
        low, high = self.low.to(action.device), self.high.to(action.device)
        return torch.minimum(torch.maximum(action, low), high)


class UnsquashActions(Connector):
    """Map tanh-squashed [-1, 1] module outputs into env bounds (parity:
    unsquash_actions piece)."""

    def __init__(self, low, high):
        self.low = _f32(low)
        self.high = _f32(high)

    def __call__(self, action):
        low, high = self.low.to(action.device), self.high.to(action.device)
        return low + (torch.tanh(action) + 1.0) * 0.5 * (high - low)


def env_to_module(*connectors: Connector) -> ConnectorPipeline:
    return ConnectorPipeline(list(connectors))


def module_to_env(*connectors: Connector) -> ConnectorPipeline:
    return ConnectorPipeline(list(connectors))
