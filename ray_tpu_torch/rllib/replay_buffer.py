"""Replay buffer for off-policy algorithms.

Parity: `rllib/utils/replay_buffers/` (EpisodeReplayBuffer et al.) — a
bounded FIFO transition store with uniform sampling. Host-side numpy ring
arrays; sampled minibatches move to the device in the learner.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ray_tpu_torch.rllib.sample_batch import SampleBatch


class ReplayBuffer:
    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self._store: Optional[dict] = None
        self._idx = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, batch: SampleBatch) -> None:
        batch = batch.as_numpy()
        n = len(batch)
        if self._store is None:
            self._store = {
                k: np.zeros((self.capacity,) + v.shape[1:], v.dtype)
                for k, v in batch.items()
            }
        for start in range(0, n, self.capacity):
            chunk = {k: v[start : start + self.capacity] for k, v in batch.items()}
            m = len(next(iter(chunk.values())))
            end = self._idx + m
            for k, v in chunk.items():
                if end <= self.capacity:
                    self._store[k][self._idx : end] = v
                else:
                    split = self.capacity - self._idx
                    self._store[k][self._idx :] = v[:split]
                    self._store[k][: end - self.capacity] = v[split:]
            self._idx = end % self.capacity
            self._size = min(self._size + m, self.capacity)

    def sample(self, batch_size: int) -> SampleBatch:
        idx = self._rng.integers(0, self._size, batch_size)
        return SampleBatch({k: v[idx] for k, v in self._store.items()})


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (parity:
    `rllib/utils/replay_buffers/prioritized_episode_buffer.py` and the Ape-X
    paper's P(i) ~ p_i^alpha with importance weights (N*P)^-beta).

    Priorities live in a flat numpy array alongside the ring store; sampling
    draws from the normalized priority distribution and returns IS weights
    (max-normalized) plus the sampled indices so the learner can write back
    fresh |TD| priorities after its update.
    """

    def __init__(self, capacity: int, seed: int = 0, alpha: float = 0.6, beta: float = 0.4):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self.beta = beta
        self._priorities = np.zeros((capacity,), np.float64)
        self._max_priority = 1.0

    def add(self, batch: SampleBatch) -> None:
        n = min(len(batch), self.capacity)
        start = self._idx
        super().add(batch)
        # new transitions get max priority so everything is sampled at
        # least once before TD errors demote it
        idx = (start + np.arange(n)) % self.capacity
        self._priorities[idx] = self._max_priority

    def sample(self, batch_size: int) -> SampleBatch:
        p = self._priorities[: self._size] ** self.alpha
        p = p / p.sum()
        idx = self._rng.choice(self._size, batch_size, p=p)
        weights = (self._size * p[idx]) ** (-self.beta)
        weights = weights / weights.max()
        out = SampleBatch({k: v[idx] for k, v in self._store.items()})
        out["weights"] = weights.astype(np.float32)
        out.sampled_indices = idx
        return out

    def update_priorities(self, idx: np.ndarray, td_errors: np.ndarray) -> None:
        prio = np.abs(np.asarray(td_errors, np.float64)) + 1e-6
        self._priorities[idx] = prio
        self._max_priority = max(self._max_priority, float(prio.max()))
