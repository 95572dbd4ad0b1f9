"""SampleBatch: columnar batch of experience.

Parity: `rllib/policy/sample_batch.py` (SampleBatch dict-of-arrays with the
standard column names, concat, shuffled minibatching). Columns are numpy
arrays on the host, as in the JAX package: rollouts hand them to the
learners at this boundary, which moves each minibatch to the device.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np


class SampleBatch(dict):
    OBS = "obs"
    NEXT_OBS = "next_obs"
    ACTIONS = "actions"
    REWARDS = "rewards"
    DONES = "dones"  # true environment terminals only
    TRUNCATEDS = "truncateds"  # time-limit cuts: bootstrap, don't zero
    LOGP = "logp"
    VALUES = "values"
    ADVANTAGES = "advantages"
    RETURNS = "returns"

    def __len__(self) -> int:
        for v in self.values():
            return int(np.shape(v)[0])
        return 0

    @property
    def count(self) -> int:
        return len(self)

    @staticmethod
    def concat_samples(batches: List["SampleBatch"]) -> "SampleBatch":
        if not batches:
            return SampleBatch()
        keys = batches[0].keys()
        return SampleBatch(
            {k: np.concatenate([np.asarray(b[k]) for b in batches]) for k in keys}
        )

    def shuffle(self, rng: np.random.Generator) -> "SampleBatch":
        perm = rng.permutation(len(self))
        return SampleBatch({k: np.asarray(v)[perm] for k, v in self.items()})

    def minibatches(self, size: int, rng: np.random.Generator) -> Iterator["SampleBatch"]:
        shuffled = self.shuffle(rng)
        n = len(self)
        for start in range(0, n - size + 1, size):
            yield SampleBatch({k: v[start : start + size] for k, v in shuffled.items()})

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({k: np.asarray(v)[start:end] for k, v in self.items()})

    def as_numpy(self) -> "SampleBatch":
        return SampleBatch({k: np.asarray(v) for k, v in self.items()})

    def stats(self) -> Dict[str, float]:
        out = {}
        if self.REWARDS in self:
            out["reward_mean"] = float(np.mean(np.asarray(self[self.REWARDS])))
        out["count"] = len(self)
        return out
