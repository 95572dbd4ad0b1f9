"""Offline data: record, persist, and load experience for offline RL.

Parity: ``rllib/offline/`` (JsonWriter/JsonReader, dataset-backed offline
inputs). Storage here is columnar ``.npz`` (numpy's zero-copy container) —
the natural host format for minibatches moved to the device,
and the same files in both packages — plus helpers to record a
dataset from a trained policy's rollouts and to attach monte-carlo RETURNS
for MARWIL/BC.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from ray_tpu_torch.rllib.sample_batch import SampleBatch


def save_batch(batch: SampleBatch, path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **batch.as_numpy())
    # np.savez appends .npz when absent; return the real on-disk path
    return path if path.endswith(".npz") else path + ".npz"


def load_batch(path: str) -> SampleBatch:
    with np.load(path) as data:
        return SampleBatch({k: data[k] for k in data.files})


def with_montecarlo_returns(batch: SampleBatch, gamma: float) -> SampleBatch:
    """Append RETURNS computed by a reverse pass over time-major [T, B]
    columns (bootstrap 0 at both terminals and rollout end — offline files
    can't look past their horizon)."""
    rewards = np.asarray(batch[SampleBatch.REWARDS], np.float32)
    dones = np.asarray(batch[SampleBatch.DONES], bool)
    returns = np.zeros_like(rewards)
    acc = np.zeros(rewards.shape[1:], np.float32)
    for t in range(rewards.shape[0] - 1, -1, -1):
        acc = rewards[t] + gamma * acc * (~dones[t])
        returns[t] = acc
    out = SampleBatch(dict(batch))
    out[SampleBatch.RETURNS] = returns
    return out


def flatten_time_major(batch: SampleBatch) -> SampleBatch:
    """[T, B, ...] -> [T*B, ...] for uniform-sampling offline consumers."""
    return SampleBatch(
        {k: np.asarray(v).reshape((-1,) + np.shape(v)[2:]) for k, v in batch.items()}
    )


def record_rollouts(
    env,
    module,
    params,
    *,
    policy: str = "actor_critic",
    num_iterations: int = 10,
    num_envs: int = 8,
    rollout_length: int = 128,
    gamma: float = 0.99,
    seed: int = 0,
    device=None,
) -> SampleBatch:
    """Roll a policy and produce a flat offline dataset with OBS/ACTIONS/
    REWARDS/NEXT_OBS/DONES/RETURNS columns (JsonWriter-recording parity).
    The policy runs on ``device`` (CUDA unless given the CPU)."""
    from ray_tpu_torch.rllib.env_runner import EnvRunner

    runner = EnvRunner(
        env,
        module,
        policy=policy,
        num_envs=num_envs,
        rollout_length=rollout_length,
        seed=seed,
        device=device,
    )
    parts: List[SampleBatch] = []
    for _ in range(num_iterations):
        batch, _final_obs, _eps = runner.sample(params)
        batch = SampleBatch({k: np.asarray(v) for k, v in batch.items()})
        batch[SampleBatch.DONES] = np.asarray(batch[SampleBatch.DONES]) | np.asarray(
            batch[SampleBatch.TRUNCATEDS]
        )
        parts.append(flatten_time_major(with_montecarlo_returns(batch, gamma)))
    return SampleBatch.concat_samples(parts)
