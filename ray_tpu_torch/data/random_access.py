"""Random-access serving of a sorted Dataset from a pool of actors.

Parity: ``python/ray/data/random_access_dataset.py`` — sort the dataset by
a key column, spread the sorted blocks across N serving actors, and answer
point lookups (`get_async`) / batched lookups (`multiget`) by binary
search: first over the per-block key ranges to find the block, then inside
the block.  TPU-first note: blocks stay as dict-of-numpy columns, so a
lookup is one `searchsorted` + one row gather — no per-row objects exist
until a row is actually returned.

The port's copy of ``ray_tpu/data/random_access.py``: the same behaviour, imports
renamed to ``ray_tpu_torch``.
"""

from __future__ import annotations

import bisect
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import BlockAccessor


@ray_tpu_torch.remote(num_cpus=0)
class _BlockServer:
    """Holds a contiguous run of sorted blocks and serves point lookups.

    num_cpus=0 (reference parity: random_access_dataset.py spawns
    zero-CPU serving actors) — lookup serving is lightweight and the pool
    must not starve the cluster's task slots: N workers on an N-CPU
    runtime would otherwise deadlock every later pipeline."""

    def __init__(self, key: str, block_refs: List[Any]):
        # the ACTOR fetches its chunk — blocks never transit the driver
        self._key = key
        self._blocks = ray_tpu_torch.get(list(block_refs))
        # per-block sorted key arrays (the sort already ordered them)
        self._keys = [np.asarray(b[key]) for b in self._blocks]
        self._lookups = 0

    def get(self, block_index: int, key_value) -> Optional[Dict[str, Any]]:
        self._lookups += 1
        keys = self._keys[block_index]
        i = int(np.searchsorted(keys, key_value))
        if i < len(keys) and keys[i] == key_value:
            return BlockAccessor(self._blocks[block_index]).row(i)
        return None

    def multiget(self, block_indices: List[int], key_values: List[Any]) -> List[Optional[dict]]:
        self._lookups += len(key_values)
        out = []
        for bi, kv in zip(block_indices, key_values):
            keys = self._keys[bi]
            i = int(np.searchsorted(keys, kv))
            out.append(
                BlockAccessor(self._blocks[bi]).row(i)
                if i < len(keys) and keys[i] == kv
                else None
            )
        return out

    def stats(self) -> dict:
        return {"blocks": len(self._blocks), "lookups": self._lookups}


class RandomAccessDataset:
    """Created via ``Dataset.to_random_access_dataset(key)``."""

    def __init__(self, ds, key: str, *, num_workers: int = 4):
        sorted_mat = ds.sort(key).materialize()

        # driver fetches only (first_key, num_rows) per block; the raw
        # blocks go to the serving actors BY REFERENCE (a 20 GiB dataset
        # must not transit — let alone peak in — driver memory)
        @ray_tpu_torch.remote
        def block_head(block):
            keys = np.asarray(block.get(key, ()))
            return (keys[0] if len(keys) else None, len(keys))

        heads = ray_tpu_torch.get([block_head.remote(r) for r in sorted_mat._refs])
        refs_and_keys = [
            (ref, first) for ref, (first, n) in zip(sorted_mat._refs, heads) if n > 0
        ]
        if not refs_and_keys:
            raise ValueError("cannot build a random-access view of an empty dataset")
        self._key = key
        # block boundary table: first key of each block (blocks are globally
        # sorted, so block lookup is one bisect over these)
        self._first_keys = [first for _ref, first in refs_and_keys]
        # assign contiguous runs of blocks to workers
        num_workers = max(1, min(num_workers, len(refs_and_keys)))
        per = (len(refs_and_keys) + num_workers - 1) // num_workers
        self._assignments: List[tuple] = []  # global block idx -> (worker idx, local idx)
        self._workers = []
        for w in range(num_workers):
            chunk = refs_and_keys[w * per : (w + 1) * per]
            if not chunk:
                break
            self._workers.append(_BlockServer.remote(key, [r for r, _k in chunk]))
            for local, _ in enumerate(chunk):
                self._assignments.append((len(self._workers) - 1, local))

    def _locate(self, key_value) -> tuple:
        # rightmost block whose first key <= key_value
        i = bisect.bisect_right(self._first_keys, key_value) - 1
        return self._assignments[max(0, i)]

    def get_async(self, key_value):
        """ObjectRef of the matching row dict (None when absent)."""
        w, local = self._locate(key_value)
        return self._workers[w].get.remote(local, key_value)

    def multiget(self, key_values: List[Any]) -> List[Optional[dict]]:
        """Batched lookup: one RPC per worker, results in input order."""
        per_worker: Dict[int, List[tuple]] = {}
        for pos, kv in enumerate(key_values):
            w, local = self._locate(kv)
            per_worker.setdefault(w, []).append((pos, local, kv))
        results: List[Optional[dict]] = [None] * len(key_values)
        futs = []
        for w, items in per_worker.items():
            futs.append(
                (items, self._workers[w].multiget.remote(
                    [local for _pos, local, _kv in items],
                    [kv for _pos, _local, kv in items],
                ))
            )
        for items, fut in futs:
            for (pos, _local, _kv), row in zip(items, ray_tpu_torch.get(fut)):
                results[pos] = row
        return results

    def stats(self) -> str:
        parts = ray_tpu_torch.get([w.stats.remote() for w in self._workers])
        lines = [f"RandomAccessDataset(key={self._key!r}, workers={len(self._workers)})"]
        for i, s in enumerate(parts):
            lines.append(f"  worker {i}: {s['blocks']} blocks, {s['lookups']} lookups")
        return "\n".join(lines)
