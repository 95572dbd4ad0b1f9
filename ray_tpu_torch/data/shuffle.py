"""All-to-all exchange: sort / hash groupby / random shuffle / repartition.

Parity: ``python/ray/data/_internal/planner/exchange/``.  Two strategies,
toggled by ``DataContext.use_push_based_shuffle`` (reference toggle:
``python/ray/data/context.py:241``):

  * **push-based (default)** — the Exoshuffle scheduler
    (``push_based_shuffle_task_scheduler.py:400``): map tasks run in rounds
    whose outputs push into a bounded set of merge tasks that pre-combine
    partition slices while later rounds still map; the final reduce combines
    one merged partial per round.  See :func:`_run_push_exchange`.
  * **pull-based fallback** — the simple two-stage exchange: every map task
    partitions its block into N slices (``num_returns=N``); each reduce task
    pulls slice j from every map task and finalizes (sort-merge, aggregate,
    or concat).

The port's copy of ``ray_tpu/data/shuffle.py``: the same behaviour, imports
renamed to ``ray_tpu_torch``.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor, concat_blocks, _sortable


# ---------------------------------------------------------------- map stage
def _partition_for_sort(block: Block, key, descending: bool, boundaries: List[Any]) -> List[Block]:
    acc = BlockAccessor(block)
    n_parts = len(boundaries) + 1
    if acc.num_rows() == 0:
        return [{} for _ in range(n_parts)]
    first_key = key if isinstance(key, str) else key[0]
    col = _sortable(block[first_key])
    idx = np.searchsorted(np.asarray(boundaries), col, side="right")
    if descending:
        idx = (n_parts - 1) - idx
    return [acc.take(np.nonzero(idx == p)[0]) for p in range(n_parts)]


def _stable_key_hash(v: Any) -> int:
    """Deterministic 64-bit hash of one partition-key value.

    Python's ``hash()`` is salted per process (PYTHONHASHSEED), so two map
    tasks in different worker processes could send the SAME string key to
    DIFFERENT reduce partitions — a groupby/repartition correctness bug,
    not just a repro nit. blake2b over a type-tagged encoding is identical
    everywhere. Numeric values hash by VALUE like Python dict keys
    (``2 == 2.0 == True`` land in one partition)."""
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, bool):
        v = int(v)
    elif isinstance(v, float) and v.is_integer():
        v = int(v)
    if isinstance(v, str):
        tag, payload = b"s", v.encode("utf-8", "surrogatepass")
    elif isinstance(v, bytes):
        tag, payload = b"b", v
    elif isinstance(v, int):
        tag, payload = b"i", str(v).encode()
    elif isinstance(v, float):
        tag, payload = b"f", repr(v).encode()
    elif v is None:
        tag, payload = b"n", b""
    else:
        tag, payload = b"o", repr(v).encode()
    return int.from_bytes(hashlib.blake2b(tag + payload, digest_size=8).digest(), "big")


def _partition_by_hash(block: Block, key: str, n_parts: int) -> List[Block]:
    acc = BlockAccessor(block)
    if acc.num_rows() == 0:
        return [{} for _ in range(n_parts)]
    col = block[key]
    hashes = np.asarray([_stable_key_hash(v) % n_parts for v in col])
    return [acc.take(np.nonzero(hashes == p)[0]) for p in range(n_parts)]


def _partition_random(block: Block, n_parts: int, seed: Optional[int]) -> List[Block]:
    acc = BlockAccessor(block)
    n = acc.num_rows()
    if n == 0:
        return [{} for _ in range(n_parts)]
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, n_parts, size=n)
    return [acc.take(np.nonzero(assign == p)[0]) for p in range(n_parts)]


def _partition_round_robin(block: Block, n_parts: int, offset: int) -> List[Block]:
    acc = BlockAccessor(block)
    n = acc.num_rows()
    if n == 0:
        return [{} for _ in range(n_parts)]
    assign = (np.arange(n) + offset) % n_parts
    return [acc.take(np.nonzero(assign == p)[0]) for p in range(n_parts)]


# ------------------------------------------------------------- reduce stage
def _reduce_concat(*parts: Block) -> Block:
    return concat_blocks(list(parts))


def _reduce_sorted(key, descending: bool, *parts: Block) -> Block:
    merged = concat_blocks(list(parts))
    if not merged:
        return merged
    return BlockAccessor(merged).sort(key, descending)


def _reduce_aggregate(key: Optional[str], aggs, *parts: Block) -> Block:
    from ray_tpu_torch.data.block import block_from_rows

    merged = concat_blocks(list(parts))
    if not merged:
        return {}
    acc = BlockAccessor(merged)
    if key is None:
        row = {a.name: a.finalize(a.accumulate_block(a.init(), merged)) for a in aggs}
        return block_from_rows([row])
    order = acc.sort_indices(key)
    sorted_block = acc.take(order)
    col = sorted_block[key]
    # group boundaries in the sorted key column
    keys_sortable = _sortable(col)
    change = np.nonzero(keys_sortable[1:] != keys_sortable[:-1])[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(col)]])
    sacc = BlockAccessor(sorted_block)
    rows = []
    for s, e in zip(starts, ends):
        group = sacc.slice(int(s), int(e))
        row = {key: sorted_block[key][s].item() if isinstance(sorted_block[key][s], np.generic) else sorted_block[key][s]}
        for a in aggs:
            row[a.name] = a.finalize(a.accumulate_block(a.init(), group))
        rows.append(row)
    return block_from_rows(rows)


# --------------------------------------------------------------- boundaries
def sample_sort_boundaries(blocks: List[Block], key, n_parts: int) -> List[Any]:
    """Sample input blocks to pick quantile boundaries for a range partition
    (parity: exchange/sort_task_spec.py sample_boundaries)."""
    first_key = key if isinstance(key, str) else key[0]
    samples = []
    for b in blocks:
        if b and len(b.get(first_key, ())):
            col = _sortable(b[first_key])
            k = min(len(col), 20)
            samples.append(np.random.default_rng(0).choice(col, size=k, replace=False))
    if not samples:
        return []
    allv = np.sort(np.concatenate(samples))
    qs = [allv[int(i * len(allv) / n_parts)] for i in range(1, n_parts)]
    return list(qs)


# ----------------------------------------------------- push-based scheduling
class PushShuffleSchedule:
    """The round/merge structure of one push-based shuffle run (parity:
    ``_PushBasedShuffleStage`` in
    ``push_based_shuffle_task_scheduler.py:400``)."""

    def __init__(self, num_inputs: int, n_parts: int, maps_per_round: int, num_mergers: int):
        self.num_inputs = num_inputs
        self.n_parts = n_parts
        self.maps_per_round = maps_per_round
        self.num_rounds = -(-num_inputs // maps_per_round)
        self.num_mergers = num_mergers
        # contiguous partition ranges, one per merger
        base, extra = divmod(n_parts, num_mergers)
        self.merger_ranges: List[Tuple[int, int]] = []
        start = 0
        for j in range(num_mergers):
            size = base + (1 if j < extra else 0)
            self.merger_ranges.append((start, start + size))
            start += size

    def __repr__(self):
        return (
            f"PushShuffleSchedule(inputs={self.num_inputs}, parts={self.n_parts}, "
            f"rounds={self.num_rounds}x{self.maps_per_round} maps, "
            f"mergers={self.num_mergers})"
        )


#: Schedule of the most recent push-based exchange (test/diagnostic hook).
last_push_schedule: Optional[PushShuffleSchedule] = None


def _run_push_exchange(
    input_refs: List[Any],
    map_fn: Callable[[Block], List[Block]],
    reduce_fn: Callable[..., Block],
    n_parts: int,
) -> Tuple[List[Any], List[Any]]:
    """Pipelined push-based (Exoshuffle) exchange: map -> merge -> reduce.

    Parity with the reference's large-scale shuffle
    (``push_based_shuffle_task_scheduler.py:400``; Exoshuffle,
    ``README.rst:99``): map tasks run in rounds; each round's outputs are
    immediately pushed into a BOUNDED set of merge tasks (one per contiguous
    partition range) that pre-combine partials while later map rounds are
    still running; the final reduce per partition combines one merged
    partial per round instead of one slice per map task.  This caps the
    live-object count at O(rounds x parts + round_size x parts) instead of
    O(maps x parts) and overlaps map/merge — the property that makes 100
    GB-class sorts feasible (BASELINE.md target #3).

    Submission here is async end-to-end: because the fabric resolves
    dependencies through object refs, round r's merges run while round r+1's
    maps execute — the pipelining falls out of ref-based dataflow with no
    bespoke scheduler loop."""
    global last_push_schedule
    import ray_tpu_torch

    M = len(input_refs)
    ctx = _data_context()
    try:
        cpus = max(1, int(ray_tpu_torch.cluster_resources().get("CPU", 2)))
    except Exception:  # noqa: BLE001
        cpus = 2
    maps_per_round = max(2, min(ctx.max_tasks_in_flight, cpus * 2))
    num_mergers = max(1, min(n_parts, cpus))
    sched = PushShuffleSchedule(M, n_parts, maps_per_round, num_mergers)
    last_push_schedule = sched

    @ray_tpu_torch.remote
    def push_map(block: Block):
        parts = map_fn(block)
        return parts[0] if len(parts) == 1 else tuple(parts)

    @ray_tpu_torch.remote
    def push_merge(n_slices: int, *parts: Block):
        """Pre-combine this merger's partition slices across one round's
        maps. parts layout: [map0_slice0..map0_sliceK, map1_slice0..]."""
        merged = []
        for s in range(n_slices):
            merged.append(concat_blocks([parts[m * n_slices + s] for m in range(len(parts) // n_slices)]))
        return merged[0] if n_slices == 1 else tuple(merged)

    @ray_tpu_torch.remote
    def push_reduce(*parts: Block):
        out = reduce_fn(*parts)
        meta = BlockAccessor(out).get_metadata()
        return out, meta

    # merge_out[r][j] -> list of per-slice refs for merger j in round r
    merge_out: List[List[List[Any]]] = []
    for r in range(sched.num_rounds):
        round_inputs = input_refs[r * maps_per_round : (r + 1) * maps_per_round]
        round_maps = []
        for ref in round_inputs:
            refs = push_map.options(num_returns=n_parts).remote(ref)
            if n_parts == 1:
                refs = [refs]
            round_maps.append(refs)
        round_merges: List[List[Any]] = []
        for j, (lo, hi) in enumerate(sched.merger_ranges):
            n_slices = hi - lo
            if n_slices == 0:
                round_merges.append([])
                continue
            args = [m[p] for m in round_maps for p in range(lo, hi)]
            out = push_merge.options(num_returns=n_slices).remote(n_slices, *args)
            if n_slices == 1:
                out = [out]
            round_merges.append(list(out))
        merge_out.append(round_merges)

    out_refs, meta_refs = [], []
    for j, (lo, hi) in enumerate(sched.merger_ranges):
        for o in range(hi - lo):
            parts = [merge_out[r][j][o] for r in range(sched.num_rounds)]
            block_ref, meta_ref = push_reduce.options(num_returns=2).remote(*parts)
            out_refs.append(block_ref)
            meta_refs.append(meta_ref)
    metas = ray_tpu_torch.get(meta_refs)
    return out_refs, metas


def _data_context():
    from ray_tpu_torch.data.context import DataContext

    return DataContext.get_current()


# ---------------------------------------------------------------- the driver
def run_exchange(
    input_refs: List[Any],
    *,
    kind: str,
    n_parts: int,
    key=None,
    descending: bool = False,
    aggs=None,
    seed: Optional[int] = None,
) -> Tuple[List[Any], List[Any]]:
    """Run the two-stage exchange; returns (output_refs, output_metadata).

    kind: "sort" | "groupby" | "shuffle" | "repartition"
    """
    n_parts = max(1, n_parts)

    if kind == "sort":
        sampled = ray_tpu_torch.get(input_refs[: min(len(input_refs), 8)])
        boundaries = sample_sort_boundaries(sampled, key, n_parts)
        n_parts = len(boundaries) + 1
        map_fn = lambda b: _partition_for_sort(b, key, descending, boundaries)
        reduce_fn = lambda *parts: _reduce_sorted(key, descending, *parts)
    elif kind == "groupby":
        if key is None:
            n_parts = 1
            map_fn = lambda b: [b]
        else:
            map_fn = lambda b: _partition_by_hash(b, key, n_parts)
        reduce_fn = lambda *parts: _reduce_aggregate(key, aggs, *parts)
        if key is not None:
            # keep reduced partitions globally sorted by key for determinism
            pass
    elif kind == "shuffle":
        map_fn = lambda b: _partition_random(b, n_parts, seed)
        reduce_fn = _reduce_concat
    elif kind == "repartition":
        map_fn = lambda b: _partition_round_robin(b, n_parts, 0)
        reduce_fn = _reduce_concat
    else:  # pragma: no cover
        raise ValueError(kind)

    if _data_context().use_push_based_shuffle and len(input_refs) > 1:
        return _run_push_exchange(input_refs, map_fn, reduce_fn, n_parts)

    @ray_tpu_torch.remote
    def exchange_map(block: Block):
        parts = map_fn(block)
        if len(parts) == 1:
            return parts[0]
        return tuple(parts)

    @ray_tpu_torch.remote
    def exchange_reduce(*parts: Block):
        out = reduce_fn(*parts)
        meta = BlockAccessor(out).get_metadata()
        return out, meta

    map_out: List[List[Any]] = []
    for ref in input_refs:
        refs = exchange_map.options(num_returns=n_parts).remote(ref)
        if n_parts == 1:
            refs = [refs]
        map_out.append(refs)

    out_refs, meta_refs = [], []
    for p in range(n_parts):
        block_ref, meta_ref = exchange_reduce.options(num_returns=2).remote(
            *[map_out[m][p] for m in range(len(input_refs))]
        )
        out_refs.append(block_ref)
        meta_refs.append(meta_ref)
    metas = ray_tpu_torch.get(meta_refs)
    return out_refs, metas
