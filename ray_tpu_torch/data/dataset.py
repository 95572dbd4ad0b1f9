"""Dataset: the lazy distributed dataset API.

Parity: ``python/ray/data/dataset.py`` (the 5.2k-LoC public class) — lazy
logical-plan accumulation, streaming execution on consumption, the full
transform surface (map/map_batches/filter/flat_map/sort/groupby/
repartition/random_shuffle/union/zip/limit), consumption
(take/count/show/iter_*), split/streaming_split, and write connectors.

The port's copy of ``ray_tpu/data/dataset.py``: the same surface and
results. ``map`` and ``map_batches`` also take ``num_gpus`` (a stage that
asks for a GPU runs next to the card: ``executor.py``), ``iter_device_batches``
stands beside ``iter_jax_batches`` (which raises ``NotPortedError``), and
``streaming_split``'s producer thread stops at ``ray_tpu_torch.shutdown``.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import logical as L
from ray_tpu_torch.data.aggregate import AggregateFn, Count, Max, Mean, Min, Std, Sum, Unique
from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata, concat_blocks
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.executor import RefBundle, StreamingExecutor, plan
from ray_tpu_torch.data.iterator import DataIterator


class Dataset:
    def __init__(self, logical_op: L.LogicalOp):
        self._logical_op = logical_op
        self._last_stats = None

    # ------------------------------------------------------------ plumbing
    def _with(self, op: L.LogicalOp) -> "Dataset":
        return Dataset(op)

    def _execute(self, preserve_order: Optional[bool] = None) -> Iterator[RefBundle]:
        """``preserve_order=True`` forces dispatch-order output release for
        THIS execution regardless of the context default — row-positional
        consumers (``take``/``take_all``) need it: without it parallel map
        tasks finishing out of order make ``take(1)`` return an arbitrary
        block's rows (a long-standing flake; blocks completed in order only
        by timing luck)."""
        ctx = DataContext.get_current()
        restore = None
        if preserve_order is not None and ctx.preserve_order != preserve_order:
            restore = ctx.preserve_order
            ctx.preserve_order = preserve_order
        try:
            optimized = L.optimize(_clone_plan(self._logical_op))
            root = plan(optimized, ctx)
            executor = StreamingExecutor(root, ctx)
        finally:
            # operators capture the flag at construction: the context can
            # restore as soon as the physical plan exists
            if restore is not None:
                ctx.preserve_order = restore
        try:
            yield from executor.run()
        finally:
            self._last_stats = executor.stats()
            # observable beyond this handle: the dashboard's Data panel
            # lists recent executions (reference: Data dashboard module)
            from ray_tpu_torch.data.executor import record_execution

            record_execution(L.plan_to_string(optimized).split("\n")[0], self._last_stats)

    def _collect_bundles(self) -> List[RefBundle]:
        return list(self._execute())

    # ---------------------------------------------------------- transforms
    def map(self, fn: Callable, *, num_cpus: float = 1, num_tpus: float = 0, num_gpus: float = 0,
            concurrency=None, **kw) -> "Dataset":
        return self._with(
            L.AbstractMap(self._logical_op, "map_rows", fn, num_cpus=num_cpus, num_tpus=num_tpus,
                          num_gpus=num_gpus, concurrency=concurrency)
        )

    def map_batches(
        self,
        fn: Callable,
        *,
        batch_size: Optional[int] = None,
        batch_format: str = "numpy",
        compute=None,
        fn_args: tuple = (),
        fn_kwargs: Optional[dict] = None,
        fn_constructor_args: tuple = (),
        fn_constructor_kwargs: Optional[dict] = None,
        num_cpus: float = 1,
        num_tpus: float = 0,
        num_gpus: float = 0,
        concurrency=None,
        **kw,
    ) -> "Dataset":
        return self._with(
            L.AbstractMap(
                self._logical_op,
                "map_batches",
                fn,
                fn_args=fn_args,
                fn_kwargs=fn_kwargs,
                batch_size=batch_size,
                batch_format=batch_format,
                compute=compute,
                num_cpus=num_cpus,
                num_tpus=num_tpus,
                num_gpus=num_gpus,
                concurrency=concurrency,
                fn_constructor_args=fn_constructor_args,
                fn_constructor_kwargs=fn_constructor_kwargs,
            )
        )

    def filter(self, fn: Callable) -> "Dataset":
        return self._with(L.AbstractMap(self._logical_op, "filter", fn))

    def flat_map(self, fn: Callable) -> "Dataset":
        return self._with(L.AbstractMap(self._logical_op, "flat_map", fn))

    def add_column(self, name: str, fn: Callable[[Dict[str, np.ndarray]], np.ndarray]) -> "Dataset":
        def add(batch):
            batch[name] = np.asarray(fn(batch))
            return batch

        add.__name__ = f"add_column[{name}]"
        return self.map_batches(add)

    def drop_columns(self, cols: List[str]) -> "Dataset":
        def drop(batch):
            return {k: v for k, v in batch.items() if k not in cols}

        drop.__name__ = f"drop_columns[{cols}]"
        return self.map_batches(drop)

    def select_columns(self, cols: List[str]) -> "Dataset":
        def select(batch):
            return {k: batch[k] for k in cols}

        select.__name__ = f"select_columns[{cols}]"
        return self.map_batches(select)

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        def rename(batch):
            return {mapping.get(k, k): v for k, v in batch.items()}

        rename.__name__ = "rename_columns"
        return self.map_batches(rename)

    def limit(self, n: int) -> "Dataset":
        return self._with(L.Limit(self._logical_op, n))

    def repartition(self, num_blocks: int, *, shuffle: bool = False) -> "Dataset":
        return self._with(L.Repartition(self._logical_op, num_blocks, shuffle))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        return self._with(L.RandomShuffle(self._logical_op, seed))

    def sort(self, key: Union[str, List[str]], descending: bool = False) -> "Dataset":
        return self._with(L.Sort(self._logical_op, key, descending))

    def union(self, *others: "Dataset") -> "Dataset":
        return self._with(L.Union([self._logical_op] + [o._logical_op for o in others]))

    def zip(self, other: "Dataset") -> "Dataset":
        return self._with(L.Zip(self._logical_op, other._logical_op))

    def groupby(self, key: Optional[str]) -> "GroupedData":
        return GroupedData(self, key)

    # --------------------------------------------------------- consumption
    def take(self, limit: int = 20) -> List[Dict[str, Any]]:
        rows: List[Dict[str, Any]] = []
        # row-positional by definition: "the first N rows" only means
        # something in dispatch order (see _execute docstring)
        for bundle in self.limit(limit)._execute(preserve_order=True):
            for ref in bundle.refs:
                block = ray_tpu_torch.get(ref)
                rows.extend(BlockAccessor(block).iter_rows())
                if len(rows) >= limit:
                    return rows[:limit]
        return rows[:limit]

    def take_all(self) -> List[Dict[str, Any]]:
        rows: List[Dict[str, Any]] = []
        for bundle in self._execute(preserve_order=True):
            for ref in bundle.refs:
                rows.extend(BlockAccessor(ray_tpu_torch.get(ref)).iter_rows())
        return rows

    def take_batch(self, batch_size: int = 20, *, batch_format: str = "numpy") -> Any:
        it = self.iterator().iter_batches(batch_size=batch_size, batch_format=batch_format)
        try:
            return next(it)
        except StopIteration:
            return {}

    def count(self) -> int:
        total = 0
        for bundle in self._execute():
            total += bundle.num_rows()
        return total

    def show(self, limit: int = 20) -> None:
        for row in self.take(limit):
            print(row)

    def schema(self) -> Optional["Schema"]:
        from ray_tpu_torch.data.compute import Schema

        for bundle in self.limit(1)._execute():
            for ref, meta in zip(bundle.refs, bundle.metadata):
                if meta.schema:
                    return Schema(meta.schema)
                block = ray_tpu_torch.get(ref)
                s = BlockAccessor(block).schema()
                return Schema(s) if s is not None else None
        return None

    def columns(self) -> Optional[List[str]]:
        s = self.schema()
        return list(s) if s else None

    def unique(self, column: str) -> List[Any]:
        res = self.groupby(None).aggregate(Unique(column)).take_all()
        if not res:
            return []
        vals = res[0][f"unique({column})"]
        return [v.item() if isinstance(v, np.generic) else v for v in vals]

    def sum(self, on: str):
        return self._global_agg(Sum(on))

    def min(self, on: str):
        return self._global_agg(Min(on))

    def max(self, on: str):
        return self._global_agg(Max(on))

    def mean(self, on: str):
        return self._global_agg(Mean(on))

    def std(self, on: str):
        return self._global_agg(Std(on))

    def _global_agg(self, agg: AggregateFn):
        rows = self.groupby(None).aggregate(agg).take_all()
        return rows[0][agg.name] if rows else None

    def aggregate(self, *aggs: AggregateFn) -> Dict[str, Any]:
        rows = self.groupby(None).aggregate(*aggs).take_all()
        return rows[0] if rows else {}

    # ----------------------------------------------------------- iterators
    def iterator(self) -> DataIterator:
        return DataIterator(self._execute, owner=self)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        return self.iterator().iter_rows()

    def iter_batches(self, **kw) -> Iterator[Any]:
        return self.iterator().iter_batches(**kw)

    def iter_device_batches(self, **kw) -> Iterator[Dict[str, Any]]:
        return self.iterator().iter_device_batches(**kw)

    def iter_jax_batches(self, **kw) -> Iterator[Dict[str, Any]]:
        return self.iterator().iter_jax_batches(**kw)

    def iter_tf_batches(self, **kw) -> Iterator[Dict[str, Any]]:
        return self.iterator().iter_tf_batches(**kw)

    def to_tf(self, feature_columns, label_columns, **kw):
        return self.iterator().to_tf(feature_columns, label_columns, **kw)

    def iter_torch_batches(self, **kw) -> Iterator[Dict[str, Any]]:
        return self.iterator().iter_torch_batches(**kw)

    # --------------------------------------------------------------- split
    def split(self, n: int, *, locality_hints=None) -> List["MaterializedDataset"]:
        """Materialize and split into n even sub-datasets (parity: split()).

        ``locality_hints`` — one per split: actor handles (the consumer
        actors) or NodeIDs.  Blocks are assigned preferentially to the split
        whose hint node already stores them (parity:
        ``output_splitter.py`` locality_hints /
        ``split.py _split_at_indices`` locality), falling back to greedy
        row-balancing."""
        mat = self.materialize()
        refs = mat._refs
        metas = mat._metadata
        groups: List[List[Tuple[Any, BlockMetadata]]] = [[] for _ in range(n)]
        loads = [0] * n
        hint_nodes = _resolve_locality_hints(locality_hints, n)
        total_rows = sum(max(0, m.num_rows) for m in metas) or 1
        fair_share = 1.3 * total_rows / n
        for ref, meta in sorted(zip(refs, metas), key=lambda rm: -rm[1].num_rows):
            i = None
            if hint_nodes is not None:
                block_nodes = _block_locations(ref)
                # prefer a co-located, not-overloaded split
                candidates = [
                    j for j in range(n)
                    if hint_nodes[j] is not None and hint_nodes[j] in block_nodes
                    and loads[j] + meta.num_rows <= fair_share
                ]
                if candidates:
                    i = min(candidates, key=loads.__getitem__)
            if i is None:
                i = loads.index(min(loads))
            groups[i].append((ref, meta))
            loads[i] += meta.num_rows
        return [MaterializedDataset([r for r, _ in g], [m for _, m in g]) for g in groups]

    def streaming_split(
        self, n: int, *, equal: bool = True, locality_hints=None
    ) -> List[DataIterator]:
        """n coordinated iterators over one execution (parity:
        ``streaming_split`` + OutputSplitter,
        ``_internal/execution/operators/output_splitter.py:1``).  Driver-side
        implementation: one shared executor thread pushes bundles into n
        queues — round-robin when ``equal``; with ``locality_hints`` (one
        actor handle / NodeID per consumer, requires ``equal=False``) each
        bundle prefers the consumer whose node already stores it."""
        import queue as _q
        import threading

        from ray_tpu_torch.data.iterator import (
            _get_unless_stopped,
            _put_unless_stopped,
            _start_pump,
        )

        queues: List[_q.Queue] = [_q.Queue(maxsize=4) for _ in range(n)]
        SENTINEL = object()
        hint_nodes = None if equal else _resolve_locality_hints(locality_hints, n)
        stop = threading.Event()

        def pick_queue(ref, i: int) -> int:
            if hint_nodes is not None:
                block_nodes = _block_locations(ref)
                candidates = [
                    j for j in range(n)
                    if hint_nodes[j] is not None and hint_nodes[j] in block_nodes
                ]
                if candidates:
                    # least-backlogged co-located consumer
                    return min(candidates, key=lambda j: queues[j].qsize())
            return i % n

        def producer():
            i = 0
            for bundle in self._execute():
                for ref, meta in zip(bundle.refs, bundle.metadata):
                    if not _put_unless_stopped(queues[pick_queue(ref, i)],
                                               RefBundle([ref], [meta]), stop):
                        return  # stop_pumps: the runtime is going
                    i += 1
            for q in queues:
                _put_unless_stopped(q, SENTINEL, stop)

        _start_pump(producer, stop, "streaming-split")

        def make_iter(q):
            def gen():
                while True:
                    item = _get_unless_stopped(q, stop)
                    if item is SENTINEL:
                        return
                    yield item

            return DataIterator(gen)

        return [make_iter(q) for q in queues]

    def train_test_split(self, test_size: float, *, shuffle: bool = False, seed: Optional[int] = None):
        ds: Dataset = self.random_shuffle(seed=seed) if shuffle else self
        mat = ds.materialize()
        total = mat.count()
        n_test = int(total * test_size) if isinstance(test_size, float) else test_size
        rows = mat.take_all()
        from ray_tpu_torch.data.read_api import from_items

        return from_items(rows[: total - n_test]), from_items(rows[total - n_test :])

    # --------------------------------------------------------- materialize
    def materialize(self) -> "MaterializedDataset":
        refs, metas = [], []
        for bundle in self._execute():
            refs.extend(bundle.refs)
            metas.extend(bundle.metadata)
        return MaterializedDataset(refs, metas)

    def num_blocks(self) -> int:
        return self.materialize().num_blocks()

    def size_bytes(self) -> int:
        return sum(m.size_bytes for m in self.materialize()._metadata)

    # -------------------------------------------------------------- writes
    def write_csv(self, path: str, **kw) -> None:
        from ray_tpu_torch.data.datasource import CSVDatasource

        self._write(CSVDatasource([]), path, kw)

    def write_json(self, path: str, **kw) -> None:
        from ray_tpu_torch.data.datasource import JSONDatasource

        self._write(JSONDatasource([]), path, kw)

    def write_numpy(self, path: str, *, column: str = "data", **kw) -> None:
        from ray_tpu_torch.data.datasource import NumpyDatasource

        kw["column"] = column
        self._write(NumpyDatasource([]), path, kw)

    def write_parquet(self, path: str, **kw) -> None:
        from ray_tpu_torch.data.datasource import ParquetDatasource

        self._write(ParquetDatasource([]), path, kw)

    def write_tfrecords(self, path: str, **kw) -> None:
        from ray_tpu_torch.data.datasource import TFRecordDatasource

        self._write(TFRecordDatasource([]), path, kw)

    def write_delta(self, table_path: str, *, mode: str = "append") -> None:
        """Delta Lake commit (parquet part files + _delta_log JSON commit;
        mode: append | overwrite)."""
        from ray_tpu_torch.data.datasource_lakes import DeltaWriteDatasource

        self._write(DeltaWriteDatasource(mode), table_path, {})

    def write_lance(self, uri: str, *, mode: str = "create") -> None:
        """Lance dataset (requires the lance package)."""
        from ray_tpu_torch.data.datasource_lakes import LanceWriteDatasource

        self._write(LanceWriteDatasource(mode), uri, {})

    def write_sql(self, table: str, connection_factory, *, paramstyle: str = "qmark") -> None:
        """Insert all rows into a DB table via DB-API (parity: write_sql)."""
        from ray_tpu_torch.data.datasource import SQLDatasource

        self._write(
            SQLDatasource("", connection_factory), table, {"paramstyle": paramstyle}
        )

    def _write(self, datasource, path: str, kw: dict) -> None:
        sink = Dataset(L.Write(self._logical_op, datasource, path, kw))
        for _ in sink._execute():
            pass

    # --------------------------------------------------------------- misc
    def to_pandas(self):
        mat = self.materialize()
        blocks = [ray_tpu_torch.get(r) for r in mat._refs]
        merged = concat_blocks([b for b in blocks if b])
        return BlockAccessor(merged).to_pandas()

    # ------------------------------------------------- metadata (parity:
    # dataset.py context/copy/names/types/input_files)
    def context(self) -> DataContext:
        return DataContext.get_current()

    def copy(self) -> "Dataset":
        return Dataset(_clone_plan(self._logical_op))

    def names(self) -> Optional[List[str]]:
        return self.columns()

    def types(self) -> Optional[List[Any]]:
        s = self.schema()
        return list(s.values()) if s else None

    def input_files(self) -> List[str]:
        """Every file path feeding the plan's Read leaves."""
        files: List[str] = []

        def walk(op):
            for i in op.inputs:
                walk(i)
            if isinstance(op, L.Read):
                files.extend(getattr(op.datasource, "paths", []) or [])

        walk(self._logical_op)
        return files

    # ---------------------------------------------- sampling / block order
    def random_sample(self, fraction: float, *, seed: Optional[int] = None) -> "Dataset":
        """Keep each row independently with probability ``fraction``.  With a
        seed, the mask is derived from (seed, block contents) so re-running
        the plan reproduces the sample without coordinating block indices
        across tasks."""
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"fraction must be in [0, 1], got {fraction}")

        def sample(batch):
            import zlib

            n = len(next(iter(batch.values()))) if batch else 0
            if n == 0:
                return batch
            if seed is None:
                rng = np.random.default_rng()
            else:
                # crc32, not hash(): the fn runs in worker processes, where
                # Python's salted hash() differs per process and would break
                # the seeded-reproducibility contract on retries/re-runs.
                # The digest covers EVERY column's full bytes — a prefix of
                # the first column would give equal-size blocks sharing a
                # constant lead column the identical keep-mask (correlated,
                # non-uniform sampling)
                digest = seed ^ n
                for key in sorted(batch):
                    arr = np.ascontiguousarray(np.asarray(batch[key]))
                    if arr.dtype != object:
                        digest = zlib.crc32(arr.tobytes(), digest)
                    else:
                        # per-element: no monolithic repr of the whole
                        # column just to feed the checksum
                        for item in arr.flat:
                            digest = zlib.crc32(str(item).encode(), digest)
                rng = np.random.default_rng(digest & 0x7FFFFFFF)
            mask = rng.random(n) < fraction
            return {k: np.asarray(v)[mask] for k, v in batch.items()}

        sample.__name__ = f"random_sample[{fraction}]"
        return self.map_batches(sample)

    def randomize_block_order(self, *, seed: Optional[int] = None) -> "Dataset":
        """Shuffle WHOLE blocks (cheap coarse shuffle — no row movement).
        Executes the plan; the result is a materialized dataset with its
        block list permuted (parity: randomize_block_order)."""
        mat = self.materialize()
        order = np.random.default_rng(seed).permutation(len(mat._refs))
        return MaterializedDataset(
            [mat._refs[i] for i in order], [mat._metadata[i] for i in order]
        )

    # ------------------------------------------------------ indexed splits
    def split_at_indices(self, indices: List[int]) -> List["MaterializedDataset"]:
        """Split into len(indices)+1 datasets at the given GLOBAL row
        offsets (parity: split_at_indices; boundary blocks are sliced by a
        remote task, interior blocks move by reference)."""
        if any(i < 0 for i in indices) or list(indices) != sorted(indices):
            raise ValueError("indices must be non-negative and sorted")
        mat = self.materialize()

        @ray_tpu_torch.remote
        def slice_block(block, start: int, end: int):
            return BlockAccessor(block).slice(start, end)

        bounds = list(indices) + [None]  # None = rest
        out: List[MaterializedDataset] = []
        blocks = list(zip(mat._refs, mat._metadata))
        bi = 0            # current block index
        row_in_block = 0  # rows of blocks[bi] already consumed
        global_row = 0
        for bound in bounds:
            refs: List[Any] = []
            metas: List[BlockMetadata] = []
            while bi < len(blocks):
                ref, meta = blocks[bi]
                n = meta.num_rows
                remaining = n - row_in_block
                if bound is None or global_row + remaining <= bound:
                    # whole (rest of) block belongs to this split
                    if row_in_block == 0:
                        refs.append(ref)
                        metas.append(meta)
                    elif remaining > 0:
                        sliced = slice_block.remote(ref, row_in_block, n)
                        refs.append(sliced)
                        metas.append(BlockMetadata(num_rows=remaining, size_bytes=0, schema=meta.schema))
                    global_row += remaining
                    bi += 1
                    row_in_block = 0
                    if bound is not None and global_row == bound:
                        break
                else:
                    take = bound - global_row
                    if take > 0:
                        sliced = slice_block.remote(ref, row_in_block, row_in_block + take)
                        refs.append(sliced)
                        metas.append(BlockMetadata(num_rows=take, size_bytes=0, schema=meta.schema))
                        row_in_block += take
                        global_row = bound
                    break
            out.append(MaterializedDataset(refs, metas))
        return out

    def split_proportionately(self, proportions: List[float]) -> List["MaterializedDataset"]:
        """Split by fractions; a final split receives the remainder
        (parity: split_proportionately)."""
        if not proportions or any(p <= 0 for p in proportions) or sum(proportions) >= 1.0:
            raise ValueError("proportions must be positive and sum to < 1")
        # materialize ONCE: count and the split must see the same execution
        # (a second run would double the cost and can disagree on the total
        # when an upstream op is nondeterministic)
        mat = self.materialize()
        total = mat.count()
        indices = []
        acc = 0
        for p in proportions:
            acc += int(total * p)
            indices.append(acc)
        return mat.split_at_indices(indices)

    # -------------------------------------------- refs-based consumption
    def get_internal_block_refs(self) -> List[Any]:
        return self.materialize()._refs

    def to_numpy_refs(self, *, column: Optional[str] = None) -> List[Any]:
        """One ref per block: dict of numpy arrays (or one array when
        ``column`` is given)."""

        @ray_tpu_torch.remote
        def to_np(block):
            return BlockAccessor(block).to_numpy(column)

        return [to_np.remote(r) for r in self.materialize()._refs]

    def to_pandas_refs(self) -> List[Any]:
        @ray_tpu_torch.remote
        def to_pd(block):
            return BlockAccessor(block).to_pandas()

        return [to_pd.remote(r) for r in self.materialize()._refs]

    def to_arrow_refs(self) -> List[Any]:
        @ray_tpu_torch.remote
        def to_arrow(block):
            return BlockAccessor(block).to_arrow()

        return [to_arrow.remote(r) for r in self.materialize()._refs]

    def to_torch(self, **kwargs):
        """A ``torch.utils.data.IterableDataset`` yielding
        ``(features, label)`` tensor pairs (label None when no
        ``label_column``) — parity: Dataset.to_torch.  Delegates to
        :meth:`DataIterator.to_torch` so both entry points share one
        implementation (dtype handling, dict feature groups, prefetch).
        Reference semantics: column dtypes are PRESERVED (cast explicitly
        via ``feature_column_dtypes``/``label_column_dtype``) and the label
        unsqueezes to ``[B, 1]`` unless ``unsqueeze_label_tensor=False``."""
        return self.iterator().to_torch(**kwargs)

    def to_random_access_dataset(self, key: str, *, num_workers: int = 4):
        """Serve this dataset for random key lookups from a pool of actors
        (parity: random_access_dataset.py)."""
        from ray_tpu_torch.data.random_access import RandomAccessDataset

        return RandomAccessDataset(self, key, num_workers=num_workers)

    # ------------------------------------------------------------ lineage
    def has_serializable_lineage(self) -> bool:
        """True when the plan can be pickled and re-executed elsewhere —
        i.e. every leaf is a Read (InputData holds process-local refs)."""

        def ok(op) -> bool:
            if isinstance(op, L.InputData):
                return False
            return all(ok(i) for i in op.inputs)

        return ok(self._logical_op)

    def serialize_lineage(self) -> bytes:
        if not self.has_serializable_lineage():
            raise ValueError(
                "dataset lineage is not serializable: the plan contains "
                "materialized InputData blocks (only Read-rooted plans can "
                "be re-executed elsewhere)"
            )
        import cloudpickle

        return cloudpickle.dumps(_clone_plan(self._logical_op))

    @staticmethod
    def deserialize_lineage(blob: bytes) -> "Dataset":
        import pickle

        return Dataset(pickle.loads(blob))

    # ------------------------------------------------------ write tail
    def write_images(self, path: str, column: str = "image", *, file_format: str = "png", **kw) -> None:
        from ray_tpu_torch.data.datasource import ImageWriteDatasource

        kw.update({"column": column, "file_format": file_format})
        self._write(ImageWriteDatasource([]), path, kw)

    def write_webdataset(self, path: str, **kw) -> None:
        from ray_tpu_torch.data.datasource import WebDatasetWriteDatasource

        self._write(WebDatasetWriteDatasource([]), path, kw)

    def write_datasource(self, datasource, *, path: str = "", **write_args) -> None:
        """Write through any Datasource with a ``write_block`` /
        ``write`` surface (parity: write_datasource)."""
        self._write(datasource, path, write_args)

    # reference 2.9 renamed Datasource->Datasink on the write path; both
    # spellings accept the same object here
    write_datasink = write_datasource

    def write_mongo(self, uri: str, database: str, collection: str, **kw) -> None:
        raise ImportError(
            "write_mongo requires the pymongo package, which is not "
            "installed in this environment; write_json + a mongoimport "
            "step, or write_sql against a DB-API driver, are the native "
            "alternatives"
        )

    def write_bigquery(self, project_id: str, dataset: str, **kw) -> None:
        raise ImportError(
            "write_bigquery requires google-cloud-bigquery, which is not "
            "installed in this environment; write_parquet to GCS + a "
            "BigQuery load job is the native alternative"
        )

    # --------------------------------------- external-frame interop (gated)
    def to_dask(self):
        raise ImportError(
            "to_dask requires the dask package, which is not installed; "
            "to_pandas()/to_pandas_refs() or iter_batches() are the native "
            "consumption paths"
        )

    def to_mars(self):
        raise ImportError("to_mars requires the mars package, which is not installed")

    def to_modin(self):
        raise ImportError("to_modin requires the modin package, which is not installed")

    def to_spark(self, spark=None):
        raise ImportError(
            "to_spark requires pyspark, which is not installed; "
            "write_parquet + spark.read.parquet is the native alternative"
        )

    def stats(self) -> str:
        if self._last_stats is None:
            return "(dataset not yet executed)"
        return self._last_stats.summary()

    def __repr__(self) -> str:
        return f"Dataset(plan=\n{L.plan_to_string(self._logical_op)}\n)"


class MaterializedDataset(Dataset):
    """A Dataset whose blocks are already in the object store
    (parity: MaterializedDataset)."""

    def __init__(self, refs: List[Any], metadata: List[BlockMetadata]):
        super().__init__(L.InputData(refs, metadata))
        self._refs = refs
        self._metadata = metadata

    def num_blocks(self) -> int:
        return len(self._refs)

    def count(self) -> int:
        return sum(m.num_rows for m in self._metadata)

    def materialize(self) -> "MaterializedDataset":
        return self


class GroupedData:
    """Result of ``Dataset.groupby`` (parity: grouped_data.py)."""

    def __init__(self, ds: Dataset, key: Optional[str]):
        self._ds = ds
        self._key = key

    def aggregate(self, *aggs: AggregateFn) -> Dataset:
        return Dataset(L.Aggregate(self._ds._logical_op, self._key, list(aggs)))

    def count(self) -> Dataset:
        return self.aggregate(Count())

    def sum(self, on: str) -> Dataset:
        return self.aggregate(Sum(on))

    def min(self, on: str) -> Dataset:
        return self.aggregate(Min(on))

    def max(self, on: str) -> Dataset:
        return self.aggregate(Max(on))

    def mean(self, on: str) -> Dataset:
        return self.aggregate(Mean(on))

    def std(self, on: str) -> Dataset:
        return self.aggregate(Std(on))

    def map_groups(self, fn: Callable[[Block], Any]) -> Dataset:
        """Apply fn to each group (materializing implementation)."""
        key = self._key
        sorted_ds = self._ds.sort(key)

        def apply_groups(batch: Block) -> Block:
            from ray_tpu_torch.data.block import _sortable, block_from_rows

            acc = BlockAccessor(batch)
            if not batch or not acc.num_rows():
                return {}
            col = _sortable(batch[key])
            change = np.nonzero(col[1:] != col[:-1])[0] + 1
            starts = np.concatenate([[0], change])
            ends = np.concatenate([change, [len(col)]])
            outs = []
            for s, e in zip(starts, ends):
                res = fn(acc.slice(int(s), int(e)))
                outs.append(normalize_or_rows(res))
            return concat_blocks(outs)

        apply_groups.__name__ = f"map_groups[{getattr(fn, '__name__', 'fn')}]"
        return sorted_ds.map_batches(apply_groups, batch_size=None)


def normalize_or_rows(res: Any) -> Block:
    from ray_tpu_torch.data.block import block_from_rows, normalize_block

    if isinstance(res, list):
        return block_from_rows(res)
    if isinstance(res, dict) and res and not any(hasattr(v, "__len__") for v in res.values()):
        return block_from_rows([res])
    return normalize_block(res)


def _clone_plan(op: L.LogicalOp) -> L.LogicalOp:
    """Shallow-clone the logical DAG so optimization never mutates the
    user-held plan (Datasets are immutable/reusable)."""
    import copy

    cloned = copy.copy(op)
    cloned.inputs = [_clone_plan(i) for i in op.inputs]
    if isinstance(cloned, L.FusedMap):
        cloned.stages = list(cloned.stages)
    return cloned


def _resolve_locality_hints(hints, n: int):
    """Resolve split locality hints (actor handles or NodeIDs) to NodeIDs.
    Returns None when no usable hints (plain balanced split)."""
    if not hints:
        return None
    if len(hints) != n:
        raise ValueError(f"locality_hints must have length {n}, got {len(hints)}")
    from ray_tpu_torch.core.ids import NodeID

    cluster = ray_tpu_torch.get_cluster()
    nodes = []
    for h in hints:
        node_id = None
        if isinstance(h, NodeID):
            node_id = h
        else:
            actor_id = getattr(h, "_actor_id", None)
            if actor_id is not None:
                info = cluster.control.actors.get(actor_id)
                if info is not None:
                    node_id = info.node_id
        nodes.append(node_id)
    return nodes if any(x is not None for x in nodes) else None


def _block_locations(ref) -> set:
    try:
        return ray_tpu_torch.get_cluster().directory.locations(ref.id())
    except Exception:  # noqa: BLE001
        return set()
