"""Datasources: pluggable read/write connectors producing ReadTasks.

Parity: ``python/ray/data/datasource/`` (Datasource/Reader/ReadTask model —
each ReadTask is a serializable thunk run as a remote task that yields
blocks) and ``read_api.py``'s family of ``read_*`` constructors.

The port's copy of ``ray_tpu/data/datasource.py``: the same behaviour, imports
renamed to ``ray_tpu_torch``. It reads files through the port's ``native/io_pool.py``.
"""

from __future__ import annotations

import glob as _glob
import json as _json
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np

from ray_tpu_torch.data.block import (
    ITEM_COLUMN,
    Block,
    BlockAccessor,
    BlockMetadata,
    block_from_items,
    block_from_rows,
)


@dataclass
class ReadTask:
    """A serializable unit of reading: ``fn()`` yields one or more blocks.

    Parity: ``python/ray/data/datasource/datasource.py`` ReadTask — carries
    metadata estimates so the planner can size the read stage without
    executing it.
    """

    fn: Callable[[], Iterable[Block]]
    metadata: BlockMetadata

    def __call__(self) -> Iterable[Block]:
        return self.fn()


class Datasource:
    """Base connector interface (parity: datasource.py Datasource)."""

    def get_name(self) -> str:
        return type(self).__name__.replace("Datasource", "")

    def estimate_inmemory_data_size(self) -> Optional[int]:
        return None

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        raise NotImplementedError

    def write(self, blocks: List[Block], path: str, **kwargs) -> None:
        raise NotImplementedError


# --------------------------------------------------------------------------
# Write-side bases (parity: the 2.9+ Datasink split — datasink.py,
# _internal/datasource/*_datasink.py). Dataset.write_datasink accepts any of
# these; the file sinks write one part file per block through an open
# binary stream, so subclasses only format rows/blocks.
# --------------------------------------------------------------------------
class Datasink:
    """Write-connector base (parity: ray.data.Datasink)."""

    def get_name(self) -> str:
        return type(self).__name__.replace("Datasink", "")

    def on_write_start(self) -> None:
        pass

    def write(self, blocks: List[Block], path: str, **kwargs) -> None:
        raise NotImplementedError

    def on_write_complete(self) -> None:
        pass


class _FileDatasink(Datasink):
    def __init__(self, file_extension: str = "out"):
        self.file_extension = file_extension

    def write(self, blocks: List[Block], path: str, **kwargs) -> None:
        os.makedirs(path, exist_ok=True)
        self.on_write_start()
        for i, block in enumerate(blocks):
            fname = os.path.join(path, f"part-{i:05d}.{self.file_extension}")
            with open(fname, "wb") as f:
                self._write_one(block, f)
        self.on_write_complete()

    def _write_one(self, block: Block, file) -> None:
        raise NotImplementedError


class BlockBasedFileDatasink(_FileDatasink):
    """Subclass and implement ``write_block_to_file(block, file)``
    (parity: ray.data.BlockBasedFileDatasink)."""

    def _write_one(self, block: Block, file) -> None:
        self.write_block_to_file(block, file)

    def write_block_to_file(self, block: Block, file) -> None:
        raise NotImplementedError


class RowBasedFileDatasink(_FileDatasink):
    """Subclass and implement ``write_row_to_file(row, file)`` — called once
    per row of each block (parity: ray.data.RowBasedFileDatasink)."""

    def _write_one(self, block: Block, file) -> None:
        for row in BlockAccessor(block).iter_rows():
            self.write_row_to_file(row, file)

    def write_row_to_file(self, row: dict, file) -> None:
        raise NotImplementedError


# --------------------------------------------------------------------------
# In-memory sources
# --------------------------------------------------------------------------
class RangeDatasource(Datasource):
    """``range``/``range_tensor`` source (parity: read_api.py range())."""

    def __init__(self, n: int, tensor_shape: Optional[tuple] = None):
        self.n = n
        self.tensor_shape = tensor_shape

    def estimate_inmemory_data_size(self) -> Optional[int]:
        per_row = 8 * int(np.prod(self.tensor_shape)) if self.tensor_shape else 8
        return self.n * per_row

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        parallelism = max(1, min(parallelism, self.n or 1))
        tasks = []
        bounds = [round(i * self.n / parallelism) for i in range(parallelism + 1)]
        for i in range(parallelism):
            lo, hi = bounds[i], bounds[i + 1]
            shape = self.tensor_shape

            def make(lo=lo, hi=hi, shape=shape):
                if shape:
                    base = np.arange(lo, hi, dtype=np.int64).reshape((-1,) + (1,) * len(shape))
                    yield {"data": np.broadcast_to(base, (hi - lo,) + tuple(shape)).copy()}
                else:
                    yield {"id": np.arange(lo, hi, dtype=np.int64)}

            per_row = 8 * int(np.prod(shape)) if shape else 8
            meta = BlockMetadata(num_rows=hi - lo, size_bytes=(hi - lo) * per_row)
            tasks.append(ReadTask(make, meta))
        return tasks


class ItemsDatasource(Datasource):
    def __init__(self, items: List[Any]):
        self.items = items

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        n = len(self.items)
        parallelism = max(1, min(parallelism, n or 1))
        bounds = [round(i * n / parallelism) for i in range(parallelism + 1)]
        tasks = []
        for i in range(parallelism):
            chunk = self.items[bounds[i] : bounds[i + 1]]

            def make(chunk=chunk):
                yield block_from_items(chunk)

            meta = BlockMetadata(num_rows=len(chunk), size_bytes=len(chunk) * 8)
            tasks.append(ReadTask(make, meta))
        return tasks


class BlocksDatasource(Datasource):
    """Wraps already-materialized blocks (from_numpy/from_pandas/from_arrow)."""

    def __init__(self, blocks: List[Block]):
        self.blocks = blocks

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        tasks = []
        for b in self.blocks:
            acc = BlockAccessor.for_block(b)

            def make(b=acc.to_block()):
                yield b

            tasks.append(ReadTask(make, acc.get_metadata()))
        return tasks


# --------------------------------------------------------------------------
# File-based sources
# --------------------------------------------------------------------------
def _expand_paths(paths, metadata_prefixes: tuple = ()) -> List[str]:
    """Directories expand RECURSIVELY to files (partitioned layouts nest
    data under key=value / bucket subdirectories).  Dotfiles are skipped
    (glob's historical behavior); ``metadata_prefixes`` lets parquet-family
    sources additionally skip their _-prefixed metadata entries
    (_delta_log, _partition_spec.json) without hiding underscore-named
    data files from text/csv/json readers."""
    if isinstance(paths, str):
        paths = [paths]
    skip = (".",) + tuple(metadata_prefixes)
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if not d.startswith(skip))
                for f in sorted(files):
                    if not f.startswith(skip):
                        out.append(os.path.join(root, f))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    return out


class FileBasedDatasource(Datasource):
    """One ReadTask per file group (parity: file_based_datasource.py).

    Subclasses that can decode from raw bytes implement ``_decode_bytes``;
    their read tasks then batch-read each group through the native IO pool
    (``ray_tpu_torch.native.io_pool``, C++ pthread pread — GIL-free), decoding in
    Python while the remaining files stream in the background."""

    #: prefixes of non-data entries to skip during expansion (parquet-family
    #: sources set ("_",) for their sidecar metadata)
    _metadata_prefixes: tuple = ()

    def __init__(self, paths, **read_kwargs):
        # remember the user-supplied directory roots: hive partition-value
        # parsing must only consider path segments BELOW a root, never
        # unrelated ancestors (/tmp/run=3/... must not become a column)
        raw = [paths] if isinstance(paths, str) else list(paths)
        self.root_dirs = [os.path.abspath(p) for p in raw if isinstance(p, str) and os.path.isdir(p)]
        self.paths = _expand_paths(paths, self._metadata_prefixes)
        self.read_kwargs = read_kwargs

    def _relative_to_root(self, path: str) -> Optional[str]:
        ap = os.path.abspath(path)
        for root in self.root_dirs:
            if ap.startswith(root + os.sep):
                return ap[len(root) + 1:]
        return None

    def _read_file(self, path: str) -> Block:
        # default: read bytes then decode (subclasses override either hook)
        with open(path, "rb") as f:
            return self._decode_bytes(path, f.read())

    def _decode_bytes(self, path: str, data: bytes) -> Block:
        raise NotImplementedError

    def _supports_bytes(self) -> bool:
        return type(self)._decode_bytes is not FileBasedDatasource._decode_bytes

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        files = self.paths
        parallelism = max(1, min(parallelism, len(files) or 1))
        groups: List[List[str]] = [[] for _ in range(parallelism)]
        for i, f in enumerate(files):
            groups[i % parallelism].append(f)
        tasks = []
        for group in groups:
            if not group:
                continue

            def make(group=group):
                pool = None
                if len(group) > 1 and self._supports_bytes():
                    from ray_tpu_torch.native.io_pool import default_pool, file_size

                    pool = default_pool()
                if pool is not None:
                    # all reads submitted up front; each file decodes as its
                    # read lands, overlapping IO with decode — memory stays
                    # ~one group of in-flight buffers, yielded one at a time
                    ranges = [(p, 0, file_size(p)) for p in group]
                    for path, data in zip(group, pool.iter_reads(ranges)):
                        yield self._decode_bytes(path, data)
                else:
                    for path in group:
                        yield self._read_file(path)

            size = sum(os.path.getsize(f) for f in group if os.path.exists(f))
            meta = BlockMetadata(num_rows=-1, size_bytes=size, input_files=group)
            tasks.append(ReadTask(make, meta))
        return tasks


class CSVDatasource(FileBasedDatasource):
    def _decode_bytes(self, path: str, data: bytes) -> Block:
        import csv
        import io

        reader = csv.DictReader(io.StringIO(data.decode(), newline=""), **self.read_kwargs)
        rows = [dict(r) for r in reader]
        block = block_from_rows(rows)
        return {k: _maybe_numeric(v) for k, v in block.items()}

    def write(self, blocks: List[Block], path: str, **kwargs) -> None:
        import csv

        os.makedirs(path, exist_ok=True)
        for i, block in enumerate(blocks):
            acc = BlockAccessor(block)
            with open(os.path.join(path, f"part-{i:05d}.csv"), "w", newline="") as f:
                keys = list(block.keys())
                w = csv.DictWriter(f, fieldnames=keys)
                w.writeheader()
                for row in acc.iter_rows():
                    w.writerow(row)


class JSONDatasource(FileBasedDatasource):
    """JSONL files, one object per line (parity: json_datasource.py)."""

    def _decode_bytes(self, path: str, data: bytes) -> Block:
        rows = []
        for line in data.decode().splitlines():
            line = line.strip()
            if line:
                rows.append(_json.loads(line))
        return block_from_rows(rows)

    def write(self, blocks: List[Block], path: str, **kwargs) -> None:
        os.makedirs(path, exist_ok=True)
        for i, block in enumerate(blocks):
            with open(os.path.join(path, f"part-{i:05d}.jsonl"), "w") as f:
                for row in BlockAccessor(block).iter_rows():
                    f.write(_json.dumps(_jsonable(row)) + "\n")


class NumpyDatasource(FileBasedDatasource):
    def _decode_bytes(self, path: str, data: bytes) -> Block:
        import io

        arr = np.load(io.BytesIO(data), allow_pickle=False)
        return {"data": arr}

    def write(self, blocks: List[Block], path: str, *, column: str = "data", **kwargs) -> None:
        os.makedirs(path, exist_ok=True)
        for i, block in enumerate(blocks):
            np.save(os.path.join(path, f"part-{i:05d}.npy"), block[column])


class ParquetDatasource(FileBasedDatasource):
    _metadata_prefixes = ("_",)  # _delta_log, _partition_spec.json, _SUCCESS

    """Parquet via pyarrow with column + predicate pushdown.

    Parity: ``python/ray/data/datasource/parquet_datasource.py`` — ``columns``
    prunes at the reader (only those column chunks are decoded) and
    ``filters`` (DNF-style ``[(col, op, value), ...]`` AND-list) prunes whole
    row groups via the file's min/max statistics BEFORE any IO on them, then
    applies the exact predicate to the surviving rows.

    ``read_stats`` (class-level, lock-guarded, **per-process**) records
    row-groups total vs actually read so pushdown is assertable on a direct
    read; reads executed in worker processes account in THAT process."""

    #: per-process pushdown accounting: {"row_groups_total", "row_groups_read", "files"}
    read_stats = {"row_groups_total": 0, "row_groups_read": 0, "files": 0}
    _stats_lock = threading.Lock()

    def __init__(self, paths, columns=None, filters=None, **read_kwargs):
        super().__init__(paths, **read_kwargs)
        self.columns = list(columns) if columns is not None else None
        self.filters = list(filters) if filters is not None else None

    @classmethod
    def reset_read_stats(cls) -> None:
        cls.read_stats = {"row_groups_total": 0, "row_groups_read": 0, "files": 0}

    @staticmethod
    def _group_may_match(meta_rg, col_index: Dict[str, int], filt) -> bool:
        """Can this row group contain rows matching (col, op, value)?
        Conservative: missing statistics => True."""
        col, op, value = filt
        idx = col_index.get(col)
        if idx is None:
            return True
        stats = meta_rg.column(idx).statistics
        if stats is None or not stats.has_min_max:
            return True
        lo, hi = stats.min, stats.max
        try:
            if op in ("=", "=="):
                return lo <= value <= hi
            if op == "<":
                return lo < value
            if op == "<=":
                return lo <= value
            if op == ">":
                return hi > value
            if op == ">=":
                return hi >= value
            if op == "in":
                return any(lo <= v <= hi for v in value)
            if op in ("!=", "not in"):
                return True  # min/max can't disprove inequality
        except TypeError:
            return True
        return True

    def _read_file(self, path: str) -> Block:
        import pyarrow.parquet as pq

        f = pq.ParquetFile(path, **self.read_kwargs)
        meta = f.metadata
        cls = type(self)
        with cls._stats_lock:
            cls.read_stats["files"] += 1
            cls.read_stats["row_groups_total"] += meta.num_row_groups
        if self.filters:
            col_index = {meta.schema.column(i).name: i for i in range(meta.num_columns)}
            keep = [
                g for g in range(meta.num_row_groups)
                if all(
                    self._group_may_match(meta.row_group(g), col_index, filt)
                    for filt in self.filters
                )
            ]
            with cls._stats_lock:
                cls.read_stats["row_groups_read"] += len(keep)
            want = self.columns or list(f.schema_arrow.names)
            if not keep:
                table = f.schema_arrow.empty_table().select(want)
            else:
                # the exact predicate needs its columns present: read the
                # union, filter, then project down to the requested set
                filter_cols = [filt[0] for filt in self.filters]
                read_cols = list(dict.fromkeys(want + filter_cols))
                table = f.read_row_groups(keep, columns=read_cols)
                if table.num_rows:
                    table = table.filter(pq.filters_to_expression(self.filters))
                table = table.select(want)
        else:
            with cls._stats_lock:
                cls.read_stats["row_groups_read"] += meta.num_row_groups
            table = f.read(columns=self.columns)
        # hive layout: key=value segments BELOW the dataset root come back
        # as columns (ancestor directories never do)
        hive = _hive_partition_values(self._relative_to_root(path))
        for key, value in hive.items():
            if key not in table.column_names and (
                self.columns is None or key in self.columns
            ):
                import pyarrow as pa

                table = table.append_column(key, pa.array([value] * table.num_rows))
        return BlockAccessor.for_block(table).to_block()

    def write(
        self, blocks: List[Block], path: str,
        partition_cols=None, partition_by=None, **kwargs,
    ) -> None:
        """Write blocks as parquet.  ``partition_cols=[col, ...]`` produces a
        hive layout (``col=value/`` directories, partition columns dropped
        from the files — restored at read time); ``partition_by={"column":
        c, "mode": "hash"|"range", "num_partitions": N}`` buckets rows by a
        deterministic hash or by global range boundaries (reference:
        partitioned writes in parquet_datasource + partitioning.py)."""
        import pyarrow.parquet as pq

        os.makedirs(path, exist_ok=True)
        if partition_cols:
            self._write_hive(blocks, path, list(partition_cols))
            return
        if partition_by:
            self._write_bucketed(blocks, path, dict(partition_by))
            return
        for i, block in enumerate(blocks):
            table = BlockAccessor(block).to_arrow()
            pq.write_table(table, os.path.join(path, f"part-{i:05d}.parquet"))

    @staticmethod
    def _hive_quote(value) -> str:
        from urllib.parse import quote

        return quote(str(value), safe="")

    def _write_hive(self, blocks, path: str, cols: List[str]) -> None:
        import pyarrow.parquet as pq

        part_seq: Dict[str, int] = {}
        for block in blocks:
            table = BlockAccessor(block).to_arrow()
            key_arrays = [np.asarray(table[c]) for c in cols]
            for c, arr in zip(cols, key_arrays):
                # NaN != NaN would silently drop those rows (no combo mask
                # matches); nulls in partition columns are a modeling error
                if arr.dtype.kind == "f" and np.isnan(arr).any():
                    raise ValueError(
                        f"partition column {c!r} contains NaN/null values; "
                        "partition keys must be non-null"
                    )
            keys = list(zip(*[a.tolist() for a in key_arrays])) if len(table) else []
            data = table.drop_columns(cols)
            for combo in sorted(set(keys), key=str):
                mask = np.ones(len(table), dtype=bool)
                for arr, v in zip(key_arrays, combo):
                    mask &= arr == v
                subdir = os.path.join(
                    path, *[f"{c}={self._hive_quote(v)}" for c, v in zip(cols, combo)]
                )
                os.makedirs(subdir, exist_ok=True)
                seq = part_seq.get(subdir, 0)
                part_seq[subdir] = seq + 1
                pq.write_table(
                    data.filter(mask), os.path.join(subdir, f"part-{seq:05d}.parquet")
                )

    def _write_bucketed(self, blocks, path: str, spec: dict) -> None:
        import json as _json

        import pyarrow.parquet as pq

        column = spec["column"]
        n = int(spec.get("num_partitions", 8))
        mode = spec.get("mode", "hash")
        tables = [BlockAccessor(b).to_arrow() for b in blocks]
        if mode == "range":
            chunks = [np.asarray(t[column]) for t in tables if len(t)]
            if not chunks:
                # empty dataset: spec-only layout, nothing to bucket
                with open(os.path.join(path, "_partition_spec.json"), "w") as f:
                    import json as _j

                    _j.dump({"column": column, "mode": mode,
                             "num_partitions": n, "bounds": []}, f)
                return
            all_vals = np.concatenate(chunks)
            if all_vals.dtype.kind not in "iuf":
                raise ValueError(
                    f"range partitioning needs a numeric column; {column!r} "
                    f"has dtype {all_vals.dtype}"
                )
            bounds = [
                float(np.quantile(all_vals, q))
                for q in np.linspace(0, 1, n + 1)[1:-1]
            ]
        elif mode == "hash":
            bounds = None
        else:
            raise ValueError(f"partition_by mode must be 'hash' or 'range', got {mode!r}")
        with open(os.path.join(path, "_partition_spec.json"), "w") as f:
            _json.dump({"column": column, "mode": mode, "num_partitions": n, "bounds": bounds}, f)
        part_seq: Dict[int, int] = {}
        for table in tables:
            vals = np.asarray(table[column])
            if mode == "range":
                idx = np.searchsorted(np.asarray(bounds), vals, side="right")
            else:
                idx = np.asarray([_stable_hash(v) % n for v in vals.tolist()])
            for part in sorted(set(idx.tolist())):
                subdir = os.path.join(path, f"{mode}={part:04d}")
                os.makedirs(subdir, exist_ok=True)
                seq = part_seq.get(part, 0)
                part_seq[part] = seq + 1
                pq.write_table(
                    table.filter(idx == part),
                    os.path.join(subdir, f"part-{seq:05d}.parquet"),
                )


def _stable_hash(value) -> int:
    """Deterministic across processes (Python's str hash is salted)."""
    import hashlib

    return int.from_bytes(
        hashlib.blake2b(repr(value).encode(), digest_size=8).digest(), "little"
    )


def coerce_partition_value(raw) -> Any:
    """THE string->value promotion for partition values ('try int, then
    float, else str') — shared by hive parquet and Delta partitionValues
    so the policies can't drift."""
    if not isinstance(raw, str):
        return raw
    for cast in (int, float):
        try:
            return cast(raw)
        except (TypeError, ValueError):
            continue
    return raw


def _hive_partition_values(rel_path: Optional[str]) -> Dict[str, Any]:
    """key=value segments of a root-RELATIVE path -> column values."""
    from urllib.parse import unquote

    out: Dict[str, Any] = {}
    if not rel_path:
        return out
    for segment in rel_path.split(os.sep)[:-1]:
        key, sep, raw = segment.partition("=")
        if not sep or not key or key in ("hash", "range"):
            continue
        out[key] = coerce_partition_value(unquote(raw))
    return out


def _maybe_numeric(arr: np.ndarray) -> np.ndarray:
    """CSV reads everything as str; promote to numbers when they parse."""
    if arr.dtype != object and not np.issubdtype(arr.dtype, np.str_):
        return arr
    vals = list(arr)
    try:
        return np.asarray([int(v) for v in vals], dtype=np.int64)
    except (TypeError, ValueError):
        pass
    try:
        return np.asarray([float(v) for v in vals], dtype=np.float64)
    except (TypeError, ValueError):
        return arr


def _jsonable(row: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in row.items():
        if isinstance(v, np.ndarray):
            out[k] = v.tolist()
        elif isinstance(v, np.generic):
            out[k] = v.item()
        else:
            out[k] = v
    return out


class TextDatasource(FileBasedDatasource):
    """One row per line (parity: text_datasource.py)."""

    def _decode_bytes(self, path: str, data: bytes) -> Block:
        text = data.decode(self.read_kwargs.get("encoding", "utf-8"))
        # split on \n ONLY (file-iteration semantics): splitlines() would
        # also break rows at \x0c, \x85,  ... inside a line
        text = text.replace("\r\n", "\n").replace("\r", "\n")  # universal newlines
        lines = text.split("\n")
        if lines and lines[-1] == "":
            lines.pop()  # trailing newline is a terminator, not an empty row
        if self.read_kwargs.get("drop_empty_lines", True):
            lines = [ln for ln in lines if ln]
        return {"text": np.asarray(lines, dtype=object)}


class BinaryDatasource(FileBasedDatasource):
    """Whole files as bytes rows (parity: binary_datasource.py)."""

    def _decode_bytes(self, path: str, data: bytes) -> Block:
        block = {"bytes": np.asarray([bytes(data)], dtype=object)}
        if self.read_kwargs.get("include_paths", False):
            block["path"] = np.asarray([path], dtype=object)
        return block


class ImageDatasource(FileBasedDatasource):
    """Images decoded to HWC uint8 arrays via PIL (parity:
    image_datasource.py). ``size=(h, w)`` resizes; ``mode`` converts."""

    def _decode_bytes(self, path: str, data: bytes) -> Block:
        import io
        from PIL import Image

        img = Image.open(io.BytesIO(data))
        mode = self.read_kwargs.get("mode")
        if mode:
            img = img.convert(mode)
        size = self.read_kwargs.get("size")
        if size:
            img = img.resize((size[1], size[0]))  # PIL takes (w, h)
        arr = np.asarray(img)
        block = {"image": arr[None, ...]}
        if self.read_kwargs.get("include_paths", False):
            block["path"] = np.asarray([path], dtype=object)
        return block


class WebDatasetDatasource(FileBasedDatasource):
    """WebDataset-style tar shards: files sharing a basename form one sample,
    keyed by extension (parity: webdataset_datasource.py). Decodes .json,
    .txt/.cls, .npy, and common image extensions; other payloads stay bytes."""

    IMAGE_EXTS = {"jpg", "jpeg", "png", "bmp", "gif", "webp"}

    def _decode_bytes(self, path: str, data: bytes) -> Block:
        import io
        import tarfile

        samples: Dict[str, Dict[str, Any]] = {}
        order: List[str] = []
        with tarfile.open(fileobj=io.BytesIO(data)) as tf:
            for member in tf:
                if not member.isfile():
                    continue
                # webdataset convention: key = member name up to the first
                # dot AFTER the last '/', so dots in directories don't split
                dirname, _, filename = member.name.rpartition("/")
                stem, _, ext = filename.partition(".")
                base = f"{dirname}/{stem}" if dirname else stem
                ext = ext.lower()
                payload = tf.extractfile(member).read()
                if base not in samples:
                    samples[base] = {"__key__": base}
                    order.append(base)
                samples[base][ext] = self._decode(ext, payload)
        rows = [samples[k] for k in order]
        return block_from_rows(rows)

    def _decode(self, ext: str, payload: bytes):
        import io

        # a multi-part extension like "seg.png" decodes by its LAST suffix
        last = ext.rsplit(".", 1)[-1]
        if last == "json":
            return _json.loads(payload)
        if last == "cls":
            text = payload.decode()
            try:
                return int(text)
            except ValueError:
                return text
        if last == "txt":
            return payload.decode()
        if last == "npy":
            return np.load(io.BytesIO(payload), allow_pickle=False)
        if last in self.IMAGE_EXTS:
            try:
                from PIL import Image

                return np.asarray(Image.open(io.BytesIO(payload)))
            except Exception:
                return payload
        return payload


class ImageWriteDatasource(FileBasedDatasource):
    """Write an image column as one file per row (parity:
    image_datasource write path / ``Dataset.write_images``).  Arrays are
    encoded via PIL; raw ``bytes`` values are written as-is."""

    def write(self, blocks: List[Block], path: str, *, column: str = "image",
              file_format: str = "png", **kwargs) -> None:
        os.makedirs(path, exist_ok=True)
        i = 0
        for block in blocks:
            for row in BlockAccessor(block).iter_rows():
                value = row[column]
                out = os.path.join(path, f"{i:08d}.{file_format}")
                if isinstance(value, (bytes, bytearray)):
                    with open(out, "wb") as f:
                        f.write(value)
                else:
                    from PIL import Image

                    arr = np.asarray(value)
                    if arr.dtype != np.uint8:
                        arr = np.clip(arr, 0, 255).astype(np.uint8)
                    Image.fromarray(arr).save(out, format=file_format.upper())
                i += 1


class WebDatasetWriteDatasource(FileBasedDatasource):
    """Write webdataset tar shards — the mirror of WebDatasetDatasource's
    reader: one tar per block, one member per (row, column), keyed
    ``{__key__}.{column-extension}`` so a read round-trips.  Column values
    encode by type: str -> .txt, int -> .cls, dict/list -> .json,
    ndarray -> .npy, bytes -> kept under the column name as extension."""

    def write(self, blocks: List[Block], path: str, **kwargs) -> None:
        import io
        import tarfile

        os.makedirs(path, exist_ok=True)
        counter = 0
        for shard_idx, block in enumerate(blocks):
            out = os.path.join(path, f"shard-{shard_idx:06d}.tar")
            with tarfile.open(out, "w") as tf:
                for row in BlockAccessor(block).iter_rows():
                    key = str(row.get("__key__", f"{counter:08d}"))
                    counter += 1
                    for col, value in row.items():
                        if col == "__key__":
                            continue
                        name, payload = self._encode(key, col, value)
                        info = tarfile.TarInfo(name=name)
                        info.size = len(payload)
                        tf.addfile(info, io.BytesIO(payload))

    @staticmethod
    def _encode(key: str, col: str, value) -> tuple:
        """Encode by the column's extension suffix (webdataset columns are
        extension-named: jpg/txt/cls/json/npy); non-extension column names
        get a type-derived suffix appended so the payload stays decodable."""
        import io

        if isinstance(value, (bytes, bytearray)):
            return f"{key}.{col}", bytes(value)
        last = col.rsplit(".", 1)[-1].lower()
        if last == "json":
            return f"{key}.{col}", _json.dumps(_jsonable({"v": value})["v"]).encode()
        if last == "cls":
            return f"{key}.{col}", str(int(value)).encode()
        if last == "txt":
            return f"{key}.{col}", str(value).encode()
        if last == "npy":
            buf = io.BytesIO()
            np.save(buf, np.asarray(value), allow_pickle=False)
            return f"{key}.{col}", buf.getvalue()
        if last in WebDatasetDatasource.IMAGE_EXTS:
            from PIL import Image

            arr = np.asarray(value)
            if arr.dtype != np.uint8:
                arr = np.clip(arr, 0, 255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="PNG" if last == "png" else "JPEG")
            return f"{key}.{col}", buf.getvalue()
        # type-derived suffix for plain column names
        if isinstance(value, str):
            return f"{key}.{col}.txt", value.encode()
        if isinstance(value, (int, np.integer)):
            return f"{key}.{col}.cls", str(int(value)).encode()
        if isinstance(value, np.ndarray):
            buf = io.BytesIO()
            np.save(buf, value, allow_pickle=False)
            return f"{key}.{col}.npy", buf.getvalue()
        return f"{key}.{col}.json", _json.dumps(_jsonable({"v": value})["v"]).encode()


class SQLDatasource(Datasource):
    """DB-API 2.0 query reads (parity: sql_datasource.py — ``read_sql``
    takes a query + zero-arg connection factory; rows become columnar
    blocks). Parallelism is 1 unless the caller provides shard queries —
    DB-API cursors can't be split safely in general."""

    def __init__(self, sql: str, connection_factory, shard_queries=None):
        self.sql = sql
        self.connection_factory = connection_factory
        self.shard_queries = list(shard_queries) if shard_queries else [sql]

    def get_name(self) -> str:
        return "SQL"

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        factory = self.connection_factory
        tasks = []
        for query in self.shard_queries:
            def make(query=query):
                conn = factory()
                try:
                    cur = conn.cursor()
                    cur.execute(query)
                    cols = [d[0] for d in cur.description]
                    rows = cur.fetchall()
                finally:
                    conn.close()
                if not rows:
                    return []
                block = {
                    c: np.asarray([r[i] for r in rows])
                    for i, c in enumerate(cols)
                }
                return [block]

            tasks.append(ReadTask(make, BlockMetadata(num_rows=-1, size_bytes=-1)))
        return tasks

    def write(self, blocks: List[Block], table: str, **kwargs) -> None:
        """Insert blocks into ``table`` (backs ``Dataset.write_sql``).

        ``paramstyle`` kwarg picks the DB-API placeholder: "qmark" (sqlite)
        or "format" (postgres/mysql drivers). The table name must be a
        plain identifier — it is interpolated into the statement.
        """
        if not table.replace("_", "").isalnum():
            raise ValueError(f"table name must be a plain identifier, got {table!r}")
        placeholder = {"qmark": "?", "format": "%s"}[kwargs.get("paramstyle", "qmark")]
        conn = self.connection_factory()
        try:
            cur = conn.cursor()
            for block in blocks:
                acc = BlockAccessor.for_block(block)
                data = acc.to_dict()
                cols = list(data.keys())
                placeholders = ", ".join(placeholder for _ in cols)
                stmt = f"INSERT INTO {table} ({', '.join(cols)}) VALUES ({placeholders})"
                n = acc.num_rows()
                cur.executemany(
                    stmt, [tuple(data[c][i] for c in cols) for i in range(n)]
                )
            conn.commit()
        finally:
            conn.close()


_CRC32C_TABLE: Optional[List[int]] = None


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, poly 0x1EDC6F41 reflected) — the checksum the
    TFRecord container mandates; table-driven pure Python."""
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
            table.append(crc)
        _CRC32C_TABLE = table
    crc = 0xFFFFFFFF
    table = _CRC32C_TABLE
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class TFRecordDatasource(FileBasedDatasource):
    """TFRecord files (parity: ``tfrecords_datasource.py``).

    The container framing (8-byte little-endian length + masked-crc32c of
    the length + payload + masked-crc32c of the payload) is parsed in pure
    Python; payloads decode as ``tf.train.Example`` feature dicts when
    ``tf_schema`` decoding is on (default, requires tensorflow), else raw
    bytes rows."""

    def __init__(self, paths, decode_examples: bool = True, **read_kwargs):
        super().__init__(paths, **read_kwargs)
        self.decode_examples = decode_examples

    def _decode_bytes(self, path: str, data: bytes) -> Block:
        import struct as _struct

        records = []
        off = 0
        n = len(data)
        while off + 12 <= n:
            (length,) = _struct.unpack_from("<Q", data, off)
            off += 12  # length + its crc
            payload = data[off : off + length]
            off += length + 4  # payload + its crc
            records.append(payload)
        if not self.decode_examples:
            return {"bytes": np.asarray(records, dtype=object)}
        try:
            from tensorflow.core.example import example_pb2
        except ImportError as exc:  # pragma: no cover
            raise ImportError(
                "decoding tf.train.Example requires tensorflow; pass "
                "decode_examples=False for raw bytes rows"
            ) from exc
        rows = []
        for payload in records:
            ex = example_pb2.Example.FromString(payload)
            row = {}
            for name, feat in ex.features.feature.items():
                kind = feat.WhichOneof("kind")
                if kind == "bytes_list":
                    vals = list(feat.bytes_list.value)
                elif kind == "float_list":
                    vals = list(feat.float_list.value)
                elif kind == "int64_list":
                    vals = list(feat.int64_list.value)
                else:
                    vals = []
                row[name] = vals[0] if len(vals) == 1 else vals
            rows.append(row)
        return block_from_rows(rows)

    def write(self, blocks: List[Block], path: str, **kwargs) -> None:
        import struct as _struct

        def _masked_crc(b: bytes) -> int:
            # real crc32c (Castagnoli) + TFRecord masking: standard TF
            # readers VERIFY these, so anything else writes unreadable files
            crc = _crc32c(b)
            return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF

        try:
            from tensorflow.core.example import example_pb2, feature_pb2
        except ImportError as exc:  # pragma: no cover
            raise ImportError("write_tfrecords requires tensorflow") from exc

        os.makedirs(path, exist_ok=True)
        for i, block in enumerate(blocks):
            with open(os.path.join(path, f"part-{i:05d}.tfrecords"), "wb") as f:
                for row in BlockAccessor(block).iter_rows():
                    feats = {}
                    for k, v in row.items():
                        if isinstance(v, (bytes, str)):
                            raw = v.encode() if isinstance(v, str) else v
                            feats[k] = feature_pb2.Feature(
                                bytes_list=feature_pb2.BytesList(value=[raw])
                            )
                        elif isinstance(v, (bool, np.bool_, int, np.integer)):
                            feats[k] = feature_pb2.Feature(
                                int64_list=feature_pb2.Int64List(value=[int(v)])
                            )
                        elif isinstance(v, (float, np.floating)):
                            feats[k] = feature_pb2.Feature(
                                float_list=feature_pb2.FloatList(value=[float(v)])
                            )
                        elif isinstance(v, (list, np.ndarray)):
                            arr = np.asarray(v)
                            if np.issubdtype(arr.dtype, np.integer):
                                feats[k] = feature_pb2.Feature(
                                    int64_list=feature_pb2.Int64List(value=arr.astype(np.int64).tolist())
                                )
                            elif np.issubdtype(arr.dtype, np.floating):
                                feats[k] = feature_pb2.Feature(
                                    float_list=feature_pb2.FloatList(value=arr.astype(np.float32).tolist())
                                )
                            else:  # strings / bytes lists
                                feats[k] = feature_pb2.Feature(
                                    bytes_list=feature_pb2.BytesList(
                                        value=[
                                            x.encode() if isinstance(x, str) else bytes(x)
                                            for x in arr.tolist()
                                        ]
                                    )
                                )
                        else:
                            raise ValueError(
                                f"write_tfrecords: column {k!r} has unsupported "
                                f"value type {type(v).__name__}"
                            )
                    payload = example_pb2.Example(
                        features=feature_pb2.Features(feature=feats)
                    ).SerializeToString()
                    header = _struct.pack("<Q", len(payload))
                    f.write(header)
                    f.write(_struct.pack("<I", _masked_crc(header)))
                    f.write(payload)
                    f.write(_struct.pack("<I", _masked_crc(payload)))


class MongoDatasource(Datasource):
    """MongoDB collections (parity: ``mongo_datasource.py``); requires
    pymongo (not bundled — gated with a clear error)."""

    def __init__(self, uri: str, database: str, collection: str, pipeline: Optional[list] = None):
        try:
            import pymongo  # noqa: F401
        except ImportError as exc:
            raise ImportError("read_mongo requires pymongo (pip install pymongo)") from exc
        self.uri, self.database, self.collection = uri, database, collection
        self.pipeline = pipeline or []

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        import pymongo

        uri, db, coll, pipeline = self.uri, self.database, self.collection, self.pipeline
        # shard by document ranges: count once, then $skip/$limit windows —
        # each ReadTask streams its slice in its own worker
        client = pymongo.MongoClient(uri)
        try:
            total = client[db][coll].count_documents({})
        finally:
            client.close()
        parallelism = max(1, min(parallelism, total or 1))
        bounds = [round(i * total / parallelism) for i in range(parallelism + 1)]
        tasks = []
        for i in range(parallelism):
            lo, hi = bounds[i], bounds[i + 1]
            if hi <= lo:
                continue

            def make(lo=lo, hi=hi):
                import pymongo as _pm

                cl = _pm.MongoClient(uri)
                try:
                    shard_pipeline = list(pipeline) + [{"$skip": lo}, {"$limit": hi - lo}]
                    rows = [
                        {k: v for k, v in doc.items() if k != "_id"}
                        for doc in cl[db][coll].aggregate(shard_pipeline)
                    ]
                finally:
                    cl.close()
                yield block_from_rows(rows)

            tasks.append(
                ReadTask(make, BlockMetadata(num_rows=hi - lo, size_bytes=-1, input_files=[uri]))
            )
        return tasks


class BigQueryDatasource(Datasource):
    """BigQuery tables/queries (parity: ``bigquery_datasource.py``);
    requires google-cloud-bigquery (not bundled — gated)."""

    def __init__(self, project_id: str, query: Optional[str] = None, dataset: Optional[str] = None):
        try:
            from google.cloud import bigquery  # noqa: F401
        except ImportError as exc:
            raise ImportError(
                "read_bigquery requires google-cloud-bigquery (pip install google-cloud-bigquery)"
            ) from exc
        self.project_id, self.query, self.dataset = project_id, query, dataset

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        project, query, dataset = self.project_id, self.query, self.dataset
        if dataset is not None and query is None:
            # table reads shard by row ranges via list_rows(start_index)
            from google.cloud import bigquery

            client = bigquery.Client(project=project)
            total = client.get_table(dataset).num_rows
            parallelism = max(1, min(parallelism, int(total) or 1))
            bounds = [round(i * total / parallelism) for i in range(parallelism + 1)]
            tasks = []
            for i in range(parallelism):
                lo, hi = bounds[i], bounds[i + 1]
                if hi <= lo:
                    continue

                def make(lo=lo, hi=hi):
                    from google.cloud import bigquery as _bq

                    cl = _bq.Client(project=project)
                    rows = cl.list_rows(dataset, start_index=lo, max_results=hi - lo)
                    yield BlockAccessor.for_block(rows.to_arrow()).to_block()

                tasks.append(
                    ReadTask(make, BlockMetadata(num_rows=hi - lo, size_bytes=-1, input_files=[project]))
                )
            return tasks

        # arbitrary queries can't be split without rewriting the SQL: one
        # task (matching the reference's query path)
        def make():
            from google.cloud import bigquery

            client = bigquery.Client(project=project)
            table = client.query(query).to_arrow()
            yield BlockAccessor.for_block(table).to_block()

        return [ReadTask(make, BlockMetadata(num_rows=-1, size_bytes=-1, input_files=[project]))]
