"""Blocks: the unit of data a Dataset is partitioned into.

Parity with the reference's block model (``python/ray/data/block.py:57`` —
``Block = Union[pyarrow.Table, pandas.DataFrame]`` with a ``BlockAccessor``
:221 abstracting over formats).

The canonical in-memory format is **columnar numpy** —
``{column: np.ndarray}`` — because the consumption path is
``iter_batches -> a copy to the device`` and numpy columns are the
zero-copy host staging format for those transfers.  Arrow/pandas interop is provided behind
optional imports rather than being the core representation.

The port's copy of ``ray_tpu/data/block.py``: the same behaviour, imports
renamed to ``ray_tpu_torch``.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np

# A Block is a columnar batch: column name -> numpy array (first dim = rows).
Block = Dict[str, np.ndarray]

# Default column name used when the user supplies bare values (parity:
# ray.data's TENSOR_COLUMN_NAME / "item" convention for simple datasets).
ITEM_COLUMN = "item"


@dataclass
class BlockMetadata:
    """Summary stats the planner/executor track per block without fetching it.

    Parity: ``python/ray/data/block.py`` BlockMetadata (num_rows, size_bytes,
    schema, input_files, exec_stats).
    """

    num_rows: int
    size_bytes: int
    schema: Optional[Dict[str, Any]] = None
    input_files: List[str] = field(default_factory=list)
    exec_time_s: float = 0.0
    cpu_time_s: float = 0.0


def _as_array(values: Any) -> np.ndarray:
    if isinstance(values, np.ndarray):
        return values
    arr = np.asarray(values)
    if arr.dtype == object:
        # Ragged / heterogeneous python objects: keep as object array.
        out = np.empty(len(values), dtype=object)
        for i, v in enumerate(values):
            out[i] = v
        return out
    return arr


def block_from_rows(rows: List[Dict[str, Any]]) -> Block:
    """Build a columnar block from a list of row dicts."""
    if not rows:
        return {}
    cols: Dict[str, List[Any]] = {k: [] for k in rows[0]}
    for row in rows:
        if row.keys() != cols.keys():
            for k in row:
                if k not in cols:
                    cols[k] = [None] * (len(next(iter(cols.values()))) - 0)
        for k in cols:
            cols[k].append(row.get(k))
    return {k: _as_array(v) for k, v in cols.items()}


def block_from_items(items: List[Any]) -> Block:
    """Build a block from bare python values (wrapped in the item column)."""
    if items and isinstance(items[0], dict):
        return block_from_rows(items)
    return {ITEM_COLUMN: _as_array(items)}


class BlockAccessor:
    """Accessor over a columnar block (parity: ``block.py:221``)."""

    def __init__(self, block: Block):
        self._block = block

    @staticmethod
    def for_block(block: Any) -> "BlockAccessor":
        return BlockAccessor(normalize_block(block))

    def to_block(self) -> Block:
        return self._block

    # ------------------------------------------------------------- shape
    def num_rows(self) -> int:
        if not self._block:
            return 0
        return len(next(iter(self._block.values())))

    def size_bytes(self) -> int:
        total = 0
        for arr in self._block.values():
            if arr.dtype == object:
                total += sum(_sizeof(v) for v in arr)
            else:
                total += arr.nbytes
        return total

    def schema(self) -> Optional[Dict[str, Any]]:
        if not self._block:
            return None
        return {k: (v.dtype, v.shape[1:]) for k, v in self._block.items()}

    def get_metadata(
        self,
        input_files: Optional[List[str]] = None,
        exec_time_s: float = 0.0,
        cpu_time_s: float = 0.0,
    ) -> BlockMetadata:
        return BlockMetadata(
            num_rows=self.num_rows(),
            size_bytes=self.size_bytes(),
            schema=self.schema(),
            input_files=input_files or [],
            exec_time_s=exec_time_s,
            cpu_time_s=cpu_time_s,
        )

    # ------------------------------------------------------------- slicing
    def slice(self, start: int, end: int) -> Block:
        return {k: v[start:end] for k, v in self._block.items()}

    def take(self, indices: np.ndarray) -> Block:
        return {k: v[indices] for k, v in self._block.items()}

    # ------------------------------------------------------------- rows
    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        n = self.num_rows()
        keys = list(self._block.keys())
        for i in range(n):
            yield {k: _unbox(self._block[k][i]) for k in keys}

    def row(self, i: int) -> Dict[str, Any]:
        return {k: _unbox(v[i]) for k, v in self._block.items()}

    # ------------------------------------------------------------- sorting
    def sort_indices(self, key: Union[str, List[str]], descending: bool = False) -> np.ndarray:
        keys = [key] if isinstance(key, str) else list(key)
        # np.lexsort sorts by the LAST key first; reverse for precedence.
        arrays = [self._block[k] for k in reversed(keys)]
        idx = np.lexsort([_sortable(a) for a in arrays])
        if descending:
            idx = idx[::-1]
        return idx

    def sort(self, key: Union[str, List[str]], descending: bool = False) -> Block:
        return self.take(self.sort_indices(key, descending))

    # ------------------------------------------------------------- interop
    def to_pandas(self):
        import pandas as pd  # baked in via torch/transformers deps

        return pd.DataFrame({k: list(v) if v.dtype == object else v for k, v in self._block.items()})

    def to_numpy(self, column: Optional[str] = None):
        if column is not None:
            return self._block[column]
        if len(self._block) == 1:
            return next(iter(self._block.values()))
        return dict(self._block)

    def to_arrow(self):
        import pyarrow as pa

        return pa.table({k: list(v) for k, v in self._block.items()})


def normalize_block(block: Any) -> Block:
    """Coerce user-returned batch data into the canonical columnar form."""
    if isinstance(block, dict):
        return {k: _as_array(v) for k, v in block.items()}
    if isinstance(block, np.ndarray):
        return {ITEM_COLUMN: block}
    if isinstance(block, list):
        return block_from_items(block)
    try:  # pandas DataFrame
        import pandas as pd

        if isinstance(block, pd.DataFrame):
            return {k: _as_array(block[k].to_numpy()) for k in block.columns}
    except ImportError:  # pragma: no cover
        pass
    try:  # pyarrow Table
        import pyarrow as pa

        if isinstance(block, pa.Table):
            return {name: _as_array(block.column(name).to_pylist()) for name in block.column_names}
    except ImportError:  # pragma: no cover
        pass
    raise TypeError(f"Cannot interpret {type(block)} as a block")


def concat_blocks(blocks: List[Block]) -> Block:
    blocks = [b for b in blocks if b and BlockAccessor(b).num_rows() > 0]
    if not blocks:
        return {}
    keys = list(blocks[0].keys())
    out: Block = {}
    for k in keys:
        arrays = [b[k] for b in blocks]
        if any(a.dtype == object for a in arrays):
            merged = np.empty(sum(len(a) for a in arrays), dtype=object)
            pos = 0
            for a in arrays:
                merged[pos : pos + len(a)] = a
                pos += len(a)
            out[k] = merged
        else:
            out[k] = np.concatenate(arrays, axis=0)
    return out


def split_block(block: Block, num_splits: int) -> List[Block]:
    acc = BlockAccessor(block)
    n = acc.num_rows()
    bounds = [round(i * n / num_splits) for i in range(num_splits + 1)]
    return [acc.slice(bounds[i], bounds[i + 1]) for i in range(num_splits)]


def _sizeof(v: Any) -> int:
    if isinstance(v, np.ndarray):
        return v.nbytes
    if isinstance(v, (bytes, str)):
        return len(v)
    return 8


def _unbox(v: Any) -> Any:
    if isinstance(v, np.generic):
        return v.item()
    return v


def _sortable(a: np.ndarray) -> np.ndarray:
    if a.dtype == object:
        return np.asarray([str(x) for x in a])
    return a
