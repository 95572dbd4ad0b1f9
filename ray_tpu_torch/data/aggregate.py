"""Aggregation functions for groupby/global aggregates.

Parity: ``python/ray/data/aggregate.py`` (AggregateFn with
init/accumulate/merge/finalize; built-ins Count, Sum, Min, Max, Mean, Std,
Unique).  Accumulation is vectorized over numpy columns — per-block partial
aggregates run inside remote map tasks; merge/finalize run in the reduce
stage.

The port's copy of ``ray_tpu/data/aggregate.py``: the same behaviour, imports
renamed to ``ray_tpu_torch``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.data.block import Block, BlockAccessor


class AggregateFn:
    def __init__(
        self,
        init: Callable[[], Any],
        accumulate_block: Callable[[Any, Block], Any],
        merge: Callable[[Any, Any], Any],
        finalize: Callable[[Any], Any],
        name: str,
    ):
        self.init = init
        self.accumulate_block = accumulate_block
        self.merge = merge
        self.finalize = finalize
        self.name = name


class Count(AggregateFn):
    def __init__(self):
        super().__init__(
            init=lambda: 0,
            accumulate_block=lambda a, b: a + BlockAccessor(b).num_rows(),
            merge=lambda a, b: a + b,
            finalize=lambda a: a,
            name="count()",
        )


class _ColumnAgg(AggregateFn):
    def __init__(self, on: str, name: str, init, acc_col, merge, finalize):
        self.on = on
        super().__init__(
            init=init,
            accumulate_block=lambda a, b: merge(a, acc_col(b[on])) if BlockAccessor(b).num_rows() else a,
            merge=merge,
            finalize=finalize,
            name=f"{name}({on})",
        )


class Sum(_ColumnAgg):
    def __init__(self, on: str):
        super().__init__(
            on, "sum",
            init=lambda: 0,
            acc_col=lambda col: col.sum(),
            merge=lambda a, b: a + b,
            finalize=lambda a: _item(a),
        )


class Min(_ColumnAgg):
    def __init__(self, on: str):
        super().__init__(
            on, "min",
            init=lambda: None,
            acc_col=lambda col: col.min(),
            merge=lambda a, b: b if a is None else (a if b is None else min(a, b)),
            finalize=lambda a: _item(a),
        )


class Max(_ColumnAgg):
    def __init__(self, on: str):
        super().__init__(
            on, "max",
            init=lambda: None,
            acc_col=lambda col: col.max(),
            merge=lambda a, b: b if a is None else (a if b is None else max(a, b)),
            finalize=lambda a: _item(a),
        )


class Mean(AggregateFn):
    def __init__(self, on: str):
        self.on = on
        super().__init__(
            init=lambda: (0.0, 0),
            accumulate_block=lambda a, b: (a[0] + float(b[on].sum()), a[1] + len(b[on])) if len(b.get(on, ())) else a,
            merge=lambda a, b: (a[0] + b[0], a[1] + b[1]),
            finalize=lambda a: a[0] / a[1] if a[1] else None,
            name=f"mean({on})",
        )


class Std(AggregateFn):
    """Welford/Chan parallel variance merge (ddof=1, matching the reference)."""

    def __init__(self, on: str, ddof: int = 1):
        self.on = on

        def acc(state, block):
            col = block.get(on)
            if col is None or not len(col):
                return state
            n2, m2_mean, m2 = len(col), float(col.mean()), float(((col - col.mean()) ** 2).sum())
            return _chan_merge(state, (n2, m2_mean, m2))

        super().__init__(
            init=lambda: (0, 0.0, 0.0),
            accumulate_block=acc,
            merge=_chan_merge,
            finalize=lambda s: float(np.sqrt(s[2] / (s[0] - ddof))) if s[0] > ddof else None,
            name=f"std({on})",
        )


class Unique(AggregateFn):
    def __init__(self, on: str):
        self.on = on
        super().__init__(
            init=lambda: set(),
            accumulate_block=lambda a, b: a | set(_tolist(b[on])) if len(b.get(on, ())) else a,
            merge=lambda a, b: a | b,
            finalize=lambda a: sorted(a),
            name=f"unique({on})",
        )


def _chan_merge(a, b):
    n1, mean1, m2_1 = a
    n2, mean2, m2_2 = b
    if n1 == 0:
        return b
    if n2 == 0:
        return a
    n = n1 + n2
    delta = mean2 - mean1
    mean = mean1 + delta * n2 / n
    m2 = m2_1 + m2_2 + delta * delta * n1 * n2 / n
    return (n, mean, m2)


def _item(v):
    return v.item() if isinstance(v, np.generic) else v


def _tolist(col: np.ndarray) -> list:
    return [_item(v) for v in col]
