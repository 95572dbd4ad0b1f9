"""Logical plan: declarative operator DAG built by Dataset transformations.

Parity: ``python/ray/data/_internal/logical/`` — Datasets accumulate logical
operators lazily; a rule-based optimizer (``optimizers.py``) rewrites the
plan (map fusion, limit pushdown) before planning physical execution.

The port's copy of ``ray_tpu/data/logical.py``: the same operators and
rules; a map also carries ``num_gpus`` (the GPUs its task or actor asks
for), which fusion takes the larger of, as it does ``num_tpus``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union


class LogicalOp:
    """A node in the logical DAG.  ``inputs`` are upstream LogicalOps."""

    name = "Op"

    def __init__(self, inputs: List["LogicalOp"]):
        self.inputs = inputs

    def __repr__(self) -> str:
        return f"{self.name}"


class Read(LogicalOp):
    name = "Read"

    def __init__(self, datasource, parallelism: int = -1):
        super().__init__([])
        self.datasource = datasource
        self.parallelism = parallelism

    def __repr__(self) -> str:
        return f"Read{self.datasource.get_name()}"


class InputData(LogicalOp):
    """Already-materialized block refs injected into a plan."""

    name = "InputData"

    def __init__(self, refs: List[Any], metadata: List[Any]):
        super().__init__([])
        self.refs = refs
        self.metadata = metadata


class AbstractMap(LogicalOp):
    """Any row/batch-wise transform — fusable with its upstream map.

    ``kind`` is one of: map_rows, map_batches, filter, flat_map.
    """

    def __init__(
        self,
        input_op: LogicalOp,
        kind: str,
        fn: Callable,
        *,
        fn_args: tuple = (),
        fn_kwargs: Optional[dict] = None,
        batch_size: Optional[int] = None,
        batch_format: str = "numpy",
        compute: Optional[Any] = None,
        num_cpus: float = 1,
        num_tpus: float = 0,
        num_gpus: float = 0,
        concurrency: Optional[Union[int, Tuple[int, int]]] = None,
        fn_constructor_args: tuple = (),
        fn_constructor_kwargs: Optional[dict] = None,
    ):
        super().__init__([input_op])
        self.kind = kind
        self.fn = fn
        self.fn_args = fn_args
        self.fn_kwargs = fn_kwargs or {}
        self.batch_size = batch_size
        self.batch_format = batch_format
        self.compute = compute
        self.num_cpus = num_cpus
        self.num_tpus = num_tpus
        self.num_gpus = num_gpus
        self.concurrency = concurrency
        self.fn_constructor_args = fn_constructor_args
        self.fn_constructor_kwargs = fn_constructor_kwargs or {}

    @property
    def name(self) -> str:  # type: ignore[override]
        base = {"map_rows": "Map", "map_batches": "MapBatches", "filter": "Filter", "flat_map": "FlatMap"}[self.kind]
        fn_name = getattr(self.fn, "__name__", type(self.fn).__name__)
        return f"{base}({fn_name})"

    def uses_actors(self) -> bool:
        return self.concurrency is not None and not callable(self.fn) is False and isinstance(self.fn, type)


class FusedMap(AbstractMap):
    """Result of fusing a chain of maps (optimizer output)."""

    def __init__(self, stages: List[AbstractMap]):
        first = stages[0]
        LogicalOp.__init__(self, first.inputs)
        self.stages = stages
        self.kind = "fused"
        self.batch_size = next((s.batch_size for s in stages if s.batch_size), None)
        self.num_cpus = max(s.num_cpus for s in stages)
        self.num_tpus = max(s.num_tpus for s in stages)
        self.num_gpus = max(s.num_gpus for s in stages)
        self.concurrency = next((s.concurrency for s in stages if s.concurrency is not None), None)
        self.fn = None

    @property
    def name(self) -> str:  # type: ignore[override]
        return "->".join(s.name for s in self.stages)


class Limit(LogicalOp):
    name = "Limit"

    def __init__(self, input_op: LogicalOp, limit: int):
        super().__init__([input_op])
        self.limit = limit


class Repartition(LogicalOp):
    name = "Repartition"

    def __init__(self, input_op: LogicalOp, num_blocks: int, shuffle: bool = False):
        super().__init__([input_op])
        self.num_blocks = num_blocks
        self.shuffle = shuffle


class RandomShuffle(LogicalOp):
    name = "RandomShuffle"

    def __init__(self, input_op: LogicalOp, seed: Optional[int] = None):
        super().__init__([input_op])
        self.seed = seed


class Sort(LogicalOp):
    name = "Sort"

    def __init__(self, input_op: LogicalOp, key: Union[str, List[str]], descending: bool = False):
        super().__init__([input_op])
        self.key = key
        self.descending = descending


class Aggregate(LogicalOp):
    name = "Aggregate"

    def __init__(self, input_op: LogicalOp, key: Optional[str], aggs: List[Any]):
        super().__init__([input_op])
        self.key = key
        self.aggs = aggs


class Union(LogicalOp):
    name = "Union"

    def __init__(self, inputs: List[LogicalOp]):
        super().__init__(inputs)


class Zip(LogicalOp):
    name = "Zip"

    def __init__(self, left: LogicalOp, right: LogicalOp):
        super().__init__([left, right])


class Write(LogicalOp):
    name = "Write"

    def __init__(self, input_op: LogicalOp, datasource, path: str, write_kwargs: Optional[dict] = None):
        super().__init__([input_op])
        self.datasource = datasource
        self.path = path
        self.write_kwargs = write_kwargs or {}


# --------------------------------------------------------------------------
# Optimizer (parity: _internal/logical/optimizers.py rule passes)
# --------------------------------------------------------------------------
def optimize(op: LogicalOp) -> LogicalOp:
    op = _rewrite(op, _fuse_maps)
    op = _rewrite(op, _push_limit_into_read)
    return op


def _rewrite(op: LogicalOp, rule: Callable[[LogicalOp], LogicalOp]) -> LogicalOp:
    op.inputs = [_rewrite(i, rule) for i in op.inputs]
    return rule(op)


def _fuse_maps(op: LogicalOp) -> LogicalOp:
    """Fuse chains of compatible maps into one stage (MapFusionRule parity).

    Two maps fuse when neither uses a class-based (actor) transform with
    different concurrency and their resource requests are compatible.
    """
    if not isinstance(op, AbstractMap) or isinstance(op, FusedMap):
        return op
    child = op.inputs[0]
    if isinstance(child, FusedMap) and _fusable(child, op):
        child.stages.append(op)
        child.batch_size = child.batch_size or op.batch_size
        child.num_cpus = max(child.num_cpus, op.num_cpus)
        child.num_tpus = max(child.num_tpus, op.num_tpus)
        child.num_gpus = max(child.num_gpus, op.num_gpus)
        return child
    if isinstance(child, AbstractMap) and not isinstance(child, FusedMap) and _fusable(child, op):
        fused = FusedMap([child, op])
        return fused
    return op


def _fusable(a: AbstractMap, b: AbstractMap) -> bool:
    a_conc = getattr(a, "concurrency", None)
    return (a_conc is None) == (b.concurrency is None) and a_conc == b.concurrency


def _push_limit_into_read(op: LogicalOp) -> LogicalOp:
    if isinstance(op, Limit) and isinstance(op.inputs[0], Read):
        read = op.inputs[0]
        read.parallelism = min(read.parallelism, op.limit) if read.parallelism > 0 else read.parallelism
    return op


def plan_to_string(op: LogicalOp, indent: int = 0) -> str:
    lines = [" " * indent + repr(op)]
    for i in op.inputs:
        lines.append(plan_to_string(i, indent + 2))
    return "\n".join(lines)
