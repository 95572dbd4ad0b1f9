"""Physical operators + StreamingExecutor.

Parity: ``python/ray/data/_internal/execution/`` — physical operators
(``operators/map_operator.py``, ``task_pool_map_operator.py``,
``actor_pool_map_operator.py``, ``limit_operator.py``, ``union``, ``zip``,
all-to-all) driven by a streaming scheduling loop
(``streaming_executor.py:48``; op-selection policy
``streaming_executor_state.py:503 select_operator_to_run``) under
backpressure policies (``backpressure_policy/``) and resource budgets
(``resource_manager.py``).

Execution model: every operator transforms a stream of **RefBundles**
(object refs to blocks + metadata).  Map-like operators launch remote tasks
(or dispatch to an actor pool for class-based UDFs); all-to-all operators
are barriers that run the two-stage exchange in ``shuffle.py``.  The
executor repeatedly picks the runnable operator with the smallest queued
output (pull-based backpressure) so the pipeline streams with bounded
memory instead of materializing every stage.

The port's copy of ``ray_tpu/data/executor.py``: the same operators,
planner and stats. One difference, a repair of the JAX package's: a map
stage's ``num_gpus`` goes into its task's or actor's resources. A
``_MapWorker`` that asks for a GPU is therefore an in-process GPU actor
(the runtime's rule for GPU actors), and a task-pool map that asks for one
runs ``execution="thread"`` next to the card; a process worker hides the
card. The JAX package drops an actor pool's ``num_tpus`` and sends a
task-pool map's through adaptive tiering into CPU-only workers, so its
batch inference never reaches the chip. ``num_tpus`` keeps the JAX meaning,
and a map without ``num_gpus`` runs as it does there.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import (
    Block,
    BlockAccessor,
    BlockMetadata,
    block_from_rows,
    concat_blocks,
    normalize_block,
    split_block,
)
from ray_tpu_torch.data import logical as L


@dataclass
class RefBundle:
    """A group of block refs + their metadata (parity: interfaces.py RefBundle)."""

    refs: List[Any]
    metadata: List[BlockMetadata]

    def num_rows(self) -> int:
        return sum(m.num_rows for m in self.metadata)

    def size_bytes(self) -> int:
        return sum(m.size_bytes for m in self.metadata)


# --------------------------------------------------------------------------
# Map transform chains (what actually runs inside the remote task)
# --------------------------------------------------------------------------
def _apply_stage(stage: L.AbstractMap, blocks: List[Block], udf) -> List[Block]:
    kind = stage.kind
    out: List[Block] = []
    if kind == "map_batches":
        for b in blocks:
            if stage.batch_size is None:
                batches = [b]
            else:
                acc = BlockAccessor(b)
                n = acc.num_rows()
                batches = [acc.slice(i, min(i + stage.batch_size, n)) for i in range(0, n, stage.batch_size)] or []
            for batch in batches:
                fmt = _format_batch(batch, stage.batch_format)
                result = udf(fmt, *stage.fn_args, **stage.fn_kwargs)
                out.append(normalize_block(result))
    elif kind == "map_rows":
        for b in blocks:
            rows = [udf(r, *stage.fn_args, **stage.fn_kwargs) for r in BlockAccessor(b).iter_rows()]
            out.append(block_from_rows(rows))
    elif kind == "filter":
        for b in blocks:
            acc = BlockAccessor(b)
            keep = np.asarray([bool(udf(r)) for r in acc.iter_rows()])
            out.append(acc.take(np.nonzero(keep)[0]) if len(keep) else b)
    elif kind == "flat_map":
        for b in blocks:
            rows = []
            for r in BlockAccessor(b).iter_rows():
                rows.extend(udf(r))
            out.append(block_from_rows(rows))
    else:  # pragma: no cover
        raise ValueError(kind)
    return out


def _format_batch(batch: Block, batch_format: str):
    if batch_format in ("numpy", "default", None):
        return dict(batch)
    if batch_format == "pandas":
        return BlockAccessor(batch).to_pandas()
    if batch_format == "pyarrow":
        return BlockAccessor(batch).to_arrow()
    raise ValueError(f"unknown batch_format {batch_format!r}")


def _run_map_chain(stages: List[L.AbstractMap], udfs: List[Any], block: Block) -> Tuple[Block, BlockMetadata]:
    t0 = time.perf_counter()
    c0 = time.process_time()
    blocks = [block]
    for stage, udf in zip(stages, udfs):
        blocks = _apply_stage(stage, blocks, udf)
    merged = concat_blocks(blocks)
    meta = BlockAccessor(merged).get_metadata(
        exec_time_s=time.perf_counter() - t0, cpu_time_s=time.process_time() - c0
    )
    return merged, meta


# --------------------------------------------------------------------------
# Physical operators
# --------------------------------------------------------------------------
class PhysicalOperator:
    def __init__(self, name: str, input_ops: List["PhysicalOperator"]):
        self.name = name
        self.input_ops = input_ops
        self.inqueues: List[deque] = [deque() for _ in input_ops] or [deque()]
        self.outqueue: deque = deque()
        self.inputs_done: List[bool] = [False for _ in (input_ops or [None])]
        self._completed = False
        self.rows_out = 0
        self.bytes_out = 0
        self.task_time_s = 0.0
        self.cpu_time_s = 0.0
        self.num_tasks = 0
        # per-task/per-block samples for the reference-style stats report
        # (wall/cpu per task, rows/bytes per output block)
        self.wall_samples: List[float] = []
        self.cpu_samples: List[float] = []
        self.row_samples: List[int] = []
        self.byte_samples: List[int] = []
        # DataContext.preserve_order (reference ExecutionOptions.preserve_order):
        # parallel map tasks finish out of order; when set, operators release
        # outputs in DISPATCH order through _emit instead of completion order
        from ray_tpu_torch.data.context import DataContext

        self._preserve_order = DataContext.get_current().preserve_order
        self._seq_counter = 0
        self._next_seq_out = 0
        self._pending_ordered: Dict[int, RefBundle] = {}

    def _next_seq(self) -> int:
        seq = self._seq_counter
        self._seq_counter += 1
        return seq

    def queued_output_count(self) -> int:
        """Finished-but-unconsumed bundles: visible outqueue plus any
        preserve_order hold-back (both are materialized memory)."""
        return len(self.outqueue) + len(self._pending_ordered)

    def queued_output_bytes(self) -> int:
        return sum(b.size_bytes() for b in self.outqueue) + sum(
            b.size_bytes() for b in self._pending_ordered.values()
        )

    def _emit(self, seq: int, bundle: RefBundle) -> None:
        """Release one task's output, reordering to dispatch order when
        preserve_order is set (a missing seq can only be a still-active
        task, so the hold-back always drains)."""
        if not self._preserve_order:
            self.outqueue.append(bundle)
            return
        self._pending_ordered[seq] = bundle
        while self._next_seq_out in self._pending_ordered:
            self.outqueue.append(self._pending_ordered.pop(self._next_seq_out))
            self._next_seq_out += 1

    def record_task_meta(self, meta) -> None:
        """One finished task's BlockMetadata -> stats samples."""
        self.task_time_s += meta.exec_time_s
        self.cpu_time_s += getattr(meta, "cpu_time_s", 0.0)
        self.wall_samples.append(meta.exec_time_s)
        self.cpu_samples.append(getattr(meta, "cpu_time_s", 0.0))

    # -- stream protocol
    def add_input(self, bundle: RefBundle, input_index: int = 0) -> None:
        self.inqueues[input_index].append(bundle)

    def input_done(self, input_index: int = 0) -> None:
        self.inputs_done[input_index] = True

    def all_inputs_done(self) -> bool:
        return all(self.inputs_done)

    def has_next(self) -> bool:
        return bool(self.outqueue)

    def get_next(self) -> RefBundle:
        bundle = self.outqueue.popleft()
        rows, nbytes = bundle.num_rows(), bundle.size_bytes()
        self.rows_out += rows
        self.bytes_out += nbytes
        self.row_samples.append(rows)
        self.byte_samples.append(nbytes)
        return bundle

    # -- scheduling hooks
    def num_active_tasks(self) -> int:
        return 0

    def can_dispatch(self) -> bool:
        return any(self.inqueues)

    def dispatch(self) -> List[Any]:
        """Launch work; returns refs the executor should wait on."""
        return []

    def on_task_done(self, ref: Any) -> None:
        pass

    def completed(self) -> bool:
        return (
            self._completed
            or (self.all_inputs_done() and not any(self.inqueues) and self.num_active_tasks() == 0)
        )

    def shutdown(self) -> None:
        pass


class InputDataBuffer(PhysicalOperator):
    """Source operator holding pre-created bundles (reads or materialized blocks)."""

    def __init__(self, bundles: List[RefBundle]):
        super().__init__("Input", [])
        self.outqueue.extend(bundles)
        self.inputs_done = [True]

    def completed(self) -> bool:
        return not self.outqueue


class TaskPoolMapOperator(PhysicalOperator):
    """Map via stateless remote tasks (parity: task_pool_map_operator.py)."""

    def __init__(self, stages: List[L.AbstractMap], input_op: PhysicalOperator, *, max_concurrency: int = 16):
        name = "->".join(s.name for s in stages)
        super().__init__(name, [input_op])
        self.stages = stages
        self.max_concurrency = max_concurrency
        self._active: Dict[Any, Tuple[Any, int]] = {}  # meta_ref -> (block_ref, seq)
        stages_ser = list(stages)
        udfs = [s.fn for s in stages]
        resources = {"CPU": max(s.num_cpus for s in stages)}
        if any(s.num_tpus for s in stages):
            resources["TPU"] = max(s.num_tpus for s in stages)
        options = {}
        num_gpus = max(s.num_gpus for s in stages)
        if num_gpus:
            resources["GPU"] = num_gpus
            options["execution"] = "thread"  # a process worker hides the card

        @ray_tpu_torch.remote
        def map_task(block: Block):
            return _run_map_chain(stages_ser, udfs, block)

        self._map_task = map_task.options(num_returns=2, resources=resources, **options)

    def num_active_tasks(self) -> int:
        return len(self._active)

    def can_dispatch(self) -> bool:
        return bool(self.inqueues[0]) and len(self._active) < self.max_concurrency

    def dispatch(self) -> List[Any]:
        bundle = self.inqueues[0].popleft()
        waits = []
        for ref in bundle.refs:
            block_ref, meta_ref = self._map_task.remote(ref)
            self._active[meta_ref] = (block_ref, self._next_seq())
            waits.append(meta_ref)
            self.num_tasks += 1
        return waits

    def on_task_done(self, meta_ref: Any) -> None:
        block_ref, seq = self._active.pop(meta_ref)
        meta = ray_tpu_torch.get(meta_ref)
        self.record_task_meta(meta)
        self._emit(seq, RefBundle([block_ref], [meta]))


class ActorPoolMapOperator(PhysicalOperator):
    """Map via a pool of stateful actors for class-based UDFs
    (parity: actor_pool_map_operator.py; ``compute=ActorPoolStrategy``)."""

    def __init__(self, stages: List[L.AbstractMap], input_op: PhysicalOperator, *, pool_size: int = 2):
        name = "->".join(s.name for s in stages) + f"[actors={pool_size}]"
        super().__init__(name, [input_op])
        self.stages = stages
        stages_ser = list(stages)

        @ray_tpu_torch.remote
        class _MapWorker:
            def __init__(self):
                self._udfs = [
                    s.fn(*s.fn_constructor_args, **s.fn_constructor_kwargs)
                    if isinstance(s.fn, type)
                    else s.fn
                    for s in stages_ser
                ]

            def run(self, block: Block):
                return _run_map_chain(stages_ser, self._udfs, block)

        num_gpus = max(s.num_gpus for s in stages)
        worker = _MapWorker.options(num_gpus=num_gpus) if num_gpus else _MapWorker
        self._actors = [worker.remote() for _ in range(pool_size)]
        self._load = {i: 0 for i in range(pool_size)}
        self._active: Dict[Any, Tuple[Any, int, int]] = {}  # (block_ref, actor, seq)
        self.max_tasks_per_actor = 2

    def num_active_tasks(self) -> int:
        return len(self._active)

    def can_dispatch(self) -> bool:
        return bool(self.inqueues[0]) and min(self._load.values()) < self.max_tasks_per_actor

    def dispatch(self) -> List[Any]:
        bundle = self.inqueues[0].popleft()
        waits = []
        for ref in bundle.refs:
            idx = min(self._load, key=self._load.get)
            self._load[idx] += 1
            block_ref, meta_ref = self._actors[idx].run.options(num_returns=2).remote(ref)
            self._active[meta_ref] = (block_ref, idx, self._next_seq())
            waits.append(meta_ref)
            self.num_tasks += 1
        return waits

    def on_task_done(self, meta_ref: Any) -> None:
        block_ref, idx, seq = self._active.pop(meta_ref)
        self._load[idx] -= 1
        meta = ray_tpu_torch.get(meta_ref)
        self.record_task_meta(meta)
        self._emit(seq, RefBundle([block_ref], [meta]))

    def shutdown(self) -> None:
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass


class LimitOperator(PhysicalOperator):
    """Truncates the stream after N rows (parity: limit_operator.py)."""

    def __init__(self, limit: int, input_op: PhysicalOperator):
        super().__init__(f"Limit[{limit}]", [input_op])
        self.limit = limit
        self.taken = 0

    def can_dispatch(self) -> bool:
        return bool(self.inqueues[0])

    def dispatch(self) -> List[Any]:
        bundle = self.inqueues[0].popleft()
        if self.taken >= self.limit:
            return []
        remaining = self.limit - self.taken
        if bundle.num_rows() <= remaining:
            self.taken += bundle.num_rows()
            self.outqueue.append(bundle)
            return []
        # Need to slice: fetch and truncate.
        out_refs, out_meta = [], []
        for ref, meta in zip(bundle.refs, bundle.metadata):
            if remaining <= 0:
                break
            take = min(meta.num_rows, remaining)
            if take == meta.num_rows:
                out_refs.append(ref)
                out_meta.append(meta)
            else:
                block = ray_tpu_torch.get(ref)
                sliced = BlockAccessor(block).slice(0, take)
                out_refs.append(ray_tpu_torch.put(sliced))
                out_meta.append(BlockAccessor(sliced).get_metadata())
            remaining -= take
        self.taken = self.limit
        self.outqueue.append(RefBundle(out_refs, out_meta))
        return []

    def completed(self) -> bool:
        return super().completed() or (self.taken >= self.limit and not self.outqueue)


class UnionOperator(PhysicalOperator):
    def __init__(self, input_ops: List[PhysicalOperator]):
        super().__init__("Union", input_ops)

    def can_dispatch(self) -> bool:
        return any(self.inqueues)

    def dispatch(self) -> List[Any]:
        for q in self.inqueues:
            while q:
                self.outqueue.append(q.popleft())
        return []


class ZipOperator(PhysicalOperator):
    """Barrier: materializes both sides then zips columns
    (parity: zip_operator.py)."""

    def __init__(self, left: PhysicalOperator, right: PhysicalOperator):
        super().__init__("Zip", [left, right])

    def can_dispatch(self) -> bool:
        return self.all_inputs_done() and any(self.inqueues)

    def dispatch(self) -> List[Any]:
        left_refs = [r for b in self.inqueues[0] for r in b.refs]
        right_refs = [r for b in self.inqueues[1] for r in b.refs]
        self.inqueues[0].clear()
        self.inqueues[1].clear()
        left = concat_blocks(ray_tpu_torch.get(left_refs)) if left_refs else {}
        right = concat_blocks(ray_tpu_torch.get(right_refs)) if right_refs else {}
        merged = dict(left)
        for k, v in right.items():
            merged[k + "_1" if k in merged else k] = v
        ref = ray_tpu_torch.put(merged)
        self.outqueue.append(RefBundle([ref], [BlockAccessor(merged).get_metadata()]))
        return []


class AllToAllOperator(PhysicalOperator):
    """Barrier operator running the two-stage exchange (sort/groupby/
    shuffle/repartition) once all input bundles arrive."""

    def __init__(self, logical_op: L.LogicalOp, input_op: PhysicalOperator, *, default_parallelism: int = 8):
        super().__init__(logical_op.name, [input_op])
        self.logical_op = logical_op
        self.default_parallelism = default_parallelism
        self._ran = False

    def can_dispatch(self) -> bool:
        return self.all_inputs_done() and not self._ran

    def num_active_tasks(self) -> int:
        return 0

    def completed(self) -> bool:
        return self._ran and not self.outqueue

    def dispatch(self) -> List[Any]:
        from ray_tpu_torch.data.shuffle import run_exchange

        bundles = [b for q in self.inqueues for b in q]
        self.inqueues[0].clear()
        in_refs = [r for b in bundles for r in b.refs]
        self._ran = True
        if not in_refs:
            return []
        op = self.logical_op
        n_in = len(in_refs)
        if isinstance(op, L.Sort):
            refs, metas = run_exchange(in_refs, kind="sort", n_parts=n_in, key=op.key, descending=op.descending)
        elif isinstance(op, L.Aggregate):
            refs, metas = run_exchange(
                in_refs, kind="groupby", n_parts=min(n_in, self.default_parallelism), key=op.key, aggs=op.aggs
            )
        elif isinstance(op, L.RandomShuffle):
            refs, metas = run_exchange(in_refs, kind="shuffle", n_parts=n_in, seed=op.seed)
        elif isinstance(op, L.Repartition):
            kind = "shuffle" if op.shuffle else "repartition"
            refs, metas = run_exchange(in_refs, kind=kind, n_parts=op.num_blocks, seed=0)
        else:  # pragma: no cover
            raise ValueError(op)
        self.num_tasks += n_in + len(refs)
        for r, m in zip(refs, metas):
            self.outqueue.append(RefBundle([r], [m]))
        return []


class ReadOperator(PhysicalOperator):
    """Executes ReadTasks as remote tasks (parity: plan_read_op.py — reads
    are just map tasks from task descriptors to blocks)."""

    def __init__(self, read_tasks: List[Any], *, max_concurrency: int = 16):
        super().__init__("Read", [])
        self.inputs_done = [True]
        self._pending = deque(read_tasks)
        self._active: Dict[Any, Tuple[Any, int]] = {}  # meta_ref -> (block_ref, seq)
        self.max_concurrency = max_concurrency

        @ray_tpu_torch.remote
        def do_read(task):
            t0 = time.perf_counter()
            blocks = [normalize_block(b) for b in task()]
            merged = concat_blocks(blocks)
            meta = BlockAccessor(merged).get_metadata(
                input_files=task.metadata.input_files, exec_time_s=time.perf_counter() - t0
            )
            return merged, meta

        self._do_read = do_read.options(num_returns=2)

    def num_active_tasks(self) -> int:
        return len(self._active)

    def can_dispatch(self) -> bool:
        return bool(self._pending) and len(self._active) < self.max_concurrency

    def dispatch(self) -> List[Any]:
        task = self._pending.popleft()
        block_ref, meta_ref = self._do_read.remote(task)
        self._active[meta_ref] = (block_ref, self._next_seq())
        self.num_tasks += 1
        return [meta_ref]

    def on_task_done(self, meta_ref: Any) -> None:
        block_ref, seq = self._active.pop(meta_ref)
        meta = ray_tpu_torch.get(meta_ref)
        self.record_task_meta(meta)
        self._emit(seq, RefBundle([block_ref], [meta]))

    def completed(self) -> bool:
        return (
            not self._pending
            and not self._active
            and not self.outqueue
            and not self._pending_ordered
        )


class WriteOperator(PhysicalOperator):
    """Collects blocks and writes via the datasource (driver-side finalize)."""

    def __init__(self, logical_op: L.Write, input_op: PhysicalOperator):
        super().__init__(f"Write{logical_op.datasource.get_name()}", [input_op])
        self.logical_op = logical_op

    def can_dispatch(self) -> bool:
        return self.all_inputs_done() and any(self.inqueues)

    def dispatch(self) -> List[Any]:
        refs = [r for b in self.inqueues[0] for r in b.refs]
        self.inqueues[0].clear()
        blocks = [b for b in ray_tpu_torch.get(refs) if b]
        op = self.logical_op
        op.datasource.write(blocks, op.path, **op.write_kwargs)
        out = block_from_rows([{"num_blocks_written": len(blocks)}])
        self.outqueue.append(RefBundle([ray_tpu_torch.put(out)], [BlockAccessor(out).get_metadata()]))
        return []


# --------------------------------------------------------------------------
# Planner: logical -> physical
# --------------------------------------------------------------------------
def plan(op: L.LogicalOp, ctx) -> PhysicalOperator:
    """Map the optimized logical DAG to physical operators
    (parity: _internal/planner/planner.py)."""
    if isinstance(op, L.Read):
        parallelism = op.parallelism if op.parallelism > 0 else ctx.read_parallelism
        tasks = op.datasource.get_read_tasks(parallelism)
        return ReadOperator(tasks, max_concurrency=ctx.max_tasks_in_flight)
    if isinstance(op, L.InputData):
        bundles = [RefBundle([r], [m]) for r, m in zip(op.refs, op.metadata)]
        return InputDataBuffer(bundles)
    if isinstance(op, (L.FusedMap, L.AbstractMap)):
        upstream = plan(op.inputs[0], ctx)
        stages = op.stages if isinstance(op, L.FusedMap) else [op]
        # compute=ActorPoolStrategy forces the actor pool even for plain
        # function UDFs (parity: ActorPoolStrategy on map_batches); class
        # UDFs always need it (stateful constructors)
        strategy = next(
            (s.compute for s in stages if getattr(s, "compute", None) is not None), None
        )
        if any(isinstance(s.fn, type) for s in stages) or strategy is not None:
            strategy_size = getattr(strategy, "size", None) or getattr(
                strategy, "min_size", None
            )
            conc = op.concurrency
            pool = conc if isinstance(conc, int) else (conc[0] if conc else None)
            return ActorPoolMapOperator(
                stages, upstream, pool_size=pool or strategy_size or 2
            )
        return TaskPoolMapOperator(stages, upstream, max_concurrency=ctx.max_tasks_in_flight)
    if isinstance(op, L.Limit):
        return LimitOperator(op.limit, plan(op.inputs[0], ctx))
    if isinstance(op, L.Union):
        return UnionOperator([plan(i, ctx) for i in op.inputs])
    if isinstance(op, L.Zip):
        return ZipOperator(plan(op.inputs[0], ctx), plan(op.inputs[1], ctx))
    if isinstance(op, (L.Sort, L.Aggregate, L.RandomShuffle, L.Repartition)):
        return AllToAllOperator(op, plan(op.inputs[0], ctx), default_parallelism=ctx.read_parallelism)
    if isinstance(op, L.Write):
        return WriteOperator(op, plan(op.inputs[0], ctx))
    raise ValueError(f"cannot plan {op!r}")


# --------------------------------------------------------------------------
# Streaming executor
# --------------------------------------------------------------------------
class StreamingExecutor:
    """The scheduling loop (parity: streaming_executor.py:48).

    Streams RefBundles through the operator topology; dispatches work on the
    operator with the smallest queued output among runnable ops (the
    reference's ``select_operator_to_run`` memory-pressure heuristic), and
    yields output bundles as soon as the sink produces them.
    """

    def __init__(self, root: PhysicalOperator, ctx):
        self.root = root
        self.ctx = ctx
        self.topology = self._topo_order(root)
        self._waits: Dict[Any, PhysicalOperator] = {}
        self._t_start = time.perf_counter()

    def _topo_order(self, root: PhysicalOperator) -> List[PhysicalOperator]:
        order: List[PhysicalOperator] = []
        seen = set()

        def visit(op):
            if id(op) in seen:
                return
            seen.add(id(op))
            for i in op.input_ops:
                visit(i)
            order.append(op)

        visit(root)
        return order

    def _pump(self) -> None:
        """Move outputs downstream; propagate done-ness."""
        for op in self.topology:
            for consumer in self.topology:
                for idx, producer in enumerate(consumer.input_ops):
                    if producer is op:
                        while op is not self.root and op.has_next():
                            consumer.add_input(op.get_next(), idx)
                        if op.completed():
                            consumer.inputs_done[idx] = True

    def _select_and_dispatch(self) -> bool:
        # ExecutionOptions.resource_limits: cap in-flight task count (cpu)
        # and finished-but-unconsumed bytes (object_store_memory) across the
        # whole topology before considering any further dispatch
        limits = self.ctx.execution_options.resource_limits
        if limits.cpu is not None and sum(
            o.num_active_tasks() for o in self.topology
        ) >= limits.cpu:
            return False
        if limits.object_store_memory is not None and sum(
            o.queued_output_bytes() for o in self.topology
        ) >= limits.object_store_memory:
            return False
        runnable = [op for op in self.topology if op.can_dispatch()]
        if not runnable:
            return False
        # Prefer the op with the least queued output (backpressure), with
        # downstream position as tie-break so data drains toward the sink.
        op = min(runnable, key=lambda o: (o.queued_output_count(), -self.topology.index(o)))
        # Output backpressure: don't let any op run far ahead of its consumer.
        # queued_output_count includes the preserve_order hold-back buffer —
        # blocks parked behind a slow head-of-line task are finished memory
        # and must throttle dispatch exactly like visible outqueue bundles.
        if op.queued_output_count() > self.ctx.max_outqueue_bundles and op is not self.root:
            return False
        for ref in op.dispatch():
            self._waits[ref] = op
        return True

    def run(self) -> Iterator[RefBundle]:
        while True:
            self._pump()
            while self.root.has_next():
                yield self.root.get_next()
            if self.root.completed():
                break
            progressed = self._select_and_dispatch()
            if self._waits:
                ready, _ = ray_tpu_torch.wait(list(self._waits.keys()), num_returns=1, timeout=0.05 if progressed else 1.0)
                for ref in ready:
                    op = self._waits.pop(ref)
                    op.on_task_done(ref)
            elif not progressed:
                self._pump()
                while self.root.has_next():
                    yield self.root.get_next()
                if self.root.completed():
                    break
                time.sleep(0.001)
        for op in self.topology:
            op.shutdown()

    def stats(self) -> "ExecutorStats":
        return ExecutorStats(
            [
                OpStats(
                    op.name, op.num_tasks, op.rows_out, op.bytes_out,
                    op.task_time_s, op.cpu_time_s,
                    list(op.wall_samples), list(op.cpu_samples),
                    list(op.row_samples), list(op.byte_samples),
                )
                for op in self.topology
            ],
            wall_s=time.perf_counter() - self._t_start if self._t_start else 0.0,
        )


# Recent dataset executions (name, wall-clock, per-op stats) for the
# dashboard's Data panel — bounded ring, newest last.
_recent_executions: deque = deque(maxlen=50)
_recent_lock = threading.Lock()


def record_execution(name: str, stats: "ExecutorStats") -> None:
    with _recent_lock:
        _recent_executions.append({"name": name, "ts": time.time(), "stats": stats})


def recent_executions() -> List[dict]:
    with _recent_lock:
        items = list(_recent_executions)
    return [
        {
            "name": it["name"],
            "ts": it["ts"],
            "wall_s": round(it["stats"].wall_s, 4),
            "ops": [
                {
                    "name": op.name,
                    "num_tasks": op.num_tasks,
                    "rows_out": op.rows_out,
                    "bytes_out": op.bytes_out,
                    "task_time_s": round(op.task_time_s, 4),
                    "cpu_time_s": round(op.cpu_time_s, 4),
                }
                for op in it["stats"].ops
            ],
        }
        for it in items
    ]


def _mmmt(samples, fmt) -> str:
    """min/max/mean/total line in the reference's stats format."""
    if not samples:
        return "none"
    return (
        f"{fmt(min(samples))} min, {fmt(max(samples))} max, "
        f"{fmt(sum(samples) / len(samples))} mean, {fmt(sum(samples))} total"
    )


def _t(v: float) -> str:
    return f"{v * 1000:.2f}ms" if v < 1 else f"{v:.2f}s"


def _b(v) -> str:
    v = float(v)
    for unit in ("B", "KB", "MB", "GB"):
        if v < 1024 or unit == "GB":
            return f"{v:.1f}{unit}" if unit != "B" else f"{int(v)}B"
        v /= 1024
    return f"{v:.1f}GB"


@dataclass
class OpStats:
    name: str
    num_tasks: int
    rows_out: int
    bytes_out: int
    task_time_s: float
    cpu_time_s: float = 0.0
    wall_samples: List[float] = field(default_factory=list)
    cpu_samples: List[float] = field(default_factory=list)
    row_samples: List[int] = field(default_factory=list)
    byte_samples: List[int] = field(default_factory=list)


@dataclass
class ExecutorStats:
    ops: List[OpStats]
    wall_s: float = 0.0

    def summary(self) -> str:
        """Per-operator report in the reference's format
        (``python/ray/data/_internal/stats.py`` to_summary — 'Operator N
        <name>: ...' with remote wall/cpu time and output rows/bytes as
        min/max/mean/total lines)."""
        lines = []
        for i, op in enumerate(self.ops):
            blocks = len(op.row_samples)
            lines.append(
                f"Operator {i} {op.name}: {op.num_tasks} tasks executed, "
                f"{blocks} blocks produced"
            )
            if op.wall_samples:
                lines.append(f"* Remote wall time: {_mmmt(op.wall_samples, _t)}")
            if any(op.cpu_samples):
                lines.append(f"* Remote cpu time: {_mmmt(op.cpu_samples, _t)}")
            if op.row_samples:
                lines.append(
                    f"* Output num rows per block: {_mmmt(op.row_samples, lambda v: str(int(v)))}"
                )
            if op.byte_samples:
                lines.append(f"* Output size bytes per block: {_mmmt(op.byte_samples, _b)}")
            lines.append("")
        if self.wall_s:
            lines.append(f"Dataset execution time: {_t(self.wall_s)}")
        return "\n".join(lines).rstrip()


# --------------------------------------------------------------------------
# Training feed: RefBundles -> one deterministic feature matrix
# --------------------------------------------------------------------------
def bundles_to_feature_rows(bundles: Iterator[RefBundle]) -> np.ndarray:
    """Materialize an ORDERED RefBundle stream into one ``[N, F]`` float32
    feature matrix — the global row order elastic training batches index
    into (``train/controller.py global_batch``).

    Columns are flattened in sorted-name order (scalars contribute one
    feature, fixed-width vectors their width), so the matrix — and with it
    every training batch — is a pure function of the dataset contents,
    independent of block boundaries or gang size.  Pass the result of
    ``dataset._execute(preserve_order=True)`` so block order matches the
    logical row order."""
    feature_blocks: List[np.ndarray] = []
    for bundle in bundles:
        for ref in bundle.refs:
            block = normalize_block(ray_tpu_torch.get(ref))
            if not block:
                continue
            cols = []
            for name in sorted(block):
                col = np.asarray(block[name])
                if col.dtype == object:
                    raise TypeError(
                        f"column {name!r} is not numeric; the training feed "
                        "needs numeric features"
                    )
                cols.append(col.reshape(col.shape[0], -1).astype(np.float32))
            feature_blocks.append(np.concatenate(cols, axis=1))
    if not feature_blocks:
        raise ValueError("dataset produced no rows to train on")
    return np.ascontiguousarray(np.concatenate(feature_blocks, axis=0))
