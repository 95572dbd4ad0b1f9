"""DataIterator: batched consumption, the device on-ramp.

Parity: ``python/ray/data/iterator.py:68`` (``iter_batches`` :106,
``iter_torch_batches`` :262).

The port's copy of ``ray_tpu/data/iterator.py``: ``iter_batches``,
``iter_rows``, ``iter_torch_batches``, ``to_torch`` and the TensorFlow
paths give the JAX package's outputs. Its flagship path, ``iter_jax_batches``
(host numpy batches staged onto the chip, optionally sharded over a mesh
axis: the Dataset→Train hand-off), becomes :meth:`DataIterator.iter_device_batches`,
which yields CUDA tensors; ``iter_jax_batches`` raises ``NotPortedError``.
The background threads here (``to_torch``'s prefetch pump, and
``Dataset.streaming_split``'s producer) call the runtime, so
``ray_tpu_torch.shutdown`` stops and joins them first (:func:`stop_pumps`):
in the JAX package such a thread's late ``get`` starts a new runtime.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor, concat_blocks


class DataIterator:
    def __init__(self, bundle_iter_factory: Callable[[], Iterator], owner=None):
        self._factory = bundle_iter_factory
        self._owner = owner

    # ------------------------------------------------------------- batches
    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        batch_format: str = "numpy",
        drop_last: bool = False,
        local_shuffle_buffer_size: Optional[int] = None,
        local_shuffle_seed: Optional[int] = None,
    ) -> Iterator[Any]:
        from ray_tpu_torch.data.executor import _format_batch

        def blocks() -> Iterator[Block]:
            for bundle in self._factory():
                for ref in bundle.refs:
                    block = ray_tpu_torch.get(ref)
                    if block and BlockAccessor(block).num_rows():
                        yield block

        source: Iterator[Block] = blocks()
        if local_shuffle_buffer_size:
            source = _shuffle_blocks(source, local_shuffle_buffer_size, local_shuffle_seed)

        carry: Optional[Block] = None
        for block in source:
            if carry:
                block = concat_blocks([carry, block])
                carry = None
            if batch_size is None:
                yield _format_batch(block, batch_format)
                continue
            acc = BlockAccessor(block)
            n = acc.num_rows()
            start = 0
            while n - start >= batch_size:
                yield _format_batch(acc.slice(start, start + batch_size), batch_format)
                start += batch_size
            if start < n:
                carry = acc.slice(start, n)
        if carry and not drop_last and BlockAccessor(carry).num_rows():
            yield _format_batch(carry, batch_format)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for batch in self.iter_batches(batch_size=None, batch_format="numpy"):
            yield from BlockAccessor(batch).iter_rows()

    # ------------------------------------------------------------ device
    def iter_device_batches(
        self,
        *,
        batch_size: int = 256,
        dtypes: Optional[Dict[str, Any]] = None,
        device: Optional[Any] = None,
        sharding: Optional[Any] = None,
        drop_last: bool = True,
        local_shuffle_buffer_size: Optional[int] = None,
    ) -> Iterator[Dict[str, Any]]:
        """Yield batches as tensors on ``device`` (default: CUDA; with no
        device named and no CUDA device this raises), the counterpart of the
        JAX package's ``iter_jax_batches``: the same keywords, ``dtypes``
        holding torch dtypes. With ``sharding`` (``named_sharding(mesh,
        "dp")`` of :mod:`ray_tpu_torch.parallel.mesh`), each rank keeps its
        own block of every batch, as ``JittedStep.shard_batch`` does; the
        block is cut on the host and only it crosses to the device.
        Non-numeric (object) columns stay on the host."""
        import torch

        from ray_tpu_torch.models.common import default_device

        dev = default_device(device, "iter_device_batches")
        if sharding is not None:
            from ray_tpu_torch.parallel.mesh import shard_array

            mesh, spec = sharding
        for batch in self.iter_batches(
            batch_size=batch_size,
            batch_format="numpy",
            drop_last=drop_last,
            local_shuffle_buffer_size=local_shuffle_buffer_size,
        ):
            out = {}
            for k, v in batch.items():
                if v.dtype == object:
                    out[k] = v  # non-numeric columns stay on host
                    continue
                t = torch.from_numpy(np.ascontiguousarray(v))
                if sharding is not None:
                    t = shard_array(t, mesh, *spec)
                out[k] = t.to(device=dev, dtype=(dtypes or {}).get(k, t.dtype))
            yield out

    def iter_jax_batches(self, **kw) -> Iterator[Dict[str, Any]]:
        """JAX arrays: not in the port; :meth:`iter_device_batches` yields
        CUDA tensors under the same keywords."""
        from ray_tpu_torch.exceptions import NotPortedError

        raise NotPortedError("iter_jax_batches (use iter_device_batches for CUDA tensors)",
                             "ray_tpu/data/iterator.py:72")

    def iter_torch_batches(self, *, batch_size: int = 256, drop_last: bool = False, **kw) -> Iterator[Dict[str, Any]]:
        import torch

        for batch in self.iter_batches(batch_size=batch_size, batch_format="numpy", drop_last=drop_last, **kw):
            yield {
                k: torch.from_numpy(np.ascontiguousarray(v)) if v.dtype != object else v
                for k, v in batch.items()
            }

    def iter_tf_batches(self, *, batch_size: int = 256, drop_last: bool = False, **kw) -> Iterator[Dict[str, Any]]:
        """Batches as tf tensors (parity: DataIterator.iter_tf_batches)."""
        import tensorflow as tf

        for batch in self.iter_batches(batch_size=batch_size, batch_format="numpy", drop_last=drop_last, **kw):
            yield {
                k: tf.convert_to_tensor(v) if v.dtype != object else v
                for k, v in batch.items()
            }

    def to_tf(self, feature_columns, label_columns, *, batch_size: int = 256):
        """A tf.data.Dataset over this iterator (parity: Dataset.to_tf):
        yields (features, labels) tuples (single column -> tensor, several
        -> dict of tensors)."""
        import tensorflow as tf

        feats = [feature_columns] if isinstance(feature_columns, str) else list(feature_columns)
        labels = [label_columns] if isinstance(label_columns, str) else list(label_columns)

        def pick(batch, cols):
            if len(cols) == 1:
                return batch[cols[0]]
            return {c: batch[c] for c in cols}

        def fresh():
            for batch in self.iter_tf_batches(batch_size=batch_size):
                yield pick(batch, feats), pick(batch, labels)

        # Probe one batch to build output specs, then hand the SAME
        # iterator (probe batch first) to the first epoch — a single-pass
        # source must not lose its first batch to the spec probe.
        probe_iter = fresh()
        first = next(probe_iter)
        state = {"probe": (probe_iter, first)}

        def gen():
            probe = state.pop("probe", None)
            if probe is not None:
                it, head = probe
                yield head
                yield from it
            else:
                yield from fresh()

        def spec_of(x):
            if isinstance(x, dict):
                return {k: tf.TensorSpec(shape=(None,) + tuple(v.shape[1:]), dtype=v.dtype) for k, v in x.items()}
            return tf.TensorSpec(shape=(None,) + tuple(x.shape[1:]), dtype=x.dtype)

        return tf.data.Dataset.from_generator(
            gen, output_signature=(spec_of(first[0]), spec_of(first[1]))
        )

    def materialize(self):
        if self._owner is not None:
            return self._owner.materialize()
        raise NotImplementedError

    # -------------------------------------------------- metadata + torch
    def schema(self):
        """Schema of the iterated dataset (parity: iterator.py:258) —
        the owner's schema when attached.  Owner-less iterators
        (streaming_split consumers) return None: their source is a
        single-pass queue, and probing a batch to infer dtypes would
        permanently drop those rows from the stream."""
        if self._owner is not None and hasattr(self._owner, "schema"):
            return self._owner.schema()
        return None

    def stats(self) -> str:
        """Execution-timing report (parity: iterator.py:253)."""
        if self._owner is not None and hasattr(self._owner, "stats"):
            return self._owner.stats()
        return ""

    def to_torch(
        self,
        *,
        label_column=None,
        feature_columns=None,
        label_column_dtype=None,
        feature_column_dtypes=None,
        batch_size: int = 1,
        prefetch_batches: int = 1,
        drop_last: bool = False,
        local_shuffle_buffer_size=None,
        local_shuffle_seed=None,
        unsqueeze_label_tensor: bool = True,
        unsqueeze_feature_tensors: bool = True,
    ):
        """Torch IterableDataset of ``(features, label)`` tuples (parity:
        iterator.py:485).  ``feature_columns`` as a list of names packs one
        ``[B, F]`` tensor; a list of name-lists yields a LIST of per-group
        tensors (with ``feature_column_dtypes`` then one dtype per group);
        a dict of name-lists yields a dict of tensors; None packs every
        non-label column (non-numeric columns are dropped with a warning)."""
        import torch

        it = self

        if isinstance(feature_columns, dict) and isinstance(
            feature_column_dtypes, (list, tuple)
        ):
            raise ValueError(
                "to_torch: positional feature_column_dtypes cannot pair with "
                "dict feature_columns (the index would reset per group) — "
                "use a {column: dtype} dict"
            )
        grouped = False
        if isinstance(feature_columns, (list, tuple)) and feature_columns:
            nested = [isinstance(c, (list, tuple)) for c in feature_columns]
            if all(nested):
                grouped = True  # List[List[str]]: one tensor per group
            elif any(nested):
                raise ValueError(
                    "to_torch: feature_columns mixes column names and "
                    "nested lists — use all strings (one [B, F] tensor), "
                    "all lists (a list of per-group tensors), or a dict of "
                    "lists (a dict of tensors)"
                )
        if grouped and isinstance(feature_column_dtypes, (list, tuple)) and len(
            feature_column_dtypes
        ) != len(feature_columns):
            raise ValueError(
                "to_torch: with List[List[str]] feature_columns, "
                "feature_column_dtypes needs one dtype per group "
                f"({len(feature_column_dtypes)} entries for "
                f"{len(feature_columns)} groups)"
            )

        def _features(batch, cols, dtypes):
            ts = []
            for j, c in enumerate(cols):
                t = torch.as_tensor(batch[c])
                if dtypes is not None:
                    if isinstance(dtypes, dict):
                        dt = dtypes.get(c)
                    elif isinstance(dtypes, (list, tuple)):
                        if len(dtypes) != len(cols):
                            raise ValueError(
                                "to_torch: feature_column_dtypes has "
                                f"{len(dtypes)} entries for "
                                f"{len(cols)} feature columns"
                            )
                        dt = dtypes[j]  # positional, parity
                    else:
                        dt = dtypes
                    if dt is not None:
                        t = t.to(dt)
                if t.dim() == 1 and unsqueeze_feature_tensors:
                    t = t.unsqueeze(1)
                ts.append(t)
            if len(ts) == 1:
                return ts[0]
            if any(t.dim() == 1 for t in ts):
                raise ValueError(
                    "to_torch: multiple 1-D feature columns cannot concatenate "
                    "with unsqueeze_feature_tensors=False — keep it True (each "
                    "column becomes [B, 1] before the [B, F] concat)"
                )
            return torch.cat(ts, dim=1)

        class _IterableDS(torch.utils.data.IterableDataset):
            def __iter__(self_ds):
                source = it.iter_batches(
                    batch_size=batch_size,
                    batch_format="numpy",
                    drop_last=drop_last,
                    local_shuffle_buffer_size=local_shuffle_buffer_size,
                    local_shuffle_seed=local_shuffle_seed,
                )
                if prefetch_batches and prefetch_batches > 0:
                    source = _prefetch(source, prefetch_batches)
                warned_dropped = False  # default-selection drop warns once
                for batch in source:
                    label = None
                    if label_column is not None:
                        label = torch.as_tensor(batch[label_column])
                        if label_column_dtype is not None:
                            label = label.to(label_column_dtype)
                        if unsqueeze_label_tensor and label.dim() == 1:
                            label = label.unsqueeze(1)
                    if isinstance(feature_columns, dict):
                        feats = {
                            k: _features(batch, cols, feature_column_dtypes)
                            for k, cols in feature_columns.items()
                        }
                    elif grouped:
                        feats = [
                            _features(
                                batch, list(cols),
                                feature_column_dtypes[gi]
                                if isinstance(feature_column_dtypes, (list, tuple))
                                else feature_column_dtypes,
                            )
                            for gi, cols in enumerate(feature_columns)
                        ]
                    else:
                        import numpy as _np

                        cols = feature_columns
                        if not cols:
                            # default selection skips non-numeric (id/text)
                            # columns — loudly: silently thinner feature
                            # tensors are a training bug nobody can see
                            cols, dropped = [], []
                            for c in batch.keys():
                                if c == label_column:
                                    continue
                                if _np.asarray(batch[c]).dtype.kind in "OUS":
                                    dropped.append(c)
                                else:
                                    cols.append(c)
                            if dropped and not warned_dropped:
                                import warnings

                                warned_dropped = True
                                warnings.warn(
                                    "to_torch: default feature selection "
                                    f"dropped non-numeric column(s) {dropped}; "
                                    "pass feature_columns explicitly to choose "
                                    "(or encode) them",
                                    stacklevel=2,
                                )
                        feats = _features(batch, cols, feature_column_dtypes)
                    yield feats, label

        return _IterableDS()


def _prefetch(source: Iterator[Any], n: int) -> Iterator[Any]:
    """Run the source iterator in a background thread, keeping up to ``n``
    items buffered ahead of the consumer (the ``prefetch_batches`` contract:
    batch formatting/IO overlaps the training step).

    A consumer that stops early (break / next-once / GC) closes this
    generator; the finally block signals the pump, whose timeout-put loop
    notices and exits — no thread or source iterator outlives the consumer.
    ``stop_pumps`` signals it too; the consumer then raises.
    """
    import queue

    q: "queue.Queue" = queue.Queue(maxsize=max(1, n))
    END = object()
    stopped = threading.Event()

    def pump():
        try:
            for item in source:
                if not _put_unless_stopped(q, item, stopped):
                    return
            _put_unless_stopped(q, END, stopped)
        except BaseException as exc:  # noqa: BLE001 — re-raised on the consumer
            _put_unless_stopped(q, exc, stopped)
        finally:
            close = getattr(source, "close", None)
            if stopped.is_set() and close is not None:
                close()

    _start_pump(pump, stopped, "to-torch-prefetch")
    try:
        while True:
            item = _get_unless_stopped(q, stopped)
            if item is END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stopped.set()


def _put_unless_stopped(q, item, stop: threading.Event) -> bool:
    """Put ``item`` into ``q``, waiting for room; False once ``stop`` is set."""
    import queue

    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _get_unless_stopped(q, stop: threading.Event):
    """The next item of ``q``; raises once ``stop`` is set (``stop_pumps``:
    the runtime, and the blocks the items name, went)."""
    import queue

    while True:
        try:
            item = q.get(timeout=0.1)
        except queue.Empty:
            item = q  # the queue itself marks "nothing yet"
        if stop.is_set():
            raise RuntimeError("the runtime shut down while this iterator was read")
        if item is not q:
            return item


# Live background threads that call the runtime: (thread, stop event).
_pumps_lock = threading.Lock()
_live_pumps: set = set()


def _start_pump(target: Callable[[], None], stop: threading.Event, name: str) -> threading.Thread:
    """Run ``target`` on a daemon thread that :func:`stop_pumps` can stop
    (by setting ``stop``, which ``target`` must watch) and join."""

    def run():
        try:
            target()
        finally:
            with _pumps_lock:
                _live_pumps.discard(entry)

    thread = threading.Thread(target=run, daemon=True, name=name)
    entry = (thread, stop)
    with _pumps_lock:
        _live_pumps.add(entry)
    thread.start()
    return thread


def stop_pumps(timeout_s: float = 10.0) -> int:
    """Stop every live pump and join it; returns how many were stopped.
    ``ray_tpu_torch.shutdown`` calls this while the runtime is still up, so
    no pump's last ``get`` starts a new one."""
    with _pumps_lock:
        entries = list(_live_pumps)
    for _, stop in entries:
        stop.set()
    for thread, _ in entries:
        if thread is not threading.current_thread():
            thread.join(timeout_s)
    return len(entries)


def _shuffle_blocks(source: Iterator[Block], buffer_size: int, seed: Optional[int]) -> Iterator[Block]:
    """Local shuffle: accumulate rows into a buffer, emit shuffled slices
    (parity: iterator local_shuffle_buffer_size semantics)."""
    rng = np.random.default_rng(seed)
    buffer: List[Block] = []
    buffered_rows = 0
    for block in source:
        buffer.append(block)
        buffered_rows += BlockAccessor(block).num_rows()
        if buffered_rows >= buffer_size:
            merged = concat_blocks(buffer)
            acc = BlockAccessor(merged)
            perm = rng.permutation(acc.num_rows())
            yield acc.take(perm)
            buffer, buffered_rows = [], 0
    if buffer:
        merged = concat_blocks(buffer)
        acc = BlockAccessor(merged)
        perm = rng.permutation(acc.num_rows())
        yield acc.take(perm)

