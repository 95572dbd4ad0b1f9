"""Serialization for cross-process object transport.

Parity with the reference's ``python/ray/_private/serialization.py``
(``SerializationContext``): a small metadata envelope plus pickle protocol 5
out-of-band buffers, so numpy arrays (and torch tensors, as numpy) move
between processes without an extra copy.  ObjectRefs pickled inside task
arguments are recorded by the context so the receiver can be registered as a
borrower (reference: ``serialization.py:145`` object_ref_reducer →
``ReferenceCounter`` borrower protocol).

The port's copy of ``ray_tpu/core/serialization.py``.  Deltas from the
reference system:
  * In-process tasks (device tasks on the host runtime) never serialize at
    all — objects pass by reference.  This module is only used at process
    boundaries (CPU worker pool) and for spill tiers.
  * A ``torch.Tensor`` crosses as a numpy array of its host bytes (a CUDA
    tensor is copied to the host first, as the JAX package sends a
    ``jax.Array`` as numpy) and is rebuilt as a CPU tensor.  torch's own
    pickling is never used: it would rebuild a CUDA tensor on CUDA in the
    receiver and create a CUDA context in every worker process.  bf16 and
    the float8 types, which numpy lacks, cross as int16 / uint8 bit
    patterns.  torch is imported only by a process that receives a tensor.
"""

from __future__ import annotations

import pickle
import sys
import threading
import warnings
from typing import Any, Callable, List, Tuple

import numpy as np

_JAX_ARRAY_MARKER = b"__ray_tpu_jax_array__"


class SerializedObject:
    """Envelope: a pickle5 stream plus its out-of-band buffers."""

    __slots__ = ("meta", "buffers")

    def __init__(self, meta: bytes, buffers: List[pickle.PickleBuffer]):
        self.meta = meta
        self.buffers = buffers

    def total_bytes(self) -> int:
        return len(self.meta) + sum(b.raw().nbytes for b in self.buffers)

    def to_flat_parts(self) -> List[bytes]:
        """Flatten for socket/shm transport: [meta, buf0, buf1, ...]."""
        return [self.meta] + [bytes(b.raw()) for b in self.buffers]


class SerializationContext:
    """Pickle-5-based serializer with pluggable custom reducers.

    Thread-local hook state lets the object-ref reducer capture which refs are
    being smuggled inside an object graph (→ borrower registration).
    """

    def __init__(self):
        self._reducers: dict[type, Callable] = {}
        self._local = threading.local()

    def register_reducer(self, cls: type, reducer: Callable) -> None:
        self._reducers[cls] = reducer

    # -- ref capture hooks -------------------------------------------------
    def start_capture_refs(self) -> None:
        self._local.captured_refs = []

    def stop_capture_refs(self) -> list:
        refs = getattr(self._local, "captured_refs", [])
        self._local.captured_refs = None
        return refs

    def note_ref(self, ref) -> None:
        captured = getattr(self._local, "captured_refs", None)
        if captured is not None:
            captured.append(ref)

    # -- serialize/deserialize --------------------------------------------
    def serialize(self, value: Any) -> SerializedObject:
        buffers: List[pickle.PickleBuffer] = []

        class _Pickler(pickle.Pickler):
            dispatch_table = {}

            def reducer_override(p_self, obj):  # noqa: N805
                r = self._reducers.get(type(obj))
                if r is not None:
                    return r(obj)
                if isinstance(obj, np.ndarray) and obj.dtype != object:
                    return NotImplemented  # numpy handles PickleBuffer itself
                return _tensor_reduction(obj)

        import io

        stream = io.BytesIO()
        pickler = _Pickler(stream, protocol=5, buffer_callback=buffers.append)
        pickler.dump(value)
        return SerializedObject(stream.getvalue(), buffers)

    def deserialize(self, serialized: SerializedObject) -> Any:
        return pickle.loads(serialized.meta, buffers=serialized.buffers)

    def deserialize_parts(self, parts: List[bytes]) -> Any:
        meta, raw_bufs = parts[0], parts[1:]
        return pickle.loads(meta, buffers=[pickle.PickleBuffer(b) for b in raw_bufs])


# torch dtypes numpy has no type for: they cross as same-width integer bits
_BIT_VIEWS = {
    "bfloat16": "int16",
    "float8_e4m3fn": "uint8",
    "float8_e5m2": "uint8",
    "float8_e4m3fnuz": "uint8",
    "float8_e5m2fnuz": "uint8",
}


def _reduce_tensor(t):
    """(rebuild, args) for a tensor: its host bytes as a numpy array (an
    out-of-band buffer under protocol 5), its dtype name and grad flag."""
    host = t.detach()
    if host.is_cuda:
        host = host.cpu()  # device to host; a sync point
    host = host.contiguous()
    dtype = str(host.dtype).removeprefix("torch.")
    view = _BIT_VIEWS.get(dtype)
    if view is not None:
        import torch

        host = host.view(getattr(torch, view))
    return (_rebuild_tensor, (host.numpy(), dtype, t.requires_grad))


def _rebuild_tensor(host: np.ndarray, dtype: str, requires_grad: bool):
    # A tensor always arrives on the CPU: a process that wants it on the card
    # moves it there itself.  The numpy array may be read-only (it views the
    # received bytes); the tensor shares it, as the JAX package's worker
    # shares its read-only numpy array.
    import torch

    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        out = torch.from_numpy(host)
    if dtype in _BIT_VIEWS:
        out = out.view(getattr(torch, dtype))
    if requires_grad:
        out.requires_grad_(True)
    return out


_default_context: SerializationContext | None = None
_default_lock = threading.Lock()


def get_context() -> SerializationContext:
    global _default_context
    if _default_context is None:
        with _default_lock:
            if _default_context is None:
                _default_context = SerializationContext()
    return _default_context


# --------------------------------------------------------------------------
# values, functions and classes that cross to or from a worker process
# --------------------------------------------------------------------------
def _tensor_reduction(obj):
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(obj, torch.Tensor):
        return _reduce_tensor(obj)
    return NotImplemented


class _TensorPickler(pickle.Pickler):
    def reducer_override(self, obj):
        return _tensor_reduction(obj)


def dumps(obj, protocol: int = 5) -> bytes:
    """``pickle.dumps`` for a frame that crosses to or from a worker process
    (task arguments, results, nested API calls): tensors cross as host numpy
    (see the module docstring), never through torch's own pickling."""
    if "torch" not in sys.modules:
        return pickle.dumps(obj, protocol=protocol)
    import io

    stream = io.BytesIO()
    _TensorPickler(stream, protocol=protocol).dump(obj)
    return stream.getvalue()


def cloudpickle_module():
    """The ``cloudpickle`` module, or None where it is not installed (the
    JAX package requires it; the port runs without it)."""
    try:
        import cloudpickle
    except ImportError:
        return None
    return cloudpickle


def _not_by_reference(obj) -> bool:
    """True for a function or class a worker cannot import by name: one
    defined in ``__main__`` or inside another function (or a lambda)."""
    if not isinstance(obj, type) and not callable(obj):
        return False
    module = getattr(obj, "__module__", None)
    qualname = getattr(obj, "__qualname__", "")
    return module == "__main__" or "<locals>" in qualname or "<lambda>" in qualname


def _missing_cloudpickle(what) -> TypeError:
    name = getattr(what, "__qualname__", None) or type(what).__qualname__
    return TypeError(
        f"{name!s} cannot be sent to a worker process by reference (it is defined "
        "in __main__ or inside a function) and the 'cloudpickle' package, which "
        "would send it by value, is not installed: define it at module level "
        "in an importable module"
    )


class _ByReferencePickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, type) or callable(obj):
            if _not_by_reference(obj):
                raise _missing_cloudpickle(obj)
        elif _not_by_reference(type(obj)):
            raise _missing_cloudpickle(type(obj))
        return _tensor_reduction(obj)


def check_by_reference(obj) -> None:
    """Raise the TypeError :func:`dumps_by_value` would raise for ``obj``
    when cloudpickle is absent; a no-op where cloudpickle is installed."""
    if cloudpickle_module() is None and _not_by_reference(obj):
        raise _missing_cloudpickle(obj)


def dumps_by_value(obj, protocol: int = 5) -> bytes:
    """Pickle a function, class or argument frame for a worker process:
    by value with cloudpickle where it is installed (closures and
    ``__main__`` definitions included), else with the stdlib by reference,
    which needs module-level definitions that the worker can import (it
    runs with the driver's ``sys.path``).  Tensors cross as in
    :func:`dumps`."""
    import io

    stream = io.BytesIO()
    cp = cloudpickle_module()
    if cp is not None:

        class _CloudTensorPickler(cp.Pickler):
            def reducer_override(self, obj):
                reduced = _tensor_reduction(obj)
                return super().reducer_override(obj) if reduced is NotImplemented else reduced

        _CloudTensorPickler(stream, protocol=protocol).dump(obj)
        return stream.getvalue()
    try:
        _ByReferencePickler(stream, protocol=protocol).dump(obj)
    except (AttributeError, pickle.PicklingError) as exc:
        raise _missing_cloudpickle(obj) from exc
    return stream.getvalue()
