"""ObjectRef: a first-class future handle to an immutable object.

The port's copy of ``ray_tpu/core/object_ref.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Parity with the reference (``python/ray/includes/object_ref.pxi`` +
``src/ray/core_worker/reference_count.h``): refs participate in distributed
reference counting — creating/copying a ref increments the owner's local
count, ``__del__`` decrements it, and pickling a ref into a task argument
registers the receiver as a borrower via the serialization context.

TPU-first delta: a ref whose value is a ``jax.Array`` resolves to the
HBM-resident array itself (zero-copy) — the ref is the handle XLA-async
dispatch hides latency behind, so ``.result()`` only blocks when the value is
actually needed on host.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Any, Optional

from ray_tpu_torch.core.ids import ObjectID

if TYPE_CHECKING:
    from concurrent.futures import Future

# The live worker hook; set by the runtime at init so ObjectRef.__del__ and
# pickling can reach the reference counter without import cycles.
_worker_hooks = threading.local()


class _GlobalHooks:
    ref_counter = None      # ReferenceCounter
    serialization_ctx = None


hooks = _GlobalHooks()


class ObjectRef:
    __slots__ = ("_id", "_owner", "_skip_decref", "__weakref__")

    def __init__(self, object_id: ObjectID, owner_address: Optional[str] = None, *, _add_ref: bool = True):
        self._id = object_id
        self._owner = owner_address
        self._skip_decref = not _add_ref
        if _add_ref and hooks.ref_counter is not None:
            hooks.ref_counter.add_local_reference(object_id)

    # -- identity ---------------------------------------------------------
    def id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    def task_id(self):
        return self._id.task_id()

    def owner_address(self) -> Optional[str]:
        return self._owner

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    # -- future protocol --------------------------------------------------
    def future(self) -> "Future":
        from ray_tpu_torch.runtime.worker import global_worker

        return global_worker().get_async(self)

    def __await__(self):
        import asyncio

        return asyncio.wrap_future(self.future()).__await__()

    # -- lifecycle --------------------------------------------------------
    def _copy(self) -> "ObjectRef":
        return ObjectRef(self._id, self._owner)

    def __del__(self):
        # __del__ can run at any GC point, including while runtime locks are
        # held — only a lock-free enqueue is safe here.
        if not self._skip_decref and hooks.ref_counter is not None:
            try:
                hooks.ref_counter.enqueue_local_ref_removal(self._id)
            except Exception:
                pass

    def __reduce__(self):
        # Record the ref in the active serialization capture (borrower
        # protocol) and re-increment on the receiving side.
        if hooks.serialization_ctx is not None:
            hooks.serialization_ctx.note_ref(self)
        return (_rebuild_object_ref, (self._id.binary(), self._owner))


def _rebuild_object_ref(id_binary: bytes, owner: Optional[str]) -> ObjectRef:
    return ObjectRef(ObjectID(id_binary), owner)
