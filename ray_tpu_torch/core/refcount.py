"""Distributed reference counting with owner/borrower semantics.

The port's copy of ``ray_tpu/core/refcount.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Parity with the reference's ``ReferenceCounter``
(``src/ray/core_worker/reference_count.h:61``): every object has one owner
(the worker that created it).  The owner tracks, per object:

  * local references   — live ObjectRef handles in the owner process,
  * submitted-task refs — the object is an argument of an in-flight task,
  * borrowers          — remote workers holding refs (``reference_count.h:265``),
  * lineage refs       — downstream objects whose reconstruction would need
    this object (kept while lineage pinning is on).

When all counts reach zero the object is freed everywhere; if lineage is still
referenced the entry is kept so a lost object can be rebuilt by re-executing
its creating task (``task_manager.h:261``).

This is plain Python guarded by one lock: counts are touched a handful of
times per task, so the cost is noise compared to dispatch; the reference
needed C++ here because N processes share each count, whereas our single-host
runtime owns all counts in-process and multi-host borrowing goes through the
control plane.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Set

from ray_tpu_torch.core.ids import ObjectID


class Reference:
    __slots__ = (
        "local_refs",
        "submitted_task_refs",
        "borrowers",
        "lineage_refs",
        "owned",
        "pinned",
        "on_delete",
    )

    def __init__(self, owned: bool = True):
        self.local_refs = 0
        self.submitted_task_refs = 0
        self.borrowers: Set[str] = set()
        self.lineage_refs = 0
        self.owned = owned
        self.pinned = False  # pinned objects are never freed (e.g. actor state)
        self.on_delete: Optional[Callable[[], None]] = None

    def total(self) -> int:
        return self.local_refs + self.submitted_task_refs + len(self.borrowers)

    def out_of_scope(self) -> bool:
        return self.total() == 0 and not self.pinned


class ReferenceCounter:
    def __init__(self, on_object_out_of_scope: Optional[Callable[[ObjectID], None]] = None):
        self._lock = threading.RLock()
        self._refs: Dict[ObjectID, Reference] = {}
        self._on_out_of_scope = on_object_out_of_scope
        # Deferred decrement queue: ObjectRef.__del__ may fire from GC while
        # ANY runtime lock is held, so it must never touch locks itself —
        # it enqueues here and a drainer thread applies the decrement.
        from collections import deque

        self._deferred: "deque[ObjectID]" = deque()
        self._deferred_event = threading.Event()
        self._drainer_stop = False
        self._drainer = threading.Thread(target=self._drain_loop, name="refcount-gc", daemon=True)
        self._drainer.start()

    def enqueue_local_ref_removal(self, object_id: ObjectID) -> None:
        """GC-safe: called from __del__; lock-free append + event set."""
        self._deferred.append(object_id)
        self._deferred_event.set()

    def _apply_pending(self) -> int:
        """Apply every queued __del__ decrement; returns how many."""
        n = 0
        while True:
            try:
                oid = self._deferred.popleft()
            except IndexError:
                return n
            try:
                self.remove_local_reference(oid)
                n += 1
            except Exception:  # noqa: BLE001
                pass

    def _drain_loop(self) -> None:
        while not self._drainer_stop:
            self._deferred_event.wait(timeout=0.5)
            self._deferred_event.clear()
            self._apply_pending()

    def stop(self) -> None:
        self._drainer_stop = True
        self._deferred_event.set()
        # wait for the drainer's last pass: it holds the runtime until it
        # exits, so without the join a shut-down runtime's objects (device
        # memory included) would outlive ``shutdown`` by up to a wake period
        if self._drainer is not threading.current_thread():
            self._drainer.join(timeout=5.0)

    def drain_deferred(self) -> int:
        """Synchronously apply queued __del__ decrements (memory-pressure
        path: the store calls this before spilling so dead objects FREE
        instead of paying a spill copy).  A full gc.collect only runs when
        the queue was empty (cycles may still hold refs) and at most once
        per second — a legitimately-over-budget workload must not pay a
        stop-the-world GC per put."""
        n = self._apply_pending()
        if n == 0:
            import gc
            import time as _time

            now = _time.monotonic()
            if now - getattr(self, "_last_pressure_gc", 0.0) < 1.0:
                return 0
            self._last_pressure_gc = now
            gc.collect()
            n = self._apply_pending()
        return n

    # -- ownership --------------------------------------------------------
    def add_owned_object(self, object_id: ObjectID, pinned: bool = False) -> None:
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                ref = Reference(owned=True)
                self._refs[object_id] = ref
            ref.pinned = ref.pinned or pinned

    def add_borrowed_object(self, object_id: ObjectID) -> None:
        with self._lock:
            if object_id not in self._refs:
                self._refs[object_id] = Reference(owned=False)

    # -- local refs -------------------------------------------------------
    def add_local_reference(self, object_id: ObjectID) -> None:
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                ref = Reference(owned=True)
                self._refs[object_id] = ref
            ref.local_refs += 1

    def remove_local_reference(self, object_id: ObjectID) -> None:
        self._decrement(object_id, "local_refs")

    # -- task argument refs ------------------------------------------------
    def add_submitted_task_references(self, object_ids) -> None:
        with self._lock:
            for oid in object_ids:
                ref = self._refs.get(oid)
                if ref is None:
                    ref = Reference(owned=True)
                    self._refs[oid] = ref
                ref.submitted_task_refs += 1

    def remove_submitted_task_references(self, object_ids) -> None:
        for oid in object_ids:
            self._decrement(oid, "submitted_task_refs")

    # -- borrowers ---------------------------------------------------------
    def add_borrower(self, object_id: ObjectID, borrower: str) -> None:
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is not None:
                ref.borrowers.add(borrower)

    def remove_borrower(self, object_id: ObjectID, borrower: str) -> None:
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                return
            ref.borrowers.discard(borrower)
            if ref.out_of_scope():
                self._delete(object_id, ref)

    # -- lineage -----------------------------------------------------------
    def add_lineage_reference(self, object_id: ObjectID) -> None:
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is not None:
                ref.lineage_refs += 1

    def remove_lineage_reference(self, object_id: ObjectID) -> None:
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is not None and ref.lineage_refs > 0:
                ref.lineage_refs -= 1

    # -- queries -----------------------------------------------------------
    def pin(self, object_id: ObjectID) -> None:
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                ref = Reference(owned=True)
                self._refs[object_id] = ref
            ref.pinned = True

    def unpin(self, object_id: ObjectID) -> None:
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is not None:
                ref.pinned = False
                if ref.out_of_scope():
                    self._delete(object_id, ref)

    def has_reference(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._refs

    def reference_counts(self, object_id: ObjectID):
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                return None
            return {
                "local": ref.local_refs,
                "submitted": ref.submitted_task_refs,
                "borrowers": len(ref.borrowers),
                "lineage": ref.lineage_refs,
                "pinned": ref.pinned,
            }

    def num_tracked(self) -> int:
        with self._lock:
            return len(self._refs)

    # -- internals ---------------------------------------------------------
    def _decrement(self, object_id: ObjectID, field: str) -> None:
        callback = None
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                return
            current = getattr(ref, field)
            if current > 0:
                setattr(ref, field, current - 1)
            if ref.out_of_scope():
                callback = self._delete(object_id, ref, run_callback=False)
        if callback is not None:
            callback()

    def _delete(self, object_id: ObjectID, ref: Reference, run_callback: bool = True):
        del self._refs[object_id]
        on_delete = ref.on_delete

        def fire():
            if on_delete is not None:
                on_delete()
            if self._on_out_of_scope is not None:
                self._on_out_of_scope(object_id)

        if run_callback:
            fire()
            return None
        return fire
