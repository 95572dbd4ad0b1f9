"""Task bookkeeping: pending tasks, retries, lineage-based reconstruction.

The port's copy of ``ray_tpu/core/task_manager.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Parity with the reference's ``TaskManager``
(``src/ray/core_worker/task_manager.h:208``): every submitted task is tracked
until its returns are committed; failed tasks retry up to ``max_retries``
(system failures always eligible; application errors only with
``retry_exceptions``); and the spec of each finished task is retained —
bounded by ``max_lineage_bytes`` parity via an entry cap — so a lost object
can be rebuilt by resubmitting its creating task
(``task_manager.h:261``, ``object_recovery_manager.h:41``).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from ray_tpu_torch.core.ids import ObjectID, TaskID
from ray_tpu_torch.exceptions import ObjectReconstructionFailedError


class TaskManager:
    def __init__(self, max_lineage_entries: int = 100_000):
        self._lock = threading.RLock()
        self._pending: Dict[TaskID, object] = {}       # TaskSpec
        self._lineage: Dict[ObjectID, object] = {}     # return id -> TaskSpec
        self._lineage_order: list = []
        self._max_lineage = max_lineage_entries
        self.num_completed = 0
        self.num_failed = 0
        self.num_retries = 0

    # ------------------------------------------------------------------
    def add_pending(self, spec) -> None:
        with self._lock:
            self._pending[spec.task_id] = spec

    def mark_completed(self, spec) -> None:
        with self._lock:
            self._pending.pop(spec.task_id, None)
            self.num_completed += 1
            # retain lineage for reconstruction
            for oid in spec.return_ids:
                if oid not in self._lineage:
                    self._lineage_order.append(oid)
                self._lineage[oid] = spec
            while len(self._lineage_order) > self._max_lineage:
                old = self._lineage_order.pop(0)
                self._lineage.pop(old, None)

    def mark_failed(self, spec) -> None:
        with self._lock:
            self._pending.pop(spec.task_id, None)
            self.num_failed += 1

    def claim(self, spec) -> bool:
        """Atomically claim the right to commit ONE terminal state for the
        task: pops the pending entry, True only for the first claimant.
        Used by the racing deadline paths (watchdog direct-fail vs a
        straggler completion) — (task_id, attempt) terminal-exactly-once
        depends on exactly one of them winning.  Only valid for tasks that
        can no longer retry (a claimed task cannot re-enter pending)."""
        with self._lock:
            return self._pending.pop(spec.task_id, None) is not None

    def should_retry(self, spec, is_system_error: bool, retry_exceptions: bool = False) -> bool:
        if spec.retries_left <= 0:
            return False
        if not is_system_error and not retry_exceptions:
            return False
        with self._lock:
            spec.retries_left -= 1
            spec.attempt += 1
            self.num_retries += 1
        return True

    # ------------------------------------------------------------------
    def lineage_spec(self, object_id: ObjectID):
        with self._lock:
            return self._lineage.get(object_id)

    def get_pending(self, task_id: TaskID):
        """O(1) pending-spec lookup (ObjectIDs embed their creating TaskID,
        so ``ref -> spec`` needs no scan — reference: task id index in
        ``task_manager.h``)."""
        with self._lock:
            return self._pending.get(task_id)

    def num_pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def pending_specs(self):
        with self._lock:
            return list(self._pending.values())


class ObjectRecoveryManager:
    """Rebuilds lost objects by re-executing their creating tasks
    (parity: src/ray/core_worker/object_recovery_manager.h:41)."""

    def __init__(self, task_manager: TaskManager, resubmit_fn: Callable[[object], None]):
        self._tm = task_manager
        self._resubmit = resubmit_fn
        self._lock = threading.Lock()
        self._recovering: set = set()

    def recover(self, object_id: ObjectID) -> bool:
        """Kick off reconstruction. Returns False if no lineage exists."""
        spec = self._tm.lineage_spec(object_id)
        if spec is None:
            return False
        with self._lock:
            if spec.task_id in self._recovering:
                return True
            self._recovering.add(spec.task_id)
        try:
            # Recursively recover missing dependencies first.
            self._resubmit(spec)
            return True
        finally:
            with self._lock:
                self._recovering.discard(spec.task_id)
