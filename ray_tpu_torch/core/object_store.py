"""Tiered object store: CUDA tensors in device memory with host/shm/disk spill.

This is the rebuild of the reference's two stores:

  * plasma (``src/ray/object_manager/plasma/store.h``) — node-wide shared
    immutable objects; here the **native shm tier** (``ray_tpu/native``) plus
    the host tier play that role.
  * the in-memory store (``src/ray/core_worker/store_provider/memory_store/
    memory_store.h:43``) — small/inline objects and errors with blocking Get;
    here every entry supports blocking get via a per-object future.

The port's copy of ``ray_tpu/core/object_store.py``.  The *primary* tier is
device memory: a CUDA ``torch.Tensor`` is stored as is (no copy, the same
storage; kernels queued on the stream may still be writing it, which is
invisible to the table, as an XLA future is in the JAX package).  Spill order
under memory pressure mirrors plasma's pinned→evictable flow
(``object_lifecycle_manager.h``): DEVICE → HOST (``.cpu()``, a sync point),
HOST → SHM (large buffers, zero-copy for workers) or DISK (pickled), with LRU
ordering.  A ``get`` after a device spill returns the host value, a CPU
tensor.  Metric tags keep ``tier="hbm"`` for the device tier, so the
exposition matches the JAX package's.
"""

from __future__ import annotations

import os
import pickle
import sys
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
# py3.10: futures.TimeoutError is NOT the builtin (unified only in 3.11)
from concurrent.futures import TimeoutError as _FutureTimeoutError
from enum import Enum
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.exceptions import GetTimeoutError, ObjectLostError, StoreFullError
from ray_tpu_torch.observability import metric_defs


class Tier(Enum):
    DEVICE = "device"   # CUDA torch.Tensor in device memory
    HOST = "host"       # any python object in process heap
    SHM = "shm"         # native shared-memory store (serialized)
    DISK = "disk"       # pickled file in spill_dir


def _is_device_array(value: Any) -> bool:
    # a tensor exists only once its owner imported torch: never import it here
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(value, torch.Tensor) and value.is_cuda


def _nbytes(value: Any) -> int:
    if isinstance(value, np.ndarray):
        return value.nbytes
    nb = getattr(value, "nbytes", None)
    if isinstance(nb, int):
        return nb
    if isinstance(value, (bytes, bytearray, memoryview)):
        return len(value)
    return 0  # small control-plane object; not accounted


class ObjectEntry:
    __slots__ = ("value", "tier", "size", "is_error", "meta", "disk_path")

    def __init__(self, value: Any, tier: Tier, size: int, is_error: bool = False):
        self.value = value
        self.tier = tier
        self.size = size
        self.is_error = is_error
        self.meta: Optional[dict] = None
        self.disk_path: Optional[str] = None


class ObjectStore:
    """Single-host object table. Thread-safe; blocking gets via futures."""

    def __init__(self, shm_store=None, hbm_budget: Optional[int] = None, host_budget: Optional[int] = None):
        cfg = get_config()
        self._lock = threading.RLock()
        self._entries: "OrderedDict[ObjectID, ObjectEntry]" = OrderedDict()
        self._waiters: Dict[ObjectID, List[Future]] = {}
        self._shm = shm_store
        self._hbm_used = 0
        self._host_used = 0
        self._hbm_budget = hbm_budget if hbm_budget is not None else cfg.object_store_hbm_bytes or _auto_hbm_budget()
        self._host_budget = host_budget if host_budget is not None else cfg.object_store_host_bytes
        self._spill_dir = cfg.spill_dir
        # bounded spill tier (overload survival, ISSUE 9): bytes currently
        # spilled to disk, charged against object_store_max_disk_bytes when
        # that knob is set.  A put that cannot fit host + disk budgets
        # BACKPRESSURES on this condition (deletions notify it) up to
        # store_put_backpressure_timeout_s, then raises StoreFullError —
        # the spill tier never grows unbounded and never half-commits.
        self._disk_used = 0
        # bytes of gate-admitted puts not yet inserted: the admission check
        # must count them or N concurrent puts each seeing the last free
        # bytes would ALL pass and overshoot the budget N-fold
        self._pending_put_bytes = 0
        self._space = threading.Condition(self._lock)
        self.num_puts = 0
        self.num_gets = 0
        self.num_spills = 0
        self.num_restores = 0
        self.num_backpressure_waits = 0
        self.num_puts_shed = 0
        # per-node metric tag sets, prebuilt once (hot-path allocations);
        # the hosting Node calls set_metrics_tags with its node id
        self._tags: Optional[Dict[str, str]] = None
        self._tags_hbm: Dict[str, str] = {"tier": "hbm"}
        self._tags_host: Dict[str, str] = {"tier": "host"}
        self._tags_hit: Dict[str, str] = {"result": "hit"}
        self._tags_miss: Dict[str, str] = {"result": "miss"}

    def set_metrics_tags(self, tags: Dict[str, str]) -> None:
        self._tags = dict(tags)
        self._tags_hbm = {**tags, "tier": "hbm"}
        self._tags_host = {**tags, "tier": "host"}
        self._tags_hit = {**tags, "result": "hit"}
        self._tags_miss = {**tags, "result": "miss"}

    # ------------------------------------------------------------------ put
    def put(self, object_id: ObjectID, value: Any, is_error: bool = False) -> None:
        if _is_device_array(value):
            tier, size = Tier.DEVICE, _nbytes(value)
        else:
            tier, size = Tier.HOST, _nbytes(value)
        reserved = False
        if tier is Tier.HOST and size and not is_error:
            # error tombstones always commit (a failed task's error must
            # reach its getters even under memory pressure); data puts pay
            # the admission gate when the spill tier is bounded
            reserved = self._admit_put(object_id, size)
        entry = ObjectEntry(value, tier, size, is_error)
        with self._lock:
            if reserved:
                self._pending_put_bytes -= size  # reservation becomes the entry
            old = self._entries.get(object_id)
            if old is not None:
                # overwriting frees the old entry's footprint INCLUDING its
                # spill copy (the _admit_put gate already credited this
                # room) and wakes backpressured puts, exactly like delete()
                self._account_remove_locked(old)
                self._drop_spill_locked(object_id, old)
                self._space.notify_all()
            self._entries[object_id] = entry
            self._entries.move_to_end(object_id)
            if tier is Tier.DEVICE:
                self._hbm_used += size
            else:
                self._host_used += size
            self.num_puts += 1
            waiters = self._waiters.pop(object_id, [])
            n_entries = len(self._entries)
            tier_used = self._hbm_used if tier is Tier.DEVICE else self._host_used
        metric_defs.OBJECT_STORE_PUTS.inc(tags=self._tags)
        if size:
            metric_defs.OBJECT_STORE_BYTES_PUT.inc(size, tags=self._tags)
        metric_defs.OBJECT_STORE_OBJECTS.set(n_entries, self._tags)
        metric_defs.OBJECT_STORE_USED_BYTES.set(
            tier_used, self._tags_hbm if tier is Tier.DEVICE else self._tags_host
        )
        for fut in waiters:
            if not fut.done():
                fut.set_result(value)
        self._maybe_spill()

    def put_error(self, object_id: ObjectID, error: BaseException) -> None:
        self.put(object_id, error, is_error=True)

    def _admit_put(self, object_id: ObjectID, size: int) -> bool:
        """Backpressure gate for host-tier puts under a BOUNDED spill tier
        (``object_store_max_disk_bytes > 0``; 0 keeps the historical
        unbounded-spill behavior).  Blocks — waking on deletions — until
        the put fits within host + disk budgets, for at most
        ``store_put_backpressure_timeout_s``; then raises a typed
        :class:`StoreFullError` having committed nothing.  On success the
        size is RESERVED (``_pending_put_bytes``) until the entry inserts,
        so concurrent admits cannot all claim the same free bytes; returns
        True iff a reservation was taken."""
        cfg = get_config()
        disk_budget = cfg.object_store_max_disk_bytes
        if disk_budget <= 0:
            return False
        waited = 0.0
        deadline = None
        with self._lock:
            while True:
                # an overwrite frees the old entry's footprint in the same
                # commit; count that room as available
                old = self._entries.get(object_id)
                credit = (
                    old.size
                    if old is not None and old.tier in (Tier.HOST, Tier.DISK)
                    else 0
                )
                footprint = self._host_used + self._disk_used + self._pending_put_bytes - credit
                if footprint + size <= self._host_budget + disk_budget:
                    self._pending_put_bytes += size
                    break
                if deadline is None:
                    deadline = time.monotonic() + cfg.store_put_backpressure_timeout_s
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self.num_puts_shed += 1
                    if waited:
                        metric_defs.STORE_PUT_BACKPRESSURE.observe(waited, tags=self._tags)
                    from ray_tpu_torch.runtime.admission import record_shed

                    record_shed("store", "spill_full", task_id=object_id.hex())
                    raise StoreFullError(waited_s=waited, needed=size)
                if waited == 0.0:
                    self.num_backpressure_waits += 1  # one per blocked put
                t0 = time.monotonic()
                self._space.wait(min(remaining, 0.1))
                waited += time.monotonic() - t0
        if waited:
            metric_defs.STORE_PUT_BACKPRESSURE.observe(waited, tags=self._tags)
        return True

    # ------------------------------------------------------------------ get
    def get_async(self, object_id: ObjectID) -> Future:
        fut: Future = Future()
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is not None:
                value = self._materialize_locked(object_id, entry)
                self._entries.move_to_end(object_id)
                self.num_gets += 1
                size = entry.size
                fut.set_result(value)
                metric_defs.OBJECT_STORE_GETS.inc(tags=self._tags_hit)
                if size:
                    metric_defs.OBJECT_STORE_BYTES_GOT.inc(size, tags=self._tags)
                return fut
            self._waiters.setdefault(object_id, []).append(fut)
        metric_defs.OBJECT_STORE_GETS.inc(tags=self._tags_miss)
        return fut

    def get(self, object_id: ObjectID, timeout: Optional[float] = None) -> Any:
        fut = self.get_async(object_id)
        try:
            return fut.result(timeout)
        except (TimeoutError, _FutureTimeoutError):
            raise GetTimeoutError(f"Get timed out for {object_id}")

    def get_batch(self, object_ids: Sequence[ObjectID], timeout: Optional[float] = None) -> List[Any]:
        futures = [self.get_async(oid) for oid in object_ids]
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for fut in futures:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            try:
                out.append(fut.result(remaining))
            except (TimeoutError, _FutureTimeoutError):
                raise GetTimeoutError("Get timed out")
        return out

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._entries

    def is_ready(self, object_id: ObjectID) -> bool:
        return self.contains(object_id)

    def entry_info(self, object_id: ObjectID):
        with self._lock:
            e = self._entries.get(object_id)
            if e is None:
                return None
            return {"tier": e.tier.value, "size": e.size, "is_error": e.is_error}

    def list_entries(self):
        """[(object_id, entry_info dict)] snapshot — the state API's
        GetObjectsInfo equivalent (node_manager.proto:426)."""
        with self._lock:
            return [
                (oid, {"tier": e.tier.value, "size": e.size, "is_error": e.is_error})
                for oid, e in self._entries.items()
            ]

    def _drop_spill_locked(self, object_id: ObjectID, entry: ObjectEntry) -> None:
        """Free an entry's spill copy (the ONE cleanup idiom for delete and
        overwrite): pinned SHM segments unpin+delete, DISK files come off
        the bounded-tier ledger and unlink."""
        if entry.tier is Tier.SHM and self._shm is not None:
            self._shm.unpin(object_id.binary())
            self._shm.delete(object_id.binary())
        elif entry.tier is Tier.DISK and entry.disk_path:
            self._disk_used -= entry.size
            try:
                os.unlink(entry.disk_path)
            except OSError:
                pass

    # --------------------------------------------------------------- delete
    def delete(self, object_id: ObjectID) -> None:
        with self._lock:
            entry = self._entries.pop(object_id, None)
            if entry is None:
                return
            self._account_remove_locked(entry)
            self._drop_spill_locked(object_id, entry)
            # room freed: wake puts blocked on the backpressure gate
            self._space.notify_all()

    def fail_pending(self, object_id: ObjectID, error: BaseException) -> None:
        """Wake waiters with an error without storing a value."""
        with self._lock:
            waiters = self._waiters.pop(object_id, [])
        for fut in waiters:
            if not fut.done():
                fut.set_exception(error)

    # ---------------------------------------------------------------- spill
    #: optional memory-pressure hook (wired by the runtime to the reference
    #: counter's synchronous drain): dead refs awaiting the GC drainer
    #: thread must FREE, not SPILL — plasma's evict-after-refcount ordering
    pressure_callback = None

    def _maybe_spill(self) -> None:
        with self._lock:
            over = (
                self._hbm_used > self._hbm_budget
                or self._host_used > self._host_budget
            )
        if over and self.pressure_callback is not None:
            try:
                # apply pending out-of-scope deletions before copying
                # anything out: a tight put loop outruns the deferred-decref
                # drainer on small hosts, and spilling already-dead objects
                # costs GB-scale memcpys for nothing
                self.pressure_callback()
            except Exception:  # noqa: BLE001 — pressure relief is best-effort
                pass
        with self._lock:
            if self._hbm_used > self._hbm_budget:
                self._spill_device_locked(self._hbm_used - self._hbm_budget)
            if self._host_used > self._host_budget:
                self._spill_host_locked(self._host_used - self._host_budget)

    def _spill_device_locked(self, need: int) -> None:
        freed = 0
        for oid, entry in list(self._entries.items()):
            if freed >= need:
                break
            if entry.tier is Tier.DEVICE:
                host = entry.value.cpu()  # device to host; sync point
                entry.value = host
                entry.tier = Tier.HOST
                self._hbm_used -= entry.size
                self._host_used += entry.size
                freed += entry.size
                self.num_spills += 1
                metric_defs.OBJECT_STORE_SPILLS.inc(tags=self._tags_host)

    def _spill_host_locked(self, need: int) -> None:
        freed = 0
        for oid, entry in list(self._entries.items()):
            if freed >= need:
                break
            if entry.tier is not Tier.HOST or entry.size == 0:
                continue
            if self._try_spill_entry_locked(oid, entry):
                freed += entry.size

    def _try_spill_entry_locked(self, oid: ObjectID, entry: ObjectEntry) -> bool:
        value = entry.value
        if self._shm is not None and isinstance(value, np.ndarray) and value.dtype != object:
            try:
                header = pickle.dumps((value.dtype.str, value.shape))
                data = np.ascontiguousarray(value)
                payload = header + data.tobytes()
                # pinned: the shm copy is the only copy, LRU must not evict it
                self._shm.put(oid.binary(), payload, meta_size=len(header), pin=True)
                entry.value = None
                entry.tier = Tier.SHM
                self._host_used -= entry.size
                self.num_spills += 1
                metric_defs.OBJECT_STORE_SPILLS.inc(tags=self._spill_tags("shm"))
                return True
            except (MemoryError, FileExistsError):
                pass
        # disk fallback — refused when the bounded spill tier has no room
        # (the put-side backpressure gate owns the full-store story; an
        # over-budget host just stays over until deletions land)
        disk_budget = get_config().object_store_max_disk_bytes
        if disk_budget > 0 and self._disk_used + entry.size > disk_budget:
            return False
        os.makedirs(self._spill_dir, exist_ok=True)
        path = os.path.join(self._spill_dir, oid.hex())
        with open(path, "wb") as f:
            pickle.dump(value, f, protocol=5)
        entry.value = None
        entry.tier = Tier.DISK
        entry.disk_path = path
        self._host_used -= entry.size
        self._disk_used += entry.size
        self.num_spills += 1
        metric_defs.OBJECT_STORE_SPILLS.inc(tags=self._spill_tags("disk"))
        return True

    def _spill_tags(self, tier: str) -> Dict[str, str]:
        # spills are rare (memory-pressure only): building the tag dict
        # here is fine, unlike the per-put/get fast paths
        return {**(self._tags or {}), "tier": tier}

    def _materialize_locked(self, oid: ObjectID, entry: ObjectEntry) -> Any:
        if entry.tier in (Tier.DEVICE, Tier.HOST):
            return entry.value
        if entry.tier is Tier.SHM:
            got = self._shm.get(oid.binary())
            if got is None:
                raise ObjectLostError(oid)
            view, meta_size = got
            try:
                dtype_str, shape = pickle.loads(view[:meta_size])
                value = np.frombuffer(view[meta_size:], dtype=np.dtype(dtype_str)).reshape(shape).copy()
            finally:
                self._shm.release(oid.binary())
            entry.value = value
            entry.tier = Tier.HOST
            self._host_used += entry.size
            self._shm.unpin(oid.binary())  # drop the spill pin, then delete
            self._shm.delete(oid.binary())
            self.num_restores += 1
            metric_defs.OBJECT_STORE_RESTORES.inc(tags=self._tags)
            return value
        if entry.tier is Tier.DISK:
            with open(entry.disk_path, "rb") as f:
                value = pickle.load(f)
            entry.value = value
            entry.tier = Tier.HOST
            self._host_used += entry.size
            self._disk_used -= entry.size
            try:
                os.unlink(entry.disk_path)
            except OSError:
                pass
            entry.disk_path = None
            self.num_restores += 1
            metric_defs.OBJECT_STORE_RESTORES.inc(tags=self._tags)
            return value
        raise ObjectLostError(oid)

    def _account_remove_locked(self, entry: ObjectEntry) -> None:
        if entry.tier is Tier.DEVICE:
            self._hbm_used -= entry.size
        elif entry.tier is Tier.HOST:
            self._host_used -= entry.size

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            return {
                "num_objects": len(self._entries),
                "hbm_used": self._hbm_used,
                "hbm_budget": self._hbm_budget,
                "host_used": self._host_used,
                "host_budget": self._host_budget,
                "disk_used": self._disk_used,
                "disk_budget": get_config().object_store_max_disk_bytes,
                "puts": self.num_puts,
                "gets": self.num_gets,
                "spills": self.num_spills,
                "restores": self.num_restores,
                "put_backpressure_waits": self.num_backpressure_waits,
                "puts_shed": self.num_puts_shed,
            }


def _auto_hbm_budget() -> int:
    """``object_store_hbm_fraction`` of the card's memory.  With no CUDA in
    the process no device-tier object can exist, and the JAX package's 4 GiB
    default stands; with CUDA, a failure to read the card raises."""
    from ray_tpu_torch.accelerators import gpu

    if not gpu.cuda_available():
        return 4 * 1024**3
    import torch

    _free, total = torch.cuda.mem_get_info()
    return int(total * get_config().object_store_hbm_fraction)
