"""Unique identifiers for jobs, tasks, actors, objects, nodes and placement groups.

The port's copy of ``ray_tpu/core/ids.py``; the port's native extension
(``ray_tpu_torch/native/src/hotpath.c``) replaces the concrete classes below.

Design parity with the reference's ID scheme (``src/ray/common/id.h``): every ID is
a fixed-width byte string; ObjectIDs embed the TaskID that created them plus an
index, so lineage can be recovered from the ID itself.  TaskIDs embed the ActorID
(or a nil actor) and the JobID.  Unlike the reference we keep IDs as immutable
Python objects with interned bytes — there is no C++ struct to mirror because the
single-host runtime is one process and IDs never cross a language boundary.

Layout (sizes in bytes):
  JobID:    4
  ActorID:  12  = 8 unique + JobID
  TaskID:   20  = 8 unique (atomic counter) + ActorID
  ObjectID: 24  = TaskID + 4 (little-endian object index)
  NodeID:   16  random
  PlacementGroupID: 16 = 12 unique + JobID
  WorkerID: 16  random
"""

from __future__ import annotations

import itertools
import os
import threading

_JOB_ID_SIZE = 4
_ACTOR_UNIQUE_SIZE = 8
_ACTOR_ID_SIZE = _ACTOR_UNIQUE_SIZE + _JOB_ID_SIZE          # 12
_TASK_UNIQUE_SIZE = 8
_TASK_ID_SIZE = _TASK_UNIQUE_SIZE + _ACTOR_ID_SIZE          # 20
_OBJECT_INDEX_SIZE = 4
_OBJECT_ID_SIZE = _TASK_ID_SIZE + _OBJECT_INDEX_SIZE        # 24
_NODE_ID_SIZE = 16
_PG_UNIQUE_SIZE = 12
_PG_ID_SIZE = _PG_UNIQUE_SIZE + _JOB_ID_SIZE                # 16
_WORKER_ID_SIZE = 16


class BaseID:
    """Fixed-width binary identifier. Immutable, hashable, ordered."""

    SIZE = 0
    __slots__ = ("_bytes", "_hash")

    def __init__(self, binary: bytes):
        if len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(binary)}"
            )
        self._bytes = binary
        self._hash = hash((type(self).__name__, binary))

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def nil(cls):
        return cls(b"\xff" * cls.SIZE)

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def is_nil(self) -> bool:
        return self._bytes == b"\xff" * self.SIZE

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other):
        return self._bytes < other._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self._bytes.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = _JOB_ID_SIZE

    _counter = 0
    _lock = threading.Lock()

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(value.to_bytes(_JOB_ID_SIZE, "little"))

    @classmethod
    def next(cls) -> "JobID":
        with cls._lock:
            cls._counter += 1
            return cls.from_int(cls._counter)

    @classmethod
    def ensure_above(cls, value: int) -> None:
        """Advance the counter past ids restored from a previous process,
        so new jobs can't collide with persisted history."""
        with cls._lock:
            cls._counter = max(cls._counter, value)

    def int_value(self) -> int:
        return int.from_bytes(self._bytes, "little")


class NodeID(BaseID):
    SIZE = _NODE_ID_SIZE


class WorkerID(BaseID):
    SIZE = _WORKER_ID_SIZE


class ActorID(BaseID):
    SIZE = _ACTOR_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(os.urandom(_ACTOR_UNIQUE_SIZE) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[_ACTOR_UNIQUE_SIZE:])


# Hot path: task ids are minted at submission rate; a process-wide atomic
# 64-bit counter is ~50x cheaper than urandom.  The counter starts at a
# RANDOM 62-bit offset: worker processes mint task ids locally
# (fire-and-forget nested submission), and two processes counting from a
# fixed base would collide on their early ids — observed as one task's
# return object satisfying another task's get.
_task_counter = itertools.count(int.from_bytes(os.urandom(8), "little") >> 2)
_UNIQUE_MASK = (1 << (8 * _TASK_UNIQUE_SIZE)) - 1


def _next_unique() -> bytes:
    return (next(_task_counter) & _UNIQUE_MASK).to_bytes(_TASK_UNIQUE_SIZE, "little")


class TaskID(BaseID):
    SIZE = _TASK_ID_SIZE

    @classmethod
    def for_normal_task(cls, job_id: JobID) -> "TaskID":
        return cls(_next_unique() + ActorID.nil().binary()[: _ACTOR_UNIQUE_SIZE] + job_id.binary())

    @classmethod
    def for_actor_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(_next_unique() + actor_id.binary())

    @classmethod
    def for_actor_creation(cls, actor_id: ActorID) -> "TaskID":
        # Deterministic: zero unique prefix marks the creation task.
        return cls(b"\x00" * _TASK_UNIQUE_SIZE + actor_id.binary())

    @classmethod
    def for_driver(cls, job_id: JobID) -> "TaskID":
        # 0xFE-filled prefix: the 8-byte little-endian counter reaches it
        # only after ~1.8e19 submissions
        return cls(b"\xfe" * _TASK_UNIQUE_SIZE + ActorID.nil().binary()[: _ACTOR_UNIQUE_SIZE] + job_id.binary())

    def actor_id(self) -> ActorID:
        embedded = self._bytes[_TASK_UNIQUE_SIZE:]
        # Normal tasks embed a nil actor-unique prefix (job id still present).
        if embedded[:_ACTOR_UNIQUE_SIZE] == b"\xff" * _ACTOR_UNIQUE_SIZE:
            return ActorID.nil()
        return ActorID(embedded)

    def job_id(self) -> JobID:
        return JobID(self._bytes[-_JOB_ID_SIZE:])


class ObjectID(BaseID):
    """Embeds the creating TaskID + return/put index → lineage is recoverable."""

    SIZE = _OBJECT_ID_SIZE

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        # index 0 is reserved for puts; returns start at 1 (reference convention).
        return cls(task_id.binary() + index.to_bytes(_OBJECT_INDEX_SIZE, "little"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        # puts use the high bit of the index to avoid collision with returns.
        idx = put_index | 0x80000000
        return cls(task_id.binary() + idx.to_bytes(_OBJECT_INDEX_SIZE, "little"))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:_TASK_ID_SIZE])

    def job_id(self) -> JobID:
        return self.task_id().job_id()

    def index(self) -> int:
        return int.from_bytes(self._bytes[_TASK_ID_SIZE:], "little")

    def is_put(self) -> bool:
        return bool(self.index() & 0x80000000)

    def is_return(self) -> bool:
        return not self.is_put()


class PlacementGroupID(BaseID):
    SIZE = _PG_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID) -> "PlacementGroupID":
        return cls(os.urandom(_PG_UNIQUE_SIZE) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[_PG_UNIQUE_SIZE:])


class UniqueID(BaseID):
    """General-purpose 28-byte id (reference ``kUniqueIDSize=28``,
    src/ray/common/id.h) — the base width of ids that don't embed lineage."""

    SIZE = 28


class FunctionID(UniqueID):
    """Identifies a registered function (content hash width parity:
    ``FunctionID``, src/ray/common/id.h)."""


class ActorClassID(UniqueID):
    """Identifies an exported actor class (``ActorClassID``,
    src/ray/common/id.h)."""


# --------------------------------------------------------------------------
# Native tier: the C extension re-implements these types with C-speed
# tp_hash/tp_richcompare (ids are the dict keys on every submit/result
# path).  Semantics are identical — tests/test_torch_native.py asserts parity
# class by class, and RAY_TPU_PURE_PY_IDS=1 keeps the Python classes (used
# by the parity tests themselves, and as the fallback wherever the
# toolchain can't build the extension).  All-or-nothing per process: mixing
# C and Python id instances in one dict would break equality.  The C types
# are named ``ray_tpu_torch.core.ids.*``, so they pickle through this module.
if os.environ.get("RAY_TPU_PURE_PY_IDS") != "1":
    try:
        from ray_tpu_torch.native import hotpath as _hotpath

        JobID = _hotpath.JobID  # noqa: F811
        NodeID = _hotpath.NodeID  # noqa: F811
        WorkerID = _hotpath.WorkerID  # noqa: F811
        ActorID = _hotpath.ActorID  # noqa: F811
        TaskID = _hotpath.TaskID  # noqa: F811
        ObjectID = _hotpath.ObjectID  # noqa: F811
        PlacementGroupID = _hotpath.PlacementGroupID  # noqa: F811
    except Exception:  # noqa: BLE001 — no compiler / load failure: Python tier
        pass
