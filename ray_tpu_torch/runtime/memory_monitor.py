"""Memory monitor + OOM worker-killing policies.

The port's copy of ``ray_tpu/runtime/memory_monitor.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Parity: ``src/ray/common/memory_monitor.h:52`` (MemoryMonitor polls system
memory against a usage threshold) and the raylet's pluggable
worker-killing policies (``src/ray/raylet/worker_killing_policy*.h`` —
retriable-FIFO and group-by-owner). When host memory crosses the threshold
the monitor asks the policy which task process to kill; the killed task
fails with ``OutOfMemoryError`` and retries per its retry policy (the
reference's OOM-killed tasks are retried with backoff the same way).

TPU note: HBM pressure is handled separately (and earlier) by the object
store's spill tiers — this monitor guards host RAM, where process workers
and staged host arrays live.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

logger = logging.getLogger(__name__)


def system_memory() -> tuple[int, int]:
    """(used_bytes, total_bytes) from /proc/meminfo (cgroup-aware when a
    limit is set, like the reference's MemoryMonitor)."""
    total = avail = None
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1]) * 1024
                if total is not None and avail is not None:
                    break
    except OSError:
        return 0, 0
    if total is None or avail is None:
        return 0, 0
    # cgroup v2 limit, if tighter than the host
    try:
        with open("/sys/fs/cgroup/memory.max") as f:
            raw = f.read().strip()
        if raw != "max":
            limit = int(raw)
            if limit < total:
                with open("/sys/fs/cgroup/memory.current") as f:
                    current = int(f.read().strip())
                # memory.current counts reclaimable page cache; subtract
                # inactive_file like the reference MemoryMonitor, or a
                # file-streaming task would trigger false OOM kills
                try:
                    with open("/sys/fs/cgroup/memory.stat") as f:
                        for line in f:
                            if line.startswith("inactive_file "):
                                current -= int(line.split()[1])
                                break
                except (OSError, ValueError):
                    pass
                return max(current, 0), limit
    except (OSError, ValueError):
        pass
    return total - avail, total


@dataclass
class KillCandidate:
    """A killable task process as the policy sees it."""

    task_id: object
    owner_id: object          # submitter (job/worker) — for group-by-owner
    start_time: float
    retriable: bool
    kill_fn: Callable[[], None]


class WorkerKillingPolicy:
    """Pick which candidate dies under memory pressure."""

    def select(self, candidates: List[KillCandidate]) -> Optional[KillCandidate]:
        raise NotImplementedError


class RetriableFIFOPolicy(WorkerKillingPolicy):
    """Prefer retriable tasks, newest first (killing the newest loses the
    least progress; retriable death is recoverable) —
    ``worker_killing_policy.h`` RetriableFIFOWorkerKillingPolicy."""

    def select(self, candidates):
        if not candidates:
            return None
        return sorted(candidates, key=lambda c: (not c.retriable, -c.start_time))[0]


class GroupByOwnerPolicy(WorkerKillingPolicy):
    """Kill from the owner with the most running tasks (spreads pain across
    jobs instead of starving one) — ``worker_killing_policy_group_by_owner.h``."""

    def select(self, candidates):
        if not candidates:
            return None
        by_owner: dict = {}
        for c in candidates:
            by_owner.setdefault(c.owner_id, []).append(c)
        # largest group; break ties toward retriable, newest
        group = max(by_owner.values(), key=len)
        return sorted(group, key=lambda c: (not c.retriable, -c.start_time))[0]


class MemoryMonitor:
    """Polls memory usage; above ``usage_threshold`` invokes the policy on
    the node's killable tasks until usage drops."""

    def __init__(
        self,
        candidates_fn: Callable[[], List[KillCandidate]],
        usage_threshold: float = 0.95,
        poll_interval_s: float = 0.25,
        policy: Optional[WorkerKillingPolicy] = None,
        memory_fn: Callable[[], tuple] = system_memory,
        min_kill_interval_s: float = 1.0,
    ):
        self._candidates_fn = candidates_fn
        self.usage_threshold = usage_threshold
        self.poll_interval_s = poll_interval_s
        self.policy = policy or RetriableFIFOPolicy()
        self._memory_fn = memory_fn
        self._min_kill_interval_s = min_kill_interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_kill = 0.0
        self.num_kills = 0

    def start(self) -> "MemoryMonitor":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, name="rt-memory-monitor", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def check_once(self) -> bool:
        """One poll cycle; returns True if a kill was issued (test hook)."""
        used, total = self._memory_fn()
        if total <= 0 or used / total < self.usage_threshold:
            return False
        now = time.monotonic()
        if now - self._last_kill < self._min_kill_interval_s:
            return False
        victim = self.policy.select(self._candidates_fn())
        if victim is None:
            return False
        logger.warning(
            "memory pressure %.1f%% >= %.0f%%: killing task %s (policy %s)",
            100.0 * used / total,
            100.0 * self.usage_threshold,
            victim.task_id,
            type(self.policy).__name__,
        )
        self._last_kill = now
        self.num_kills += 1
        try:
            victim.kill_fn()
        except Exception:
            logger.exception("kill_fn failed for %s", victim.task_id)
        return True

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.check_once()
            except Exception:
                logger.exception("memory monitor poll failed")
