"""Per-node metrics reporter + head-side time-series history.

Reference parity: the dashboard's per-node agent & reporter module
(``dashboard/agent.py:28``, ``dashboard/modules/reporter/``) — each node
samples CPU/memory/device utilization and ships it to the head, which keeps
ring-buffer time series the UI graphs.  The port's copy of
``ray_tpu/dashboard/reporter.py``; device memory comes from
``torch.cuda.mem_get_info`` (``accelerators/gpu.py``) where a card is
visible.

Transport: agents piggyback samples on the existing ``resource_report``
control message (no extra channel, no extra socket); the head node samples
itself on a local thread.  Sampling is /proc-based (no psutil in the
image).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, Optional

from ray_tpu_torch.accelerators import gpu


class SystemSampler:
    """CPU%, memory, load, worker-visible TPU memory for THIS process's
    host.  CPU% is computed from /proc/stat deltas between calls."""

    def __init__(self):
        self._last_cpu: Optional[tuple] = None
        self._tpu_ok: Optional[bool] = None  # None = not probed yet

    def _cpu_times(self):
        try:
            with open("/proc/stat") as f:
                parts = f.readline().split()
            fields = [int(x) for x in parts[1:9]]
            idle = fields[3] + fields[4]  # idle + iowait
            return sum(fields), idle
        except (OSError, ValueError, IndexError):
            return None

    def _meminfo(self):
        total = avail = 0
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemTotal:"):
                        total = int(line.split()[1]) * 1024
                    elif line.startswith("MemAvailable:"):
                        avail = int(line.split()[1]) * 1024
                    if total and avail:
                        break
        except (OSError, ValueError):
            pass
        return total, avail

    def _tpu_memory(self):
        """(bytes_in_use, bytes_limit) of the card, or None without one.  The
        JAX package's name and sample keys (``tpu_mem_*``) are kept, as the
        metric families are, so both packages report under one schema."""
        if self._tpu_ok is False:
            return None
        mem = gpu.device_memory()
        if mem is None:
            self._tpu_ok = False
            return None
        return mem["used"], mem["total"]

    def sample(self) -> dict:
        out: dict = {"ts": time.time()}
        cur = self._cpu_times()
        if cur is not None and self._last_cpu is not None:
            dt_total = cur[0] - self._last_cpu[0]
            dt_idle = cur[1] - self._last_cpu[1]
            if dt_total > 0:
                out["cpu_percent"] = round(100.0 * (1 - dt_idle / dt_total), 1)
        if cur is not None:
            self._last_cpu = cur
        total, avail = self._meminfo()
        if total:
            out["mem_total"] = total
            out["mem_used"] = total - avail
            out["mem_percent"] = round(100.0 * (total - avail) / total, 1)
        try:
            out["load1"] = round(os.getloadavg()[0], 2)
        except OSError:
            pass
        tpu = self._tpu_memory()
        if tpu is not None:
            out["tpu_mem_used"], out["tpu_mem_limit"] = tpu
            if tpu[1]:
                out["tpu_mem_percent"] = round(100.0 * tpu[0] / tpu[1], 1)
        return out


class MetricsHistory:
    """Ring-buffer time series per node (the head's reporter store).
    ~1 h at one sample per 2 s."""

    def __init__(self, maxlen: int = 1800, min_interval_s: float = 2.0):
        self._lock = threading.Lock()
        self._series: Dict[str, deque] = {}
        self._last_add: Dict[str, float] = {}
        self._maxlen = maxlen
        self._min_interval = min_interval_s

    def add(self, node_hex: str, metrics: Optional[dict]) -> None:
        if not metrics:
            return
        now = time.monotonic()
        with self._lock:
            if now - self._last_add.get(node_hex, 0.0) < self._min_interval:
                return
            self._last_add[node_hex] = now
            self._series.setdefault(node_hex, deque(maxlen=self._maxlen)).append(metrics)
        # mirror the freshest sample into the Prometheus gauges so /metrics
        # scrapes carry node utilization without a second sampling path
        from ray_tpu_torch.observability import metric_defs

        tags = {"node": node_hex[:8]}
        if "cpu_percent" in metrics:
            metric_defs.NODE_CPU_PERCENT.set(metrics["cpu_percent"], tags)
        if "mem_used" in metrics:
            metric_defs.NODE_MEM_USED_BYTES.set(metrics["mem_used"], tags)
        if "tpu_mem_used" in metrics:
            metric_defs.NODE_TPU_MEM_USED_BYTES.set(metrics["tpu_mem_used"], tags)

    def series(self, node_hex: str, minutes: float = 15.0):
        cutoff = time.time() - minutes * 60
        with self._lock:
            points = list(self._series.get(node_hex, ()))
        return [p for p in points if p.get("ts", 0) >= cutoff]

    def all_series(self, minutes: float = 15.0) -> Dict[str, list]:
        with self._lock:
            nodes = list(self._series.keys())
        return {n: self.series(n, minutes) for n in nodes}

    def drop_node(self, node_hex: str) -> None:
        with self._lock:
            self._series.pop(node_hex, None)
            self._last_add.pop(node_hex, None)


class NodeLogStore:
    """Per-node ring buffer of worker log lines (the head's log-viewer
    store; reference: dashboard log module + per-node log_monitor)."""

    def __init__(self, maxlen: int = 2000):
        self._lock = threading.Lock()
        self._logs: Dict[str, deque] = {}
        self._maxlen = maxlen

    def append(self, node_hex: str, lines) -> None:
        with self._lock:
            buf = self._logs.setdefault(node_hex, deque(maxlen=self._maxlen))
            for line in lines:
                buf.append(line)

    def tail(self, node_hex: str, n: int = 200):
        with self._lock:
            buf = self._logs.get(node_hex)
            if buf is None:
                return []
            return list(buf)[-n:]

    def nodes(self):
        with self._lock:
            return list(self._logs.keys())

    def search(self, pattern: str, limit: int = 500, node_hex: str | None = None):
        """Cross-node log grep (regex; falls back to substring on a bad
        pattern).  Returns [{"node", "line"}] newest-last, capped at
        ``limit`` (reference: the dashboard log module's search box)."""
        import re

        try:
            rx = re.compile(pattern)
            match = rx.search
        except re.error:
            match = lambda line: pattern in line  # noqa: E731
        # snapshot under the lock, match OUTSIDE it: a pathological regex
        # (catastrophic backtracking) must not stall log ingestion
        with self._lock:
            items = (
                [(node_hex, list(self._logs.get(node_hex, ())))]
                if node_hex is not None
                else [(n, list(buf)) for n, buf in self._logs.items()]
            )
        out = []
        for node, buf in items:
            for line in buf:
                if match(line):
                    out.append({"node": node, "line": line})
        return out[-limit:]
