"""Usage stats collection, local-only.

The port's copy of ``ray_tpu/usage/usage_lib.py``: the report has the same
keys; its ``source`` names this package, so a report says which of the two
packages wrote it.

Parity: ``python/ray/_private/usage/usage_lib.py:95`` — opt-out collection
of library/feature usage tags. The reference phones home; this build has
zero egress by design, so the report is only ever written to the session
dir (``usage_stats.json``) where operators can inspect exactly what would
be reported. Opt out with ``RAY_TPU_USAGE_STATS_ENABLED=0``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict

_lock = threading.Lock()
_tags: Dict[str, str] = {}
_counters: Dict[str, int] = {}


def usage_stats_enabled() -> bool:
    return os.environ.get("RAY_TPU_USAGE_STATS_ENABLED", "1") not in ("0", "false", "False")


def record_extra_usage_tag(key: str, value: str) -> None:
    """Tag a feature as used (reference TagKey semantics)."""
    if not usage_stats_enabled():
        return
    with _lock:
        _tags[str(key)] = str(value)
        _counters[str(key)] = _counters.get(str(key), 0) + 1


def usage_report() -> dict:
    from ray_tpu_torch._version import version

    with _lock:
        tags = dict(_tags)
        counters = dict(_counters)
    return {
        "schema_version": "0.1",
        "source": "ray_tpu_torch",
        "version": version,
        "collected_at": time.time(),
        "tags": tags,
        "counters": counters,
        "total_num_cpus": os.cpu_count(),
    }


def write_usage_report(session_dir: str) -> str:
    """Dump the report into the session dir (called at shutdown)."""
    path = os.path.join(session_dir, "usage_stats.json")
    try:
        with open(path, "w") as f:
            json.dump(usage_report(), f, indent=2)
    except OSError:
        pass
    return path
