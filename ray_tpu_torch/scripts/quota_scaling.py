"""CPU-quota scaling proof for the parallel-submitter benchmark rows.

The reference's parallel-submitter numbers come from a 64-CPU node
(release/microbenchmark/tpl_64.yaml); this box exposes ONE core, so those
rows cannot be compared directly.  This runner bounds the gap with a
controlled-resource curve instead of a hand-wave: each selected row runs in
a child process confined to a cgroup cpu quota (0.25 / 0.5 / 1.0 cores on
the cgroup-v1 cpu controller; cpu.max on v2).  If throughput scales
~linearly in quota, the rows are CPU-bound — the ceiling is the box, not
the fabric — and the single-core artifact number extrapolates.

Usage: python -m ray_tpu_torch.scripts.quota_scaling [out.json]
Needs write access to the cgroup cpu controller (CI containers have it).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROWS = (
    "multi_client_tasks_async",
    "n_n_actor_calls_async",
    "n_n_async_actor_calls_async",
    "multi_client_put_calls",
)
QUOTAS = (0.25, 0.5, 1.0)

_V1_ROOT = "/sys/fs/cgroup/cpu"
_V2_ROOT = "/sys/fs/cgroup"

_CHILD_SRC = r"""
import json, os, sys
sys.path.insert(0, {repo!r})
import ray_tpu_torch as rt
from ray_tpu_torch.scripts.microbench import run_suite
rt.init(num_cpus=4)
res = run_suite(rt, select={rows!r})
print("RESULT::" + json.dumps({{k: v for k, (v, _u) in res.items()}}))
rt.shutdown()
"""


def _cgroup_create(name: str, quota: float):
    """Returns (procs_path, cleanup) or None when no writable controller."""
    v1 = os.path.join(_V1_ROOT, name)
    try:
        os.makedirs(v1, exist_ok=True)
        with open(os.path.join(v1, "cpu.cfs_period_us"), "w") as f:
            f.write("100000")
        with open(os.path.join(v1, "cpu.cfs_quota_us"), "w") as f:
            f.write(str(int(quota * 100000)))
        return os.path.join(v1, "cgroup.procs"), lambda: os.rmdir(v1)
    except OSError:
        pass
    v2 = os.path.join(_V2_ROOT, name)
    try:
        os.makedirs(v2, exist_ok=True)
        with open(os.path.join(v2, "cpu.max"), "w") as f:
            f.write(f"{int(quota * 100000)} 100000")
        return os.path.join(v2, "cgroup.procs"), lambda: os.rmdir(v2)
    except OSError:
        return None


def run_quota(quota: float, rows=ROWS, repo_root: str | None = None) -> dict:
    repo_root = repo_root or os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    made = _cgroup_create(f"rtq_{int(quota * 100)}", quota)
    if made is None:
        raise RuntimeError("no writable cgroup cpu controller")
    procs_path, cleanup = made
    child = subprocess.Popen(
        [sys.executable, "-c", _CHILD_SRC.format(repo=repo_root, rows=list(rows))],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    try:
        # confine the child (its worker processes inherit membership)
        with open(procs_path, "w") as f:
            f.write(str(child.pid))
        out, _ = child.communicate(timeout=1800)
        for line in out.splitlines():
            if line.startswith("RESULT::"):
                return json.loads(line[len("RESULT::"):])
        raise RuntimeError(f"bench child produced no result (rc={child.returncode})")
    finally:
        child.kill()
        try:
            cleanup()
        except OSError:
            pass  # pids may linger briefly; next run recreates


def linearity(curve: dict) -> float:
    """Throughput ratio per quota doubling, averaged: 1.0 = perfectly
    CPU-bound, <<1 = something other than CPU limits the row."""
    qs = sorted(curve)
    ratios = []
    for lo, hi in zip(qs, qs[1:]):
        if curve[lo] > 0:
            ratios.append((curve[hi] / curve[lo]) / (hi / lo))
    return sum(ratios) / len(ratios) if ratios else 0.0


def main() -> None:
    out_path = sys.argv[1] if len(sys.argv) > 1 else "QUOTA_SCALING.json"
    results: dict = {row: {} for row in ROWS}
    for quota in QUOTAS:
        vals = run_quota(quota)
        for row, v in vals.items():
            results[row][quota] = v
        print(f"quota {quota}: " + ", ".join(f"{r}={v:.0f}" for r, v in vals.items()))
    report = {
        "curves": results,
        "linearity": {row: round(linearity(c), 3) for row, c in results.items()},
        "quotas": list(QUOTAS),
    }
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report["linearity"]))


if __name__ == "__main__":
    main()
