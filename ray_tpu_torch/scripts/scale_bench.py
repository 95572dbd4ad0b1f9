"""Control-plane scale suite (reference: release/benchmarks/ —
many_actors 10k actors @638/s, many_tasks 10k tasks/2500 CPUs, many_pgs
1k placement groups; head peak RSS 3.66 GB in
release/release_logs/2.22.0/benchmarks/many_actors.json).

Measures the fabric's control plane — actor FSM registration/scheduling,
task submission/drain throughput, placement-group 2PC — at release-test
sizes, plus the head process's peak RSS.  Actors run execution="inproc"
(one process cannot host 10k OS processes; the reference's figure is
cluster-wide — what this row measures is the HEAD's bookkeeping rate,
which is the component the reference benchmark exists to bound).

Usage: python -m ray_tpu_torch.scripts.scale_bench [out.json]
       (sizes shrink with SCALE=0.1 for the in-suite regression run)
"""

from __future__ import annotations

import json
import os
import resource
import sys
import time


def _peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6  # kB -> GB


def many_actors(rt, n: int) -> dict:
    """Launch n actors, wait until every one answered a call (the
    reference row times launch-to-all-alive)."""

    @rt.remote(execution="inproc", num_cpus=0)
    class A:
        def ready(self):
            return 1

    t0 = time.perf_counter()
    actors = [A.remote() for _ in range(n)]
    create_s = time.perf_counter() - t0
    got = rt.get([a.ready.remote() for a in actors], timeout=1800)
    total_s = time.perf_counter() - t0
    assert sum(got) == n
    t1 = time.perf_counter()
    for a in actors:
        rt.kill(a)
    kill_s = time.perf_counter() - t1
    return {
        "num_actors": n,
        "create_s": round(create_s, 2),
        "total_s": round(total_s, 2),
        "actors_per_s": round(n / total_s, 1),
        "kill_per_s": round(n / max(kill_s, 1e-9), 1),
    }


def many_tasks(rt, n: int) -> dict:
    """Submit n no-op tasks and drain every result."""

    @rt.remote(num_cpus=0, execution="inproc")
    def noop():
        return None

    t0 = time.perf_counter()
    refs = [noop.remote() for _ in range(n)]
    submit_s = time.perf_counter() - t0
    rt.get(refs, timeout=1800)
    total_s = time.perf_counter() - t0
    return {
        "num_tasks": n,
        "submit_s": round(submit_s, 2),
        "total_s": round(total_s, 2),
        "tasks_per_s": round(n / total_s, 1),
    }


def many_pgs(rt, n: int) -> dict:
    """Create + ready + remove n placement groups, one bundle each."""
    from ray_tpu_torch.util.placement import placement_group, remove_placement_group

    t0 = time.perf_counter()
    for _ in range(n):
        pg = placement_group([{"CPU": 0.001}], strategy="PACK")
        rt.get(pg.ready(), timeout=60)
        remove_placement_group(pg)
    total_s = time.perf_counter() - t0
    return {
        "num_pgs": n,
        "total_s": round(total_s, 2),
        "pgs_per_s": round(n / total_s, 1),
    }


def run(rt, scale: float = 1.0) -> dict:
    out = {
        "scale": scale,
        "many_actors": many_actors(rt, max(10, int(10_000 * scale))),
        "many_tasks": many_tasks(rt, max(50, int(50_000 * scale))),
        "many_pgs": many_pgs(rt, max(10, int(1_000 * scale))),
        "head_peak_rss_gb": round(_peak_rss_gb(), 3),
        "reference": {
            "many_actors_per_s": 638.2,
            "many_tasks_per_s": 580.7,
            "many_pgs_per_s": 23.6,
            "head_peak_rss_gb": 3.66,
            "source": "release/release_logs/2.22.0/benchmarks/*.json",
        },
    }
    out["vs_reference"] = {
        "actors": round(out["many_actors"]["actors_per_s"] / 638.2, 2),
        "tasks": round(out["many_tasks"]["tasks_per_s"] / 580.7, 2),
        "pgs": round(out["many_pgs"]["pgs_per_s"] / 23.6, 2),
    }
    return out


def main() -> None:
    import ray_tpu_torch as rt

    out_path = sys.argv[1] if len(sys.argv) > 1 else "SCALE.json"
    scale = float(os.environ.get("SCALE", "1.0"))
    rt.init(num_cpus=4)
    try:
        report = run(rt, scale)
    finally:
        rt.shutdown()
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
