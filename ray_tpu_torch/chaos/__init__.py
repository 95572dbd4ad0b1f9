"""Deterministic chaos engineering for the ray_tpu_torch fabric.

The port's copy of ``ray_tpu/chaos/__init__.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Three layers:

  * :mod:`ray_tpu_torch.runtime.failpoints` — named fault-injection sites
    compiled into the runtime's hot paths (near-zero cost disarmed), with a
    seeded, hash-indexed decision stream: same ``(seed, spec, workload)``
    -> byte-for-byte identical fault log.
  * :mod:`ray_tpu_torch.chaos.schedule` — a declarative fault timeline (arm a
    frame-drop at t=0, partition the heartbeat at t=1 for 3s, kill a node
    at t=2, lose half the committed objects at t=2.5), JSON-serializable
    so a failing chaos run ships as ``(seed, schedule.json)``.
  * :mod:`ray_tpu_torch.chaos.runner` + :mod:`ray_tpu_torch.chaos.invariants` — execute
    a workload while walking the timeline, wait for quiescence, then assert
    the recovery invariants: every submitted task reached a terminal state
    exactly once per attempt, no object ref resolves to a lost value
    without a raised ``ObjectLostError``, reference counts return to
    baseline, and every retried attempt is visible as a distinct span.

CLI: ``rt chaos run --seed N --schedule f.json``.
"""

from ray_tpu_torch.chaos.invariants import InvariantReport, check_invariants, snapshot_baseline
from ray_tpu_torch.chaos.runner import ChaosResult, ChaosRunner
from ray_tpu_torch.chaos.schedule import ChaosEvent, ChaosSchedule, validate_schedule

__all__ = [
    "ChaosEvent",
    "ChaosSchedule",
    "ChaosRunner",
    "ChaosResult",
    "InvariantReport",
    "check_invariants",
    "snapshot_baseline",
    "validate_schedule",
]
