"""Declarative chaos schedules: a seeded timeline of fault events.

The port's copy of ``ray_tpu/chaos/schedule.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

A schedule is the reproducible half of a chaos run — ``(seed, schedule)``
fully determines which faults fire (see the determinism contract in
``runtime/failpoints.py``).  Schedules are plain data, JSON round-trippable,
so a failing run is shipped and replayed as a file::

    {
      "seed": 42,
      "events": [
        {"t": 0.0, "kind": "arm",       "spec": "data_plane.send_frame=drop(0.2)"},
        {"t": 1.0, "kind": "partition", "fp": "agent.heartbeat", "duration": 3.0},
        {"t": 2.0, "kind": "kill_node", "index": 1},
        {"t": 2.5, "kind": "lose_objects", "fraction": 0.5},
        {"t": 3.0, "kind": "disarm"}
      ]
    }

Event kinds
-----------
``arm``           arm failpoints from ``spec`` (merges; see failpoints.arm).
``disarm``        disarm ``name`` (one failpoint) or everything.
``partition``     arm ``fp`` at probability 1.0 for ``duration`` seconds,
                  then restore whatever was armed before — a timed network
                  partition of that site.
``kill_node``     kill the ``index``-th live non-head node through the
                  existing ``cluster.kill_node`` chaos hook
                  (NodeKillerActor parity).
``lose_objects``  delete a seeded ``fraction`` of committed objects from
                  every store and kick lineage reconstruction — the
                  "silent storage loss" failure mode.
``add_node``      grow the cluster mid-run: add a node with ``resources``
                  (default ``{"CPU": 1}``) and optional ``labels`` — the
                  elastic half of a scale event.
``drain_node``    gracefully remove the ``index``-th live non-head node via
                  ``cluster.drain_node`` (DrainRaylet parity): placements
                  stop, sole-replica objects evacuate, actors restart
                  elsewhere, then the node terminates.
``kill_head``     simulate head control-service death: durable state (incl.
                  failpoint hit counters) snapshots, then mutations go to
                  the doomed incarnation until ``restart_head``.
``restart_head``  restore the head from the kill-time snapshot; live nodes
                  re-adopt and live actor instances reconcile.
``slow_node``     arm a fixed per-dispatch delay on the ``index``-th live
                  non-head node (``delay`` seconds; 0 clears) — the
                  deterministic straggler the hedging machinery exists for.
``partition_node``  gray failure: declare the ``index``-th live non-head
                  node dead (full death sweep) WITHOUT shutting it down —
                  its runtime keeps executing and its commits must all be
                  rejected as fenced (stale incarnation).
``heal_partition``  the partition heals: the fenced node self-fences
                  (workers killed, store dropped, pins cleared) and a
                  FRESH node joins through the add_node elasticity path.
``overload``      deterministic synthetic load injector: submit ``tasks``
                  no-op tasks demanding ``cpus`` CPUs each and holding
                  their slot ``hold_s`` seconds — offered load beyond the
                  bounded admission queues must SHED with typed
                  OverloadedError, never grow a queue or double-execute
                  (invariant 11).  The injector's refs join the invariant
                  sweep's resolution set.
``preempt_gang_member``  preempt one member of a registered training gang
                  (``job`` names the TrainController; default: the first
                  registered, sorted).  ``graceful=True`` (default) drives
                  the checkpoint → shrink → continue ladder the serving
                  admission path uses; ``graceful=False`` hard-kills the
                  member (``kill -9`` equivalent), which must flip the plan
                  BROKEN with a typed error and repair bit-exact from the
                  latest step checkpoint (invariant 12).
``kill_decode_replica``  kill one replica of a disaggregated serving
                  deployment (``deployment`` names it; default: the sole
                  roles deployment), by ``role`` (default ``"decode"``) and
                  ``index`` within the pool (default 0, list order — never
                  random).  A migration in flight must surface as a typed
                  KVMigrationError internally and re-prefill on a fresh
                  replica pair; every staged block set still reaches
                  exactly one terminal outcome (invariant 13).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

_KINDS = (
    "arm", "disarm", "partition", "kill_node", "lose_objects",
    "add_node", "drain_node", "kill_head", "restart_head",
    "slow_node", "partition_node", "heal_partition", "overload",
    "preempt_gang_member", "kill_decode_replica",
)


class ChaosEvent:
    __slots__ = ("t", "kind", "params")

    def __init__(self, t: float, kind: str, **params: Any):
        if kind not in _KINDS:
            raise ValueError(f"unknown chaos event kind {kind!r} (expected one of {_KINDS})")
        self.t = float(t)
        self.kind = kind
        self.params = params

    def to_dict(self) -> dict:
        return {"t": self.t, "kind": self.kind, **self.params}

    @classmethod
    def from_dict(cls, d: dict) -> "ChaosEvent":
        d = dict(d)
        t = d.pop("t", 0.0)
        kind = d.pop("kind")
        return cls(t, kind, **d)

    def __repr__(self):
        return f"ChaosEvent(t={self.t}, kind={self.kind!r}, {self.params})"


class ChaosSchedule:
    """An ordered fault timeline plus the decision-stream seed."""

    def __init__(self, events: List[ChaosEvent], seed: int = 0, name: str = ""):
        self.events = sorted(events, key=lambda e: e.t)
        self.seed = int(seed)
        self.name = name

    # ------------------------------------------------------------- codec
    def to_dict(self) -> dict:
        out: Dict[str, Any] = {"seed": self.seed, "events": [e.to_dict() for e in self.events]}
        if self.name:
            out["name"] = self.name
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "ChaosSchedule":
        return cls(
            [ChaosEvent.from_dict(e) for e in d.get("events", [])],
            seed=d.get("seed", 0),
            name=d.get("name", ""),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "ChaosSchedule":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load(cls, path: str, seed: Optional[int] = None) -> "ChaosSchedule":
        with open(path) as f:
            sched = cls.from_json(f.read())
        if seed is not None:
            sched.seed = int(seed)
        return sched

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    def duration(self) -> float:
        """Timeline span including partition windows (the runner keeps
        walking until every timed window has closed)."""
        end = 0.0
        for e in self.events:
            end = max(end, e.t + float(e.params.get("duration", 0.0)))
        return end


# --------------------------------------------------------------------------
# schema validation (`rt chaos validate`) — catch a malformed schedule in
# milliseconds instead of finding out minutes into a chaos run
# --------------------------------------------------------------------------

#: per-kind parameter schema: name -> (required, {param: allowed types})
_EVENT_SCHEMA: Dict[str, Dict[str, tuple]] = {
    "arm": {"spec": (True, (str, dict))},
    "disarm": {"name": (False, (str,))},
    "partition": {"fp": (True, (str,)), "duration": (False, (int, float))},
    "kill_node": {"index": (False, (int,))},
    "drain_node": {"index": (False, (int,)), "timeout": (False, (int, float))},
    "add_node": {"resources": (False, (dict,)), "labels": (False, (dict,))},
    "kill_head": {},
    "restart_head": {},
    "lose_objects": {"fraction": (False, (int, float))},
    "slow_node": {"index": (False, (int,)), "delay": (False, (int, float))},
    "partition_node": {"index": (False, (int,))},
    "heal_partition": {},
    "overload": {
        "tasks": (False, (int,)),
        "cpus": (False, (int, float)),
        "hold_s": (False, (int, float)),
    },
    "preempt_gang_member": {
        "job": (False, (str,)),
        "index": (False, (int,)),
        "graceful": (False, (bool,)),
    },
    "kill_decode_replica": {
        "deployment": (False, (str,)),
        "role": (False, (str,)),
        "index": (False, (int,)),
    },
}


def validate_schedule(data: Any, num_nodes: Optional[int] = None) -> List[str]:
    """Schema-check a schedule dict (as loaded from JSON) WITHOUT running
    anything.  Returns a list of friendly error strings — empty means valid.

    ``num_nodes`` (optional) is the number of live non-head worker nodes the
    run will start with; when given, ``kill_node``/``drain_node`` indices
    are bounds-checked against a simulated node count that tracks
    ``add_node``/``kill_node``/``drain_node`` events in timeline order."""
    errors: List[str] = []
    if not isinstance(data, dict):
        return [f"schedule must be a JSON object, got {type(data).__name__}"]
    if "seed" in data and not isinstance(data["seed"], int):
        errors.append(f"'seed' must be an integer, got {data['seed']!r}")
    events = data.get("events")
    if events is None:
        return errors + ["schedule has no 'events' list"]
    if not isinstance(events, list):
        return errors + [f"'events' must be a list, got {type(events).__name__}"]

    from ray_tpu_torch.runtime.failpoints import parse_spec

    indexed = []
    for i, ev in enumerate(events):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: must be an object, got {type(ev).__name__}")
            continue
        kind = ev.get("kind")
        if kind is None:
            errors.append(f"{where}: missing 'kind'")
            continue
        if kind not in _KINDS:
            errors.append(
                f"{where}: unknown kind {kind!r} (expected one of {', '.join(_KINDS)})"
            )
            continue
        t = ev.get("t", 0.0)
        if not isinstance(t, (int, float)) or isinstance(t, bool):
            errors.append(f"{where} ({kind}): 't' must be a number, got {t!r}")
            t = 0.0
        elif t < 0:
            errors.append(f"{where} ({kind}): 't' must be >= 0, got {t}")
        schema = _EVENT_SCHEMA[kind]
        for pname, (required, _types) in schema.items():
            if required and pname not in ev:
                errors.append(f"{where} ({kind}): missing required parameter {pname!r}")
        for pname, pval in ev.items():
            if pname in ("t", "kind"):
                continue
            if pname not in schema:
                errors.append(
                    f"{where} ({kind}): unknown parameter {pname!r} "
                    f"(accepts: {', '.join(schema) or 'none'})"
                )
                continue
            types = schema[pname][1]
            if not isinstance(pval, types) or (isinstance(pval, bool) and bool not in types):
                names = "/".join(tp.__name__ for tp in types)
                errors.append(
                    f"{where} ({kind}): {pname!r} must be {names}, got {pval!r}"
                )
        if kind == "arm" and isinstance(ev.get("spec"), str):
            try:
                parse_spec(ev["spec"])
            except ValueError as exc:
                errors.append(f"{where} (arm): bad failpoint spec: {exc}")
        if kind == "partition" and isinstance(ev.get("duration"), (int, float)) \
                and ev["duration"] <= 0:
            errors.append(f"{where} (partition): 'duration' must be > 0")
        if kind == "lose_objects" and isinstance(ev.get("fraction"), (int, float)) \
                and not 0.0 <= ev["fraction"] <= 1.0:
            errors.append(
                f"{where} (lose_objects): 'fraction' must be in [0, 1], "
                f"got {ev['fraction']}"
            )
        if kind in ("kill_node", "drain_node", "slow_node", "partition_node") \
                and isinstance(ev.get("index"), int) and ev["index"] < 0:
            errors.append(f"{where} ({kind}): 'index' must be >= 0")
        if kind == "slow_node" and isinstance(ev.get("delay"), (int, float)) \
                and ev["delay"] < 0:
            errors.append(f"{where} (slow_node): 'delay' must be >= 0")
        if kind == "preempt_gang_member" and isinstance(ev.get("index"), int) \
                and ev["index"] < 0:
            errors.append(f"{where} (preempt_gang_member): 'index' must be >= 0")
        if kind == "kill_decode_replica":
            if isinstance(ev.get("index"), int) and ev["index"] < 0:
                errors.append(f"{where} (kill_decode_replica): 'index' must be >= 0")
            if isinstance(ev.get("role"), str) and ev["role"] not in ("prefill", "decode"):
                errors.append(
                    f"{where} (kill_decode_replica): 'role' must be "
                    f"'prefill' or 'decode', got {ev['role']!r}"
                )
        if kind == "overload":
            if isinstance(ev.get("tasks"), int) and ev["tasks"] < 1:
                errors.append(f"{where} (overload): 'tasks' must be >= 1")
            if isinstance(ev.get("cpus"), (int, float)) and ev["cpus"] <= 0:
                errors.append(f"{where} (overload): 'cpus' must be > 0")
            if isinstance(ev.get("hold_s"), (int, float)) and ev["hold_s"] < 0:
                errors.append(f"{where} (overload): 'hold_s' must be >= 0")
        indexed.append((t, i, kind, ev))

    # timeline-order simulation: head liveness pairing + node-index bounds
    indexed.sort(key=lambda e: (e[0], e[1]))
    head_down = False
    live = num_nodes
    partitioned = 0
    for t, i, kind, ev in indexed:
        where = f"event[{i}]"
        if kind == "kill_head":
            if head_down:
                errors.append(f"{where}: kill_head while the head is already down")
            head_down = True
        elif kind == "restart_head":
            if not head_down:
                errors.append(f"{where}: restart_head without a preceding kill_head")
            head_down = False
        elif kind == "heal_partition":
            if partitioned <= 0:
                errors.append(
                    f"{where}: heal_partition without a preceding partition_node"
                )
            else:
                partitioned -= 1
                if live is not None:
                    live += 1  # the fenced node rejoins as a FRESH node
        elif live is not None:
            if kind == "add_node":
                live += 1
            elif kind in ("kill_node", "drain_node", "partition_node", "slow_node"):
                idx = ev.get("index", 0)
                if isinstance(idx, int) and idx >= live:
                    errors.append(
                        f"{where} ({kind}): index {idx} out of range — only "
                        f"{live} live non-head node(s) at t={t}"
                    )
                if kind != "slow_node":
                    live = max(0, live - 1)
                if kind == "partition_node":
                    partitioned += 1
        elif kind == "partition_node":
            partitioned += 1
    if head_down:
        errors.append("schedule ends with the head still down (missing restart_head)")
    return errors


def validate_cli(args) -> int:
    """``rt chaos validate <schedule.json> [--nodes N]``: schema-check a
    schedule before a run burns minutes on it."""
    import sys

    try:
        with open(args.schedule) as f:
            data = json.load(f)
    except OSError as exc:
        print(f"cannot read {args.schedule}: {exc}", file=sys.stderr)
        return 1
    except json.JSONDecodeError as exc:
        print(f"{args.schedule} is not valid JSON: {exc}", file=sys.stderr)
        return 1
    errors = validate_schedule(data, num_nodes=args.nodes)
    if errors:
        print(f"{args.schedule}: {len(errors)} problem(s)", file=sys.stderr)
        for err in errors:
            print(f"  - {err}", file=sys.stderr)
        return 1
    n = len(data.get("events", []))
    print(f"{args.schedule}: ok ({n} events, seed {data.get('seed', 0)})")
    return 0
