"""Chaos schedule runner: execute a workload while walking a fault timeline.

The port's copy of ``ray_tpu/chaos/runner.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

The runner owns the full life of one chaos run:

  1. reset the fault log and arm the schedule's t=0 state,
  2. snapshot the invariant baseline (refcounts, event counts),
  3. start the workload on its own thread and walk the timeline — arming /
     disarming failpoints, opening timed partitions, killing nodes through
     the existing ``cluster.kill_node`` hook, losing committed objects,
  4. join the workload, wait for quiescence, disarm everything the schedule
     armed (restoring whatever was armed before the run),
  5. run the invariant sweep and return a :class:`ChaosResult` carrying the
     deterministic fault log, the invariant report, and the workload's
     resolution summary.

The **workload** is a zero-arg callable.  If it returns a list of
``ObjectRef`` (the common shape: submit, return the refs), the runner
resolves them inside the invariant sweep; any other return value is kept
verbatim as ``result.workload_result``.

Determinism: ``result.faults`` is ``failpoints.fault_log()`` — sorted by
``(failpoint, hit)``, identical across runs of the same ``(seed, schedule,
workload)``.  ``ChaosResult.same_faults(other)`` is the comparison a
regression suite asserts.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional

from ray_tpu_torch.chaos import invariants as _inv
from ray_tpu_torch.chaos.schedule import ChaosEvent, ChaosSchedule
from ray_tpu_torch.runtime import failpoints


class ChaosResult:
    def __init__(self):
        self.faults: List[dict] = []
        self.invariants: Optional[_inv.InvariantReport] = None
        self.workload_result: Any = None
        self.workload_error: Optional[BaseException] = None
        self.events_applied: List[dict] = []
        self.duration_s: float = 0.0

    @property
    def ok(self) -> bool:
        return self.workload_error is None and bool(self.invariants)

    def same_faults(self, other: "ChaosResult") -> bool:
        return self.faults == other.faults

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "duration_s": round(self.duration_s, 3),
            "faults": self.faults,
            "events_applied": self.events_applied,
            "invariants": self.invariants.to_dict() if self.invariants else None,
            "workload_error": repr(self.workload_error) if self.workload_error else None,
        }


class ChaosRunner:
    def __init__(self, schedule: ChaosSchedule, quiesce_timeout: float = 60.0):
        self.schedule = schedule
        self.quiesce_timeout = quiesce_timeout
        # refs minted by `overload` injector events: resolved by the
        # invariant sweep alongside the workload's refs, so every injected
        # request provably terminates exactly once (value or typed error)
        self._injected_refs: List[Any] = []

    # ------------------------------------------------------------------
    def run(self, workload: Callable[[], Any]) -> ChaosResult:
        from ray_tpu_torch.core.object_ref import ObjectRef
        from ray_tpu_torch.runtime.worker import global_worker

        cluster = global_worker().cluster
        result = ChaosResult()
        pre_spec = failpoints.armed_spec()  # restored after the run
        failpoints.disarm()                 # also clears log + hit counters
        if pre_spec:
            failpoints.arm(pre_spec, seed=self.schedule.seed)
        else:
            # fix the seed even with nothing armed yet: the first timeline
            # "arm" event must join an already-seeded decision stream
            failpoints.arm({}, seed=self.schedule.seed)
        baseline = _inv.snapshot_baseline()

        box: dict = {}

        def _run_workload():
            try:
                box["value"] = workload()
            except BaseException as exc:  # noqa: BLE001 — reported, not raised
                box["error"] = exc

        t_start = time.monotonic()
        restores: List[tuple] = []  # (deadline, fp name, previous entry|None)
        # t<=0 events apply BEFORE the workload starts: arming must never
        # race the first dispatches, or hit indices shift run-to-run and
        # the fault log stops being reproducible
        timed_events = []
        for event in self.schedule.events:
            if event.t <= 0.0:
                try:
                    applied = self._apply(cluster, event, restores, t_start)
                except Exception as exc:  # noqa: BLE001
                    applied = {"error": f"{type(exc).__name__}: {exc}"}
                result.events_applied.append({"t": event.t, "kind": event.kind, **(applied or {})})
            else:
                timed_events.append(event)
        worker_thread = threading.Thread(target=_run_workload, name="chaos-workload", daemon=True)
        worker_thread.start()

        # -- walk the timeline ------------------------------------------
        for event in timed_events:
            self._sleep_until(t_start + event.t)
            self._fire_pending_restores(restores, now=time.monotonic())
            try:
                applied = self._apply(cluster, event, restores, t_start)
            except Exception as exc:  # noqa: BLE001 — a bad event must not strand the run
                applied = {"error": f"{type(exc).__name__}: {exc}"}
            result.events_applied.append({"t": event.t, "kind": event.kind, **(applied or {})})
        # close any still-open partition windows
        while restores:
            self._sleep_until(min(r[0] for r in restores))
            self._fire_pending_restores(restores, now=time.monotonic())

        worker_thread.join(timeout=self.quiesce_timeout)
        if worker_thread.is_alive():
            result.workload_error = TimeoutError(
                f"chaos workload still running after {self.quiesce_timeout}s"
            )
        else:
            result.workload_error = box.get("error")
            result.workload_result = box.get("value")

        # -- capture the deterministic artifact, restore pre-run arming --
        # Quiesce FIRST: a workload that returns unresolved refs still has
        # tasks in flight, and disarming/capturing mid-flight would make
        # the log race-dependent (truncated at a wall-clock instant).
        _inv.wait_quiescent(cluster, timeout=self.quiesce_timeout)
        result.faults = failpoints.fault_log()
        failpoints.disarm()
        if pre_spec:
            failpoints.arm(pre_spec)

        # -- invariants --------------------------------------------------
        refs = None
        value = result.workload_result
        if isinstance(value, list) and value and all(isinstance(r, ObjectRef) for r in value):
            refs = value
            result.workload_result = f"<{len(refs)} refs (resolved by invariant sweep)>"
        if self._injected_refs:
            if refs is None:
                refs = self._injected_refs
            else:
                # extend IN PLACE: the sweep clears this list to drop the
                # workload's pins, and the workload's own reference to it
                # must drain too (a fresh merged list would leave the
                # original pinning every ref past the refcount check)
                refs.extend(self._injected_refs)
            self._injected_refs = []
        result.invariants = _inv.check_invariants(
            refs=refs, baseline=baseline, timeout=self.quiesce_timeout
        )
        result.duration_s = time.monotonic() - t_start
        return result

    # ------------------------------------------------------------------
    @staticmethod
    def _sleep_until(deadline: float) -> None:
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            time.sleep(min(remaining, 0.05))

    @staticmethod
    def _fire_pending_restores(restores: List[tuple], now: float) -> None:
        for entry in list(restores):
            deadline, name, prev = entry
            if now >= deadline:
                if prev is None:
                    failpoints.disarm(name)
                else:
                    failpoints.arm({name: prev})
                restores.remove(entry)

    def _apply(self, cluster, event: ChaosEvent, restores: List[tuple], t_start: float) -> dict:
        p = event.params
        if event.kind == "arm":
            failpoints.arm(p["spec"], seed=self.schedule.seed)
            return {"spec": p["spec"]}
        if event.kind == "disarm":
            failpoints.disarm(p.get("name"))
            return {"name": p.get("name")}
        if event.kind == "partition":
            name = p["fp"]
            prev = failpoints.configured(name)
            failpoints.arm({name: {"action": "partition", "prob": 1.0, "delay_s": 0.0}})
            restores.append((t_start + event.t + float(p.get("duration", 1.0)), name, prev))
            return {"fp": name, "duration": p.get("duration", 1.0)}
        if event.kind in ("kill_node", "drain_node"):
            victims = [
                (nid, node) for nid, node in cluster.nodes.items()
                if not node.dead and node is not cluster.head_node
            ]
            idx = int(p.get("index", 0))
            if idx >= len(victims):
                return {"skipped": f"no live non-head node at index {idx}"}
            nid, node = victims[idx]
            if event.kind == "kill_node":
                cluster.kill_node(nid, reason="chaos schedule kill_node")
                return {"node": nid.hex()[:8]}
            report = cluster.drain_node(nid, timeout_s=p.get("timeout"))
            return {
                "node": nid.hex()[:8],
                "outcome": report["outcome"],
                "evacuated": report["evacuated"],
                "actors_restarted": report["actors_restarted"],
            }
        if event.kind in ("slow_node", "partition_node"):
            victims = [
                (nid, node) for nid, node in cluster.nodes.items()
                if not node.dead and node is not cluster.head_node
            ]
            idx = int(p.get("index", 0))
            if idx >= len(victims):
                return {"skipped": f"no live non-head node at index {idx}"}
            nid, node = victims[idx]
            if event.kind == "slow_node":
                # deterministic straggler: a fixed per-dispatch delay — no
                # failpoint decisions consumed, fault logs unaffected
                node._chaos_delay_s = float(p.get("delay", 1.0))
                return {"node": nid.hex()[:8], "delay": node._chaos_delay_s}
            cluster.partition_node(nid)
            return {"node": nid.hex()[:8]}
        if event.kind == "heal_partition":
            fresh = cluster.heal_partition()
            if fresh is None:
                return {"skipped": "nothing partitioned"}
            return {"node": fresh.node_id.hex()[:8]}
        if event.kind == "add_node":
            node = cluster.add_node(
                dict(p.get("resources") or {"CPU": 1}), labels=p.get("labels")
            )
            return {"node": node.node_id.hex()[:8]}
        if event.kind == "kill_head":
            return {"snapshot": cluster.kill_head()}
        if event.kind == "restart_head":
            return cluster.restart_head()
        if event.kind == "lose_objects":
            return self._lose_objects(cluster, float(p.get("fraction", 0.5)))
        if event.kind == "overload":
            return self._inject_overload(
                int(p.get("tasks", 32)),
                float(p.get("cpus", 1.0)),
                float(p.get("hold_s", 0.0)),
            )
        if event.kind == "preempt_gang_member":
            return self._preempt_gang_member(
                cluster,
                p.get("job"),
                p.get("index"),
                bool(p.get("graceful", True)),
            )
        if event.kind == "kill_decode_replica":
            return self._kill_decode_replica(
                cluster,
                p.get("deployment"),
                str(p.get("role", "decode")),
                int(p.get("index", 0)),
            )
        return {}

    @staticmethod
    def _kill_decode_replica(cluster, deployment, role: str, index: int) -> dict:
        """Kill one replica of a disaggregated serving deployment through
        the controller's chaos hook.  Like preempt_gang_member this
        consumes NO failpoint decisions — same-seed fault logs stay
        byte-identical; what it perturbs is the replica pool.  A migration
        in flight must walk the re-prefill ladder (typed KVMigrationError
        internally), and invariant 13 audits that every staged block set
        still reached exactly one terminal outcome."""
        controllers = getattr(cluster, "serve_controllers", {})
        if not controllers:
            return {"skipped": "no registered serve controllers"}
        for key in sorted(controllers):
            ctl = controllers[key]
            try:
                killed = ctl.chaos_kill_replica(
                    deployment or "", role=role, index=index
                )
            except Exception as exc:  # noqa: BLE001 — report, don't crash
                return {"skipped": f"controller hook failed: {exc!r}"}
            if killed:
                return {
                    "deployment": deployment or "(sole roles deployment)",
                    "role": role,
                    "index": index,
                }
        return {"skipped": f"no {role!r} replica at index {index}"}

    @staticmethod
    def _preempt_gang_member(cluster, job, index, graceful: bool) -> dict:
        """Preempt one member of a registered training gang.  Like the
        overload injector this consumes no failpoint decisions, so
        same-seed fault logs stay byte-identical; what it perturbs is the
        gang itself.  ``graceful=True`` exercises the serving-burst ladder
        (checkpoint → shrink → continue); ``graceful=False`` hard-kills the
        member, and the workload's repair must resume bit-exact from the
        latest step checkpoint (invariant 12 audits the resumed loss
        trajectory against an uninterrupted replay)."""
        controllers = getattr(cluster, "train_controllers", {})
        if job is None:
            names = sorted(controllers)
            if not names:
                return {"skipped": "no registered training gangs"}
            job = names[0]
        ctl = controllers.get(job)
        if ctl is None:
            return {"skipped": f"no training gang named {job!r}"}
        if graceful:
            new_size = ctl.preempt_member(index, graceful=True)
            return {"job": job, "graceful": True, "gang_size": new_size}
        ctl.preempt_member(index, graceful=False)
        return {"job": job, "graceful": False, "killed_index": index}

    def _inject_overload(self, tasks: int, cpus: float, hold_s: float) -> dict:
        """Deterministic synthetic load burst: ``tasks`` submissions each
        demanding ``cpus`` CPUs and holding them ``hold_s`` seconds.  No
        failpoint decisions are consumed, so same-seed fault logs stay
        byte-identical; what varies under overload is WHICH admission layer
        sheds, and invariant 11 audits that every shed was typed and no
        shed task executed.  Refs (including ones whose terminal state is
        the committed OverloadedError) join the invariant sweep."""
        import ray_tpu_torch as rt
        from ray_tpu_torch.exceptions import OverloadedError

        @rt.remote(num_cpus=cpus, max_retries=0)
        def _overload_probe(i, hold):
            if hold:
                time.sleep(hold)
            return i

        admitted = shed_at_submit = 0
        for i in range(tasks):
            try:
                self._injected_refs.append(_overload_probe.remote(i, hold_s))
                admitted += 1
            except OverloadedError:
                # submission-layer shed: typed, raised before a ref was
                # minted (queue-layer sheds commit the error to the ref
                # instead, and resolve in the sweep)
                shed_at_submit += 1
        return {"tasks": tasks, "submitted": admitted, "shed_at_submit": shed_at_submit}

    def _lose_objects(self, cluster, fraction: float) -> dict:
        """Delete a seeded fraction of committed objects from every store,
        forget their locations, and kick lineage reconstruction — recovery
        must rebuild them (or tombstone ObjectLostError) for the invariant
        sweep to pass."""
        with cluster.directory._lock:
            oids = sorted(cluster.directory._locations.keys(), key=lambda o: o.binary())
        lost = []
        for i, oid in enumerate(oids):
            if failpoints._decision(self.schedule.seed, "chaos.lose_objects", i) >= fraction:
                continue
            for node in list(cluster.nodes.values()):
                if not node.dead and hasattr(node, "store"):
                    try:
                        node.store.delete(oid)
                    except Exception:  # noqa: BLE001 — remote store already gone
                        pass
            cluster.directory.forget(oid)
            lost.append(oid)
        for oid in lost:
            cluster._try_recover(oid)
        return {"lost": len(lost), "of": len(oids)}


# --------------------------------------------------------------------------
# CLI entry (`rt chaos run`)
# --------------------------------------------------------------------------
def builtin_workload(name: str, rt):
    """Small self-contained workloads for `rt chaos run` demos/smokes."""
    if name == "fanout":
        def fanout():
            @rt.remote(max_retries=5)
            def bump(x):
                return x + 1

            return [bump.remote(i) for i in range(50)]

        return fanout
    if name == "actor":
        def actor():
            @rt.remote
            class Counter:
                def __init__(self):
                    self.n = 0

                def add(self, k):
                    self.n += k
                    return self.n

            c = Counter.options(max_task_retries=5, max_restarts=2).remote()
            return [c.add.remote(1) for _ in range(20)]

        return actor
    raise ValueError(f"unknown builtin chaos workload {name!r} (fanout|actor)")


def run_cli(args) -> int:
    """`rt chaos run --seed N --schedule f.json [--workload fanout]`."""
    import json

    import ray_tpu_torch as rt

    # schema-check before burning minutes: a typo'd kind or malformed spec
    # fails in milliseconds with a friendly message, not mid-run
    from ray_tpu_torch.chaos.schedule import validate_schedule

    with open(args.schedule) as f:
        errors = validate_schedule(json.load(f))
    if errors:
        import sys

        print(f"{args.schedule}: invalid schedule", file=sys.stderr)
        for err in errors:
            print(f"  - {err}", file=sys.stderr)
        return 1

    schedule = ChaosSchedule.load(args.schedule, seed=args.seed)
    own_runtime = not rt.is_initialized()
    if own_runtime:
        rt.init(num_cpus=args.num_cpus)
    try:
        runner = ChaosRunner(schedule, quiesce_timeout=args.timeout)
        result = runner.run(builtin_workload(args.workload, rt))
    finally:
        if own_runtime:
            rt.shutdown()
    print(json.dumps(result.to_dict(), indent=2))
    return 0 if result.ok else 1
