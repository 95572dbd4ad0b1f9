"""Recovery invariants checked after a chaos run reaches quiescence.

The port's copy of ``ray_tpu/chaos/invariants.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

The point of deterministic chaos is not that faults fired — it is that the
fabric's recovery machinery provably restored every contract afterwards.
These are the contracts:

  1. **No stuck work**: the task manager's pending set drains to empty.
  2. **No silent object loss**: every workload ref resolves within a bound —
     to a value, or by *raising* a typed error (``ObjectLostError``,
     ``RayTaskError``, ``ActorDiedError``, ...).  A get that hangs, or that
     *returns* an ``ObjectLostError`` instance as if it were data, is a
     violation.
  3. **Terminal exactly once**: the task-event store shows exactly one
     terminal record (FINISHED/FAILED) per ``(task_id, attempt)`` — a task
     that double-commits (or whose retry resurrects a completed attempt)
     is a correctness bug even when every get succeeds.
  4. **Refcounts at baseline**: once the workload's refs are dropped, the
     reference counter returns to its pre-run footprint — recovery must not
     leak pins.
  5. **Retries are visible**: every terminal record with ``attempt = n > 0``
     has matching distinct ``retry::`` spans in the span store (the
     tracing layer), so a reproduced schedule can be audited from the timeline.

Elasticity invariants — membership changes must not
weaken any of the above, and add contracts of their own:

  6. **Drains lose nothing**: every graceful drain evacuated ALL its
     sole-replica objects before terminating — an object that had a
     surviving replica (or time to gain one) is never lost to a drain.
  7. **Restart budgets hold**: no actor's ``num_restarts`` ever exceeds its
     ``max_restarts`` — drains, head restarts, and chaos kills all consume
     the same FSM budget.
  8. **Plan state machines are legal**: compiled plans only ever move
     READY→BROKEN (death), BROKEN→READY (repair), or →TORN_DOWN — audited
     from the cluster's transition log so released plans stay checkable.

Gray-failure invariants — partitions that heal must not
reintroduce the dead:

  9. **No commit lands from a fenced incarnation**: a node the fabric
     declared dead never re-enters the object directory (its locations
     stay purged), and every fence event on record names a node that is
     genuinely DEAD — fencing never false-positives a live node.
 10. **At most one terminal side-effect per task across a heal**: no
     terminal task event was recorded from a node a fence event rejected
     for that same task — the resubmitted attempt's result is the ONLY one
     visible.

Overload invariant — bounded admission queues must shed
correctly, never lose or duplicate work:

 11. **Sheds are typed and final**: every admitted request terminates
     exactly once — value or typed error (checks 2 and 3 applied to the
     merged workload + injector refs) — every shed request got the typed
     ``OverloadedError`` signal (audited from ``cluster.overload_events``,
     which only the typed-shed paths feed), and no shed task ever
     executed (a shed task id with a FINISHED terminal record is a
     shed-then-run double execution).

Training invariant — repair must be bit-exact, not
merely "it kept going":

 12. **Post-repair loss trajectory equals an uninterrupted run's**: every
     gang repair this run recorded (``cluster.train_repair_audits``)
     carries the restored checkpoint state and the losses the gang
     produced after resuming; replaying the same number of steps from the
     same state WITHOUT the gang (single-process, same seeded batches,
     same update arithmetic) must reproduce those losses byte-for-byte
     (float32 buffers compared with ``tobytes()``).  A repair that resumed
     from torn state, re-sharded batches non-deterministically, or summed
     gradients in a different order fails here even though training
     "continued" without error.

Disaggregated-serving invariant — KV-block migrations
must never leak or double-free staged state:

 13. **Every staged migration reaches exactly one terminal**: each
     ``"staged"`` audit row in ``cluster.kv_migration_audits``
     (serve/disagg.py) pairs with exactly one ``"released"`` row —
     outcome ``adopted``, ``reprefill``, or ``failed``.  Zero terminals
     means the prefill replica's staged block set leaked; more than one
     means it was freed twice.  A decode-replica kill mid-migration must
     still land here: the re-prefill ladder releases the orphaned attempt
     before staging the next.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional


class InvariantReport:
    """Outcome of one invariant sweep; truthy iff everything held."""

    def __init__(self):
        self.violations: List[str] = []
        self.checked: Dict[str, Any] = {}

    @property
    def ok(self) -> bool:
        return not self.violations

    def __bool__(self) -> bool:
        return self.ok

    def add(self, message: str) -> None:
        self.violations.append(message)

    def to_dict(self) -> dict:
        return {"ok": self.ok, "violations": list(self.violations), "checked": dict(self.checked)}

    def __repr__(self):
        state = "ok" if self.ok else f"{len(self.violations)} violation(s)"
        return f"InvariantReport({state}: {self.violations})"


def snapshot_baseline() -> dict:
    """Capture the pre-run footprint the post-run state must return to.
    Call BEFORE submitting the chaos workload."""
    from ray_tpu_torch.runtime.worker import global_worker

    worker = global_worker()
    worker.ref_counter.drain_deferred()
    cluster = worker.cluster
    return {
        "tracked_refs": worker.ref_counter.num_tracked(),
        "num_task_events": len(cluster.control.task_events),
        # elasticity scoping: only drains / plan transitions from THIS run
        "num_drain_reports": len(getattr(cluster, "drain_reports", ())),
        "num_plan_transitions": len(getattr(cluster, "plan_transitions", ())),
        "num_fence_events": getattr(cluster, "fence_events_total", 0),
        "num_overload_events": getattr(cluster, "overload_events_total", 0),
        "num_train_repairs": len(getattr(cluster, "train_repair_audits", ())),
        "num_kv_migration_audits": len(getattr(cluster, "kv_migration_audits", ())),
    }


def wait_quiescent(cluster, timeout: float = 60.0, settle_s: float = 0.2) -> bool:
    """Wait until no task is pending and the state holds for ``settle_s``
    (a retry landing between polls must not count as quiescent)."""
    deadline = time.monotonic() + timeout
    settled_since: Optional[float] = None
    while time.monotonic() < deadline:
        if cluster.task_manager.num_pending() == 0:
            if settled_since is None:
                settled_since = time.monotonic()
            elif time.monotonic() - settled_since >= settle_s:
                return True
        else:
            settled_since = None
        time.sleep(0.02)
    return False


_EXPECTED_ERRORS_CACHE = None


def _expected_errors() -> tuple:
    global _EXPECTED_ERRORS_CACHE
    if _EXPECTED_ERRORS_CACHE is None:
        from ray_tpu_torch import exceptions as exc
        from ray_tpu_torch.runtime.failpoints import FailpointInjected

        _EXPECTED_ERRORS_CACHE = (
            exc.RayTaskError,
            exc.RayActorError,
            exc.ObjectLostError,
            exc.WorkerCrashedError,
            exc.TaskCancelledError,
            exc.OverloadedError,
            exc.StoreFullError,
            exc.DeadlineExceededError,
            FailpointInjected,
        )
    return _EXPECTED_ERRORS_CACHE


def _lineage_pinned(cluster) -> set:
    """ObjectIDs held alive by retained lineage specs' top-level args —
    the designed pins check 4 must not count as leaks."""
    from ray_tpu_torch.core.object_ref import ObjectRef

    with cluster.task_manager._lock:
        specs = {id(s): s for s in cluster.task_manager._lineage.values()}
    pinned = set()
    for spec in specs.values():
        values = list(getattr(spec, "args", ()) or ())
        values += list((getattr(spec, "kwargs", {}) or {}).values())
        for v in values:
            if isinstance(v, ObjectRef):
                pinned.add(v.id())
    return pinned


def check_invariants(
    refs: Optional[List[Any]] = None,
    baseline: Optional[dict] = None,
    timeout: float = 60.0,
) -> InvariantReport:
    """Run the full sweep against the current runtime.  ``refs`` are the
    workload's ObjectRefs (resolved, then dropped for the refcount check);
    ``baseline`` comes from :func:`snapshot_baseline`."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.exceptions import GetTimeoutError, ObjectLostError
    from ray_tpu_torch.observability.tracing import SPAN_EVENT_TYPE
    from ray_tpu_torch.runtime.worker import global_worker

    worker = global_worker()
    cluster = worker.cluster
    report = InvariantReport()

    # 1. pending set drains -------------------------------------------------
    if not wait_quiescent(cluster, timeout=timeout):
        stuck = [s.name for s in cluster.task_manager.pending_specs()]
        report.add(f"tasks never quiesced: {len(stuck)} still pending ({stuck[:5]}...)")
    report.checked["pending_after"] = cluster.task_manager.num_pending()

    # 2. every ref resolves or raises a typed error -------------------------
    # Ownership note: the caller hands the ref list over — it is CLEARED
    # before the refcount check so the workload's pins actually drop.
    resolved = failed = 0
    ref_list = refs if isinstance(refs, list) else list(refs or [])
    deadline = time.monotonic() + timeout
    for ref in ref_list:
        remaining = max(0.5, deadline - time.monotonic())
        try:
            value = rt.get(ref, timeout=remaining)
        except GetTimeoutError:
            report.add(f"silent loss: {ref} neither resolved nor raised within {timeout}s")
            continue
        except _expected_errors():
            failed += 1
            continue
        except BaseException as exc:  # noqa: BLE001 — anything else is a contract break
            report.add(f"untyped failure from get({ref}): {type(exc).__name__}: {exc}")
            continue
        if isinstance(value, BaseException):
            # an error object RETURNED as data — the "lost value without a
            # raised ObjectLostError" failure mode, verbatim
            report.add(
                f"silent loss: get({ref}) returned {type(value).__name__} "
                "instead of raising it"
            )
            continue
        resolved += 1
    report.checked["refs_resolved"] = resolved
    report.checked["refs_failed_typed"] = failed

    # 3. terminal exactly once per (task_id, attempt) -----------------------
    events = cluster.control.task_events.list_events(limit=1_000_000)
    if baseline is not None:
        # scope to THIS run: events recorded before the baseline snapshot
        # belong to earlier workloads in the session
        events = events[baseline.get("num_task_events", 0):]
    terminal: Dict[tuple, int] = {}
    attempts_by_task: Dict[str, set] = {}
    for ev in events:
        if ev.get("state") in ("FINISHED", "FAILED"):
            key = (ev["task_id"], ev.get("attempt", 0))
            terminal[key] = terminal.get(key, 0) + 1
            attempts_by_task.setdefault(ev["task_id"], set()).add(ev.get("attempt", 0))
    dupes = {k: n for k, n in terminal.items() if n > 1}
    if dupes:
        report.add(f"non-unique terminal records for (task, attempt): {list(dupes)[:5]}")
    report.checked["terminal_records"] = len(terminal)

    # 4. refcounts return to baseline --------------------------------------
    # Lineage retention is a DESIGNED pin, not a leak: completed specs keep
    # their argument refs alive so lost returns can reconstruct (reference
    # lineage refcount parity, task_manager.h:261) — the baseline allows
    # for refs reachable through retained lineage specs.
    if baseline is not None:
        ref_list.clear()  # drop the workload's pins before measuring
        ref = value = None  # the loop locals pin the last ref otherwise
        # caught injected faults leave traceback<->frame cycles whose frames
        # pin the workload's ref lists; init defers cyclic GC, so collect
        # explicitly before calling anything a leak
        import gc

        gc.collect()
        worker.ref_counter.drain_deferred()
        allowed = baseline["tracked_refs"] + len(_lineage_pinned(cluster))
        # out-of-scope deletions ripple through callbacks; settle briefly
        settle_deadline = time.monotonic() + 5.0
        tracked = worker.ref_counter.num_tracked()
        while tracked > allowed and time.monotonic() < settle_deadline:
            time.sleep(0.05)
            worker.ref_counter.drain_deferred()
            tracked = worker.ref_counter.num_tracked()
            allowed = baseline["tracked_refs"] + len(_lineage_pinned(cluster))
        report.checked["tracked_refs"] = tracked
        report.checked["lineage_pinned"] = allowed - baseline["tracked_refs"]
        if tracked > allowed:
            report.add(
                f"refcount leak: {tracked} tracked refs after the run "
                f"(baseline {baseline['tracked_refs']} + "
                f"{allowed - baseline['tracked_refs']} lineage-pinned)"
            )

    # 5. retried attempts visible as distinct spans -------------------------
    spans = cluster.control.spans.list_events(limit=1_000_000)
    retry_attempts: Dict[str, set] = {}
    for ev in spans:
        if ev.get("type") == SPAN_EVENT_TYPE and str(ev.get("name", "")).startswith("retry::"):
            attrs = ev.get("attrs") or {}
            tid = attrs.get("task_id")
            if tid is not None:
                retry_attempts.setdefault(tid, set()).add(attrs.get("attempt"))
    for task_id, attempts in attempts_by_task.items():
        final_attempt = max(attempts)
        if final_attempt > 0:
            seen = retry_attempts.get(task_id, set())
            if len(seen) < final_attempt:
                report.add(
                    f"task {task_id[:8]} reached attempt {final_attempt} but only "
                    f"{len(seen)} retry spans are in the span store"
                )
    report.checked["tasks_with_retries"] = sum(1 for a in attempts_by_task.values() if max(a) > 0)

    # 6. drains lose nothing that had somewhere to go -----------------------
    drain_reports = list(getattr(cluster, "drain_reports", ()))
    if baseline is not None:
        drain_reports = drain_reports[baseline.get("num_drain_reports", 0):]
    for rep in drain_reports:
        if rep.get("failed_evacuations"):
            report.add(
                f"drain of node {rep['node']} terminated with "
                f"{rep['failed_evacuations']} sole-replica object(s) "
                "unevacuated (survivors existed)"
            )
    report.checked["drains"] = len(drain_reports)
    report.checked["drain_evacuated"] = sum(r.get("evacuated", 0) for r in drain_reports)

    # 7. actor restart budgets hold -----------------------------------------
    over_budget = [
        info for info in cluster.control.actors.list_actors()
        if info.max_restarts >= 0 and info.num_restarts > info.max_restarts
    ]
    for info in over_budget:
        report.add(
            f"actor {info.actor_id.hex()[:8]} restarted {info.num_restarts} "
            f"times with max_restarts={info.max_restarts}"
        )

    # 8. compiled-plan state machines are legal -----------------------------
    legal = {
        ("READY", "BROKEN"), ("BROKEN", "READY"),
        ("READY", "TORN_DOWN"), ("BROKEN", "TORN_DOWN"),
    }
    transitions = list(getattr(cluster, "plan_transitions", ()))
    if baseline is not None:
        transitions = transitions[baseline.get("num_plan_transitions", 0):]
    last_state: Dict[str, str] = {}
    for plan_id, src, dst in transitions:
        prev = last_state.get(plan_id, src)
        if (prev, dst) not in legal or prev != src:
            report.add(
                f"plan {plan_id[:8]} made an illegal state transition "
                f"{src}->{dst} (after {prev})"
            )
        last_state[plan_id] = dst
    report.checked["plan_transitions"] = len(transitions)

    # 9. no commit lands from a fenced incarnation --------------------------
    from ray_tpu_torch.runtime.control import NodeState

    dead_nodes = {
        info.node_id
        for info in cluster.control.nodes.all_nodes()
        if info.state is NodeState.DEAD
    }
    dead_short = {nid.hex()[:8] for nid in dead_nodes}
    with cluster.directory._lock:
        for oid, locs in cluster.directory._locations.items():
            bad = locs & dead_nodes
            if bad:
                report.add(
                    f"fenced incarnation re-entered the directory: object "
                    f"{oid.hex()[:8]} located on dead node(s) "
                    f"{[n.hex()[:8] for n in bad]}"
                )
                break
    fence_events = list(getattr(cluster, "fence_events", ()))
    if baseline is not None:
        # the log is a bounded deque: slice THIS run's tail by the
        # monotonic total, not a list index
        delta = getattr(cluster, "fence_events_total", 0) - baseline.get(
            "num_fence_events", 0
        )
        fence_events = fence_events[-delta:] if delta > 0 else []
    for fe in fence_events:
        if fe.get("node") and fe["node"] not in dead_short:
            if (
                fe.get("incarnation") is not None
                and fe.get("current") is not None
                and fe["incarnation"] != fe["current"]
            ):
                # a stale EPOCH of a still-alive node id (transient rejoin
                # superseded the old connection): fencing working as
                # designed, not a false positive
                continue
            report.add(
                f"fence false-positive: frame from LIVE node {fe['node']} "
                f"rejected ({fe.get('kind')})"
            )
    report.checked["fence_events"] = len(fence_events)

    # 10. at most one terminal side-effect per task across a heal -----------
    fenced_tasks = {
        (fe.get("task"), fe.get("node"))
        for fe in fence_events
        if fe.get("task")
    }
    if fenced_tasks:
        for ev in events:
            if ev.get("state") in ("FINISHED", "FAILED") and (
                ev.get("task_id"), ev.get("node")
            ) in fenced_tasks:
                report.add(
                    f"fenced commit LANDED: task {ev['task_id'][:8]} has a "
                    f"terminal record from fenced node {ev['node']}"
                )
    report.checked["fenced_tasks"] = len(fenced_tasks)

    # 11. overload sheds are typed, attributed, and shed work never ran ------
    overload_events = list(getattr(cluster, "overload_events", ()))
    if baseline is not None:
        # bounded deque: slice THIS run's tail by the monotonic total
        delta = getattr(cluster, "overload_events_total", 0) - baseline.get(
            "num_overload_events", 0
        )
        overload_events = overload_events[-delta:] if delta > 0 else []
    finished_tasks = {
        ev.get("task_id") for ev in events if ev.get("state") == "FINISHED"
    }
    for oe in overload_events:
        if not oe.get("typed"):
            report.add(f"shed WITHOUT the typed signal: {oe}")
        if not oe.get("layer") or not oe.get("reason"):
            report.add(f"unattributed overload shed: {oe}")
        task = oe.get("task")
        if task and task in finished_tasks:
            report.add(
                f"shed task {task[:8]} has a FINISHED terminal record — "
                "shed-then-run double execution"
            )
    report.checked["overload_sheds"] = len(overload_events)

    # 12. post-repair loss trajectory equals an uninterrupted run's ---------
    audits = list(getattr(cluster, "train_repair_audits", ()))
    if baseline is not None:
        audits = audits[baseline.get("num_train_repairs", 0):]
    replayed_steps = 0
    for audit in audits:
        losses = list(audit.get("losses", ()))
        if not losses:
            continue  # repair landed but no post-repair step ran this run
        import numpy as np

        expected = audit["replay"](
            audit["state"], audit["world_size"], len(losses)
        )
        got = np.asarray(losses, np.float32).tobytes()
        want = np.asarray(expected, np.float32).tobytes()
        if got != want:
            report.add(
                f"train repair of {audit.get('controller')!r} at step "
                f"{audit.get('start_step')} ({audit.get('outcome')}) diverged "
                f"from the uninterrupted replay over {len(losses)} step(s)"
            )
        replayed_steps += len(losses)
    report.checked["train_repairs"] = len(audits)
    report.checked["train_replayed_steps"] = replayed_steps

    # 13. every staged KV-block migration reaches exactly one terminal ------
    # (serve/disagg.py: "staged" must pair with exactly one "released" —
    # adopted, reprefill, or failed; zero terminals leaks the staged set,
    # two would double-free it)
    mig_audits = list(getattr(cluster, "kv_migration_audits", ()))
    if baseline is not None:
        mig_audits = mig_audits[baseline.get("num_kv_migration_audits", 0):]
    staged_ids: List[str] = []
    released: Dict[str, int] = {}
    for audit in mig_audits:
        mid = audit.get("mig_id", "")
        if audit.get("event") == "staged":
            staged_ids.append(mid)
        elif audit.get("event") == "released":
            released[mid] = released.get(mid, 0) + 1
    for mid in staged_ids:
        n = released.get(mid, 0)
        if n == 0:
            report.add(
                f"kv migration {mid!r} staged but never released — the "
                "staged block set leaked"
            )
        elif n > 1:
            report.add(
                f"kv migration {mid!r} released {n} times — staged block "
                "set freed more than once"
            )
    for mid, n in released.items():
        if mid not in staged_ids:
            report.add(
                f"kv migration {mid!r} released without a staged record"
            )
    report.checked["kv_migrations"] = len(staged_ids)
    return report
