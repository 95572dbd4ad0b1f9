"""Owner-side task watchdog: end-to-end deadlines + hedged straggler retries.

The port's copy of ``ray_tpu/runtime/watchdog.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Two gray-failure defenses the fabric gained in ISSUE 8, both owner-side
(the owner is the single commit authority, so enforcement composes with the
``(task_id, attempt)`` fencing the rest of the stack already speaks):

**Deadlines** (``.options(deadline_s=...)``): the budget rides the TaskSpec
as an absolute wall-clock deadline and is enforced at every lifecycle stage
— parked on the demand queue, queued on a node, pulling dependencies,
executing.  The watchdog fires a cooperative cancel at the deadline, a
force-kill (``CancelTask`` force parity) after ``task_deadline_grace_s``,
and a direct owner-side commit as the terminal safety net, surfacing a
typed :class:`~ray_tpu_torch.exceptions.DeadlineExceededError` that never retries
(a late task cannot un-miss its deadline).  Nested submissions inherit the
REMAINING budget through ``runtime/context.py``.

**Hedging** (``.options(hedge_after_s=...)`` or the opt-in per-SchedulingKey
latency-EWMA auto mode): a dependency-free retryable task still pending past
its threshold gets a second attempt launched on a *different* node
(``pick_node(exclude=...)``).  First commit wins — arbitration runs under
the hedge-group lock inside the owner's completion path, the loser is
cancelled, and its late commit is discarded (the same attempt-fencing
discipline the PR 7 ``pushed_duplicate`` guard uses).  The reference's
equivalent knob family is speculative task execution / request hedging
("the tail at scale"); the raylet has none, which is one reason its tail
latencies are what they are.

Determinism note for chaos runs: hedge firing depends only on wall-clock
thresholds vs the chaos schedule's *fixed* ``slow_node`` delays — no
failpoint decisions are consumed by the watchdog itself — so with the
generous margins the seeded schedules use, the same (seed, schedule,
workload) fires the same hedges and the fault log stays byte-identical.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.sync import join_threads
from ray_tpu_torch.exceptions import DeadlineExceededError
from ray_tpu_torch.observability import metric_defs

# prebuilt tag dicts for the completion hot path
_HEDGE_WON = {"outcome": "won"}
_HEDGE_LOST = {"outcome": "lost"}


class _HedgeGroup:
    """First-commit-wins arbitration between a primary attempt and its
    hedge.  All decisions happen under one lock; exactly one attempt is
    ever allowed to commit a terminal state for the task."""

    __slots__ = ("lock", "primary", "hedge", "terminal", "suppressed", "suppressed_at")

    def __init__(self, primary, hedge):
        self.lock = threading.Lock()
        self.primary = primary
        self.hedge = hedge
        self.terminal = False
        # an errored attempt whose sibling was still live: (spec, error).
        # The sibling owns the outcome now; if it never delivers one (its
        # node died), the watchdog resurrects this error.
        self.suppressed: Optional[tuple] = None
        self.suppressed_at = 0.0

    def sibling(self, spec):
        return self.hedge if spec is self.primary else self.primary

    def arbitrate(self, spec, error) -> bool:
        """True: this completion commits (normal path continues).
        False: discard it entirely — another attempt owns the outcome."""
        with self.lock:
            if self.terminal:
                return False  # the loser's late commit: attempt-fenced away
            if error is None:
                self.terminal = True
                # detach the winner so nothing re-arbitrates it; the loser
                # keeps the (terminal) group and discards on arrival
                spec._hedge = None
                return True
            sib = self.sibling(spec)
            if self.suppressed is None and not getattr(sib, "_cancelled", False):
                # first error with a live sibling: suppress — the sibling
                # (still running) owns the outcome; keep the error around
                # in case the sibling's node dies and it never reports
                self.suppressed = (spec, error)
                self.suppressed_at = time.monotonic()
                return False
            # both attempts failed (or the sibling was already cancelled):
            # this error is the task's outcome — commit it through the
            # normal failure path (retries and all).  When the committing
            # spec is the hedge clone (retries_left pinned to 0 at launch),
            # restore the PRIMARY's remaining budget onto it: hedging must
            # never cost the task retries it would have had without it.
            if spec is self.hedge:
                spec.retries_left = max(spec.retries_left, self.primary.retries_left)
            self.terminal = True
            self.primary._hedge = None
            self.hedge._hedge = None
            return True


class _Entry:
    __slots__ = (
        "spec", "deadline_fired_at", "forced", "escalated",
        "hedged", "hedge_group",
    )

    def __init__(self, spec):
        self.spec = spec
        self.deadline_fired_at: Optional[float] = None
        self.forced = False
        self.escalated = False
        self.hedged = False
        self.hedge_group: Optional[_HedgeGroup] = None


class TaskWatchdog:
    """One monitor thread per cluster, started lazily on first track()."""

    def __init__(self, cluster):
        self._cluster = cluster
        self._lock = threading.Lock()
        self._entries: Dict[int, _Entry] = {}  # id(spec) -> entry
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # per-SchedulingKey latency EWMA for the auto-hedge mode; keyed the
        # same way worker leases are (function identity x resource demand x
        # execution tier), entries pin (func, resources) via the spec refs
        self._ewma: Dict[tuple, list] = {}  # key -> [ewma_s, samples, func, res]
        cfg = get_config()
        self.auto_on = bool(cfg.hedge_auto_enabled)
        # lifetime stats (racy ints are fine; tests and /api read them)
        self.deadlines_fired = 0
        self.hedges_launched = 0
        self.hedges_won = 0
        self.hedges_lost = 0
        self.hedge_discards = 0

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            thread = self._thread
        if thread is not None:
            join_threads([thread])

    # ------------------------------------------------------------------
    # tracking
    # ------------------------------------------------------------------
    def hedge_eligible(self, spec) -> bool:
        """Dep-free, strategy-free, non-streaming, RETRYABLE normal tasks
        only: a hedge is a speculative second attempt, so the same
        side-effect contract as retries applies (max_retries > 0 is the
        caller's assertion that re-execution is safe)."""
        return (
            spec.actor_id is None
            and not spec.dependencies
            and spec.scheduling_strategy is None
            and spec.num_returns != "streaming"
            and spec.max_retries > 0
        )

    def maybe_track(self, spec) -> None:
        """Called at submit for specs carrying a deadline or hedge-eligible
        under an explicit/auto threshold."""
        wants_hedge = (
            spec.hedge_after_s is not None or self.auto_on
        ) and self.hedge_eligible(spec)
        if spec.deadline_ts is None and not wants_hedge:
            return
        with self._lock:
            self._entries[id(spec)] = _Entry(spec)
            if self._thread is None and not self._stop.is_set():
                self._thread = threading.Thread(
                    target=self._loop, name="task-watchdog", daemon=True
                )
                self._thread.start()

    def on_terminal(self, spec) -> None:
        """A terminal state committed for this spec (cluster._after_commit)."""
        with self._lock:
            self._entries.pop(id(spec), None)

    # ------------------------------------------------------------------
    # hedge arbitration + stats (called from cluster.on_task_finished)
    # ------------------------------------------------------------------
    def arbitrate(self, spec, error) -> bool:
        group = spec._hedge
        if group is None:
            return True
        commit = group.arbitrate(spec, error)
        if not commit:
            self.hedge_discards += 1
            return False
        if error is None:
            # winner committed: score the race and cancel the loser NOW
            loser = group.sibling(spec)
            if spec is group.hedge:
                self.hedges_won += 1
                metric_defs.TASK_HEDGES.inc(tags=_HEDGE_WON)
            else:
                self.hedges_lost += 1
                metric_defs.TASK_HEDGES.inc(tags=_HEDGE_LOST)
            loser._cancelled = True
            try:
                self._cluster.cancel_task(loser)
            except Exception:  # noqa: BLE001 — loser's node mid-death
                pass
        return True

    def observe_latency(self, spec, seconds: float) -> None:
        """Feed the auto-hedge EWMA (successful commits of eligible shapes)."""
        if not self.auto_on or seconds <= 0:
            return
        from ray_tpu_torch.runtime.scheduler import LeaseManager

        key = LeaseManager.key_for(spec)
        with self._lock:
            row = self._ewma.get(key)
            if row is None:
                if len(self._ewma) > 2048:
                    self._ewma.clear()
                self._ewma[key] = [seconds, 1, spec.func, spec.resources]
            else:
                row[0] = 0.8 * row[0] + 0.2 * seconds
                row[1] += 1

    def _auto_threshold(self, spec) -> Optional[float]:
        from ray_tpu_torch.runtime.scheduler import LeaseManager

        cfg = get_config()
        with self._lock:
            row = self._ewma.get(LeaseManager.key_for(spec))
        if row is None or row[1] < max(1, cfg.hedge_auto_min_samples):
            return None
        return max(cfg.hedge_auto_min_s, row[0] * cfg.hedge_auto_multiplier)

    # ------------------------------------------------------------------
    # the monitor loop
    # ------------------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(max(0.005, get_config().watchdog_poll_period_s)):
            try:
                self.auto_on = bool(get_config().hedge_auto_enabled)
                self._tick()
            except Exception:  # noqa: BLE001 — the watchdog must not die
                pass

    def _tick(self) -> None:
        cluster = self._cluster
        now = time.time()
        mono = time.monotonic()
        with self._lock:
            entries = list(self._entries.values())
        cfg = get_config()
        for entry in entries:
            spec = entry.spec
            if cluster.task_manager.get_pending(spec.task_id) is None:
                # resolved (or was never pending): self-clean
                with self._lock:
                    self._entries.pop(id(spec), None)
                continue
            if spec.deadline_ts is not None:
                self._enforce_deadline(entry, spec, now, mono, cfg)
            if not entry.hedged and not spec._deadline_fired and not spec._cancelled:
                self._maybe_hedge(entry, spec, now)
            group = entry.hedge_group
            if group is not None:
                self._check_abandoned(group, mono)

    # -- deadlines ------------------------------------------------------
    def _enforce_deadline(self, entry, spec, now, mono, cfg) -> None:
        if entry.deadline_fired_at is None:
            if now < spec.deadline_ts:
                return
            # FIRE: stamp the stage the task was caught in, cancel
            # cooperatively; parked/pulling tasks have no worker to kill,
            # so their terminal commit happens right here
            stage = spec._stage
            spec._deadline_fired = True
            spec._deadline_stage = stage
            spec._cancelled = True
            group = spec._hedge
            if group is not None:
                # the deadline dooms the TASK, not one attempt: fence the
                # hedge clone too, or its late success would overwrite the
                # committed DeadlineExceededError with real values (a
                # second terminal state for a task the caller already saw
                # fail)
                sib = group.sibling(spec)
                sib._deadline_fired = True
                sib._deadline_stage = stage
                sib._cancelled = True
                try:
                    self._cluster.cancel_task(sib)
                except Exception:  # noqa: BLE001
                    pass
            entry.deadline_fired_at = mono
            self.deadlines_fired += 1
            metric_defs.TASK_DEADLINE_EXCEEDED.inc(tags={"stage": stage})
            if stage == "parked":
                if self._cluster.unpark_and_fail(spec, self.deadline_error(spec)):
                    return
                # lost the race to placement: fall through to the cancel
            try:
                self._cluster.cancel_task(spec)
            except Exception:  # noqa: BLE001
                pass
            if stage == "pulling":
                # nothing to cancel is running yet and the deps may never
                # arrive — commit the terminal error directly (claim-based,
                # so a racing dispatch completion loses cleanly)
                self._cluster.deadline_fail_now(spec)
            return
        grace = max(0.0, cfg.task_deadline_grace_s)
        elapsed = mono - entry.deadline_fired_at
        if not entry.forced and elapsed >= grace:
            entry.forced = True
            try:
                self._cluster.cancel_task(spec, force=True)
            except Exception:  # noqa: BLE001
                pass
        if not entry.escalated and elapsed >= 2 * grace + 1.0:
            # terminal safety net: the kill path wedged (agent partitioned,
            # worker unkillable) — the owner commits the deadline error
            # itself; any straggler completion is claim-fenced away
            entry.escalated = True
            self._cluster.deadline_fail_now(spec)

    def deadline_error(self, spec) -> DeadlineExceededError:
        return DeadlineExceededError(
            spec.name, spec._deadline_stage or spec._stage, spec.deadline_s
        )

    # -- hedging --------------------------------------------------------
    def _maybe_hedge(self, entry, spec, now) -> None:
        if spec._hedge is not None or not self.hedge_eligible(spec):
            return
        threshold = spec.hedge_after_s
        if threshold is None:
            threshold = self._auto_threshold(spec)
        if threshold is None or not spec.submit_time:
            return
        if now - spec.submit_time < threshold:
            return
        clone = self._clone_for_hedge(spec)
        group = _HedgeGroup(spec, clone)
        spec._hedge = clone._hedge = group
        if not self._cluster.submit_hedge(clone, exclude=(spec.owner_node,)):
            # no alternative node RIGHT NOW: dissolve the group and leave
            # entry.hedged unset — the next tick retries the launch (a
            # transient capacity blip must not disable hedging for good).
            # The primary may have ERRORED in the tiny window the group
            # existed (arbitrate suppressed it in favor of the never-
            # launched clone): resurrect that error through the normal
            # failure path, or the task would hang with no attempt left.
            with group.lock:
                clone._cancelled = True  # never ran; nothing may wait on it
                suppressed = group.suppressed
                if suppressed is not None:
                    group.terminal = True  # the resurrection owns the outcome
                spec._hedge = clone._hedge = None
            if suppressed is not None:
                sspec, err = suppressed
                cluster = self._cluster
                node = cluster.nodes.get(sspec.owner_node)
                if node is None or node.dead:
                    node = cluster.head_node
                cluster.on_task_finished(node, sspec, None, err)
            return
        entry.hedged = True  # one SUCCESSFUL hedge per task lifetime
        entry.hedge_group = group
        self.hedges_launched += 1
        # the hedge IS a speculative retry: its attempt must be auditable
        # from the span store like every other retry (chaos invariant 5)
        self._cluster._emit_retry_span(clone)

    @staticmethod
    def _clone_for_hedge(spec):
        from ray_tpu_torch.runtime.scheduler import TaskSpec

        clone = TaskSpec(
            task_id=spec.task_id,
            name=spec.name,
            func=spec.func,
            args=spec.args,
            kwargs=spec.kwargs,
            dependencies=[],
            num_returns=spec.num_returns,
            return_ids=spec.return_ids,
            resources=spec.resources,
            max_retries=spec.max_retries,
            execution=spec.execution,
            runtime_env=spec.runtime_env,
        )
        # a distinct attempt of the SAME task: the (task_id, attempt)
        # fencing everywhere else (dedup guards, terminal-exactly-once
        # invariant) keeps the two attempts' commits apart
        clone.attempt = spec.attempt + 1
        clone.retries_left = 0  # the hedge itself never re-retries
        clone._retry_exceptions = spec._retry_exceptions
        clone.trace_ctx = spec.trace_ctx
        clone.submit_time = time.time()
        clone.deadline_ts = spec.deadline_ts
        clone.deadline_s = spec.deadline_s
        return clone

    def _check_abandoned(self, group: _HedgeGroup, mono: float) -> None:
        """A suppressed PRIMARY error whose hedge died with its node is
        resurrected as the task's outcome — hedges are speculative and are
        never resubmitted by the node-death sweep, so nothing else would
        ever terminate the task.  (The mirror case — suppressed hedge
        error, primary's node dead — is owned by the death sweep, which
        resubmits the pending primary; resurrecting there would race it.)"""
        with group.lock:
            if group.terminal or group.suppressed is None:
                return
            spec, error = group.suppressed
            if spec is not group.primary:
                return
            node = self._cluster.nodes.get(group.hedge.owner_node)
            if node is not None and not node.dead:
                return
            group.terminal = True
            group.primary._hedge = None
            group.hedge._hedge = None
        cluster = self._cluster
        node = cluster.nodes.get(spec.owner_node)
        if node is None or node.dead:
            node = cluster.head_node
        cluster.on_task_finished(node, spec, None, error)

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            tracked = len(self._entries)
        return {
            "tracked": tracked,
            "deadlines_fired": self.deadlines_fired,
            "hedges_launched": self.hedges_launched,
            "hedges_won": self.hedges_won,
            "hedges_lost": self.hedges_lost,
            "hedge_discards": self.hedge_discards,
        }
