"""Deterministic failpoint fabric: named fault-injection sites.

The port's copy of ``ray_tpu/runtime/failpoints.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

The reference threads env-settable delay/failure knobs through its RPC layer
(``RAY_testing_asio_delay_us``-style, ``src/ray/common/asio/asio_chaos.cc``)
and drives whole-node kills from ``NodeKillerActor``
(``python/ray/_private/test_utils.py:1429``).  This module is the
finer-grained version of that idea, in the tikv/etcd ``failpoint`` style:
hot paths carry **named** failpoints —

    from ray_tpu_torch.runtime import failpoints
    ...
    action = failpoints.fp("data_plane.send_frame")
    if action is not None:        # "drop" / "kill" / "partition"
        <site-specific handling>

compiled to a near-zero-cost no-op when disarmed (one module-attribute read
and an early return — no locks, no dict lookups, nothing allocated), and
armed via the ``RAY_TPU_FAILPOINTS`` env var / ``failpoints`` config knob or
programmatically with :func:`arm`.

Actions
-------
``raise``      raise :class:`FailpointInjected` at the site (``fp`` raises).
``delay``      sleep ``delay_s`` inside ``fp``, then continue normally.
``drop``       returned to the site: a frame/report silently not sent, a
               commit skipped — whatever "the bytes vanished" means there.
``kill``       returned to the site: kill the process the site just touched
               (worker spawn kills the fresh worker process).
``partition``  returned to the site: behave as if the network is partitioned
               (sites treat it like ``drop``; schedules arm/disarm it over a
               window to model a timed partition).

Spec grammar (env var and :func:`arm` string form)::

    name=action[(args)] [; name=action...]

    raise / drop / kill / partition:  optional  (p)       p = probability
    delay:                            (seconds[, p])

e.g. ``RAY_TPU_FAILPOINTS="data_plane.send_frame=drop(0.05);rpc.call=delay(0.2,0.5)"``.

Determinism
-----------
Every injection decision is a pure function of ``(seed, failpoint name,
hit index)`` — a blake2b hash, NOT a shared mutable PRNG.  Hit indices are
per-failpoint counters, so the decision sequence of each failpoint is fixed
by the seed regardless of thread interleaving: two runs of the same
workload under the same ``(seed, schedule)`` inject the same faults at the
same per-failpoint positions, and :func:`fault_log` (sorted by
``(name, hit)``) compares byte-for-byte equal across runs.  Thread races
can only change *which* thread owns a given hit index, never what happens
at it.

Observability: every injected fault increments the
``chaos_faults_injected_total`` metric family (tags: failpoint, action) and,
when tracing is enabled, emits a ``fault::<name>`` span event that lands in
``rt timeline --tracing`` output alongside the task phases it perturbed.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict, List, Optional

#: module-level fast-path gate: ``fp()`` reads this first and returns
#: immediately when False — the only cost a disarmed failpoint ever pays
ARMED = False

_ACTIONS = ("raise", "delay", "drop", "kill", "partition")

_lock = threading.Lock()          # guards arm/disarm + the registry shape
_fps: Dict[str, "_Failpoint"] = {}
#: hit counters of single-name-disarmed failpoints: a later re-arm of the
#: same name RESUMES its index stream (indices never restart mid-run, even
#: across a partition window's disarm/restore)
_retired_counts: Dict[str, int] = {}
_seed: int = 0
_log: List[tuple] = []            # (name, hit_index, action)
_log_lock = threading.Lock()
_trace_id: Optional[str] = None   # one trace groups all fault events of a run


class FailpointInjected(RuntimeError):
    """Raised at a failpoint armed with the ``raise`` action."""

    def __init__(self, name: str, hit: int):
        super().__init__(f"failpoint {name!r} injected fault (hit #{hit})")
        self.failpoint = name
        self.hit = hit

    def __reduce__(self):
        # args holds the formatted message; replaying __init__ with it
        # would TypeError (two required params) — rebuild from the fields
        return (FailpointInjected, (self.failpoint, self.hit))


class _Failpoint:
    __slots__ = ("name", "action", "prob", "delay_s", "count", "lock")

    def __init__(self, name: str, action: str, prob: float, delay_s: float):
        self.name = name
        self.action = action
        self.prob = prob
        self.delay_s = delay_s
        self.count = 0          # hit index allocator; survives re-arm of the
        self.lock = threading.Lock()  # same name so indices never restart mid-run


def _decision(seed: int, name: str, index: int) -> float:
    """Uniform [0, 1) draw fully determined by (seed, name, index)."""
    h = hashlib.blake2b(
        f"{seed}:{name}:{index}".encode(), digest_size=8
    ).digest()
    return int.from_bytes(h, "little") / 2.0**64


# --------------------------------------------------------------------------
# the hot-path hook
# --------------------------------------------------------------------------
def fp(name: str) -> Optional[str]:
    """Evaluate the failpoint ``name``.

    Disarmed (the overwhelmingly common case): returns None after one
    module-global check.  Armed: draws the deterministic decision for this
    hit; on injection, ``raise`` raises :class:`FailpointInjected` and
    ``delay`` sleeps here, both returning None afterwards/never — the call
    site needs no handling for them.  ``drop`` / ``kill`` / ``partition``
    are returned for the site to interpret.
    """
    if not ARMED:
        return None
    f = _fps.get(name)
    if f is None:
        return None
    with f.lock:
        idx = f.count
        f.count += 1
    if f.prob < 1.0 and _decision(_seed, name, idx) >= f.prob:
        return None
    _record(name, idx, f.action)
    if f.action == "delay":
        time.sleep(f.delay_s)
        return None
    if f.action == "raise":
        raise FailpointInjected(name, idx)
    return f.action


def _record(name: str, idx: int, action: str) -> None:
    with _log_lock:
        _log.append((name, idx, action))
    try:
        from ray_tpu_torch.observability import metric_defs, tracing

        metric_defs.CHAOS_FAULTS_INJECTED.inc(
            tags={"failpoint": name, "action": action}
        )
        if tracing.enabled():
            cur = tracing.current_context()
            # rt-lint: disable=chaos-determinism -- span timestamps only;
            # the fault log records (name, hit, action), never wall-clock
            now = time.time()
            tracing.emit_span(
                f"fault::{name}",
                cur.trace_id if cur is not None else (_trace_id or "chaos"),
                cur.span_id if cur is not None else None,
                now,
                now,
                attrs={"failpoint": name, "action": action, "hit": str(idx)},
            )
    except Exception:  # noqa: BLE001 — observability must not alter the fault
        pass


# --------------------------------------------------------------------------
# arming / disarming
# --------------------------------------------------------------------------
def parse_spec(spec: str) -> Dict[str, dict]:
    """``"a=drop(0.5);b=delay(0.1,0.2)"`` -> {name: {action, prob, delay_s}}.
    Raises ValueError on malformed entries — a silently-ignored chaos spec
    would make a passing chaos run meaningless."""
    out: Dict[str, dict] = {}
    entries: List[str] = []
    depth, cur = 0, []
    for ch in spec:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(0, depth - 1)
        if ch in ";," and depth == 0:
            entries.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    entries.append("".join(cur))
    for raw in entries:
        entry = raw.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise ValueError(f"failpoint entry {entry!r}: expected name=action")
        name, _, action_s = entry.partition("=")
        name = name.strip()
        action_s = action_s.strip()
        args: List[str] = []
        if "(" in action_s:
            if not action_s.endswith(")"):
                raise ValueError(f"failpoint entry {entry!r}: unclosed '('")
            action_s, _, arg_s = action_s[:-1].partition("(")
            args = [a.strip() for a in arg_s.split(",") if a.strip()]
        action = action_s.strip()
        if action not in _ACTIONS:
            raise ValueError(
                f"failpoint entry {entry!r}: unknown action {action!r} "
                f"(expected one of {_ACTIONS})"
            )
        prob, delay_s = 1.0, 0.0
        try:
            if action == "delay":
                if not args:
                    raise ValueError("delay requires (seconds[, p])")
                delay_s = float(args[0])
                if len(args) > 1:
                    prob = float(args[1])
            elif args:
                prob = float(args[0])
        except ValueError as exc:
            raise ValueError(f"failpoint entry {entry!r}: {exc}") from None
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"failpoint entry {entry!r}: p must be in [0, 1]")
        out[name] = {"action": action, "prob": prob, "delay_s": delay_s}
    return out


def arm(spec, seed: Optional[int] = None) -> None:
    """Arm failpoints from a spec string (see :func:`parse_spec`) or a
    ``{name: {action, prob, delay_s}}`` dict.  Merges with already-armed
    failpoints; re-arming an existing name updates its action but keeps its
    hit counter (indices never restart mid-run).  ``seed`` (default: keep
    current) fixes the decision stream."""
    global ARMED, _seed, _trace_id
    entries = parse_spec(spec) if isinstance(spec, str) else dict(spec)
    with _lock:
        if seed is not None:
            _seed = int(seed)
        for name, e in entries.items():
            cur = _fps.get(name)
            if cur is None:
                fp_new = _Failpoint(
                    name, e["action"], float(e.get("prob", 1.0)),
                    float(e.get("delay_s", 0.0)),
                )
                fp_new.count = _retired_counts.pop(name, 0)
                _fps[name] = fp_new
            else:
                cur.action = e["action"]
                cur.prob = float(e.get("prob", 1.0))
                cur.delay_s = float(e.get("delay_s", 0.0))
        if _trace_id is None:
            import os

            # rt-lint: disable=chaos-determinism -- trace-correlation id for
            # emitted spans only; never feeds fp decisions or the fault log
            _trace_id = "chaos-" + os.urandom(4).hex()
        ARMED = bool(_fps)


def disarm(name: Optional[str] = None) -> None:
    """Disarm one failpoint, or all of them (``name=None``).

    Single-name disarm preserves the fault log AND the name's hit counter
    (re-arming resumes the index stream) — a schedule closing a partition
    window must not erase the run's deterministic artifact.  Only the full
    ``disarm()`` resets everything for the next run."""
    global ARMED, _trace_id
    with _lock:
        if name is None:
            _fps.clear()
            _retired_counts.clear()
            ARMED = False
            _trace_id = None
            with _log_lock:
                _log.clear()
            return
        retired = _fps.pop(name, None)
        if retired is not None:
            _retired_counts[name] = retired.count
        ARMED = bool(_fps)


def configured(name: str) -> Optional[dict]:
    """The armed entry for ``name`` (action/prob/delay_s), or None."""
    f = _fps.get(name)
    if f is None:
        return None
    return {"action": f.action, "prob": f.prob, "delay_s": f.delay_s}


def armed_spec() -> Dict[str, dict]:
    """Snapshot of every armed failpoint, keyed by name."""
    with _lock:
        return {
            n: {"action": f.action, "prob": f.prob, "delay_s": f.delay_s}
            for n, f in _fps.items()
        }


def arm_from_env() -> None:
    """Arm from ``RAY_TPU_FAILPOINTS`` / ``RAY_TPU_FAILPOINT_SEED`` if set —
    called at process start by worker_main and the node agent so a spec
    exported on the driver's environment covers every fabric process."""
    import os

    spec = os.environ.get("RAY_TPU_FAILPOINTS", "")
    if spec:
        arm(spec, seed=int(os.environ.get("RAY_TPU_FAILPOINT_SEED", "0")))


# --------------------------------------------------------------------------
# the fault log — the deterministic artifact chaos runs compare
# --------------------------------------------------------------------------
def fault_log() -> List[dict]:
    """Every injected fault so far, sorted by ``(failpoint, hit)`` — the
    canonical order, identical across runs of the same (seed, schedule,
    workload) regardless of thread interleaving."""
    with _log_lock:
        entries = list(_log)
    entries.sort()
    return [{"fp": n, "hit": i, "action": a} for n, i, a in entries]


def raw_log(start: int = 0) -> List[dict]:
    """Fault entries in APPEND order from index ``start`` — the incremental
    form (the log only ever appends): shippers keep a cursor and send the
    tail instead of re-serializing the whole run every tick.  Sort the
    accumulated entries by ``(fp, hit)`` to recover the canonical
    :func:`fault_log` order."""
    with _log_lock:
        entries = _log[start:]
    return [{"fp": n, "hit": i, "action": a} for n, i, a in entries]


def reset_log() -> None:
    with _log_lock:
        _log.clear()


def reset() -> None:
    """Full teardown: disarm everything, clear the log, forget the seed."""
    global _seed
    disarm()
    with _lock:
        _seed = 0


# --------------------------------------------------------------------------
# state persistence — the determinism contract THROUGH a head restart
# --------------------------------------------------------------------------
def snapshot_state() -> dict:
    """Everything a restarted head must not lose for same-seed fault logs to
    stay byte-identical through the restart: the seed, the armed spec, every
    hit counter (armed and retired), and the fault log accumulated so far.
    The control snapshot (``control.save_snapshot``) embeds this, so a head
    killed and restored mid-run resumes every decision stream at the exact
    hit index where the snapshot left it."""
    with _lock:
        spec = {
            n: {"action": f.action, "prob": f.prob, "delay_s": f.delay_s}
            for n, f in _fps.items()
        }
        counters = {n: f.count for n, f in _fps.items()}
        retired = dict(_retired_counts)
        seed = _seed
    with _log_lock:
        log = list(_log)
    return {
        "seed": seed,
        "spec": spec,
        "counters": counters,
        "retired": retired,
        "log": log,
    }


def restore_state(state: dict) -> None:
    """Restore a :func:`snapshot_state` capture.  Merge semantics — counters
    only advance (max) and log entries union — so restoring into a process
    that never actually died is a no-op, while restoring into a fresh head
    process resumes the per-failpoint index streams where they stopped."""
    global _seed
    if not state:
        return
    spec = state.get("spec") or {}
    if spec:
        arm(spec, seed=state.get("seed"))
    elif state.get("seed") is not None:
        with _lock:
            _seed = int(state["seed"])
    with _lock:
        for name, count in (state.get("counters") or {}).items():
            f = _fps.get(name)
            if f is not None:
                with f.lock:
                    f.count = max(f.count, int(count))
            else:
                _retired_counts[name] = max(_retired_counts.get(name, 0), int(count))
        for name, count in (state.get("retired") or {}).items():
            if name not in _fps:
                _retired_counts[name] = max(_retired_counts.get(name, 0), int(count))
    with _log_lock:
        seen = set(_log)
        for entry in state.get("log") or ():
            entry = tuple(entry)
            if entry not in seen:
                _log.append(entry)
                seen.add(entry)
