"""Request-scope serving observability: lifecycle traces + flight recorder.

The port's own copy of ``ray_tpu/observability/reqtrace.py``.  A
:class:`RequestTrace` rides the request context (``runtime/context.py``)
through every serving layer; each layer stamps a named **mark**, a
monotonic offset from the trace's birth.  Phase durations are the deltas
between consecutive marks, so a completed trace's waterfall sums exactly to
its end-to-end latency:

    proxy_in -> router_in       "proxy"          ingress parse + route match
    router_in -> router_dequeue "router_queue"   bounded-queue wait
    router_dequeue -> replica_in "dispatch"      handle -> replica hop
    replica_in -> engine_submit "replica"        user code before the engine
    engine_submit -> wfq_pop    "engine_queue"   WFQ admission wait
    wfq_pop -> admitted         "kv_block_wait"  held head-of-line for pages
    admitted -> first_token     "prefill"        chunks counted on the side
    first_token -> kv_migrate   "kv_migrate"     disaggregated handoff only
    kv_migrate -> finished      "decode"         inter-token gaps aggregated

Marks, segments and ``PHASE_SPANS`` names are the JAX package's.  Per-token
data stays O(1) per trace (gaps, stalls and prefill chunks fold into
counters), and the store is bounded rings and sketches only.  Trace ids come
from ``os.urandom``.  The JAX package also exports each finished trace as
spans to its tracing module; the port has no span exporter, so
``PHASE_SPANS`` only names the phases here.

The **flight recorder** (:func:`flight_record`) snapshots the last-N
completed traces plus caller-supplied engine/admission state into the
bounded ``EventManager`` ring on an abnormal terminal (a shed, an engine
crash).
"""

from __future__ import annotations

import heapq
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.observability.sketch import LatencySketch

#: canonical mark order; marks outside this set are allowed (extension
#: point) but the waterfall names below cover the serving path.
MARKS = (
    "proxy_in", "router_in", "router_dequeue", "replica_in",
    "engine_submit", "wfq_pop", "admitted", "first_token", "kv_migrate",
    "finished",
)

#: segment name keyed by the LATER mark of the pair.
_SEGMENT_FOR_MARK = {
    "router_in": "proxy",
    "router_dequeue": "router_queue",
    "replica_in": "dispatch",
    "engine_submit": "replica",
    "wfq_pop": "engine_queue",
    "admitted": "kv_block_wait",
    "first_token": "prefill",
    "kv_migrate": "kv_migrate",
    "finished": "decode",
}

#: span name per phase — `serve::` for the routing layers, `llm::` for the
#: engine-attributed phases (the span-manifest lint pins these prefixes).
PHASE_SPANS = {
    "proxy": "serve::proxy",
    "router_queue": "serve::router_queue",
    "dispatch": "serve::dispatch",
    "replica": "serve::replica",
    "handler": "serve::handler",
    "engine_queue": "llm::engine_queue",
    "kv_block_wait": "llm::kv_block_wait",
    "prefill": "llm::prefill",
    "kv_migrate": "llm::kv_migrate",
    "decode": "llm::decode",
}

_MAX_MARKS = 32          # fixed set + headroom; hard bound per trace
_SLOWEST_N = 32          # slowest completed traces kept alongside `recent`
_MAX_DEPLOYMENT_SKETCHES = 64


def _new_id() -> str:
    import os

    return os.urandom(8).hex()


class RequestTrace:
    """One request's phase-attributed lifecycle.  Single-writer at any
    instant (the request moves between threads, it is never stamped
    concurrently); readers (snapshots) tolerate a mid-update view."""

    __slots__ = (
        "request_id", "tenant", "deployment", "route", "born_wall", "t0",
        "marks", "outcome", "detail", "tokens", "prefill_chunks", "stalls",
        "gap_count", "gap_sum", "gap_max", "e2e_s", "done",
    )

    def __init__(self, route: str = "", deployment: str = "",
                 tenant: Optional[str] = None):
        self.request_id = _new_id()
        self.tenant = tenant
        self.deployment = deployment
        self.route = route
        self.born_wall = time.time()
        self.t0 = time.perf_counter()
        self.marks: List[Tuple[str, float]] = [("proxy_in", 0.0)]
        self.outcome = ""         # set once at the FIRST terminal claim
        self.detail = ""
        self.tokens = 0
        self.prefill_chunks = 0
        self.stalls = 0
        self.gap_count = 0
        self.gap_sum = 0.0
        self.gap_max = 0.0
        self.e2e_s = 0.0
        self.done = False

    # ------------------------------------------------------------ stamps
    def mark(self, name: str) -> None:
        """Stamp ``name`` at now; idempotent (a held request re-entering
        admission must not re-mark) and bounded."""
        if self.done or len(self.marks) >= _MAX_MARKS:
            return
        for n, _ in self.marks:
            if n == name:
                return
        self.marks.append((name, time.perf_counter() - self.t0))

    def note_token(self, gap_s: float) -> None:
        self.tokens += 1
        if self.tokens == 1:
            self.mark("first_token")
            return
        self.gap_count += 1
        self.gap_sum += gap_s
        if gap_s > self.gap_max:
            self.gap_max = gap_s

    def note_prefill_chunk(self) -> None:
        self.prefill_chunks += 1

    def note_stall(self) -> None:
        self.stalls += 1

    def set_outcome(self, outcome: str, detail: str = "") -> None:
        """First terminal claim wins: an engine-side 'crash' must not be
        overwritten by the proxy's later generic 'error'."""
        if not self.outcome:
            self.outcome = outcome
            self.detail = detail

    # ------------------------------------------------------------- reads
    def mark_offset(self, name: str) -> Optional[float]:
        for n, off in self.marks:
            if n == name:
                return off
        return None

    def ttft_s(self) -> Optional[float]:
        return self.mark_offset("first_token")

    def phases(self) -> List[Tuple[str, float, float]]:
        """``(phase, start_off, end_off)`` per consecutive mark pair —
        durations sum exactly to the last mark's offset (= e2e when
        finished)."""
        out: List[Tuple[str, float, float]] = []
        for (prev, t_prev), (name, t) in zip(self.marks, self.marks[1:]):
            phase = _SEGMENT_FOR_MARK.get(name, name)
            if name == "finished" and prev not in ("first_token", "kv_migrate"):
                # non-LLM requests (or ones that died pre-token) end their
                # last segment in the handler, not decode
                phase = "handler"
            out.append((phase, t_prev, t))
        return out

    def to_dict(self) -> dict:
        ttft = self.ttft_s()
        return {
            "id": self.request_id,
            "tenant": self.tenant,
            "deployment": self.deployment,
            "route": self.route,
            "born": self.born_wall,
            "outcome": self.outcome or ("in_flight" if not self.done else "ok"),
            "detail": self.detail,
            "e2e_s": round(self.e2e_s, 6) if self.done
            else round(time.perf_counter() - self.t0, 6),
            "ttft_s": round(ttft, 6) if ttft is not None else None,
            "tokens": self.tokens,
            "prefill_chunks": self.prefill_chunks,
            "stalls": self.stalls,
            "inter_token": {
                "count": self.gap_count,
                "mean_s": round(self.gap_sum / self.gap_count, 6)
                if self.gap_count else 0.0,
                "max_s": round(self.gap_max, 6),
            },
            "marks": [[n, round(t, 6)] for n, t in self.marks],
            "phases": [
                {"phase": p, "start_s": round(a, 6), "dur_s": round(b - a, 6)}
                for p, a, b in self.phases()
            ],
        }

    def summary(self) -> dict:
        """Compact form for flight-recorder custom_fields."""
        ttft = self.ttft_s()
        return {
            "id": self.request_id,
            "tenant": self.tenant,
            "deployment": self.deployment,
            "outcome": self.outcome or "in_flight",
            "e2e_ms": round(1e3 * (self.e2e_s if self.done
                                   else time.perf_counter() - self.t0), 1),
            "ttft_ms": round(1e3 * ttft, 1) if ttft is not None else None,
            "tokens": self.tokens,
        }


class TraceStore:
    """Process-global bounded store: recent ring + slowest-N + in-flight,
    plus per-deployment SLO sketches fed at completion."""

    def __init__(self, ring: int = 512):
        self._lock = threading.Lock()
        self._ring_cap = ring
        self._recent: deque = deque(maxlen=ring)
        self._slowest: List[Tuple[float, int, RequestTrace]] = []
        self._seq = 0
        self._inflight: Dict[str, RequestTrace] = {}
        self._sample_counter = 0
        #: deployment -> {"e2e"|"queue_wait": LatencySketch}, bounded
        self._deployment_sketches: Dict[str, Dict[str, LatencySketch]] = {}

    # ------------------------------------------------------------ intake
    def start(self, route: str = "", deployment: str = "",
              tenant: Optional[str] = None) -> Optional[RequestTrace]:
        cfg = get_config()
        if not cfg.serve_request_trace:
            return None
        sample_n = max(1, int(cfg.serve_request_trace_sample_n))
        with self._lock:
            self._sample_counter += 1
            if (self._sample_counter - 1) % sample_n:
                return None
            if self._ring_cap != cfg.serve_request_trace_ring:
                # knob changed since the store was built: re-bound the ring
                self._ring_cap = int(cfg.serve_request_trace_ring)
                self._recent = deque(self._recent, maxlen=max(1, self._ring_cap))
            trace = RequestTrace(route=route, deployment=deployment, tenant=tenant)
            self._inflight[trace.request_id] = trace
        return trace

    def finish(self, trace: RequestTrace, outcome: str = "ok",
               detail: str = "") -> None:
        with self._lock:
            if trace.done:
                return
            trace.set_outcome(outcome, detail)
            trace.mark("finished")
            trace.done = True
            trace.e2e_s = trace.marks[-1][1]
            self._inflight.pop(trace.request_id, None)
            self._recent.append(trace)
            self._seq += 1
            entry = (trace.e2e_s, self._seq, trace)
            if len(self._slowest) < _SLOWEST_N:
                heapq.heappush(self._slowest, entry)
            else:
                heapq.heappushpop(self._slowest, entry)
            sketches = self._deployment_sketches.get(trace.deployment)
            if sketches is None and len(self._deployment_sketches) < _MAX_DEPLOYMENT_SKETCHES:
                sketches = self._deployment_sketches[trace.deployment] = {
                    "e2e": LatencySketch(),
                    "queue_wait": LatencySketch(),
                }
        if sketches is not None:
            sketches["e2e"].observe(trace.e2e_s)
            for phase, a, b in trace.phases():
                if phase in ("router_queue", "engine_queue"):
                    sketches["queue_wait"].observe(b - a)
        self._observe_phase_metrics(trace)

    # --------------------------------------------------------- exporters
    def snapshot(self, limit: int = 50) -> dict:
        with self._lock:
            recent = list(self._recent)[-limit:]
            slowest = sorted(self._slowest, key=lambda e: -e[0])[:limit]
            inflight = list(self._inflight.values())[:limit]
            deployments = {
                dep: {name: sk.percentiles() for name, sk in sketches.items()}
                for dep, sketches in self._deployment_sketches.items()
            }
        return {
            "recent": [t.to_dict() for t in reversed(recent)],
            "slowest": [t.to_dict() for _, _, t in slowest],
            "in_flight": [t.to_dict() for t in inflight],
            "deployments": deployments,
        }

    def deployment_percentiles(self) -> dict:
        """{deployment: {sketch: percentiles}} — the cheap SLO summary for
        /api/overload (no trace records, just the merged sketches)."""
        with self._lock:
            return {
                dep: {name: sk.percentiles() for name, sk in sketches.items()}
                for dep, sketches in self._deployment_sketches.items()
            }

    def last(self, n: int = 8) -> List[dict]:
        """Most recent completed traces, newest first (flight recorder)."""
        with self._lock:
            return [t.summary() for t in list(self._recent)[-n:]][::-1]

    def find(self, request_id: str) -> Optional[RequestTrace]:
        with self._lock:
            trace = self._inflight.get(request_id)
            if trace is not None:
                return trace
            for t in self._recent:
                if t.request_id == request_id:
                    return t
        return None

    def reset(self) -> None:
        with self._lock:
            self._recent.clear()
            self._slowest.clear()
            self._inflight.clear()
            self._sample_counter = 0
            self._seq = 0
            self._deployment_sketches.clear()

    # --------------------------------------------------------- internals
    def _observe_phase_metrics(self, trace: RequestTrace) -> None:
        try:
            from ray_tpu_torch.observability import metric_defs

            for phase, a, b in trace.phases():
                metric_defs.SERVE_REQUEST_PHASE.observe(b - a, tags={"phase": phase})
        except Exception:  # noqa: BLE001 — metrics must not fail a request
            pass


_store_lock = threading.Lock()
_store: Optional[TraceStore] = None


def global_trace_store() -> TraceStore:
    global _store
    if _store is None:
        with _store_lock:
            if _store is None:
                _store = TraceStore(ring=max(1, get_config().serve_request_trace_ring))
    return _store


def start_trace(route: str = "", deployment: str = "",
                tenant: Optional[str] = None) -> Optional[RequestTrace]:
    """Proxy entry point: returns a trace (already holding its
    ``proxy_in`` mark) or None when disabled / not sampled."""
    return global_trace_store().start(route=route, deployment=deployment, tenant=tenant)


def finish_trace(trace: Optional[RequestTrace], outcome: str = "ok",
                 detail: str = "") -> None:
    if trace is not None:
        global_trace_store().finish(trace, outcome=outcome, detail=detail)


# --------------------------------------------------------------------------
# flight recorder: abnormal-terminal snapshots into the EventManager ring
# --------------------------------------------------------------------------
_throttle_lock = threading.Lock()
_last_snapshot: Dict[str, float] = {}


def snapshot_due(key: str, min_interval_s: float = 1.0) -> bool:
    """Rate limit full flight snapshots per key (sheds can be thousands/s
    under overload; one snapshot a second per layer tells the same story)."""
    now = time.monotonic()
    with _throttle_lock:
        last = _last_snapshot.get(key)
        if last is not None and now - last < min_interval_s:
            return False
        _last_snapshot[key] = now
    return True


def flight_record(label: str, message: str, *, severity: str = "WARNING",
                  state: Optional[dict] = None,
                  requests: Optional[List[dict]] = None,
                  limit: int = 8, **fields: Any) -> None:
    """Emit one structured postmortem event: the last-``limit`` completed
    request records (or caller-supplied ones) + engine/admission ``state``
    as custom fields on the bounded event ring.  Never raises."""
    try:
        from ray_tpu_torch.observability.events import EventSeverity, global_event_manager

        recs = requests if requests is not None else global_trace_store().last(limit)
        custom = {k: v for k, v in fields.items()}
        if state:
            custom["state"] = json.dumps(state, default=str, sort_keys=True)
        if recs:
            custom["requests"] = json.dumps(recs, default=str)
        sev = EventSeverity[severity] if isinstance(severity, str) else severity
        global_event_manager().emit(sev, "SERVE", label, message, **custom)
    except Exception:  # noqa: BLE001 — the recorder must never hurt serving
        pass
