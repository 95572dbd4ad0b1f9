"""The port's serving observability against the JAX package's.

Latency sketches (quantiles, wire form, merges), the metrics registry's text
exposition, the metric catalog, request traces (marks, segments, outcomes),
the flight recorder, the request context and the config's environment
override: the same operations give the same answers in both packages. Samples
come from seeded numpy generators; the port runs on the CPU.
"""

import json
import os
import time
import uuid

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ray_tpu.core import config as jconfig  # noqa: E402
from ray_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from ray_tpu.models import init_params as jax_init_params  # noqa: E402
from ray_tpu.observability import metric_defs as jdefs  # noqa: E402
from ray_tpu.observability import metrics as jmetrics  # noqa: E402
from ray_tpu.observability import reqtrace as jtrace  # noqa: E402
from ray_tpu.observability import sketch as jsketch  # noqa: E402
from ray_tpu.runtime import context as jctx  # noqa: E402
from ray_tpu.serve.llm import LLMEngine as JaxEngine  # noqa: E402
from ray_tpu_torch.convert import params_from_numpy  # noqa: E402
from ray_tpu_torch.core import config as tconfig  # noqa: E402
from ray_tpu_torch.models.transformer import TransformerConfig  # noqa: E402
from ray_tpu_torch.observability import metric_defs as tdefs  # noqa: E402
from ray_tpu_torch.observability import metrics as tmetrics  # noqa: E402
from ray_tpu_torch.observability import reqtrace as ttrace  # noqa: E402
from ray_tpu_torch.observability import sketch as tsketch  # noqa: E402
from ray_tpu_torch.observability.events import EventSeverity, global_event_manager  # noqa: E402
from ray_tpu_torch.runtime import context as tctx  # noqa: E402
from ray_tpu_torch.serve.llm import LLMEngine  # noqa: E402

SMALL = dict(vocab_size=89, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64)


# --------------------------------------------------------------------------
# LatencySketch: quantiles, wire bytes, merges
# --------------------------------------------------------------------------
def _samples(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "lognormal":  # serving latencies: ms-scale with a long tail
        return rng.lognormal(mean=-4.0, sigma=1.5, size=500)
    if kind == "uniform":
        return rng.uniform(0.0, 40.0, size=300)  # spills into the overflow bucket
    if kind == "edges":  # exactly on the boundaries, and around them
        b = np.asarray(jsketch.SERVING_LATENCY_BOUNDS)
        return np.concatenate([b, np.nextafter(b, 0), np.nextafter(b, 1), [0.0]])
    return np.full(100, 1e-4)  # "p99 guard": 0.99 * 100 in floating point


def _fill(mod, values):
    sk = mod.LatencySketch()
    for v in values:
        sk.observe(float(v))
    return sk


@pytest.mark.parametrize("kind", ["lognormal", "uniform", "edges", "p99_guard"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sketch_quantiles_and_wire_bytes_match_jax(kind, seed):
    vals = _samples(kind, seed)
    if kind == "p99_guard":
        vals = np.append(vals[:99], 99.0)
    j, t = _fill(jsketch, vals), _fill(tsketch, vals)
    assert json.dumps(t.to_dict()).encode() == json.dumps(j.to_dict()).encode()
    assert t.percentiles() == j.percentiles()
    for q in np.linspace(0.0, 1.0, 41):
        assert t.quantile(q) == j.quantile(q)
    # the wire form crosses packages both ways
    assert tsketch.LatencySketch.from_dict(j.to_dict()).to_dict() == j.to_dict()
    assert jsketch.LatencySketch.from_dict(t.to_dict()).to_dict() == t.to_dict()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sketch_merges_match_jax(seed):
    vals = _samples("lognormal", seed)
    parts = np.array_split(vals, 4)
    j = jsketch.merged([_fill(jsketch, p) for p in parts])
    t = tsketch.merged([_fill(tsketch, p) for p in parts])
    assert t.to_dict() == j.to_dict()
    # in place, in another order: counts, totals, max and quantiles agree
    t2 = _fill(tsketch, parts[3]).merge(_fill(tsketch, parts[1])).merge(
        tsketch.merged([_fill(tsketch, parts[0]), _fill(tsketch, parts[2])]))
    assert t2.counts == j.counts and t2.total == j.total and t2.max == j.max
    assert [t2.quantile(q) for q in (0.5, 0.95, 0.99)] == [j.quantile(q) for q in (0.5, 0.95, 0.99)]
    with pytest.raises(ValueError) as te:
        tsketch.LatencySketch((0.1, 1.0)).merge(tsketch.LatencySketch())
    with pytest.raises(ValueError) as je:
        jsketch.LatencySketch((0.1, 1.0)).merge(jsketch.LatencySketch())
    assert str(te.value) == str(je.value)


# --------------------------------------------------------------------------
# metrics: byte-equal exposition, the same catalog
# --------------------------------------------------------------------------
def _drive_registry(mod, seed: int) -> str:
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    c = reg.counter("requests_total", 'Requests "served", with \\ and\nnewline.')
    g = reg.gauge("depth", "Queue depth.", "requests")
    h = reg.histogram("latency_s", "Latency.", "s", boundaries=(0.001, 0.01, 0.1, 1.0))
    hd = reg.histogram("default_buckets_s")
    tags = [None, {"layer": "engine"}, {"tenant": 'a"b\\c\nd', "layer": "router"}]
    for _ in range(50):
        t = tags[rng.integers(len(tags))]
        c.inc(float(rng.integers(1, 4)), t)
        g.set(float(rng.uniform(0, 100)), t)
        h.observe(float(rng.lognormal(-4, 2)), t)
        hd.observe(float(rng.uniform(0, 70)))
    g.set(1e-7, {"layer": "tiny"})
    g.set(12345678901.5, {"layer": "huge"})
    with mod.timed(h, {"layer": "timed"}):
        pass
    return reg.render_prometheus()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_exposition_is_byte_equal(seed):
    jtext, ttext = _drive_registry(jmetrics, seed), _drive_registry(tmetrics, seed)
    # the timed() observation is a wall time: drop its series' values only
    def strip(text):
        return "\n".join(line for line in text.splitlines()
                         if 'layer="timed"' not in line or line.startswith("#"))
    assert strip(ttext).encode() == strip(jtext).encode()
    assert 'layer="timed"' in ttext and "# TYPE ray_tpu_latency_s histogram" in ttext


def test_metric_catalog_matches_jax():
    jax_by_name = {m.name: m for m in jdefs.ALL_METRICS}
    for m in tdefs.ALL_METRICS:
        ref = jax_by_name[m.name]
        assert (m.kind, m.description, m.unit) == (ref.kind, ref.description, ref.unit), m.name
        if m.kind == "histogram":
            assert list(m.boundaries) == list(ref.boundaries), m.name
    names = {m.name for m in tdefs.ALL_METRICS}
    for family in ("llm_", "admission_", "tenant_", "serve_pool_"):
        assert {n for n in jax_by_name if n.startswith(family)} <= names, family
    assert tsketch.SERVING_LATENCY_BOUNDS == tuple(tdefs.LLM_TTFT.boundaries)


# --------------------------------------------------------------------------
# request traces: marks, segments, outcomes
# --------------------------------------------------------------------------
MARK_SEQUENCES = {
    "colocated": ("router_in", "router_dequeue", "replica_in", "engine_submit", "wfq_pop",
                  "admitted", "first_token"),
    "disagg": ("router_in", "router_dequeue", "replica_in", "engine_submit", "wfq_pop",
               "admitted", "first_token", "kv_migrate"),
    "non_llm": ("router_in", "router_dequeue", "replica_in"),
    "repeated": ("router_in", "router_in", "replica_in", "replica_in", "first_token"),
}


def _trace(mod, seq, outcome):
    store = mod.TraceStore(ring=16)
    tr = mod.RequestTrace(route="/llm", deployment="LLMServer", tenant="acme")
    for name in seq:
        tr.mark(name)
    if "first_token" in seq:
        for gap in (0.001, 0.003):
            tr.note_token(gap)
    tr.note_prefill_chunk()
    tr.note_stall()
    if outcome == "crash":
        tr.set_outcome("crash", "engine loop died")
    store.finish(tr, "error" if outcome == "crash" else "ok", "proxy")
    return tr


@pytest.mark.parametrize("outcome", ["ok", "crash"])
@pytest.mark.parametrize("seq", list(MARK_SEQUENCES))
def test_trace_marks_segments_and_outcomes_match_jax(seq, outcome):
    assert (tuple(ttrace.MARKS), ttrace._SEGMENT_FOR_MARK, ttrace.PHASE_SPANS) == (
        tuple(jtrace.MARKS), jtrace._SEGMENT_FOR_MARK, jtrace.PHASE_SPANS)
    j = _trace(jtrace, MARK_SEQUENCES[seq], outcome)
    t = _trace(ttrace, MARK_SEQUENCES[seq], outcome)
    assert [n for n, _ in t.marks] == [n for n, _ in j.marks]
    assert [p for p, _, _ in t.phases()] == [p for p, _, _ in j.phases()]
    # contiguous, and summing exactly to e2e
    phases = t.phases()
    for (_, _, end), (_, start, _) in zip(phases, phases[1:]):
        assert end == start
    assert sum(b - a for _, a, b in phases) == pytest.approx(t.e2e_s, rel=1e-9)
    td, jd = t.to_dict(), j.to_dict()
    timing = {"id", "born", "e2e_s", "ttft_s", "marks", "phases", "inter_token"}
    assert {k: v for k, v in td.items() if k not in timing} == \
        {k: v for k, v in jd.items() if k not in timing}
    assert td["inter_token"]["count"] == jd["inter_token"]["count"]
    assert (t.outcome, t.detail) == (j.outcome, j.detail)


def test_trace_store_sampling_and_off_switch_match_jax(monkeypatch):
    for mod, cfg in ((jtrace, jconfig.get_config()), (ttrace, tconfig.get_config())):
        monkeypatch.setattr(cfg, "serve_request_trace_sample_n", 3)
    picks = {}
    for name, mod in (("jax", jtrace), ("port", ttrace)):
        store = mod.TraceStore(ring=8)
        picks[name] = [store.start(route="/r", deployment="d") is not None for _ in range(10)]
        for _ in range(20):
            tr = mod.RequestTrace(route="/r", deployment="d")
            store.finish(tr, "ok")
        snap = store.snapshot(limit=100)
        picks[name + "_sizes"] = (len(snap["recent"]), len(snap["slowest"]),
                                  snap["deployments"]["d"]["e2e"]["count"])
    assert picks["port"] == picks["jax"] and picks["port_sizes"] == picks["jax_sizes"]
    monkeypatch.setattr(tconfig.get_config(), "serve_request_trace", False)
    assert ttrace.start_trace(route="/r") is None
    ttrace.finish_trace(None)


def test_flight_record_lands_in_the_event_ring():
    store = ttrace.global_trace_store()
    store.reset()
    try:
        for _ in range(3):
            store.finish(store.start(route="/llm", deployment="d"), "ok")
        label = f"test_crash_{uuid.uuid4().hex[:8]}"
        ttrace.flight_record(label, "engine loop crashed in a test", severity="ERROR",
                             state={"slots": 2, "queue": 7}, layer="engine")
        events = [e for e in global_event_manager().list_events(source_type="SERVE")
                  if e.label == label]
        assert len(events) == 1
        ev = events[0]
        assert ev.severity == EventSeverity.ERROR
        assert ev.custom_fields["layer"] == "engine"
        assert json.loads(ev.custom_fields["state"]) == {"slots": 2, "queue": 7}
        recs = json.loads(ev.custom_fields["requests"])
        assert len(recs) == 3 and all(r["outcome"] == "ok" for r in recs)
        key = f"shed:test:{uuid.uuid4().hex[:8]}"
        assert ttrace.snapshot_due(key, 60.0) and not ttrace.snapshot_due(key, 60.0)
    finally:
        store.reset()


# --------------------------------------------------------------------------
# the request context
# --------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["deadline", "tenant", "request_trace"])
def test_context_push_pop_match_jax(which):
    def run(mod):
        push, pop = getattr(mod, f"push_{which}"), getattr(mod, f"pop_{which}")
        cur = getattr(mod, "current_deadline_ts" if which == "deadline" else f"current_{which}")
        seen = [cur()]
        a = push("A" if which != "deadline" else 100.0)
        seen.append(cur())
        b = push(None)  # a no-op install still nests
        seen.append(cur())
        pop(b)
        seen.append(cur())
        pop(a)
        seen.append(cur())
        try:  # a token used twice: the same outcome in both packages
            pop(a)
        except RuntimeError as exc:
            seen.append(type(exc).__name__)
        seen.append(cur())
        return seen

    assert run(tctx) == run(jctx)


def test_context_defaults_and_budget_match_jax():
    assert tctx.current_tenant("dflt") == jctx.current_tenant("dflt") == "dflt"
    assert tctx.remaining_budget(5.0) == jctx.remaining_budget(5.0) == 5.0
    tok_t, tok_j = tctx.push_deadline(time.time() - 1), jctx.push_deadline(time.time() - 1)
    try:
        assert tctx.remaining_budget() == jctx.remaining_budget() == 0.0
    finally:
        tctx.pop_deadline(tok_t)
        jctx.pop_deadline(tok_j)


# --------------------------------------------------------------------------
# one environment configures both packages
# --------------------------------------------------------------------------
@pytest.fixture()
def fresh_configs():
    """Both packages re-read the environment; their old configs come back
    afterwards."""
    saved = jconfig.get_config(), tconfig.get_config()
    jconfig.reset_config()
    tconfig.reset_config()
    yield
    jconfig.set_config(saved[0])
    tconfig.set_config(saved[1])


def test_config_knobs_and_defaults_match_jax():
    jfields = {f.name: f.default for f in jconfig.Config.__dataclass_fields__.values()}
    for name, f in tconfig.Config.__dataclass_fields__.items():
        assert name in jfields and f.default == jfields[name], name


@pytest.fixture(scope="module")
def tiny_params():
    jp = jax_init_params(JaxConfig(**SMALL, attention="dense", dtype=jnp.float32),
                         jax.random.key(3))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("env,value", [
    ("RAY_TPU_KV_BLOCK_SIZE", "8"),
    ("RAY_TPU_PREFILL_CHUNK_TOKENS", "7"),
    ("RAY_TPU_LLM_PREFIX_CACHE", "0"),
    ("RAY_TPU_KV_NUM_BLOCKS", "9"),
    ("RAY_TPU_LLM_CACHE_KIND", "dense"),
])
def test_env_override_governs_both_engines(monkeypatch, fresh_configs, tiny_params, env, value):
    jp, tp = tiny_params
    monkeypatch.setitem(os.environ, env, value)
    jax_eng = JaxEngine(JaxConfig(**SMALL, attention="dense", dtype=jnp.float32), jp,
                        max_batch_size=2, max_seq_len=32)
    eng = LLMEngine(TransformerConfig(**SMALL, attention="dense", dtype=torch.float32), tp,
                    device="cpu", max_batch_size=2, max_seq_len=32)
    try:
        for attr in ("cache_kind", "kv_block_size", "kv_num_blocks", "prefill_chunk_tokens"):
            assert getattr(eng, attr) == getattr(jax_eng, attr), attr
        assert (eng._prefix is None) == (jax_eng._prefix is None)
        knob = env.removeprefix("RAY_TPU_").lower()
        assert getattr(tconfig.get_config(), knob) == getattr(jconfig.get_config(), knob)
        assert str(getattr(tconfig.get_config(), knob)) in (value, str(value == "1"))
    finally:
        jax_eng.shutdown()
        eng.shutdown()
