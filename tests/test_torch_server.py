"""The port's engine observability and its servers against the JAX package's.

``stats()`` and ``admission_snapshot()`` carry the reference's keys and, after
the same requests, its values (timings aside); the tenant and the deadline
come from the request context; the metric families move by the same deltas;
an expired deadline sheds the same way. ``LLMServer`` and
``OpenAICompatLLMServer`` answer the same bodies with the same tokens,
envelopes, streamed chunks, stop handling and rejection messages. Both
packages serve the same converted weights (small f32 config) with the JAX
tests' toy character tokenizer; the port runs on the CPU.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ray_tpu.exceptions import DeadlineExceededError as JaxDeadlineExceededError  # noqa: E402
from ray_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from ray_tpu.models import init_params as jax_init_params  # noqa: E402
from ray_tpu.observability import metric_defs as jdefs  # noqa: E402
from ray_tpu.runtime import admission as jadmission  # noqa: E402
from ray_tpu.runtime import context as jctx  # noqa: E402
from ray_tpu.serve.llm import LLMEngine as JaxEngine  # noqa: E402
from ray_tpu.serve.llm import LLMServer as JaxLLMServer  # noqa: E402
from ray_tpu.serve.llm import OpenAICompatLLMServer as JaxOpenAIServer  # noqa: E402
from ray_tpu_torch.convert import params_from_numpy  # noqa: E402
from ray_tpu_torch.exceptions import DeadlineExceededError  # noqa: E402
from ray_tpu_torch.models.transformer import TransformerConfig  # noqa: E402
from ray_tpu_torch.observability import metric_defs as tdefs  # noqa: E402
from ray_tpu_torch.runtime import admission as tadmission  # noqa: E402
from ray_tpu_torch.runtime import context as tctx  # noqa: E402
from ray_tpu_torch.serve.llm import LLMEngine, LLMServer, OpenAICompatLLMServer  # noqa: E402

SMALL = dict(vocab_size=89, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64)
JCFG = JaxConfig(**SMALL, attention="dense", dtype=jnp.float32)
CFG = TransformerConfig(**SMALL, attention="dense", dtype=torch.float32)
PROMPTS = [[3, 5, 7, 11, 13], [2] * 17, list(range(1, 31)), [3, 5, 7, 11, 13]]


class _Tok:
    """The JAX tests' toy tokenizer (tests/test_serve_llm.py): 1 char = 1 id."""

    def encode(self, s):
        return [ord(c) % 80 + 1 for c in s]

    def decode(self, ids):
        return "".join(chr((i - 1) % 80 + 97) for i in ids)


@pytest.fixture(scope="module")
def params():
    jp = jax_init_params(JCFG, jax.random.key(11))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _wait(pred, timeout=60):
    deadline = time.time() + timeout
    while not pred() and time.time() < deadline:
        time.sleep(0.005)
    assert pred()


def _engines(params, **kw):
    jp, tp = params
    kw = {"max_batch_size": 4, "max_seq_len": 64, **kw}
    return JaxEngine(JCFG, jp, **kw), LLMEngine(CFG, tp, device="cpu", **kw)


def _counter(defs, name, tags):
    return getattr(defs, name).get(tags)


# --------------------------------------------------------------------------
# engine observability
# --------------------------------------------------------------------------
@pytest.mark.parametrize("cache_kind", ["paged", "dense"])
def test_stats_and_snapshot_keys_equal_jax(params, cache_kind):
    j, t = _engines(params, cache_kind=cache_kind)
    try:
        assert set(t.stats()) == set(j.stats())
        snap_t, snap_j = t.admission_snapshot(), j.admission_snapshot()
        assert set(snap_t) == set(snap_j)
        assert set(snap_t["latency"]) == set(snap_j["latency"])
        for name in snap_t["latency"]:
            assert set(snap_t["latency"][name]) == set(snap_j["latency"][name])
    finally:
        j.shutdown()
        t.shutdown()


def _serve_under_context(ctx, eng, tenant):
    tok_t, tok_d = ctx.push_tenant(tenant), ctx.push_deadline(time.time() + 600)
    try:
        futs = [eng.submit(p, max_tokens=6) for p in PROMPTS]
    finally:
        ctx.pop_deadline(tok_d)
        ctx.pop_tenant(tok_t)
    return [f.result(timeout=120) for f in futs]


@pytest.mark.parametrize("cache_kind", ["paged", "dense"])
def test_admission_snapshot_and_metric_deltas_equal_jax(params, cache_kind):
    """The same requests, submitted under a tenant and a deadline in the
    request context, leave equal stats, snapshots (timings aside) and metric
    deltas: tenant admissions, prefix hit/partial/miss, the queue depth."""
    tenant = f"acme-{cache_kind}"
    tags = {"tenant": tenant}
    before = [(_counter(d, "TENANT_ADMISSIONS", tags),
               {r: _counter(d, "LLM_PREFIX_CACHE_HITS", {"result": r})
                for r in ("hit", "partial", "miss")}) for d in (jdefs, tdefs)]
    j, t = _engines(params, cache_kind=cache_kind, kv_block_size=8)
    try:
        out_j = _serve_under_context(jctx, j, tenant)
        out_t = _serve_under_context(tctx, t, tenant)
        assert out_t == out_j
        for eng in (j, t):
            _wait(lambda: eng.stats()["active_slots"] == 0)
        assert t.stats() == j.stats()
        snap_t, snap_j = t.admission_snapshot(), j.admission_snapshot()
        lat_t, lat_j = snap_t.pop("latency"), snap_j.pop("latency")
        assert snap_t == snap_j
        for name in lat_j:  # timings differ; the counts do not
            assert lat_t[name]["count"] == lat_j[name]["count"], name
        assert lat_t["ttft"]["count"] == len(PROMPTS) and lat_t["ttft"]["p99"] > 0.0
        assert lat_t["inter_token"]["count"] == len(PROMPTS) * 5
        # the tenant came from the context: the finished ring and the metric
        assert {r["tenant"] for r in t._finished_ring} == {tenant}
        after = [(_counter(d, "TENANT_ADMISSIONS", tags),
                  {r: _counter(d, "LLM_PREFIX_CACHE_HITS", {"result": r})
                   for r in ("hit", "partial", "miss")}) for d in (jdefs, tdefs)]
        deltas = [(a[0] - b[0], {r: a[1][r] - b[1][r] for r in a[1]})
                  for a, b in zip(after, before)]
        assert deltas[1] == deltas[0]
        assert deltas[1][0] == len(PROMPTS)
        assert tdefs.ADMISSION_QUEUE_DEPTH.get(t._depth_tags) == \
            jdefs.ADMISSION_QUEUE_DEPTH.get(j._depth_tags) == 0
        if cache_kind == "paged":
            assert tdefs.LLM_KV_BLOCK_POOL_SIZE.get(t._depth_tags) == t.stats()["kv_block_pool_size"]
            assert tdefs.LLM_KV_BLOCKS_IN_USE.get(t._depth_tags) == t.stats()["kv_blocks_in_use"]
            assert tdefs.LLM_PREFIX_CACHE_BLOCKS.get(t._depth_tags) == \
                t.stats()["prefix_cache_blocks"]
        assert any(s["source"] == "llm_engine" and s is not None
                   for s in tadmission.sources_snapshot())
    finally:
        j.shutdown()
        t.shutdown()
    assert t._admission_token not in tadmission._sources


@pytest.mark.parametrize("where", ["argument", "context"])
def test_expired_deadline_sheds_as_jax(params, where):
    j, t = _engines(params)
    try:
        before = (jadmission.shed_totals().get("engine", {}).get("deadline_expired", 0),
                  tadmission.shed_totals().get("engine", {}).get("deadline_expired", 0))
        shed_before = _counter(tdefs, "REQUESTS_SHED",
                               {"layer": "engine", "reason": "deadline_expired"})
        for eng, ctx, err in ((j, jctx, JaxDeadlineExceededError),
                              (t, tctx, DeadlineExceededError)):
            past = time.time() - 1
            if where == "argument":
                with pytest.raises(err) as exc:
                    eng.submit([1, 2], max_tokens=2, deadline_ts=past)
            else:
                tok = ctx.push_deadline(past)
                try:
                    with pytest.raises(err) as exc:
                        eng.submit([1, 2], max_tokens=2)
                finally:
                    ctx.pop_deadline(tok)
            assert exc.value.stage == "engine_admission"
        after = (jadmission.shed_totals()["engine"]["deadline_expired"],
                 tadmission.shed_totals()["engine"]["deadline_expired"])
        assert after[1] - before[1] == after[0] - before[0] == 1
        assert _counter(tdefs, "REQUESTS_SHED",
                        {"layer": "engine", "reason": "deadline_expired"}) == shed_before + 1
        assert t.stats()["shed"] == j.stats()["shed"] == 1
    finally:
        j.shutdown()
        t.shutdown()


def test_request_trace_rides_the_context_through_the_engine(params):
    from ray_tpu.observability import reqtrace as jtrace
    from ray_tpu_torch.observability import reqtrace as ttrace

    j, t = _engines(params)
    try:
        names = []
        for mod, ctx, eng in ((jtrace, jctx, j), (ttrace, tctx, t)):
            tr = mod.RequestTrace(route="/llm", deployment="LLMServer")
            tok = ctx.push_request_trace(tr)
            try:
                eng.generate([3, 1, 4], max_tokens=5)
            finally:
                ctx.pop_request_trace(tok)
            mod.TraceStore(ring=4).finish(tr, "ok")
            names.append(([n for n, _ in tr.marks], [p for p, _, _ in tr.phases()],
                          tr.tokens, tr.gap_count))
        assert names[1] == names[0]
        assert names[1][1][-1] == "decode" and names[1][2] == 5
    finally:
        j.shutdown()
        t.shutdown()


def test_crashed_loop_is_flight_recorded(params):
    from ray_tpu_torch.observability.events import global_event_manager

    _, tp = params
    eng = LLMEngine(CFG, tp, device="cpu", max_batch_size=2, max_seq_len=64)
    try:
        eng.generate([1, 2, 3], max_tokens=3)
        real = eng._decode_k_paged
        eng._decode_k_paged = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("injected"))
        with pytest.raises(RuntimeError, match="step failed"):
            eng.submit([4, 5], max_tokens=4).result(timeout=60)
        eng._decode_k_paged = real
        evs = [e for e in global_event_manager().list_events(source_type="SERVE")
               if e.label == "engine_crash"
               and e.custom_fields.get("engine") == str(eng._admission_token)]
        assert evs and "injected" in evs[-1].message
        assert '"outcome": "finish"' in evs[-1].custom_fields["requests"]
        assert any(r["outcome"] == "crash" for r in eng._finished_ring)
    finally:
        eng.shutdown()


# --------------------------------------------------------------------------
# LLMServer and OpenAICompatLLMServer
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def servers(params):
    jp, tp = params
    kw = dict(max_batch_size=4, max_seq_len=64)
    j = JaxOpenAIServer(lambda: (JCFG, jp, _Tok()), **kw)
    t = OpenAICompatLLMServer(lambda: (CFG, tp, _Tok()), device="cpu", **kw)
    yield j, t
    j.engine.shutdown()
    t.engine.shutdown()


def _normalise(resp):
    """Drop what differs by design (ids are random, times are times)."""
    if isinstance(resp, dict):
        out = {k: v for k, v in resp.items() if k not in ("created", "latency_s")}
        if "id" in out:
            out["id"] = out["id"].split("-")[0] + "-"
        return out
    return [_normalise(r) for r in resp]


BODIES = {
    "native_tokens": {"prompt": [3, 14, 15], "max_tokens": 6},
    "native_text": {"text": "hello", "max_tokens": 5},
    "native_eos": {"prompt": [3, 14, 15], "max_tokens": 6, "eos_id": "@2"},
    "native_stream": {"prompt": [2, 7, 1], "max_tokens": 5, "stream": True},
    "completion": {"model": "m", "prompt": "hello", "max_tokens": 6, "temperature": 0},
    "completion_ids": {"model": "m", "prompt": [3, 14, 15], "max_tokens": 5, "temperature": 0},
    "completion_defaults": {"model": "m", "prompt": "abc", "max_tokens": 4, "temperature": 0,
                            "top_p": 1.0, "n": 1, "presence_penalty": 0, "logprobs": False},
    "chat": {"model": "m", "messages": [{"role": "user", "content": "hi"}], "max_tokens": 6,
             "temperature": 0},
    "chat_stream": {"model": "m", "messages": [{"role": "system", "content": "be brief"},
                                               {"role": "user", "content": "hi"}],
                    "max_tokens": 6, "temperature": 0, "stream": True},
    "completion_stream": {"model": "m", "prompt": "xyz", "max_tokens": 5, "temperature": 0,
                          "stream": True},
    "stop_id": {"model": "m", "prompt": "hello", "max_tokens": 8, "temperature": 0,
                "stop": "@2"},
    "stop_one_char": {"model": "m", "prompt": "hello", "max_tokens": 8, "temperature": 0,
                      "stop": "#2"},
    "stop_text": {"model": "m", "prompt": "hello", "max_tokens": 8, "temperature": 0,
                  "stop": "#2:4"},
    "stop_list": {"model": "m", "prompt": "hello", "max_tokens": 8, "temperature": 0,
                  "stop": ["#2:4"]},
    "stop_stream": {"model": "m", "messages": [{"role": "user", "content": "hello"}],
                    "max_tokens": 8, "temperature": 0, "stop": "@2", "stream": True},
}


def _fill_stops(body, greedy):
    """``"@k"``: the k-th greedy token id; ``"#k"`` / ``"#k:m"``: the decoded
    text of greedy tokens k (to m): stops that do occur in the answer."""
    tok = _Tok()
    out = {}
    for key, v in body.items():
        if isinstance(v, list) and v and isinstance(v[0], str) and v[0].startswith("#"):
            v = [_fill_stops({"s": x}, greedy)["s"] for x in v]
        elif isinstance(v, str) and v.startswith("@"):
            v = greedy[int(v[1:])]
        elif isinstance(v, str) and v.startswith("#"):
            lo, _, hi = v[1:].partition(":")
            v = tok.decode(greedy[int(lo): int(hi or int(lo) + 1)])
        out[key] = v
    return out


def _greedy_for(srv, body):
    probe = {k: v for k, v in body.items() if k not in ("stop", "eos_id", "stream")}
    if "messages" in probe or "model" in probe:
        return srv(probe)["choices"][0]["token_ids"]
    return srv(probe)["tokens"]


@pytest.mark.parametrize("name", list(BODIES))
def test_server_answers_equal_jax(servers, name):
    j, t = servers
    greedy = _greedy_for(j, BODIES[name])
    assert _greedy_for(t, BODIES[name]) == greedy
    body = _fill_stops(BODIES[name], greedy)
    rj, rt = j(dict(body)), t(dict(body))
    if body.get("stream"):
        rj, rt = list(rj), list(rt)
        assert len(rt) >= 2
    assert _normalise(rt) == _normalise(rj)
    if "stop" in body and name != "stop_one_char":  # the toy encoding of a char may not occur
        choice = rt[-1]["choices"][0] if isinstance(rt, list) else rt["choices"][0]
        assert choice["finish_reason"] == "stop"
    if isinstance(rt, dict) and "usage" in rt:
        u = rt["usage"]
        assert u["total_tokens"] == u["prompt_tokens"] + u["completion_tokens"]
        assert rt["id"].startswith("chatcmpl-" if "messages" in body else "cmpl-")


REJECTED = {
    "top_p": {"top_p": 0.5},
    "n": {"n": 2},
    "best_of": {"best_of": 3},
    "logprobs": {"logprobs": 0},
    "penalties": {"presence_penalty": 0.5, "frequency_penalty": 0.1},
    "echo": {"echo": True},
    "all": {"top_p": 0.9, "n": 2, "echo": True, "logprobs": 1},
    "stop_many": {"stop": ["a", "b"]},
    "stop_type": {"stop": 1.5},
    "prompt_type": {"prompt": {"not": "a prompt"}},
    "stream_stop_text": {"stop": "zzz", "stream": True},
}


@pytest.mark.parametrize("name", list(REJECTED))
def test_server_rejections_equal_jax(servers, name):
    j, t = servers
    body = {"model": "m", "prompt": "hello", "max_tokens": 4, "temperature": 0,
            **REJECTED[name]}
    with pytest.raises(ValueError) as je:
        j(dict(body))
    with pytest.raises(ValueError) as te:
        t(dict(body))
    assert str(te.value) == str(je.value)


def test_server_without_tokenizer_equals_jax(params):
    jp, tp = params
    j = JaxLLMServer(lambda: (JCFG, jp), max_batch_size=2, max_seq_len=64, cache_kind="dense")
    t = LLMServer(lambda: (CFG, tp), device="cpu", max_batch_size=2, max_seq_len=64,
                  cache_kind="dense")
    try:
        body = {"prompt": [5, 6, 7], "max_tokens": 5}
        assert _normalise(t(body)) == _normalise(j(body))
        assert set(t.stats()) == set(j.stats()) and t.stats()["cache_kind"] == "dense"
        for bad in ({"text": "hi"}, {}):
            with pytest.raises(ValueError) as je:
                j(bad)
            with pytest.raises(ValueError) as te:
                t(bad)
            assert str(te.value) == str(je.value)
        assert t.kv_free_blocks() == j.kv_free_blocks() == 0
    finally:
        j.engine.shutdown()
        t.engine.shutdown()
    # mesh= is ported (tests/test_torch_tp_serve.py): it takes a Mesh, and
    # tp= names its axis, as in the JAX package
    with pytest.raises(TypeError, match="ray_tpu_torch.parallel.Mesh"):
        LLMServer(lambda: (CFG, tp), device="cpu", mesh=object())
    LLMServer(lambda: (CFG, tp), device="cpu", tp="tp").engine.shutdown()


def test_second_shutdown_leaves_the_next_engine_registered(params):
    """An engine shut down explicitly and then again by its server's
    ``__del__`` must not unregister the engine that took its admission
    token in between, nor zero that engine's gauges."""
    import gc

    _, tp = params
    kw = dict(device="cpu", max_batch_size=2, max_seq_len=32)
    first = LLMServer(lambda: (CFG, tp), **kw)
    token = first.engine._admission_token
    first.engine.shutdown()
    second = LLMServer(lambda: (CFG, tp), **kw)
    try:
        assert second.engine._admission_token == token  # the freed token is reused
        n_sources = len(tadmission.sources_snapshot())
        del first
        gc.collect()  # the first server's __del__ shuts its engine down again
        assert len(tadmission.sources_snapshot()) == n_sources
        tags = second.engine._depth_tags
        assert tdefs.LLM_KV_BLOCK_POOL_SIZE.get(tags) == second.engine._allocator.capacity > 0
        assert second({"prompt": [3, 1, 4], "max_tokens": 3})["num_generated"] == 3
    finally:
        second.engine.shutdown()


def test_server_is_the_ingress_of_a_request_trace(params):
    """The ingress of a request's trace is the HTTP proxy in front of the
    server, as in the JAX package: called with no trace in its context the
    server starts none, a trace the caller put there is stamped and not
    finished, and behind ``serve.run`` the proxy starts and finishes one
    per request: ``ok`` for an answer and a stream run to its end,
    ``disconnect`` for a stream whose client went away, ``error`` for a
    rejected body."""
    import json
    import socket
    import struct
    import urllib.error
    import urllib.request

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.observability import reqtrace as ttrace

    _, tp = params
    store = ttrace.global_trace_store()
    srv = LLMServer(lambda: (CFG, tp), device="cpu", max_batch_size=2, max_seq_len=64)
    store.reset()
    try:
        assert srv({"prompt": [3, 1, 4], "max_tokens": 2})["num_generated"] == 2
        assert store.snapshot()["recent"] == []
        own = ttrace.RequestTrace(route="/llm")
        tok = tctx.push_request_trace(own)
        try:
            srv({"prompt": [5, 6], "max_tokens": 2})
        finally:
            tctx.pop_request_trace(tok)
        assert "engine_submit" in [n for n, _ in own.marks] and not own.done
    finally:
        srv.engine.shutdown()

    def post(body, tenant=None):
        headers = {"Content-Type": "application/json"}
        if tenant:
            headers["X-Tenant-Id"] = tenant
        req = urllib.request.Request(serve.proxy_url() + "/llm",
                                     data=json.dumps(body).encode(), headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as err:
            return err.code, err.read()

    def abandon_stream(body):
        """Read the first SSE frame, then reset the connection."""
        data = json.dumps(body).encode()
        host, port = serve.proxy_url()[len("http://"):].split(":")
        with socket.create_connection((host, int(port)), timeout=60) as sock:
            sock.sendall(b"POST /llm HTTP/1.1\r\nHost: x\r\nContent-Type: "
                         b"application/json\r\nContent-Length: %d\r\n\r\n" % len(data) + data)
            got = b""
            while b"data: " not in got:
                got += sock.recv(4096)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))

    rt.init(num_cpus=4)
    try:
        serve.start(http_port=0)
        serve.run(serve.deployment(LLMServer).bind(
            lambda: (CFG, tp), device="cpu", max_batch_size=2, max_seq_len=64),
            route_prefix="/llm")
        store.reset()
        assert post({"prompt": [3, 1, 4], "max_tokens": 5}, tenant="acme")[0] == 200
        status, body = post({"prompt": [3, 1, 4], "max_tokens": 5, "stream": True})
        assert status == 200 and b'"done": true' in body
        abandon_stream({"prompt": [2, 7], "max_tokens": 60, "stream": True})
        assert _wait_for(lambda: len(store.snapshot()["recent"]) == 3)
        assert post({})[0] == 500
        done = [store.find(d["id"]) for d in reversed(store.snapshot()["recent"])]
        assert [t.outcome for t in done] == ["ok", "ok", "disconnect", "error"]
        for t in done:
            assert t.deployment == "LLMServer" and t.route == "/llm" and t.done
            assert t.marks[0][0] == "proxy_in" and t.marks[-1][0] == "finished"
            assert sum(b - a for _, a, b in t.phases()) == pytest.approx(t.e2e_s, abs=1e-9)
        for t in done[:2]:
            phases = [p for p, _, _ in t.phases()]
            assert phases[0] == "proxy" and "prefill" in phases and phases[-1] == "decode"
            assert t.tokens == 5
        assert done[0].tenant == "acme" and done[1].tenant is None
        assert [p for p, _, _ in done[3].phases()][-1] == "handler"
    finally:
        serve.shutdown()
        rt.shutdown()
        store.reset()


def _wait_for(pred, timeout=30):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.02)
    return bool(pred())

