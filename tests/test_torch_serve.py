"""The port's Serve runtime against the JAX package's, scenario by scenario.

Each scenario is a function of one package's side (its runtime and its
``serve``): the test starts a one-node runtime and Serve in ``ray_tpu``,
runs the scenario, shuts both down, then does the same in
``ray_tpu_torch``, and the two outputs must be equal after the runtime
tests' normalization (the package's name, ids and source paths masked in
messages: ``_norm`` of ``tests/test_torch_runtime.py``). The scenarios are
the JAX package's ``tests/test_serve.py``, the ``LLMServer`` deployments of
``test_serve_llm.py``, the dispatcher of ``test_disagg.py`` and the router
and replica parts of ``test_overload.py``.

The LLM scenarios serve one small f32 decoder (2 layers, d_model 32) with
weights made by the JAX ``init_params`` from a seed and carried across by
``ray_tpu_torch/convert.py``; the port's replicas ask for ``device="cpu"``.
Greedy tokens must be identical, and equal to the JAX one-shot
``generate``. Every scenario ends with ``serve.shutdown()`` and the
runtime's ``shutdown()``.
"""

import dataclasses
import importlib
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from ray_tpu.models import generate as jax_generate  # noqa: E402
from ray_tpu.models import init_params as jax_init_params  # noqa: E402
from ray_tpu_torch.convert import params_from_numpy  # noqa: E402
from ray_tpu_torch.models.transformer import TransformerConfig  # noqa: E402
from test_torch_runtime import _norm  # noqa: E402  (the runtime tests' masking)

PACKAGES = ("ray_tpu", "ray_tpu_torch")
SMALL = dict(vocab_size=89, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64)
JCFG = JaxConfig(**SMALL, attention="dense", dtype=jnp.float32)
CFG = TransformerConfig(**SMALL, attention="dense", dtype=torch.float32)
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3]


def _pkg(name):
    return importlib.import_module(name)


def _error(exc):
    """What a caller sees of an exception: type names and message; a
    wrapped task error also its cause."""
    out = {"type": type(exc).__name__, "mro": [c.__name__ for c in type(exc).__mro__]}
    cause = getattr(exc, "cause", None)
    if cause is not None:
        out["cause"] = (type(cause).__name__, str(cause))
    else:
        out["message"] = str(exc)
    return out


class _Side:
    """One package's view: its runtime, its ``serve``, and how it builds the
    shared tiny LLM deployment (the port's replicas ask for the CPU)."""

    def __init__(self, name, params):
        self.name = name
        self.rt = _pkg(name)
        self.serve = _pkg(name + ".serve")
        self.exc = _pkg(name + ".exceptions")
        self.api = _pkg(name + ".serve.api")
        self.failpoints = _pkg(name + ".runtime.failpoints")
        self.params = params

    @property
    def torch(self):
        return self.name == "ray_tpu_torch"

    def factory(self, tokenizer=None):
        jp, tp = self.params if self.params is not None else (None, None)
        made = (CFG, tp) if self.torch else (JCFG, jp)
        if tokenizer is not None:
            made = made + (tokenizer,)
        return lambda: made

    def llm_app(self, cls="LLMServer", tokenizer=None, deployment_kw=None, **kw):
        server = getattr(_pkg(self.name + ".serve.llm"), cls)
        dep = self.serve.deployment(server, **(deployment_kw or {}))
        if self.torch:
            kw["device"] = "cpu"
        return dep.bind(self.factory(tokenizer), **kw)

    def cluster(self):
        return self.rt.get_cluster()


def _both(scenario, *args, params=None, num_cpus=8, system_config=None):
    outs = {}
    for name in PACKAGES:
        side = _Side(name, params)
        kw = {"num_cpus": num_cpus}
        if system_config:
            kw["_system_config"] = system_config
        side.rt.init(**kw)
        try:
            side.serve.start(http_port=0)
            outs[name] = _norm(scenario(side, *args))
        finally:
            side.serve.shutdown()
            side.rt.shutdown()
    assert outs["ray_tpu_torch"] == outs["ray_tpu"]
    return outs["ray_tpu_torch"]


def _http(url, body=None, headers=None, timeout=60):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode() if body is not None else None,
        headers=headers or {"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), err.read()


def _sse(body):
    return [json.loads(line[6:]) for line in body.decode().splitlines()
            if line.startswith("data: ")]


def _wait(pred, timeout=30):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.02)
    return bool(pred())


@pytest.fixture(scope="module")
def params():
    jp = jax_init_params(JCFG, jax.random.key(11))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _reference(jp, prompt, n):
    """Greedy continuation by the JAX one-shot ``generate``."""
    out, lens = jax_generate(JCFG, jp, jnp.asarray([prompt], jnp.int32),
                             max_new_tokens=n, temperature=0)
    return np.asarray(out[0, len(prompt): int(lens[0])]).tolist()


class _Tok:
    """The JAX tests' toy tokenizer (tests/test_serve_llm.py): 1 char = 1 id."""

    def encode(self, s):
        return [ord(c) % 80 + 1 for c in s]

    def decode(self, ids):
        return "".join(chr((i - 1) % 80 + 97) for i in ids)


# --------------------------------------------------------------------------
# deployments, routing, composition (tests/test_serve.py)
# --------------------------------------------------------------------------
def scenario_function_class_and_methods(s):
    serve = s.serve

    @serve.deployment
    def hello(name):
        return f"hello {name}"

    @serve.deployment
    class Counter:
        def __init__(self, start):
            self.count = start

        def __call__(self, inc):
            self.count += inc
            return self.count

    @serve.deployment
    class Calc:
        def add(self, a, b):
            return a + b

        def mul(self, a, b):
            return a * b

    out = {"hello": serve.run(hello.bind(), route_prefix=None).remote("world").result()}
    h = serve.run(Counter.bind(10), route_prefix=None)
    out["counter"] = [h.remote(1).result(), h.remote(2).result()]
    h = serve.run(Calc.bind(), route_prefix=None)
    out["methods"] = [h.add.remote(2, 3).result(), h.mul.remote(2, 3).result(),
                      h.options(method_name="add").remote(4, 5).result()]
    out["repr"] = repr(Calc)
    return out


def test_function_class_and_method_deployments():
    out = _both(scenario_function_class_and_methods)
    assert out["hello"] == "hello world" and out["counter"] == [11, 13]
    assert out["methods"] == [5, 6, 9]


def scenario_multiple_replicas_and_composition(s):
    serve = s.serve

    @serve.deployment(num_replicas=3)
    class WhoAmI:
        def __init__(self):
            self.id = id(self)

        def __call__(self, _):
            return self.id

    @serve.deployment
    class Preprocess:
        def __call__(self, x):
            return x * 2

    @serve.deployment
    class Model:
        def __init__(self, pre):
            self.pre = pre

        def __call__(self, x):
            return self.pre.remote(x).result() + 1

    h = serve.run(WhoAmI.bind(), route_prefix=None)
    seen = {h.remote(None).result() for _ in range(30)}
    comp = serve.run(Model.bind(Preprocess.bind()), route_prefix=None)
    return {
        "spread": len(seen) >= 2,
        "composed": comp.remote(10).result(),
        "by_name": serve.get_deployment_handle("Preprocess").remote(3).result(),
        "status": {k: v for k, v in serve.status()["deployments"].items()},
    }


def test_multi_replica_routing_and_composition():
    out = _both(scenario_multiple_replicas_and_composition)
    assert out["spread"] and out["composed"] == 21 and out["by_name"] == 6
    assert out["status"]["WhoAmI"]["num_replicas"] == 3


def scenario_batching_and_multiplexing(s):
    serve = s.serve
    batch_sizes, loads = [], []

    @serve.deployment
    class BatchedModel:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.1)
        def handle_batch(self, items):
            batch_sizes.append(len(items))
            return [i * 10 for i in items]

        def __call__(self, x):
            return self.handle_batch(x)

    @serve.deployment
    class MultiModel:
        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id):
            loads.append(model_id)
            return lambda x: f"{model_id}:{x}"

        def __call__(self, payload):
            return self.get_model(payload["model"])(payload["x"])

        def current(self, _):
            return serve.get_multiplexed_model_id()

    h = serve.run(BatchedModel.bind(), route_prefix=None)
    responses = [h.remote(i) for i in range(8)]
    out = {"batched": sorted(r.result() for r in responses), "batched_at_all": max(batch_sizes) > 1}
    h = serve.run(MultiModel.bind(), route_prefix=None)
    out["multiplexed"] = [h.remote({"model": m, "x": i}).result()
                          for i, m in enumerate("aabca")]
    out["loads"] = list(loads)
    out["model_id_outside_a_request"] = h.current.remote(None).result()

    @serve.batch(max_batch_size=2)
    def bad(items):
        return items[:1]

    try:
        out["bad_batch"] = [bad(1), bad(2)]
    except Exception as exc:  # noqa: BLE001 — the error is the output
        out["bad_batch"] = _error(exc)
    try:
        bad(1, extra=2)
    except Exception as exc:  # noqa: BLE001
        out["bad_kwargs"] = _error(exc)
    return out


def test_batching_and_multiplexing():
    out = _both(scenario_batching_and_multiplexing)
    assert out["batched"] == [i * 10 for i in range(8)] and out["batched_at_all"]
    assert out["loads"] == ["a", "b", "c", "a"]


def scenario_reconfigure_upgrade_and_topology(s):
    serve = s.serve

    @serve.deployment(user_config={"threshold": 5})
    class Configurable:
        def __init__(self):
            self.threshold = 0

        def reconfigure(self, config):
            self.threshold = config["threshold"]

        def __call__(self, _):
            return (self.threshold, serve.get_replica_context().deployment)

    @serve.deployment
    def v(x):
        return "v1"

    @serve.deployment(name="v")
    def v2(x):
        return "v2"

    @serve.deployment
    class Embed:
        def __call__(self, x):
            return x * 2

    @serve.deployment
    class Rank:
        def __init__(self, embed):
            self.embed = embed

        def __call__(self, x):
            return self.embed.remote(x).result() + 1

    out = {"reconfigured": serve.run(Configurable.bind(), route_prefix=None).remote(None).result()}
    serve.run(v.bind(), route_prefix=None)
    h = serve.run(v2.bind(), route_prefix=None)
    out["upgraded"] = h.remote(None).result()
    h = serve.run(Rank.bind(Embed.bind()), name="pipeline", route_prefix=None)
    out["pipeline"] = h.remote(3).result()
    out["topology"] = serve.status()["applications"]["pipeline"]
    out["app_handle"] = serve.get_app_handle("pipeline").remote(4).result()
    try:
        serve.get_app_handle("nope")
    except KeyError as exc:
        out["missing_app"] = str(exc)
    try:
        serve.get_replica_context()
    except RuntimeError as exc:
        out["no_context"] = str(exc)
    try:
        serve.ingress(None)
    except ImportError as exc:
        out["ingress"] = str(exc)
    serve.delete("Embed")
    out["after_delete"] = sorted(serve.status()["applications"])
    return out


def test_reconfigure_upgrade_and_topology():
    out = _both(scenario_reconfigure_upgrade_and_topology)
    assert out["reconfigured"] == (5, "Configurable") and out["upgraded"] == "v2"
    assert out["topology"]["ingress"] == "Rank" and out["pipeline"] == 7


def scenario_autoscaling(s):
    serve = s.serve

    @serve.deployment(
        autoscaling_config={"min_replicas": 1, "max_replicas": 3,
                            "target_ongoing_requests": 1, "upscale_delay_s": 0.0},
        max_ongoing_requests=16,
    )
    class Slow:
        def __call__(self, _):
            time.sleep(0.3)
            return 1

    handle = serve.run(Slow.bind(), route_prefix=None)
    results = []

    def worker():
        for _ in range(3):
            results.append(handle.remote(None).result())

    threads = [threading.Thread(target=worker) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    st = serve.status()["deployments"]["Slow"]
    auto = serve.deployment(num_replicas="auto")(lambda: 0).autoscaling_config
    return {"n": len(results), "scaled": st["num_replicas"] >= 2,
            "auto_default": dataclasses.asdict(auto)}


def test_autoscaling_scales_up():
    out = _both(scenario_autoscaling)
    assert out["n"] == 18 and out["scaled"]


# --------------------------------------------------------------------------
# HTTP and gRPC ingress
# --------------------------------------------------------------------------
def scenario_http_ingress(s):
    serve = s.serve

    @serve.deployment
    def echo(payload):
        return {"got": payload, "array": np.arange(3, dtype=np.float32)}

    @serve.deployment
    def who(_x):
        ctx = _pkg(s.name + ".runtime.context")
        return {"tenant": ctx.current_tenant()}

    serve.run(echo.bind(), name="echo", route_prefix="/echo")
    serve.run(who.bind(), name="who", route_prefix="/who")
    url = serve.proxy_url()
    out = {}
    status, headers, body = _http(url + "/echo?x=1", {"a": 1})
    out["echo"] = (status, headers["Content-Type"], json.loads(body))
    status, _h, body = _http(url + "/echo/sub", None)
    out["get"] = (status, json.loads(body))
    status, _h, body = _http(url + "/nonexistent-route-xyz")
    out["missing"] = (status, body)
    status, _h, body = _http(url + "/who", {"x": 1},
                             headers={"X-Tenant-Id": "team-42"})
    out["tenant"] = (status, json.loads(body))
    return out


def test_http_ingress_routes_404_and_tenant_header():
    out = _both(scenario_http_ingress)
    assert out["echo"][0] == 200 and out["echo"][2]["got"] == {"a": 1}
    assert out["missing"][0] == 404 and out["tenant"][1] == {"tenant": "team-42"}


def test_jsonify_renders_tensors_as_the_jax_package_renders_arrays():
    """The proxy's JSON of a tensor (bfloat16 too) is the JAX package's JSON
    of the numpy array of the same values."""
    import ml_dtypes

    from ray_tpu.serve.proxy import _jsonify as jax_jsonify
    from ray_tpu_torch.serve.proxy import _jsonify

    vals = [1.1, 2.7, -3.14159, 1e-3]
    for tdt, ndt in ((torch.float32, np.float32), (torch.bfloat16, ml_dtypes.bfloat16),
                     (torch.int32, np.int32)):
        t = torch.tensor(vals).to(tdt)
        a = np.asarray(vals).astype(ndt)
        got = json.dumps({"x": t, "s": t[0], "m": t.reshape(2, 2)}, default=_jsonify)
        want = json.dumps({"x": a, "s": a[0], "m": a.reshape(2, 2)}, default=jax_jsonify)
        assert got == want
    assert json.dumps(torch.ones(2, requires_grad=True), default=_jsonify) == "[1.0, 1.0]"


def scenario_grpc_ingress(s):
    import grpc

    serve = s.serve
    serve.start(grpc_port=0)

    @serve.deployment
    def double(x):
        return {"doubled": x["v"] * 2}

    @serve.deployment
    def overloaded(_x):
        raise s.exc.OverloadedError("engine", "queue_full", 2.0)

    serve.run(double.bind(), name="default", route_prefix=None)
    serve.run(overloaded.bind(), name="hot", route_prefix=None)
    channel = grpc.insecure_channel(serve.grpc_address())
    out = {}
    try:
        svc = "/ray_tpu.serve.Serve/"
        predict = channel.unary_unary(svc + "Predict")
        out["predict"] = json.loads(predict(json.dumps({"v": 21}).encode(), timeout=30))
        out["apps"] = json.loads(channel.unary_unary(svc + "ListApplications")(b"", timeout=30))
        out["health"] = channel.unary_unary(svc + "Healthz")(b"", timeout=30)
        for name, md in (("shed", (("application", "hot"),)),
                         ("missing", (("application", "nope"),)),
                         ("pickle", (("payload-codec", "pickle"),))):
            try:
                predict(b"{}", metadata=md, timeout=30)
            except grpc.RpcError as exc:
                out[name] = (exc.code().name, exc.details())
    finally:
        channel.close()
    return out


def test_grpc_ingress_and_overload_status():
    pytest.importorskip("grpc")
    out = _both(scenario_grpc_ingress)
    assert out["predict"] == {"doubled": 42} and out["health"] == b"success"
    assert out["shed"][0] == "RESOURCE_EXHAUSTED" and "retry_after_s=2" in out["shed"][1]


# --------------------------------------------------------------------------
# declarative config (serve/schema.py)
# --------------------------------------------------------------------------
def _config_app_fn(x):
    return {"doubled": x * 2}


def __getattr__(name):
    """``config_app_<package>``: the bound app a config's ``import_path``
    names, one for each package's ``serve``."""
    if name.startswith("config_app_"):
        serve = _pkg(name[len("config_app_"):] + ".serve")
        return serve.deployment(_config_app_fn).bind()
    raise AttributeError(name)


def scenario_run_config(s, yaml_path):
    serve = s.serve
    schema = _pkg(s.name + ".serve.schema")
    import_path = f"{__name__}:config_app_{s.name}"
    cfg = {"applications": [{
        "name": "cfg_app", "route_prefix": "/cfg", "import_path": import_path,
        "deployments": [{"name": "_config_app_fn", "num_replicas": 2,
                         "max_ongoing_requests": 7}],
    }]}
    out = {"deployed": serve.run_config(cfg)}
    handle = serve.get_deployment_handle("_config_app_fn")
    out["call"] = handle.remote(21).result()
    out["status"] = serve.status()["deployments"]["_config_app_fn"]
    out["http"] = json.loads(_http(serve.proxy_url() + "/cfg", 4)[2])
    with open(yaml_path, "w") as f:
        f.write(f"applications:\n  - name: yaml_app\n    route_prefix: /yaml\n"
                f"    import_path: {import_path}\n")
    out["yaml"] = serve.run_config(yaml_path)
    # the redeploy replaced the replicas; membership reaches the shared
    # router by its long poll, so wait for it rather than race it
    handle = serve.get_deployment_handle("_config_app_fn")
    controller = s.api._controller
    out["caught_up"] = _wait(lambda: handle._router._version == s.rt.get(
        controller.get_replicas.remote("_config_app_fn"))[0], timeout=10)
    out["yaml_call"] = handle.remote(3).result()
    bad = [
        {},
        {"applications": [{"name": "x"}]},
        {"applications": [{"name": "a", "import_path": "m:a", "route_prefix": "nope"}]},
        {"applications": [{"name": "a", "import_path": "m:a"},
                          {"name": "a", "import_path": "m:b"}]},
        {"applications": [{"import_path": "m:a", "deployments": [{"name": "d", "bogus": 1}]}]},
        {"applications": [{"import_path": "no_colon"}]},
        {"applications": [{"import_path": import_path,
                           "deployments": [{"name": "Other", "num_replicas": 1}]}]},
        {"applications": [{"import_path": f"{__name__}:PACKAGES"}]},
    ]
    errors = []
    for b in bad:
        try:
            serve.run_config(b)
            errors.append(None)
        except schema.ServeConfigError as exc:
            errors.append(("ServeConfigError", str(exc), isinstance(exc, ValueError)))
    out["bad"] = errors
    return out


def test_run_config_dict_yaml_and_bad_configs(tmp_path):
    out = _both(scenario_run_config, str(tmp_path / "serve.yaml"))
    assert out["deployed"]["cfg_app"]["ingress"] == "_config_app_fn"
    assert out["call"] == {"doubled": 42} and out["status"]["target_replicas"] == 2
    assert out["yaml_call"] == {"doubled": 6} and None not in out["bad"]


def test_yaml_config_without_pyyaml_raises_the_reference_import_error(tmp_path, monkeypatch):
    """``load_config_file`` imports PyYAML inside, as the JAX package does:
    without it a YAML path raises the same ImportError, and nothing else
    needs it."""
    import sys

    from ray_tpu.serve import schema as jschema
    from ray_tpu_torch.serve import schema as tschema

    path = tmp_path / "s.yaml"
    path.write_text("applications: []\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    errors = []
    for mod in (jschema, tschema):
        with pytest.raises(ImportError) as exc:
            mod.load_config_file(str(path))
        errors.append(str(exc.value))
        assert mod.validate_config({"applications": [{"import_path": "m:a"}]})
    assert errors[0] == errors[1]


# --------------------------------------------------------------------------
# membership: long poll, health checks, failover
# --------------------------------------------------------------------------
def scenario_long_poll(s):
    serve = s.serve

    @serve.deployment(num_replicas=1)
    class Scaled:
        def __call__(self, x):
            return x

    handle = serve.run(Scaled.bind(), route_prefix=None)
    first = handle.remote(1).result()
    router = handle._router
    v0 = router._version
    serve.run(Scaled.options(num_replicas=3).bind(), route_prefix=None)
    grown = _wait(lambda: len(router._replicas) == 3, timeout=10)
    return {"first": first, "grown": grown, "moved": router._version != v0}


def test_long_poll_pushes_membership():
    out = _both(scenario_long_poll)
    assert out == {"first": 1, "grown": True, "moved": True}


def scenario_health_check_replacement(s):
    serve, rt = s.serve, s.rt

    @serve.deployment(num_replicas=2)
    class Svc:
        def __call__(self, x):
            return x + 1

    handle = serve.run(Svc.bind(), route_prefix=None)
    first = handle.remote(1).result()
    controller = s.api._controller
    _v, replicas = rt.get(controller.get_replicas.remote("Svc"))
    rt.kill(replicas[0])

    def healed():
        _v2, reps = rt.get(controller.get_replicas.remote("Svc"))
        return len(reps) == 2 and replicas[0] not in reps

    out = {"first": first, "healed": _wait(healed, timeout=15)}
    # the replacement reaches the handle's router by its long poll: until
    # then the router may still pick the killed replica (not idempotent:
    # no replay), so wait for it as a caller that must not fail would
    out["caught_up"] = _wait(lambda: handle._router._version == rt.get(
        controller.get_replicas.remote("Svc"))[0], timeout=10)
    out["after"] = [handle.remote(i).result() for i in range(6)]
    return out


def test_dead_replica_replaced_by_health_check():
    out = _both(scenario_health_check_replacement)
    assert out["healed"] and out["after"] == [i + 1 for i in range(6)]


def scenario_failover(s):
    serve, rt = s.serve, s.rt

    @serve.deployment(num_replicas=2, idempotent=True)
    class Svc:
        def __call__(self, x):
            return x * 10

    @serve.deployment(num_replicas=1, idempotent=True)
    class Solo:
        def __call__(self, x):
            return x + 100

    @serve.deployment(num_replicas=1)
    class Once:
        def __call__(self, x):
            return x + 100

    controller = s.api._controller
    out = {}
    handle = serve.run(Svc.bind(), route_prefix=None)
    out["svc"] = handle.remote(1).result()
    _v, replicas = rt.get(controller.get_replicas.remote("Svc"))
    rt.kill(replicas[0])  # and hammer at once: no wait for the health check
    out["svc_failover"] = [handle.remote(i).result(timeout=60) for i in range(12)]
    solo = serve.run(Solo.bind(), route_prefix=None)
    out["solo"] = solo.remote(1).result()
    _v, replicas = rt.get(controller.get_replicas.remote("Solo"))
    rt.kill(replicas[0])
    out["solo_failover"] = solo.remote(7).result(timeout=60)
    once = serve.run(Once.bind(), route_prefix=None)
    out["once"] = once.remote(1).result(timeout=30)
    _v, replicas = rt.get(controller.get_replicas.remote("Once"))
    rt.kill(replicas[0])
    try:
        out["never_replays"] = once.remote(7).result(timeout=30)
    except s.exc.RayActorError as exc:
        out["never_replays"] = type(exc).__name__
    return out


def test_requests_fail_over_only_for_idempotent_deployments():
    out = _both(scenario_failover)
    assert out["svc_failover"] == [i * 10 for i in range(12)]
    assert out["solo_failover"] == 107 and out["never_replays"] == "ActorDiedError"


# --------------------------------------------------------------------------
# admission: router queue bound, replica backstop, proxy status mapping
# --------------------------------------------------------------------------
def scenario_router_queue_bound(s):
    serve = s.serve
    release = threading.Event()

    @serve.deployment(num_replicas=1, max_ongoing_requests=1, max_queued_requests=1)
    class Gate:
        def __call__(self, x):
            release.wait(30)
            return x

    handle = serve.run(Gate.bind(), route_prefix="/gate")
    results = []
    threads = [threading.Thread(target=lambda i=i: results.append(handle.remote(i).result(timeout=30)),
                                daemon=True) for i in range(2)]
    for t in threads:
        t.start()
    out = {"queued": _wait(lambda: handle._router._queue_waiters >= 1, timeout=10)}
    try:
        handle.remote(99).result(timeout=10)
    except s.exc.OverloadedError as exc:
        out["shed"] = (type(exc).__name__, exc.layer, exc.reason, exc.retry_after_s > 0)
    status, headers, body = _http(serve.proxy_url() + "/gate", 5)
    out["http"] = (status, "Retry-After" in headers, json.loads(body)["type"])
    release.set()
    for t in threads:
        t.join(timeout=30)
    out["results"] = sorted(results)
    out["recovered"] = handle.remote(7).result(timeout=30)
    meta = s.rt.get(s.api._controller.get_deployment_meta.remote("Gate"))
    out["meta"] = meta
    return out


def test_router_queue_bound_sheds_typed_and_as_429():
    out = _both(scenario_router_queue_bound)
    assert out["shed"][:3] == ("OverloadedError", "router", "queue_full")
    assert out["http"] == (429, True, "OverloadedError")
    assert out["results"] == [0, 1] and out["recovered"] == 7


def scenario_replica_backstop(s):
    rt = s.rt
    ReplicaActor = _pkg(s.name + ".serve.replica").ReplicaActor
    admission = _pkg(s.name + ".runtime.admission")
    release = threading.Event()

    def slow(x):
        release.wait(30)
        return x

    replica = ReplicaActor.options(execution="inproc", max_concurrency=4).remote(
        slow, (), {}, None, True, max_ongoing_requests=1,
    )
    first = replica.handle_request.remote("__call__", (1,), {})
    time.sleep(0.2)
    out = {}
    try:
        rt.get(replica.handle_request.remote("__call__", (2,), {}))
    except Exception as raw:  # noqa: BLE001 — the typed cause is the output
        cause = admission.unwrap(raw)
        out["shed"] = (type(cause).__name__, cause.layer, cause.reason, str(cause))
    release.set()
    out["first"] = rt.get(first, timeout=30)
    out["metrics"] = rt.get(replica.get_metrics.remote())
    out["health"] = rt.get(replica.check_health.remote())
    return out


def test_replica_backstop_sheds_past_max_ongoing():
    out = _both(scenario_replica_backstop)
    assert out["shed"][:2] == ("OverloadedError", "replica") and out["first"] == 1


def scenario_proxy_status_mappings(s):
    serve, exc = s.serve, s.exc

    @serve.deployment
    def overloaded(_x):
        raise exc.OverloadedError("engine", "queue_full", 3.0)

    @serve.deployment
    def too_late(_x):
        raise exc.DeadlineExceededError("req", "executing", 1.0)

    @serve.deployment
    def dead_actor(_x):
        raise exc.ActorDiedError(None, "replica died after retry budget")

    @serve.deployment
    def boom(_x):
        raise ValueError("application bug")

    @serve.deployment
    def glacial(_x):
        time.sleep(2)
        return "done"

    for fn, route in ((overloaded, "overloaded"), (too_late, "late"), (dead_actor, "dead"),
                      (boom, "boom"), (glacial, "slow")):
        serve.run(fn.bind(), name=route, route_prefix="/" + route)
    s.api._proxy.request_timeout_s = 0.3
    out = {}
    for route in ("overloaded", "late", "dead", "boom", "slow"):
        status, headers, body = _http(serve.proxy_url() + "/" + route, {"x": 1})
        out[route] = (status, headers.get("Retry-After"), json.loads(body))
    handle = serve.get_app_handle("overloaded")
    try:
        handle.remote(1).result()
    except exc.OverloadedError as e:
        out["handle"] = (type(e).__name__, e.retry_after_s)
    return out


def test_proxy_maps_errors_to_status_codes():
    out = _both(scenario_proxy_status_mappings)
    assert [out[r][0] for r in ("overloaded", "late", "dead", "boom", "slow")] == [
        429, 504, 503, 500, 504]
    assert out["overloaded"][1] == "3" and out["handle"] == ("OverloadedError", 3.0)


# --------------------------------------------------------------------------
# device seam: a replica that asks for the card
# --------------------------------------------------------------------------
def test_gpu_replica_without_a_card_is_infeasible_as_a_tpu_replica_is():
    """A ``num_gpus`` replica on a node without a GPU never runs (it is not
    moved to the CPU): its requests wait exactly as a ``num_tpus`` replica's
    do on a node without chips in the JAX package."""
    built = []

    def scenario(s):
        serve = s.serve
        resource = "num_gpus" if s.torch else "num_tpus"

        @serve.deployment(ray_actor_options={resource: 1})
        class Card:
            def __init__(self):
                built.append(s.name)

            def __call__(self, x):
                return x

        handle = serve.run(Card.bind(), route_prefix=None)
        try:
            handle.remote(1).result(timeout=1.0)
            return "served"
        except Exception as exc:  # noqa: BLE001 — the typed error is the output
            return _error(exc)

    out = _both(scenario, num_cpus=4, system_config={"infeasible_task_timeout_s": 0.5})
    assert out["type"] == "GetTimeoutError" and built == []


def test_engine_replica_with_no_device_and_no_cuda_raises():
    """No fallback: an ``LLMServer`` given no ``device`` on a box without
    CUDA raises, so its replica dies in construction and the caller gets
    the typed actor error, never tokens computed on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA: a replica with no device runs on it")
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import LLMServer

    tp = params_from_numpy(jax.tree.map(np.asarray, jax_init_params(JCFG, jax.random.key(11))))
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        LLMServer(lambda: (CFG, tp))
    rt.init(num_cpus=4)
    try:
        serve.start(http_port=0)
        handle = serve.run(serve.deployment(LLMServer).bind(lambda: (CFG, tp)),
                           route_prefix=None)
        # the call either queued behind the failed constructor (its error)
        # or arrived after the replica died (the actor error)
        with pytest.raises((rt.RayActorError, rt.RayTaskError)) as exc:
            handle.remote({"prompt": [3, 1, 4], "max_tokens": 2}).result(timeout=30)
        if isinstance(exc.value, rt.RayTaskError):
            assert "no CUDA device is available" in str(exc.value)
    finally:
        serve.shutdown()
        rt.shutdown()


# --------------------------------------------------------------------------
# LLMServer deployments (tests/test_serve_llm.py)
# --------------------------------------------------------------------------
def scenario_llm_deployment(s):
    serve = s.serve
    handle = serve.run(s.llm_app(max_batch_size=4, max_seq_len=64), route_prefix="/llm")
    reqs = [{"prompt": [3, 1, 4], "max_tokens": 5}, {"prompt": [2, 7], "max_tokens": 3},
            {"prompt": PROMPT, "max_tokens": 6}]
    resps = [handle.remote(r) for r in reqs]
    out = {"handle": [{k: v for k, v in r.result(timeout=120).items() if k != "latency_s"}
                      for r in resps]}
    status, headers, body = _http(serve.proxy_url() + "/llm",
                                  {"prompt": [3, 1, 4], "max_tokens": 5, "stream": True})
    out["sse"] = (status, headers["Content-Type"], _sse(body))
    status, _h, body = _http(serve.proxy_url() + "/llm",
                             {"prompt": [1, 2, 3], "max_tokens": 500, "stream": True})
    out["invalid"] = (status, json.loads(body))
    status, _h, body = _http(serve.proxy_url() + "/llm", {"prompt": [5, 6], "max_tokens": 2})
    out["http"] = (status, {k: v for k, v in json.loads(body).items() if k != "latency_s"})
    out["stats_keys"] = sorted(handle.stats.remote().result())
    return out


def test_llm_server_deployment_tokens_equal_jax(params):
    out = _both(scenario_llm_deployment, params=params)
    jp = params[0]
    assert [r["tokens"] for r in out["handle"]] == [
        _reference(jp, [3, 1, 4], 5), _reference(jp, [2, 7], 3), _reference(jp, PROMPT, 6)]
    status, ctype, events = out["sse"]
    assert status == 200 and ctype == "text/event-stream"
    assert [e["token"] for e in events if "token" in e] == _reference(jp, [3, 1, 4], 5)
    assert events[-1] == {"done": True, "num_generated": 5}
    assert out["invalid"][0] == 500 and out["invalid"][1]["type"] == "ValueError"


def scenario_openai_over_http(s):
    serve = s.serve
    serve.run(s.llm_app("OpenAICompatLLMServer", tokenizer=_Tok(), max_batch_size=2,
                        max_seq_len=64), route_prefix="/v1")
    url = serve.proxy_url()
    status, _h, body = _http(url + "/v1/completions",
                             {"model": "m", "prompt": "ab", "max_tokens": 4, "temperature": 0})
    resp = json.loads(body)
    out = {"completion": (status, {k: v for k, v in resp.items() if k not in ("id", "created")})}
    status, headers, body = _http(url + "/v1/chat/completions", {
        "model": "m", "messages": [{"role": "user", "content": "yo"}],
        "max_tokens": 4, "temperature": 0, "stream": True})
    chunks = [{k: v for k, v in c.items() if k not in ("id", "created")} for c in _sse(body)]
    out["chat_stream"] = (status, headers["Content-Type"], chunks)
    status, _h, body = _http(url + "/v1/completions",
                             {"model": "m", "prompt": "ab", "max_tokens": 4, "logprobs": 2})
    out["rejected"] = (status, json.loads(body))
    return out


def test_openai_server_over_http(params):
    out = _both(scenario_openai_over_http, params=params)
    status, resp = out["completion"]
    assert status == 200 and resp["object"] == "text_completion"
    assert resp["choices"][0]["token_ids"] == _reference(params[0], _Tok().encode("ab"), 4)
    assert out["chat_stream"][2][-1]["choices"][0]["finish_reason"] == "length"


def scenario_trace_from_the_proxy(s):
    """The proxy starts each request's trace; the replica re-installs it
    and the engine stamps it (the server starts none of its own)."""
    serve = s.serve
    reqtrace = _pkg(s.name + ".observability.reqtrace")
    serve.run(s.llm_app(max_batch_size=2, max_seq_len=64), route_prefix="/llm")
    store = reqtrace.global_trace_store()
    store.reset()
    _http(serve.proxy_url() + "/llm", {"prompt": [3, 1, 4], "max_tokens": 4},
          headers={"Content-Type": "application/json", "X-Tenant-Id": "acme"})
    _http(serve.proxy_url() + "/llm", {"prompt": [2, 7, 9], "max_tokens": 4, "stream": True})
    _http(serve.proxy_url() + "/llm", {})
    out = []
    for d in reversed(store.snapshot(limit=10)["recent"]):
        out.append({"outcome": d["outcome"], "deployment": d["deployment"],
                    "route": d["route"], "tenant": d["tenant"], "tokens": d["tokens"],
                    "marks": [n for n, _ in d["marks"]],
                    "phases": [p["phase"] for p in d["phases"]]})
    store.reset()
    return out


def test_request_trace_is_born_at_the_proxy(params):
    out = _both(scenario_trace_from_the_proxy, params=params)
    assert [t["outcome"] for t in out] == ["ok", "ok", "error"]
    assert out[0]["tenant"] == "acme" and out[0]["deployment"] == "LLMServer"
    assert out[0]["phases"] == ["proxy", "router_queue", "dispatch", "replica",
                                "engine_queue", "kv_block_wait", "prefill", "decode"]


# --------------------------------------------------------------------------
# disaggregated deployments: DisaggDispatcher (tests/test_disagg.py)
# --------------------------------------------------------------------------
def _audits(s, start=0):
    return [dict(a) for a in list(s.cluster().kv_migration_audits)[start:]]


def _settled(handle):
    """The handle with its router's membership and roles pulled now. A
    fresh router learns a deployment's roles by its first pull; until then
    (in both packages) a request may route to one replica as if co-located."""
    handle._router._refresh(force=True)
    return handle


def scenario_disagg_end_to_end(s):
    serve = s.serve
    out = {}
    for name, roles, kw in (("BadRoles", {"prefill": 1}, {}),
                            ("BadKind", {"prefill": 1, "decode": 1}, {"cache_kind": "dense"})):
        try:
            serve.run(s.llm_app(deployment_kw={"name": name, "roles": roles}, **kw),
                      route_prefix=None)
        except Exception as exc:  # noqa: BLE001 — the typed error is the output
            out[name] = _error(exc)
    co = serve.run(s.llm_app(deployment_kw={"name": "Colocated"}, max_batch_size=4,
                             max_seq_len=64), route_prefix=None)
    handle = _settled(serve.run(s.llm_app(deployment_kw={"roles": {"prefill": 1, "decode": 1}},
                                          max_batch_size=4, max_seq_len=64),
                                route_prefix="/split"))
    out["colocated"] = co.remote({"prompt": PROMPT, "max_tokens": 6}).result(timeout=120)["tokens"]
    r = handle.remote({"prompt": PROMPT, "max_tokens": 6}).result(timeout=120)
    out["split"] = {k: v for k, v in r.items() if k != "latency_s"}
    events = list(handle.remote({"prompt": PROMPT, "max_tokens": 6, "stream": True})
                  .result(timeout=120))
    out["stream"] = events
    out["warm"] = handle.remote({"prompt": PROMPT, "max_tokens": 6}).result(timeout=120)["tokens"]
    status, _h, body = _http(serve.proxy_url() + "/split",
                             {"prompt": PROMPT[:9], "max_tokens": 4, "stream": True})
    out["http"] = (status, _sse(body))
    out["audits"] = _audits(s)
    out["dispatcher"] = handle._router.disagg_snapshot()
    # the decode pool's free-page fraction appears once the controller's
    # one-second probe has run: timing, not parity
    out["pools"] = {d: {r: {k: v for k, v in row.items() if k != "kv_free_frac"}
                        for r, row in pools.items()}
                    for d, pools in s.cluster().overload_snapshot()["serve_pools"].items()}
    ctl = s.api._controller
    out["meta"] = s.rt.get(ctl.get_deployment_meta.remote("LLMServer"))
    out["stats_via_method"] = sorted(handle.stats.remote().result(timeout=60))
    return out


def test_disagg_dispatcher_equals_colocated_and_jax(params):
    out = _both(scenario_disagg_end_to_end, params=params)
    ref = _reference(params[0], PROMPT, 6)
    assert out["colocated"] == ref and out["split"]["tokens"] == ref and out["warm"] == ref
    assert [e["token"] for e in out["stream"] if "token" in e] == ref
    assert "at least one 'decode'" in out["BadRoles"]["cause"][1]
    staged = [a["mig_id"] for a in out["audits"] if a["event"] == "staged"]
    assert staged == ["LLMServer/m1", "LLMServer/m2", "LLMServer/m3", "LLMServer/m4"]
    assert all(a["outcome"] == "adopted" for a in out["audits"] if a["event"] == "released")
    assert out["dispatcher"]["migrations"]["host"] == 4
    assert set(out["pools"]["LLMServer"]) == {"prefill", "decode"}


def scenario_disagg_ladder(s, seed):
    """Sequential requests under ``disagg.decode_call=raise(0.4)``: each
    route attempt consumes one failpoint decision, so the same seed gives
    the same fault log, the same re-prefill ids and the same typed
    failures in both packages."""
    serve, fp = s.serve, s.failpoints
    handle = _settled(serve.run(s.llm_app(deployment_kw={"roles": {"prefill": 1, "decode": 1}},
                                          max_batch_size=4, max_seq_len=64), route_prefix=None))
    disagg = _pkg(s.name + ".serve.disagg")
    fp.reset()
    fp.arm("disagg.decode_call=raise(0.4)", seed=seed)
    results = []
    for i in range(6):
        p = PROMPT + [i + 1]
        try:
            results.append(handle.remote({"prompt": p, "max_tokens": 3}).result(timeout=60)["tokens"])
        except disagg.KVMigrationError as exc:
            results.append(("KVMigrationError", exc.mig_id, exc.stage))
    out = {"results": results, "faults": fp.fault_log(),
           "audits": _audits(s), "dispatcher": handle._router.disagg_snapshot()}
    fp.reset()
    return out


def test_disagg_reprefill_ladder_under_failpoint(params):
    out = _both(scenario_disagg_ladder, 7, params=params)
    jp = params[0]
    assert out["faults"] and all(f["fp"] == "disagg.decode_call" for f in out["faults"])
    for i, r in enumerate(out["results"]):
        if isinstance(r, list):
            assert r == _reference(jp, PROMPT + [i + 1], 3)
    outcomes = [a.get("outcome") for a in out["audits"] if a["event"] == "released"]
    assert "reprefill" in outcomes
    assert any("#a1" in a["mig_id"] for a in out["audits"])


def scenario_decode_replica_kill(s):
    serve = s.serve
    handle = _settled(serve.run(s.llm_app(deployment_kw={"roles": {"prefill": 1, "decode": 2}},
                                          max_batch_size=4, max_seq_len=64), route_prefix=None))
    ctl = s.api._controller
    first = handle.remote({"prompt": PROMPT, "max_tokens": 4}).result(timeout=120)["tokens"]
    killed = s.rt.get(ctl.chaos_kill_replica.remote("LLMServer", role="decode", index=0))
    missing = s.rt.get(ctl.chaos_kill_replica.remote("LLMServer", role="decode", index=5))
    healed = _wait(lambda: s.rt.get(ctl.pool_status.remote())["LLMServer"]["decode"]["replicas"] == 2,
                   timeout=30)
    _settled(handle)  # the replacement's membership, before the next requests
    after = []
    for i in range(3):
        try:
            after.append(handle.remote({"prompt": PROMPT + [i + 1], "max_tokens": 3})
                         .result(timeout=60)["tokens"])
        except Exception as exc:  # noqa: BLE001 — a typed failure is an output
            after.append(type(exc).__name__)
    released = [a for a in _audits(s) if a["event"] == "released"]
    return {"first": first, "killed": killed, "missing": missing, "healed": healed,
            "after": after, "terminals": sorted(a["outcome"] for a in released),
            "pools": {r: {k: v for k, v in row.items() if k != "kv_free_frac"}
                      for r, row in s.rt.get(ctl.pool_status.remote())["LLMServer"].items()}}


def test_chaos_kill_of_a_decode_replica(params):
    out = _both(scenario_decode_replica_kill, params=params)
    jp = params[0]
    assert out["killed"] is True and out["missing"] is False and out["healed"]
    assert out["after"] == [_reference(jp, PROMPT + [i + 1], 3) for i in range(3)]


def test_shutdown_leaves_no_serve_thread():
    """After ``serve.shutdown()`` and the runtime's ``shutdown()`` no
    ``serve-*`` thread of the port is left: the proxy, the control loop,
    each router's long-poll watcher and (once its replica is gone) the
    batch queue's thread."""
    import gc

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    before = set(threading.enumerate())  # the JAX package's stragglers, if any

    def serve_threads():
        return sorted(t.name for t in threading.enumerate()
                      if t.name.startswith("serve-") and t not in before)

    rt.init(num_cpus=4)
    try:
        serve.start(http_port=0)

        @serve.deployment(num_replicas=2)
        class Batched:
            @serve.batch(max_batch_size=2, batch_wait_timeout_s=0.01)
            def many(self, items):
                return [i + 1 for i in items]

            def __call__(self, x):
                return self.many(x)

        handle = serve.run(Batched.bind(), route_prefix="/b")
        assert [handle.remote(i).result() for i in range(4)] == [1, 2, 3, 4]
        assert _http(serve.proxy_url() + "/b", 5)[2] == b"6"
        running = serve_threads()
        assert {"serve-proxy", "serve-reconcile", "serve-watch-Batched",
                "serve-batch"} <= set(running)
    finally:
        serve.shutdown()
        rt.shutdown()
    del handle
    gc.collect()
    assert _wait(lambda: serve_threads() == [], timeout=5), serve_threads()
