"""Batch LLM inference through the port's data library against the JAX
package's: ``LLMPredictor`` under ``map_batches`` (the cases of
``tests/test_serve_llm.py::test_data_batch_inference`` and
``test_llm_predictor_cache_respects_kwargs``) on a tiny f32 decoder whose
weights come from the JAX ``init_params`` through ``ray_tpu_torch.convert``;
the port's engines run on the CPU (``device="cpu"``), and greedy tokens
must be identical.

The JAX package's map builds its engine in a process worker that imports
JAX, which is slow, so tier-1 holds the port's map against the JAX
``LLMPredictor.__call__`` called directly on the same batch; the map
through both packages runs in the slow tier (``full``). A stage given
``num_gpus`` makes in-process GPU actors (declared with ``init(num_gpus=1)``
here); without it the port's actor is a process actor that receives the
factory by value.
"""

import importlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from ray_tpu.models import init_params as jax_init_params  # noqa: E402
from ray_tpu_torch.convert import params_from_numpy  # noqa: E402
from ray_tpu_torch.models.transformer import TransformerConfig  # noqa: E402

SMALL = dict(vocab_size=89, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64)
JCFG = JaxConfig(**SMALL, attention="dense", dtype=jnp.float32)
CFG = TransformerConfig(**SMALL, attention="dense", dtype=torch.float32)
PROMPTS = [[3, 1], [4, 1, 5], [9, 2], [6, 5, 3, 5], [7, 7, 7, 1, 2], [8], [2, 4, 6, 8], [5, 3]]
ENGINE_KW = {"max_batch_size": 4, "max_seq_len": 32}


@pytest.fixture(scope="module")
def weights():
    jp = jax_init_params(JCFG, jax.random.key(11))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _engine_threads():
    return [t for t in threading.enumerate() if t.name == "llm-engine" and t.is_alive()]


@pytest.fixture(autouse=True)
def _nothing_left():
    yield
    from ray_tpu.data.llm_inference import clear_engine_cache as jax_clear
    from ray_tpu_torch.data.llm_inference import clear_engine_cache

    jax_clear()
    clear_engine_cache()
    for name in ("ray_tpu", "ray_tpu_torch"):
        assert not importlib.import_module(name).is_initialized(), name
    assert _engine_threads() == []


def _jax_direct(jp, prompts, max_tokens):
    """The JAX ``LLMPredictor.__call__`` on one batch, in this process."""
    from ray_tpu.data.llm_inference import LLMPredictor, clear_engine_cache

    pred = LLMPredictor(lambda: (JCFG, jp), max_tokens=max_tokens, **ENGINE_KW)
    try:
        batch = {"prompt": np.array([list(p) for p in prompts], dtype=object)}
        out = pred(batch)
        return [list(x) for x in out["generated"]]
    finally:
        clear_engine_cache()


def _port_map(tp, prompts, max_tokens, **map_kw):
    import ray_tpu_torch as rt
    from ray_tpu_torch.data import LLMPredictor

    factory = lambda: (CFG, tp)  # noqa: E731
    ds = rt.data.from_items([{"prompt": p} for p in prompts])
    out = ds.map_batches(
        LLMPredictor, fn_constructor_args=(factory,),
        fn_constructor_kwargs={"max_tokens": max_tokens, "device": "cpu", **ENGINE_KW},
        batch_size=4, **map_kw).take_all()
    return {tuple(r["prompt"]): [int(t) for t in r["generated"]] for r in out}


@pytest.mark.parametrize("where", ["gpu_actors_in_process", "process_actor"])
def test_port_map_batches_matches_jax_predictor_call(weights, where):
    """The port's ``map_batches(LLMPredictor)`` (every row) against the JAX
    ``LLMPredictor`` called on the same batch, greedy: identical tokens. In
    process (``num_gpus=0.5``, two actors) the two actors share one engine:
    they see the same factory object, handed over by reference."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.data import llm_inference

    jp, tp = weights
    want = _jax_direct(jp, PROMPTS, 4)
    if where == "gpu_actors_in_process":
        rt.init(num_cpus=4, num_gpus=1)
        map_kw = {"num_gpus": 0.5, "concurrency": 2}
    else:
        rt.init(num_cpus=4)
        map_kw = {"concurrency": 1}
    try:
        got = _port_map(tp, PROMPTS, 4, **map_kw)
        engines = [e for _, e, _ in llm_inference._engine_cache.values()]
    finally:
        rt.shutdown()
    assert [got[tuple(p)] for p in PROMPTS] == want
    if where == "gpu_actors_in_process":
        assert len(engines) == 1 and engines[0].device.type == "cpu"
    else:
        assert engines == []  # the engine lived in the actor's process


def test_predictor_rows_text_and_errors_match_jax(weights):
    """``__call__`` itself: the output columns, a tokenizer's text column,
    and string prompts without a tokenizer refused with the same error."""
    from ray_tpu.data.llm_inference import LLMPredictor as JaxPredictor
    from ray_tpu_torch.data.llm_inference import LLMPredictor

    class Tok:
        def encode(self, s):
            return [ord(c) % 80 + 1 for c in s]

        def decode(self, ids):
            return "".join(chr(97 + t % 26) for t in ids)

    jp, tp = weights
    outs = {}
    for name, cls, made in (("jax", JaxPredictor, (JCFG, jp, Tok())),
                            ("port", LLMPredictor, (CFG, tp, Tok()))):
        kw = dict(ENGINE_KW, device="cpu") if name == "port" else dict(ENGINE_KW)
        pred = cls(lambda made=made: made, max_tokens=3, output_column="gen", **kw)
        bare = cls(lambda made=made: made[:2], max_tokens=3, **kw)
        batch = {"prompt": np.array(["hi", "there"], dtype=object), "id": np.array([1, 2])}
        out = pred(batch)
        try:
            bare(batch)
        except ValueError as exc:
            err = str(exc)
        outs[name] = {"keys": sorted(out), "gen": [list(x) for x in out["gen"]],
                      "text": list(out["gen_text"]), "id": out["id"].tolist(),
                      "dtype": out["gen"].dtype.str, "error": err}
    assert outs["port"] == outs["jax"]


def test_llm_predictor_cache_respects_kwargs(weights):
    """Different engine kwargs must not share a cached engine; the same
    factory and kwargs reuse one; ``clear_engine_cache`` stops them all."""
    from ray_tpu_torch.data.llm_inference import LLMPredictor, _engine_cache, clear_engine_cache

    _, tp = weights
    factory = lambda: (CFG, tp)  # noqa: E731
    a = LLMPredictor(factory, max_batch_size=2, max_seq_len=32, device="cpu")
    b = LLMPredictor(factory, max_batch_size=2, max_seq_len=32, device="cpu")
    c = LLMPredictor(factory, max_batch_size=2, max_seq_len=48, device="cpu")
    assert a.engine is b.engine and a.engine is not c.engine and c.engine.S == 48
    assert len(_engine_cache) == 2 and len(_engine_threads()) >= 2
    clear_engine_cache()
    assert len(_engine_cache) == 0 and _engine_threads() == []


def test_predictor_without_device_refuses_the_cpu(weights, monkeypatch):
    from ray_tpu_torch.data.llm_inference import LLMPredictor, _engine_cache

    _, tp = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMPredictor(lambda: (CFG, tp), **ENGINE_KW)
    assert len(_engine_cache) == 0


@pytest.mark.full
def test_data_batch_inference_through_both_packages(weights):
    """``test_data_batch_inference``: the map through both packages (the JAX
    one builds its engine in a JAX-importing process worker)."""
    import ray_tpu
    import ray_tpu.data as jrd
    from ray_tpu.data import LLMPredictor as JaxPredictor

    jp, tp = weights
    ray_tpu.init(num_cpus=4)
    try:
        out = jrd.from_items([{"prompt": p} for p in PROMPTS[:4]]).map_batches(
            JaxPredictor, fn_constructor_args=(lambda: (JCFG, jp),),
            fn_constructor_kwargs={"max_tokens": 4, **ENGINE_KW}, batch_size=4).take_all()
    finally:
        ray_tpu.shutdown()
    want = {tuple(r["prompt"]): list(r["generated"]) for r in out}
    import ray_tpu_torch as rt

    rt.init(num_cpus=4, num_gpus=1)
    try:
        got = _port_map(tp, PROMPTS[:4], 4, num_gpus=0.5)
    finally:
        rt.shutdown()
    assert got == want
