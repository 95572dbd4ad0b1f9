"""The port's LLMEngine against the JAX package's, token for token.

Both engines serve the same converted weights (small f32 config, as
tests/test_paged_kv.py) on the same prompts with greedy decoding; the port
runs on the CPU (``device="cpu"``). Then the port's own admission and
release paths: every path returns every KV block to the pool.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from ray_tpu.models import init_params as jax_init_params  # noqa: E402
from ray_tpu.serve.llm import LLMEngine as JaxEngine  # noqa: E402
from ray_tpu_torch.convert import params_from_numpy  # noqa: E402
from ray_tpu_torch.exceptions import DeadlineExceededError, OverloadedError  # noqa: E402
from ray_tpu_torch.models.transformer import TransformerConfig  # noqa: E402
from ray_tpu_torch.runtime import admission  # noqa: E402
from ray_tpu_torch.serve.kv_blocks import BlockAllocator  # noqa: E402
from ray_tpu_torch.serve.llm import LLMEngine  # noqa: E402

SMALL = dict(vocab_size=89, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64)
JCFG = JaxConfig(**SMALL, attention="dense", dtype=jnp.float32)
CFG = TransformerConfig(**SMALL, attention="dense", dtype=torch.float32)
PROMPTS = [[3, 5, 7, 11, 13], [2] * 17, list(range(1, 31)), [8, 9]]  # tests/test_paged_kv.py


@pytest.fixture(scope="module")
def params():
    jp = jax_init_params(JCFG, jax.random.key(11))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _port(tparams, **kw):
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("max_seq_len", 64)
    return LLMEngine(CFG, tparams, device="cpu", **kw)


def _serve(eng, prompts=PROMPTS, max_tokens=8):
    return [f.result(timeout=120) for f in [eng.submit(p, max_tokens=max_tokens) for p in prompts]]


def _wait(pred, timeout=60):
    deadline = time.time() + timeout
    while not pred() and time.time() < deadline:
        time.sleep(0.005)
    assert pred()


def _assert_no_leak(eng):
    """Quiesced-engine leak check: every held page is the prefix cache's,
    and flushing it empties the pool."""
    st = eng.stats()
    assert st["kv_blocks_in_use"] == st["prefix_cache_blocks"]
    eng.flush_prefix_cache()
    st = eng.stats()
    assert st["kv_blocks_in_use"] == 0 and st["prefix_cache_blocks"] == 0


@pytest.fixture(scope="module")
def jax_reference(params):
    """The JAX engine's greedy tokens on PROMPTS (one-shot, paged)."""
    jp, _ = params
    eng = JaxEngine(JCFG, jp, max_batch_size=4, max_seq_len=64, cache_kind="paged")
    try:
        return _serve(eng)
    finally:
        eng.shutdown()


# --------------------------------------------------------------------------
# token identity with the JAX engine
# --------------------------------------------------------------------------
def test_dense_engine_matches_jax(params):
    jp, tp = params
    ref_eng = JaxEngine(JCFG, jp, max_batch_size=4, max_seq_len=64, cache_kind="dense")
    eng = _port(tp, cache_kind="dense")
    try:
        assert _serve(eng) == _serve(ref_eng)
        assert eng.stats()["cache_kind"] == "dense"
    finally:
        ref_eng.shutdown()
        eng.shutdown()


@pytest.mark.parametrize("chunk", [0, 16, 7, 64])  # one-shot, 1 block, odd, full prompt
def test_paged_engine_matches_jax(params, jax_reference, chunk):
    _, tp = params
    eng = _port(tp, prefill_chunk_tokens=chunk)
    try:
        assert _serve(eng) == jax_reference
        if chunk:
            assert eng.stats()["prefill_chunks"] >= len(PROMPTS)
        _assert_no_leak(eng)
    finally:
        eng.shutdown()


@pytest.mark.parametrize("n,cows", [(33, 0), (32, 1)])
def test_prefix_hit_with_cow_matches_jax(params, n, cows):
    """A repeated prompt admits through the prefix cache: its 4 full blocks
    of 8 are shared; when the prompt is exactly those blocks, the last one
    is copy-on-write (its last token is recomputed). Both runs match the
    JAX engine's tokens."""
    jp, tp = params
    prompt = list(range(40, 40 - n, -1))
    ref_eng = JaxEngine(JCFG, jp, max_batch_size=4, max_seq_len=64, kv_block_size=8)
    eng = _port(tp, kv_block_size=8)
    try:
        ref = ref_eng.generate(prompt, max_tokens=6)
        a = eng.generate(prompt, max_tokens=6)
        assert eng.stats()["prefix_cache_misses"] == 1
        b = eng.generate(prompt, max_tokens=6)
        assert a == b == ref
        st = eng.stats()
        assert st["prefix_cache_hits"] == 1
        assert st["prefix_tokens_reused"] == n - 1  # all but the one recomputed token
        assert st["cow_copies"] == cows
        _assert_no_leak(eng)
    finally:
        ref_eng.shutdown()
        eng.shutdown()


# --------------------------------------------------------------------------
# int8 weight-only serving
# --------------------------------------------------------------------------
@pytest.mark.parametrize("cache_kind", ["paged", "dense"])
def test_quantized_engine_matches_jax(params, cache_kind):
    """``quantize=True`` (every linear int8 at min_size 256) with chunked
    prefill on: the port's greedy tokens equal the JAX quantized engine's."""
    jp, tp = params
    kw = dict(max_batch_size=4, max_seq_len=64, cache_kind=cache_kind, quantize=True,
              quantize_min_size=256, prefill_chunk_tokens=7)
    ref_eng = JaxEngine(JCFG, jp, **kw)
    eng = LLMEngine(CFG, tp, device="cpu", **kw)
    try:
        assert eng.quantized and eng.params["layers"]["wq"].dtype == torch.int8
        assert eng.params["layers"]["attn_norm"].dtype == torch.float32  # norms untouched
        assert _serve(eng) == _serve(ref_eng)
        if cache_kind == "paged":
            assert eng.stats()["prefill_chunks"] > len(PROMPTS)  # prompts of 17, 30 chunk
            _assert_no_leak(eng)
    finally:
        ref_eng.shutdown()
        eng.shutdown()


# --------------------------------------------------------------------------
# MoE configs
# --------------------------------------------------------------------------
MOE = dict(SMALL, num_experts=4, expert_top_k=2)


@pytest.fixture(scope="module")
def moe_params():
    jp = jax_init_params(JaxConfig(**MOE, dtype=jnp.float32), jax.random.key(13))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("factor", [0.0, 1.25], ids=["dense_dispatch", "capacity1.25"])
@pytest.mark.parametrize("cache_kind", ["paged", "dense"])
def test_moe_engine_matches_jax(moe_params, cache_kind, factor, quantize):
    """A MoE config served by both engines, chunked prefill on: the same
    greedy tokens, float and int8 (every linear of at least 256 elements,
    the router and the experts included). Capacity dispatch sizes its slots
    from the padded length of each call, so it holds only if the two
    engines pad prompts and chunks to the same buckets."""
    jp, tp = moe_params
    kw = dict(max_batch_size=4, max_seq_len=64, cache_kind=cache_kind, quantize=quantize,
              quantize_min_size=256, prefill_chunk_tokens=7)
    ref_eng = JaxEngine(JaxConfig(**MOE, moe_capacity_factor=factor, attention="dense",
                                  dtype=jnp.float32), jp, **kw)
    eng = LLMEngine(TransformerConfig(**MOE, moe_capacity_factor=factor, attention="dense",
                                      dtype=torch.float32), tp, device="cpu", **kw)
    try:
        if quantize:
            assert eng.params["layers"]["we1"].dtype == torch.int8
            assert eng.params["layers"]["router"].dtype == torch.int8
        assert _serve(eng) == _serve(ref_eng)
        if cache_kind == "paged":
            assert eng.stats()["prefill_chunks"] > len(PROMPTS)
            _assert_no_leak(eng)
    finally:
        ref_eng.shutdown()
        eng.shutdown()


def test_moe_prefix_hit_with_cow_matches_jax(moe_params):
    """Prefix reuse and copy-on-write on a MoE config: a repeated prompt of
    exactly 4 blocks of 8 is served from the cache, its last block copied."""
    jp, tp = moe_params
    prompt = list(range(40, 8, -1))
    ref_eng = JaxEngine(JaxConfig(**MOE, attention="dense", dtype=jnp.float32), jp,
                        max_batch_size=4, max_seq_len=64, kv_block_size=8)
    eng = LLMEngine(TransformerConfig(**MOE, attention="dense", dtype=torch.float32), tp,
                    device="cpu", max_batch_size=4, max_seq_len=64, kv_block_size=8)
    try:
        ref = ref_eng.generate(prompt, max_tokens=6)
        assert eng.generate(prompt, max_tokens=6) == ref == eng.generate(prompt, max_tokens=6)
        st = eng.stats()
        assert st["prefix_cache_hits"] == 1 and st["cow_copies"] == 1
        _assert_no_leak(eng)
    finally:
        ref_eng.shutdown()
        eng.shutdown()


def test_quantized_engine_equals_generate_on_dequantized_weights(params):
    """The JAX test's contract (tests/test_serve_llm.py:144-174): greedy
    output of the quantized engine equals ``generate()`` on the dequantized
    weights."""
    from ray_tpu_torch.models.generation import generate
    from ray_tpu_torch.ops.quantization import dequantize_int8

    _, tp = params
    eng = _port(tp, quantize=True, quantize_min_size=256)
    try:
        prompt = [3, 14, 15]
        out = eng.generate(prompt, max_tokens=8)
        q_layers = eng.params["layers"]
        deq = {k: dequantize_int8(w, eng._layer_scales[k], CFG.param_dtype)
               if w.dtype == torch.int8 else w for k, w in q_layers.items()}
        ref, _ = generate(CFG, {**eng.params, "layers": deq}, torch.tensor([prompt]),
                          max_new_tokens=8, temperature=0)
        assert out == ref[0, len(prompt):].tolist()
    finally:
        eng.shutdown()


# --------------------------------------------------------------------------
# admission: typed sheds and the never-fits contract
# --------------------------------------------------------------------------
def test_pool_exhaustion_is_typed_overload():
    a = BlockAllocator(4)
    held = a.alloc(2)
    with pytest.raises(OverloadedError) as exc:
        a.alloc(2)
    assert exc.value.layer == "engine" and exc.value.reason == "kv_blocks"
    assert exc.value.retry_after_s > 0
    assert a.free_blocks == 1 and a.used_blocks == 2  # the failed alloc took nothing
    a.free(held)
    with pytest.raises(ValueError):
        a.free(held)  # double free


def test_queue_bound_sheds_typed_and_expired_deadline(params):
    _, tp = params
    eng = _port(tp, max_batch_size=1, max_queued_requests=1)
    try:
        blocker = eng.submit([2, 7, 1], max_tokens=30)
        _wait(lambda: eng.stats()["active_slots"] == 1)
        queued = eng.submit([2, 7], max_tokens=2)
        with pytest.raises(OverloadedError) as exc:
            eng.submit([2, 7], max_tokens=2)
        assert exc.value.reason == "queue_full"
        with pytest.raises(DeadlineExceededError):
            eng.submit([1], max_tokens=2, deadline_ts=time.time() - 1)
        assert len(blocker.result(timeout=120)) == 30
        assert len(queued.result(timeout=120)) == 2
        assert eng.stats()["shed"] == 2
        assert admission.shed_totals()["engine"]["queue_full"] >= 1
        _assert_no_leak(eng)
    finally:
        eng.shutdown()


def test_never_fitting_prompt_is_value_error(params):
    _, tp = params
    # 2 usable blocks (32 positions) but max_seq_len 64: the block check fires
    eng = _port(tp, kv_num_blocks=3)
    try:
        with pytest.raises(ValueError, match="never be admitted"):
            eng.submit([1] * 30, max_tokens=10)
        assert eng.stats()["kv_blocks_in_use"] == 0
    finally:
        eng.shutdown()


def test_head_of_line_waits_for_blocks(params):
    _, tp = params
    eng = _port(tp, max_batch_size=2, kv_num_blocks=5)  # 4 usable blocks
    try:
        a = eng.submit([1] * 40, max_tokens=20)  # needs all 4 blocks
        _wait(lambda: eng.stats()["kv_blocks_in_use"] == 4)
        b = eng.submit([2] * 40, max_tokens=20)
        _wait(lambda: eng.admission_snapshot()["waiting_for_blocks"] == 1)
        assert len(a.result(timeout=120)) == 20
        assert len(b.result(timeout=120)) == 20
        _assert_no_leak(eng)
    finally:
        eng.shutdown()


# --------------------------------------------------------------------------
# release paths: finish, eos, disconnect evict, prefill crash, loop crash
# --------------------------------------------------------------------------
def test_blocks_released_on_finish_and_eos(params):
    _, tp = params
    eng = _port(tp)
    try:
        out = eng.generate([4, 5, 6], max_tokens=8)
        stopped = eng.generate([4, 5, 6], max_tokens=8, eos_id=out[2])
        assert stopped == out[: out.index(out[2]) + 1]
        _assert_no_leak(eng)
    finally:
        eng.shutdown()


def test_disconnect_evict_frees_every_block(params):
    _, tp = params
    eng = _port(tp, max_batch_size=1)
    try:
        stream = eng.submit_stream([4, 2], max_tokens=50)
        next(stream)
        _wait(lambda: eng.stats()["active_slots"] == 1)
        assert eng.stats()["kv_blocks_in_use"] > 0
        stream.close()
        _wait(lambda: eng.stats()["active_slots"] == 0)
        _wait(lambda: eng.stats()["kv_blocks_in_use"] == 0)
        assert eng.stats()["slots_evicted"] == 1
        assert len(eng.generate([4, 2], max_tokens=3)) == 3  # freed pages serve again
        _assert_no_leak(eng)
    finally:
        eng.shutdown()


def test_prefill_crash_releases_blocks(params):
    _, tp = params
    eng = _port(tp, prefill_chunk_tokens=8)
    try:
        real = eng._prefill_chunk
        eng._prefill_chunk = lambda *a, **k: (_ for _ in ()).throw(
            RuntimeError("injected prefill fault")
        )
        fut = eng.submit([1, 2, 3, 4, 5], max_tokens=4)
        with pytest.raises(RuntimeError, match="prefill failed"):
            fut.result(timeout=120)
        _wait(lambda: eng.stats()["kv_blocks_in_use"] == 0)
        eng._prefill_chunk = real
        assert len(eng.generate([1, 2, 3], max_tokens=3)) == 3
        _assert_no_leak(eng)
    finally:
        eng.shutdown()


@pytest.mark.parametrize("cache_kind", ["paged", "dense"])
def test_loop_crash_resets_cache_and_keeps_serving(params, jax_reference, cache_kind):
    _, tp = params
    eng = _port(tp, cache_kind=cache_kind)
    step = "_decode_k_paged" if cache_kind == "paged" else "_decode_k"
    try:
        real = getattr(eng, step)
        old_cache = eng._cache["k"]
        setattr(eng, step, lambda *a, **k: (_ for _ in ()).throw(
            RuntimeError("injected decode fault")
        ))
        fut = eng.submit([1, 2, 3], max_tokens=8)
        with pytest.raises(RuntimeError, match="step failed"):
            fut.result(timeout=120)
        _wait(lambda: eng._cache["k"] is not old_cache)
        setattr(eng, step, real)
        # _fail_inflight + _reset_cache: the engine serves the same tokens
        assert _serve(eng) == jax_reference
        if cache_kind == "paged":
            _assert_no_leak(eng)
    finally:
        eng.shutdown()
