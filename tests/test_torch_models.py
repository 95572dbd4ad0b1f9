"""The port's decoder and cached generation against the JAX package's.

JAX params from ``init_params`` convert leaf by leaf (``ray_tpu_torch.convert``)
so both sides run identical numbers. Small config (as tests/test_paged_kv.py),
f32, logits at atol 1e-4 (summation order and the two BLAS libraries differ);
greedy tokens must be identical. The bf16 tests check that the port rounds at
the same points as the JAX code (the promotion rules of ``_rms_norm``,
``_rope`` and ``embed_tokens``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import generation as jgen  # noqa: E402
from ray_tpu.models import transformer as jtr  # noqa: E402
from ray_tpu_torch.convert import params_from_numpy  # noqa: E402
from ray_tpu_torch.models import generation as tgen  # noqa: E402
from ray_tpu_torch.models import transformer as ttr  # noqa: E402

SMALL = dict(vocab_size=89, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64)
JCFG = jtr.TransformerConfig(**SMALL, attention="dense", dtype=jnp.float32)
TCFG = ttr.TransformerConfig(**SMALL, attention="dense", dtype=torch.float32)
ATOL = 1e-4


@pytest.fixture(scope="module")
def params():
    jp = jtr.init_params(JCFG, jax.random.key(11))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x)


# --------------------------------------------------------------------------
# weight conversion
# --------------------------------------------------------------------------
@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_converted_params_round_trip_bit_for_bit(pdtype):
    cfg = jtr.TransformerConfig(**SMALL, param_dtype=getattr(jnp, pdtype))
    jp = jtr.init_params(cfg, jax.random.key(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    bits = {"float32": (np.int32, torch.int32), "bfloat16": (np.int16, torch.int16)}[pdtype]
    leaves, _ = jax.tree_util.tree_flatten_with_path(jp)
    for path, leaf in leaves:
        t = tp
        for key in path:
            t = t[key.key]
        assert t.dtype == getattr(torch, pdtype), path
        assert tuple(t.shape) == leaf.shape, path
        np.testing.assert_array_equal(
            t.view(bits[1]).numpy(), np.asarray(leaf).view(bits[0]), err_msg=str(path)
        )


# --------------------------------------------------------------------------
# layer math: promotion rules in f32 and bf16
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_math_rounds_like_jax(dtype):
    rng = np.random.default_rng(0)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    x = rng.normal(size=(2, 5, 4, 8)).astype(np.float32)
    jx, tx = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    pos = np.tile(np.arange(3, 8), (2, 1))
    a = jtr._rope(jx, jnp.asarray(pos), 10000.0)
    b = ttr._rope(tx, torch.from_numpy(pos), 10000.0)
    assert b.dtype == td
    np.testing.assert_allclose(_np(b), np.asarray(a, np.float32), atol=1e-6)
    scale = rng.normal(size=(8,)).astype(np.float32)
    a = jtr._rms_norm(jx, jnp.asarray(scale))
    b = ttr._rms_norm(tx, torch.from_numpy(scale))
    assert b.dtype == td
    np.testing.assert_allclose(_np(b), np.asarray(a, np.float32), atol=1e-6)
    emb = rng.normal(size=(89, 32)).astype(np.float32)
    toks = np.array([[1, 5, 88, 3]])
    jc = jtr.TransformerConfig(**SMALL, dtype=jd)
    tc = ttr.TransformerConfig(**SMALL, dtype=td)
    a = jtr.embed_tokens(jc, {"embed": jnp.asarray(emb)}, jnp.asarray(toks))
    b = ttr.embed_tokens(tc, {"embed": torch.from_numpy(emb)}, torch.from_numpy(toks))
    assert b.dtype == td
    np.testing.assert_array_equal(_np(b), np.asarray(a, np.float32))


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_forward_logits_match_jax(params, attention):
    jp, tp = params
    toks = np.random.default_rng(1).integers(0, 89, size=(2, 12))
    jcfg = jtr.TransformerConfig(**SMALL, attention=attention, dtype=jnp.float32)
    tcfg = ttr.TransformerConfig(**SMALL, attention=attention, dtype=torch.float32)
    ref = jtr.forward(jcfg, jp, jnp.asarray(toks))
    got = ttr.forward(tcfg, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_unported_paths_raise(params):
    """The engine's mesh= is still unported; ring attention without a mesh
    is the JAX package's einsum attention (its forward takes mha there)."""
    from ray_tpu_torch.serve.llm import LLMEngine

    jp, tp = params
    cfg = ttr.TransformerConfig(**SMALL, attention="ring", dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        LLMEngine(cfg, tp, device="cpu", mesh=object())
    toks = np.random.default_rng(1).integers(0, 89, size=(2, 12))
    ref = jtr.forward(jtr.TransformerConfig(**SMALL, attention="ring", dtype=jnp.float32), jp,
                      jnp.asarray(toks))
    got = ttr.forward(cfg, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


# --------------------------------------------------------------------------
# cached forward: prefill + 3 decode steps, dense and paged
# --------------------------------------------------------------------------
PROMPT = np.array([[3, 5, 7, 11, 13, 17, 19, 23], [2, 4, 6, 8, 10, 0, 0, 0]])
LENS = np.array([8, 5])


@pytest.mark.parametrize("jax_kernels", [False, True], ids=["xla", "pallas_interpret"])
def test_forward_with_cache_matches_jax(params, jax_kernels):
    jp, tp = params
    S = 16
    jcache = jgen.init_cache(JCFG, 2, S)
    tcache = tgen.init_cache(TCFG, 2, S)
    jlast, jcache = jgen.prefill(JCFG, jp, jcache, jnp.asarray(PROMPT), jnp.asarray(LENS),
                                 use_prefill_kernel=jax_kernels)
    tlast, tcache = tgen.prefill(TCFG, tp, tcache, torch.from_numpy(PROMPT), torch.from_numpy(LENS))
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=ATOL)
    tok = np.array(jnp.argmax(jlast, -1))
    for t in range(3):
        pos = LENS + t
        jl, jcache = jgen.decode_step(JCFG, jp, jcache, jnp.asarray(tok), jnp.asarray(pos),
                                      use_decode_kernel=jax_kernels)
        tl, tcache = tgen.decode_step(TCFG, tp, tcache, torch.from_numpy(tok), torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        tok = np.array(jnp.argmax(jl, -1))
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), atol=ATOL)


@pytest.mark.parametrize("jax_kernels", [False, True], ids=["xla", "pallas_interpret"])
def test_paged_forward_with_cache_matches_jax(params, jax_kernels):
    jp, tp = params
    bs, M = 4, 4
    N = 2 * M + 1
    bt = np.random.default_rng(2).permutation(np.arange(1, N)).reshape(2, M).astype(np.int32)
    jcache = jgen.init_paged_cache(JCFG, N, bs)
    tcache = tgen.init_paged_cache(TCFG, N, bs)
    positions = np.tile(np.arange(8), (2, 1))
    valid = positions < LENS[:, None]
    jl, jcache = jgen.paged_forward_with_cache(
        JCFG, jp, jcache, jnp.asarray(bt), jnp.asarray(PROMPT), jnp.asarray(positions),
        valid=jnp.asarray(valid), use_decode_kernel=False,
    )
    tl, tcache = tgen.paged_forward_with_cache(
        TCFG, tp, tcache, torch.from_numpy(bt), torch.from_numpy(PROMPT),
        torch.from_numpy(positions), valid=torch.from_numpy(valid),
    )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    tok = np.array(jnp.argmax(jl[np.arange(2), LENS - 1], -1))
    for t in range(3):
        pos = LENS + t
        jl, jcache = jgen.paged_decode_step(
            JCFG, jp, jcache, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(bt),
            use_decode_kernel=jax_kernels,
        )
        tl, tcache = tgen.paged_decode_step(
            TCFG, tp, tcache, torch.from_numpy(tok), torch.from_numpy(pos), torch.from_numpy(bt)
        )
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        tok = np.array(jnp.argmax(jl, -1))
    # every real page agrees (page 0 is garbage: only its existence matters)
    np.testing.assert_allclose(tcache["v"].numpy()[:, 1:], np.asarray(jcache["v"])[:, 1:],
                               atol=ATOL)


# --------------------------------------------------------------------------
# int8 weight-only serving: quantized layers with their scales
# --------------------------------------------------------------------------
@pytest.fixture(scope="module", params=[256, 2048], ids=["all_linears", "wk_wv_float"])
def qparams(request, params):
    """(JAX params, scales), (port params, scales) from ``quantize_layers``;
    at min_size 2048 ``wk``/``wv`` (1024 elements) stay float."""
    from ray_tpu.ops.quantization import quantize_layers as jquantize_layers
    from ray_tpu_torch.ops.quantization import quantize_layers as tquantize_layers

    jp, tp = params
    jl, js = jquantize_layers(jp["layers"], min_size=request.param)
    tl, ts = tquantize_layers(tp["layers"], min_size=request.param)
    assert (tl["wk"].dtype == torch.int8) == (request.param == 256)
    return ({**jp, "layers": jl}, js), ({**tp, "layers": tl}, ts)


def test_quantized_forward_with_cache_matches_jax(qparams):
    """Prefill + 3 decode steps with ``layer_scales``: the port's int8
    products (the plain version of K6 on the CPU) and dequantized ``wo``
    against the JAX code's per-layer dequantization, atol 1e-4."""
    (jp, js), (tp, ts) = qparams
    jcache, tcache = jgen.init_cache(JCFG, 2, 16), tgen.init_cache(TCFG, 2, 16)
    jlast, jcache = jgen.prefill(JCFG, jp, jcache, jnp.asarray(PROMPT), jnp.asarray(LENS),
                                 layer_scales=js)
    tlast, tcache = tgen.prefill(TCFG, tp, tcache, torch.from_numpy(PROMPT),
                                 torch.from_numpy(LENS), layer_scales=ts)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=ATOL)
    tok = np.array(jnp.argmax(jlast, -1))
    for t in range(3):
        pos = LENS + t
        jl, jcache = jgen.decode_step(JCFG, jp, jcache, jnp.asarray(tok), jnp.asarray(pos),
                                      layer_scales=js)
        tl, tcache = tgen.decode_step(TCFG, tp, tcache, torch.from_numpy(tok),
                                      torch.from_numpy(pos), layer_scales=ts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        tok = np.array(jnp.argmax(jl, -1))
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), atol=ATOL)


def test_quantized_paged_forward_with_cache_matches_jax(qparams):
    (jp, js), (tp, ts) = qparams
    bs, M = 4, 4
    N = 2 * M + 1
    bt = np.random.default_rng(7).permutation(np.arange(1, N)).reshape(2, M).astype(np.int32)
    jcache, tcache = jgen.init_paged_cache(JCFG, N, bs), tgen.init_paged_cache(TCFG, N, bs)
    positions = np.tile(np.arange(8), (2, 1))
    valid = positions < LENS[:, None]
    jl, jcache = jgen.paged_forward_with_cache(
        JCFG, jp, jcache, jnp.asarray(bt), jnp.asarray(PROMPT), jnp.asarray(positions),
        valid=jnp.asarray(valid), layer_scales=js,
    )
    tl, tcache = tgen.paged_forward_with_cache(
        TCFG, tp, tcache, torch.from_numpy(bt), torch.from_numpy(PROMPT),
        torch.from_numpy(positions), valid=torch.from_numpy(valid), layer_scales=ts,
    )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    tok = np.array(jnp.argmax(jl[np.arange(2), LENS - 1], -1))
    for t in range(3):
        pos = LENS + t
        jl, jcache = jgen.paged_decode_step(JCFG, jp, jcache, jnp.asarray(tok), jnp.asarray(pos),
                                            jnp.asarray(bt), layer_scales=js)
        tl, tcache = tgen.paged_decode_step(TCFG, tp, tcache, torch.from_numpy(tok),
                                            torch.from_numpy(pos), torch.from_numpy(bt),
                                            layer_scales=ts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        tok = np.array(jnp.argmax(jl, -1))
    np.testing.assert_allclose(tcache["v"].numpy()[:, 1:], np.asarray(jcache["v"])[:, 1:],
                               atol=ATOL)


def test_quantized_products_route_by_dtype_and_scale_shape(monkeypatch, qparams):
    """Every int8 leaf whose scales are per output column goes through
    ``int8_matmul`` (6 products a layer with all linears int8: wq, wk, wv,
    w1, w3, w2); ``wo``, whose scales vary along the contracted Dh, and
    float leaves do not."""
    from ray_tpu_torch.models import transformer as ttr_mod

    _, (tp, ts) = qparams
    seen = []
    real = ttr_mod.int8_matmul

    def spy(x, w, s, **kw):
        seen.append(tuple(w.shape))
        return real(x, w, s, **kw)

    monkeypatch.setattr(ttr_mod, "int8_matmul", spy)
    cache = tgen.init_cache(TCFG, 2, 16)
    tgen.prefill(TCFG, tp, cache, torch.from_numpy(PROMPT), torch.from_numpy(LENS),
                 layer_scales=ts)
    d, ff = SMALL["d_model"], SMALL["d_ff"]
    kv = d // SMALL["n_heads"] * SMALL["n_kv_heads"]
    per_layer = [(d, d), (d, kv), (d, kv), (d, ff), (d, ff), (ff, d)]
    if tp["layers"]["wk"].dtype != torch.int8:
        per_layer = [per_layer[0]] + per_layer[3:]
    assert sorted(seen) == sorted(per_layer * SMALL["n_layers"])


# --------------------------------------------------------------------------
# MoE FFNs: dense and capacity dispatch
# --------------------------------------------------------------------------
MOE = dict(SMALL, num_experts=4)
# (top_k, capacity factor): dense dispatch at top-1 and top-2; capacity
# dispatch with room to spare at 1.25 and at 0.5, where tokens overflow
DISPATCH = {"top1_dense": (1, 0.0), "top2_dense": (2, 0.0), "top2_capacity1.25": (2, 1.25),
            "top2_capacity0.5": (2, 0.5)}


def _moe_cfgs(case, attention="dense"):
    k, f = DISPATCH[case]
    kw = dict(MOE, expert_top_k=k, moe_capacity_factor=f, attention=attention)
    return (jtr.TransformerConfig(**kw, dtype=jnp.float32),
            ttr.TransformerConfig(**kw, dtype=torch.float32))


@pytest.fixture(scope="module")
def moe_params():
    jp = jtr.init_params(_moe_cfgs("top2_dense")[0], jax.random.key(12))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def test_moe_params_keep_the_jax_leaves(moe_params):
    jp, tp = moe_params
    tc = _moe_cfgs("top2_dense")[1]
    fresh = ttr.init_params(tc, torch.Generator().manual_seed(0))
    for tree in (tp, fresh):
        assert {k: tuple(v.shape) for k, v in tree["layers"].items()} == {
            k: v.shape for k, v in jp["layers"].items()}
    assert {"router", "we1", "we3", "we2"} <= set(fresh["layers"])
    assert not {"w1", "w3", "w2"} & set(fresh["layers"])


@pytest.mark.parametrize("case", list(DISPATCH))
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_moe_forward_logits_match_jax(moe_params, case, attention):
    jp, tp = moe_params
    jc, tc = _moe_cfgs(case, attention)
    toks = np.random.default_rng(1).integers(0, 89, size=(2, 12))
    ref = jtr.forward(jc, jp, jnp.asarray(toks))
    got = ttr.forward(tc, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("case", ["top2_capacity1.25", "top2_capacity0.5"])
def test_moe_capacity_padding_never_takes_a_real_tokens_slot(moe_params, case):
    """Slots fill in token order, so tokens padded after the real ones
    change nothing for the real ones, whatever they hold (C is that of the
    padded T); the FFN on the padded input matches the JAX code's. At 0.5
    some real tokens overflow (their output is 0)."""
    jp, tp = moe_params
    jc, tc = _moe_cfgs(case)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 16, 32)).astype(np.float32)
    layer_j = jax.tree.map(lambda a: a[0], jp["layers"])
    layer_t = ttr.layer_params(tp, 0)
    outs = []
    for pad in (np.zeros((2, 6, 32), np.float32), rng.normal(size=(2, 6, 32)).astype(np.float32) * 3):
        xp = np.concatenate([x[:, :10], pad], axis=1)
        got = ttr._moe_ffn(tc, layer_t, torch.from_numpy(xp))
        ref = jtr._moe_ffn(jc, layer_j, jnp.asarray(xp))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
        outs.append(got[:, :10])
    assert torch.equal(outs[0], outs[1])
    dropped = (outs[0].abs().amax(-1) == 0).sum()
    assert (int(dropped) > 0) == (case == "top2_capacity0.5")


def _greedy_run(gen, mk, cfg, params, kind, scales=None):
    """Prefill PROMPT, then 3 greedy decode steps on the row's own argmax:
    the logits of each step (as numpy), dense or paged cache."""
    kw = {} if scales is None else {"layer_scales": scales}
    bt = np.random.default_rng(2).permutation(np.arange(1, 9)).reshape(2, 4).astype(np.int32)
    if kind == "dense":
        cache = gen.init_cache(cfg, 2, 16)
        last, cache = gen.prefill(cfg, params, cache, mk(PROMPT), mk(LENS), **kw)
    else:
        cache = gen.init_paged_cache(cfg, 9, 4)
        positions = np.tile(np.arange(8), (2, 1))
        lg, cache = gen.paged_forward_with_cache(
            cfg, params, cache, mk(bt), mk(PROMPT), mk(positions),
            valid=mk(positions < LENS[:, None]), **kw)
        last = lg[mk(np.arange(2)), mk(LENS - 1)]
    out = [np.array(last, np.float32)]
    for t in range(3):
        tok, pos = out[-1].argmax(-1), LENS + t
        if kind == "dense":
            lg, cache = gen.decode_step(cfg, params, cache, mk(tok), mk(pos), **kw)
        else:
            lg, cache = gen.paged_decode_step(cfg, params, cache, mk(tok), mk(pos), mk(bt), **kw)
        out.append(np.array(lg, np.float32))
    return out


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("case", ["top2_dense", "top2_capacity1.25"])
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_moe_cached_forward_matches_jax(moe_params, kind, case, quantize):
    """Prefill + 3 greedy decode steps: logits atol 1e-4 and the same
    tokens. Under ``quantize`` every linear of at least 256 elements is int8
    (the router and the experts dequantized, wq/wk/wv through the plain
    version of the int8 matmul)."""
    from ray_tpu.ops.quantization import quantize_layers as jquantize_layers
    from ray_tpu_torch.ops.quantization import quantize_layers as tquantize_layers

    jp, tp = moe_params
    jc, tc = _moe_cfgs(case)
    js = ts = None
    if quantize:
        jl, js = jquantize_layers(jp["layers"], min_size=256)
        tl, ts = tquantize_layers(tp["layers"], min_size=256)
        assert {k for k, w in tl.items() if w.dtype == torch.int8} == {
            "wq", "wk", "wv", "wo", "router", "we1", "we3", "we2"}
        jp, tp = {**jp, "layers": jl}, {**tp, "layers": tl}
    ref = _greedy_run(jgen, jnp.asarray, jc, jp, kind, js)
    got = _greedy_run(tgen, torch.from_numpy, tc, tp, kind, ts)
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=f"step {i}")
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1), err_msg=f"step {i}")


def test_moe_quantized_products_route_by_scale_shape(monkeypatch, moe_params):
    """Under int8 serving of a MoE config only wq, wk and wv go through
    ``int8_matmul`` (their scales are per output column); wo, the router and
    the experts are dequantized."""
    from ray_tpu_torch.models import transformer as ttr_mod
    from ray_tpu_torch.ops.quantization import quantize_layers as tquantize_layers

    _, tp = moe_params
    tl, ts = tquantize_layers(tp["layers"], min_size=256)
    seen = []
    real = ttr_mod.int8_matmul

    def spy(x, w, s, **kw):
        seen.append(tuple(w.shape))
        return real(x, w, s, **kw)

    monkeypatch.setattr(ttr_mod, "int8_matmul", spy)
    tc = _moe_cfgs("top2_dense")[1]
    tgen.prefill(tc, {**tp, "layers": tl}, tgen.init_cache(tc, 2, 16), torch.from_numpy(PROMPT),
                 torch.from_numpy(LENS), layer_scales=ts)
    d, kv = SMALL["d_model"], SMALL["d_model"] // SMALL["n_heads"] * SMALL["n_kv_heads"]
    assert sorted(seen) == sorted([(d, d), (d, kv), (d, kv)] * SMALL["n_layers"])


def test_scatter_paged_kv_routes_invalid_writes_to_page_zero():
    rng = np.random.default_rng(4)
    N, bs, Hkv, D, M = 6, 4, 2, 3, 2
    pages = rng.normal(size=(N, bs, Hkv, D)).astype(np.float32)
    new = rng.normal(size=(2, 5, Hkv, D)).astype(np.float32)
    bt = np.array([[3, 5], [0, 0]], np.int32)  # row 1: an inactive row's all-zero table
    positions = np.array([[4, 5, 6, 7, 8], [0, 1, 2, 3, 4]])  # row 0 runs past its table
    valid = np.array([[True, True, True, False, False], [True] * 5])
    ref = jtr.scatter_paged_kv(jnp.asarray(pages), jnp.asarray(new), jnp.asarray(bt),
                               jnp.asarray(positions), jnp.asarray(valid))
    tpages = torch.from_numpy(pages.copy())
    got = ttr.scatter_paged_kv(tpages, torch.from_numpy(new), torch.from_numpy(bt),
                               torch.from_numpy(positions), torch.from_numpy(valid))
    assert got is tpages  # in place
    # every page but the garbage page is identical; page 0 took the invalid
    # and inactive writes (which of two duplicate writes wins is unspecified)
    np.testing.assert_array_equal(got.numpy()[1:], np.asarray(ref)[1:])
    np.testing.assert_array_equal(got.numpy()[[1, 2, 4]], pages[[1, 2, 4]])
    assert not np.array_equal(got.numpy()[0], pages[0])


def test_filter_top_k_top_p_matches_jax():
    logits = np.random.default_rng(5).normal(size=(4, 89)).astype(np.float32)
    for top_k, top_p in [(5, None), (None, 0.3), (7, 0.9), (None, None)]:
        ref = jgen.filter_top_k_top_p(jnp.asarray(logits), top_k, top_p)
        got = tgen.filter_top_k_top_p(torch.from_numpy(logits), top_k, top_p)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_generate_greedy_tokens_match_jax(params):
    jp, tp = params
    jout, jlens = jgen.generate(JCFG, jp, jnp.asarray(PROMPT), jnp.asarray(LENS),
                                max_new_tokens=6, temperature=0, eos_id=7)
    tout, tlens = tgen.generate(TCFG, tp, torch.from_numpy(PROMPT), torch.from_numpy(LENS),
                                max_new_tokens=6, temperature=0, eos_id=7)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tlens.numpy(), np.asarray(jlens))


def test_sampling_uses_the_callers_generator(params):
    _, tp = params
    p = torch.from_numpy(PROMPT)
    a, _ = tgen.generate(TCFG, tp, p, max_new_tokens=5, temperature=1.0,
                         generator=torch.Generator().manual_seed(9))
    b, _ = tgen.generate(TCFG, tp, p, max_new_tokens=5, temperature=1.0, top_k=10,
                         generator=torch.Generator().manual_seed(9))
    c, _ = tgen.generate(TCFG, tp, p, max_new_tokens=5, temperature=1.0,
                         generator=torch.Generator().manual_seed(9))
    assert torch.equal(a, c) and a.shape == b.shape == (2, 13)
