"""The port's quantization ops against the JAX package's.

Inputs are drawn with numpy from a seed and fed to both sides. The JAX
``int8_matmul`` runs its Pallas kernel in interpret mode (as in
tests/test_quantization.py); the port runs its plain version on the CPU.
Quantization (int8 values and scales) must agree bit for bit. The matmul
in f32 within rtol 1e-5 and atol 1e-6 x max|reference|: the JAX kernel
scales each column after summing x * w_q over 32-row k-tiles, the plain
version sums x * (w_q * s); both in f32, so elements near zero differ by
about sqrt(K) * 2^-24 * |partial sums| (1.3e-5 at K = 300), which no pure
rtol covers. In bf16 within rtol 2e-2 / atol 2e-1 (the bf16 output keeps
about 3 digits; the tolerance of tests/test_quantization.py:63-65).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ray_tpu.ops import quantization as jq  # noqa: E402
from ray_tpu_torch.convert import params_from_numpy  # noqa: E402
from ray_tpu_torch.ops import quantization as tq  # noqa: E402


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("shape,axis", [((128, 64), 0), ((128, 64), 1), ((3, 32, 4, 8), 1),
                                        ((5, 6, 7), 2)])
def test_quantize_int8_bitwise_matches_jax(shape, axis):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) * rng.uniform(0.01, 10.0, size=shape[-1])).astype(np.float32)
    w.reshape(-1, shape[-1])[:, 1] = 0.0  # an all-zero channel along every axis but the last
    jw, js = jq.quantize_int8(jnp.asarray(w), axis=axis)
    tw, ts = tq.quantize_int8(torch.from_numpy(w), axis=axis)
    assert tw.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy().view(np.int32), np.asarray(js).view(np.int32))


def test_zero_column_and_round_half_to_even():
    w = np.zeros((16, 4), np.float32)
    # column 1: values at exact half steps of its scale (absmax 127 -> scale 1)
    w[:, 1] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5] * 2
    jw, js = jq.quantize_int8(jnp.asarray(w), axis=0)
    tw, ts = tq.quantize_int8(torch.from_numpy(w), axis=0)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tw[:8, 1].tolist() == [127, 0, 2, 2, 0, -2, -2, 4]
    assert ts[0, 0] == 1.0 and not tw[:, 0].any()  # all-zero column: scale 1, zeros
    assert not tq.dequantize_int8(tw, ts)[:, 0].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_int8_matches_jax(dtype):
    rng = np.random.default_rng(1)
    q = rng.integers(-127, 128, size=(32, 24)).astype(np.int8)
    s = rng.uniform(1e-3, 1.0, size=(1, 24)).astype(np.float32)
    a = jq.dequantize_int8(jnp.asarray(q), jnp.asarray(s), getattr(jnp, dtype))
    b = tq.dequantize_int8(torch.from_numpy(q), torch.from_numpy(s), getattr(torch, dtype))
    assert b.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_np(b), np.asarray(a, np.float32))


@pytest.mark.parametrize("shape", [(64, 128, 96), (100, 300, 50)], ids=["tiled", "ragged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_matches_jax_interpret(shape, dtype):
    M, K, N = shape
    rng = np.random.default_rng(2)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    w_q, scales = jq.quantize_int8(jnp.asarray(w), axis=0)
    # the JAX kernel at small tiles, so the interpret-mode grid has several
    # k-steps and ragged edges (tests/test_quantization.py:46)
    ref = jq.int8_matmul(jx, w_q, scales, block_m=32, block_n=64, block_k=32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tq.int8_matmul(tx, torch.from_numpy(np.array(w_q)), torch.from_numpy(np.array(scales)),
                         block_m=32, block_n=64, block_k=32)
    assert got.dtype == tx.dtype and tuple(got.shape) == (M, N)
    if dtype == "float32":
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())
    else:
        np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), rtol=2e-2, atol=2e-1)


@pytest.mark.parametrize("M", [16, 64, 65])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_row_tiles_match_jax_interpret(M, dtype):
    """The row counts at which the CUDA kernel changes its row tile (16, 64,
    one past 64), K not a multiple of the JAX k-tile: the plain version
    against the JAX kernel in interpret mode, tolerances as above."""
    K, N = 136, 96
    rng = np.random.default_rng(10 + M)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w_q, scales = jq.quantize_int8(jnp.asarray(rng.standard_normal((K, N)), jnp.float32), axis=0)
    ref = jq.int8_matmul(jnp.asarray(x, getattr(jnp, dtype)), w_q, scales,
                         block_m=32, block_n=64, block_k=32)
    n = tq.int8_matmul.launches, dict(tq.int8_matmul.launches_by_route)
    got = tq.int8_matmul(torch.from_numpy(x).to(getattr(torch, dtype)),
                         torch.from_numpy(np.array(w_q)), torch.from_numpy(np.array(scales)))
    assert (tq.int8_matmul.launches, tq.int8_matmul.launches_by_route) == n  # CPU: plain version
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (M, N)
    ref = np.asarray(ref, np.float32)
    tol = (dict(rtol=1e-5, atol=1e-6 * np.abs(ref).max()) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-1))
    np.testing.assert_allclose(_np(got), ref, **tol)


@pytest.mark.parametrize("dtype,M,K,N,route", [
    (torch.bfloat16, 8, 1024, 4096, "mma_bf16"),   # decode
    (torch.bfloat16, 1, 1024, 512, "mma_bf16"),
    (torch.bfloat16, 64, 1024, 4096, "mma_bf16"),  # prefill
    (torch.bfloat16, 200, 4096, 1024, "mma_bf16"),
    (torch.bfloat16, 20, 328, 512, "mma_bf16"),    # K % 16 != 0 still fits the 16-byte copies
    (torch.bfloat16, 100, 300, 50, "simt"),        # ragged N and K
    (torch.bfloat16, 8, 1024, 1000, "simt"),       # N % 16 != 0
    (torch.bfloat16, 8, 1020, 512, "simt"),        # K % 8 != 0
    (torch.float32, 8, 1024, 4096, "simt"),        # f32: never rounded to bf16
    (torch.float32, 64, 1024, 4096, "simt"),
])
def test_matmul_route_by_dtype_and_shape(dtype, M, K, N, route):
    assert tq.matmul_route(dtype, M, K, N) == route
    assert route in tq.ROUTES and set(tq.int8_matmul.launches_by_route) == set(tq.ROUTES)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
def test_matmul_route_refuses_what_no_kernel_takes(dtype):
    with pytest.raises(TypeError):
        tq.matmul_route(dtype, 8, 1024, 1024)


def test_int8_matmul_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper launches or raises; ``int8_matmul`` sends a CPU
    tensor to the plain version before it gets there."""
    x = torch.randn(8, 64)
    w_q, s = tq.quantize_int8(torch.randn(64, 32), axis=0)
    before = tq.int8_matmul.launches, dict(tq.int8_matmul.launches_by_route)
    with pytest.raises(RuntimeError, match="CUDA"):
        tq._int8_matmul_cuda(x, w_q, s.reshape(-1), torch.float32)
    torch.testing.assert_close(tq.int8_matmul(x, w_q, s),
                               tq._int8_matmul_plain(x, w_q, s.reshape(-1), torch.float32))
    assert (tq.int8_matmul.launches, tq.int8_matmul.launches_by_route) == before


@pytest.mark.parametrize("x_dtype,out_dtype", [("bfloat16", "float32"), ("float32", "bfloat16")])
def test_int8_matmul_out_dtype_matches_jax(x_dtype, out_dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 64)).astype(np.float32)
    w_q, scales = jq.quantize_int8(jnp.asarray(rng.standard_normal((64, 40)), jnp.float32))
    ref = jq.int8_matmul(jnp.asarray(x, getattr(jnp, x_dtype)), w_q, scales,
                         out_dtype=getattr(jnp, out_dtype))
    got = tq.int8_matmul(torch.from_numpy(x).to(getattr(torch, x_dtype)),
                         torch.from_numpy(np.array(w_q)), torch.from_numpy(np.array(scales)),
                         out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    ref = np.asarray(ref, np.float32)
    tol = (dict(rtol=1e-5, atol=1e-6 * np.abs(ref).max()) if out_dtype == "float32"
           else dict(rtol=2e-2, atol=2e-1))
    np.testing.assert_allclose(_np(got), ref, **tol)


def test_quantize_tree_and_dequantize_tree_match_jax():
    rng = np.random.default_rng(4)
    params = {
        "big": rng.standard_normal((128, 64)).astype(np.float32),
        "small": rng.standard_normal((4,)).astype(np.float32),  # kept
        "nested": {"w": rng.standard_normal((96, 96)).astype(np.float32),
                   "v": rng.standard_normal((8, 8)).astype(np.float32)},  # under min_size
    }
    jw, js = jq.quantize_tree(jax.tree.map(jnp.asarray, params), min_size=1024)
    tw, ts = tq.quantize_tree(params_from_numpy(params), min_size=1024)
    for path in (("big",), ("nested", "w")):
        a, b, sa, sb = jw, tw, js, ts
        for k in path:
            a, b, sa, sb = a[k], b[k], sa[k], sb[k]
        assert b.dtype == torch.int8
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_array_equal(sb.numpy(), np.asarray(sa))
    assert ts["small"] is tq.NO_SCALE and ts["nested"]["v"] is tq.NO_SCALE
    assert js["small"] is jq.NO_SCALE
    assert tw["small"].dtype == torch.float32
    jb, tb = jq.dequantize_tree(jw, js), tq.dequantize_tree(tw, ts)
    for a, b in ((jb["big"], tb["big"]), (jb["nested"]["w"], tb["nested"]["w"]),
                 (jb["small"], tb["small"])):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


SMALL_LAYERS = dict(vocab_size=89, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64)


@pytest.mark.parametrize("min_size", [256, 2048], ids=["all_linears", "wk_wv_float"])
def test_quantize_layers_bitwise_matches_jax(min_size):
    from ray_tpu.models import transformer as jtr

    jp = jtr.init_params(jtr.TransformerConfig(**SMALL_LAYERS), jax.random.key(5))
    tlayers = params_from_numpy(jax.tree.map(np.asarray, jp["layers"]))
    jl, js = jq.quantize_layers(jp["layers"], min_size=min_size)
    tl, ts = tq.quantize_layers(tlayers, min_size=min_size)
    assert set(tl) == set(jl) == set(ts)
    for k in jl:
        assert tl[k].dtype == {jnp.int8: torch.int8, jnp.float32: torch.float32}[jl[k].dtype.type]
        assert tl[k].shape == jl[k].shape and ts[k].shape == js[k].shape
        np.testing.assert_array_equal(_np(tl[k]), np.asarray(jl[k], np.float32), err_msg=k)
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), err_msg=k)
    floats = {k for k in tl if tl[k].dtype != torch.int8}
    # wk/wv [2, 32, 2, 8] hold 1024 elements: float at min_size 2048
    assert floats == ({"attn_norm", "ffn_norm"} if min_size == 256
                      else {"attn_norm", "ffn_norm", "wk", "wv"})
    assert all((ts[k] == 1).all() for k in floats)


def test_params_from_numpy_carries_int8_leaves_bit_for_bit():
    from ray_tpu.models import transformer as jtr

    jp = jtr.init_params(jtr.TransformerConfig(**SMALL_LAYERS), jax.random.key(6))
    jl, js = jq.quantize_layers(jp["layers"], min_size=256)
    tree = params_from_numpy(jax.tree.map(np.asarray, {"layers": jl, "scales": js}))
    for k in jl:
        got, want = tree["layers"][k], np.asarray(jl[k])
        assert got.dtype == (torch.int8 if want.dtype == np.int8 else torch.float32)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tree["scales"][k].numpy().view(np.int32),
                                      np.asarray(js[k]).view(np.int32))
