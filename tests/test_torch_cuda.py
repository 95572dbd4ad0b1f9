"""The port's CUDA kernels on a GPU, each against its plain PyTorch version,
and the engine and the train step on the GPU against the same on the CPU.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode; on the CPU the wrappers run the plain versions,
which tests/test_torch_ops.py holds against the JAX package). This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerances: f32 atol 1e-4 (summation order only), bf16 atol = rtol = 2e-2
(the tensor-core route of K3, K4 and K5 also rounds P and dS to bf16, as the
TPU kernels' MXU passes do), lse atol 1e-4.
The int8 matmul in f32: atol 1e-5 x max|plain| (its K-term sums in another
order differ by about sqrt(K) * 2^-24 * |partial sums|, which grows with the
output's magnitude). The attention kernels and the int8 matmul have no
atomics: two launches give the same bits.
"""

import time

import pytest

torch = pytest.importorskip("torch")

from ray_tpu_torch.ops import attention as tattn  # noqa: E402
from ray_tpu_torch.ops import decode_attention as tdec  # noqa: E402
from ray_tpu_torch.ops import quantization as tq  # noqa: E402
from ray_tpu_torch.ops import variant_probe as vp  # noqa: E402

pytestmark = pytest.mark.cuda

TOLS = [(torch.float32, 1e-4, 0.0), (torch.bfloat16, 2e-2, 2e-2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
def test_paged_decode_kernel_matches_plain(cuda, dtype, atol, rtol):
    g = torch.Generator(device=cuda).manual_seed(0)
    B, H, Hkv, D, bs, M = 3, 8, 4, 64, 16, 4
    N = B * M + 1
    q = torch.randn(B, H, D, generator=g, device=cuda).to(dtype)
    kp, vp = (torch.randn(N, bs, Hkv, D, generator=g, device=cuda).to(dtype) for _ in range(2))
    tables = (torch.randperm(N - 1, generator=g, device=cuda) + 1).reshape(B, M).int()
    tables[0] = 0  # an empty row: all entries on the garbage page
    tables[1, 2:] = 0  # entries past the length too
    lengths = torch.tensor([0, 21, M * bs], dtype=torch.int32, device=cuda)
    n = tdec.paged_decode_attention.launches
    got = tdec.paged_decode_attention(q, kp, vp, tables, lengths)
    want = tdec.paged_decode_attention(q, kp, vp, tables, lengths, use_kernel=False)
    assert tdec.paged_decode_attention.launches == n + 1
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert not got[0].any()


@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
def test_decode_kernel_matches_plain(cuda, dtype, atol, rtol):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(3, 8, 64, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(3, 4, 300, 64, generator=g, device=cuda).to(dtype) for _ in range(2))
    lengths = torch.tensor([0, 17, 300], device=cuda)
    got = tdec.decode_attention(q, k, v, lengths)
    want = tdec.decode_attention(q, k, v, lengths, use_kernel=False)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


# (B, H, Hkv, D, table width, lengths), shared with chip_smoke.py and the
# variant probe: the llm_bench decoder's serving step, its full context and
# batch 64; every n_rep at D 64 and 128; zero, clamped and ragged lengths
DECODE_CASES = vp.decode_cases()


def _check_decode_launch(fn, run, dtype, atol, rtol):
    """One kernel launch against the plain version; a second launch gives
    the same bits."""
    n = fn.launches
    got = run(None)
    assert fn.launches == n + 1
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), run(False).float(), atol=atol, rtol=rtol)
    assert torch.equal(got, run(None))  # no atomics: bitwise repeatable
    return got


@pytest.mark.parametrize("case", list(DECODE_CASES))
@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
def test_paged_decode_kernel_cases_match_plain(cuda, case, dtype, atol, rtol):
    g = torch.Generator(device=cuda).manual_seed(8)
    q, kp, vp_, tables, ln = vp.decode_inputs(True, *DECODE_CASES[case], dtype, g)
    got = _check_decode_launch(
        tdec.paged_decode_attention,
        lambda k: tdec.paged_decode_attention(q, kp, vp_, tables, ln, use_kernel=k),
        dtype, atol, rtol)
    assert not got[ln == 0].any()  # an empty row gives zeros


@pytest.mark.parametrize("case", list(DECODE_CASES))
@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
def test_decode_kernel_cases_match_plain(cuda, case, dtype, atol, rtol):
    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v, ln = vp.decode_inputs(False, *DECODE_CASES[case], dtype, g)
    got = _check_decode_launch(
        tdec.decode_attention, lambda kern: tdec.decode_attention(q, k, v, ln, use_kernel=kern),
        dtype, atol, rtol)
    assert not got[ln == 0].any()


@pytest.mark.parametrize("case", ["main", "zero_and_ragged"])
@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
def test_paged_decode_kernel_never_reads_the_garbage_page(cuda, case, dtype, atol, rtol):
    """Page 0 full of NaN: the output is finite and equals the plain version
    on the same pool with page 0 zeroed."""
    g = torch.Generator(device=cuda).manual_seed(8)
    q, kp, vp_, tables, ln = vp.decode_inputs(True, *DECODE_CASES[case], dtype, g)
    kp[0], vp_[0] = float("nan"), float("nan")
    got = tdec.paged_decode_attention(q, kp, vp_, tables, ln)
    assert torch.isfinite(got).all()
    kp[0], vp_[0] = 0.0, 0.0
    want = tdec.paged_decode_attention(q, kp, vp_, tables, ln, use_kernel=False)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 16)])
@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
def test_flash_kernel_matches_plain(cuda, causal, window, dtype, atol, rtol):
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(2, 4, 77, 64, generator=g, device=cuda).to(dtype) for _ in range(3))
    o, lse = tattn.flash_attention_with_lse(q, k, v, None, causal, window=window)
    po, plse = tattn.flash_attention_with_lse(q, k, v, None, causal, window=window, use_kernel=False)
    torch.testing.assert_close(o.float(), po.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-5)


BWD_CASES = {  # (B, H, Tq, Tk, D, causal, window)
    "ragged_causal": (2, 4, 77, 77, 64, True, None),
    "noncausal_tq_ne_tk": (2, 4, 37, 100, 64, False, None),
    "window_causal_d128": (1, 4, 200, 200, 128, True, 16),
    "window_noncausal_empty_rows": (1, 4, 150, 60, 64, False, 40),  # rows >= 99 see no key
}


@pytest.mark.parametrize("case", list(BWD_CASES))
@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
def test_flash_backward_kernels_match_plain(cuda, case, dtype, atol, rtol):
    B, H, Tq, Tk, D, causal, window = BWD_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(3)
    q, g_out = (torch.randn(B, H, Tq, D, generator=g, device=cuda).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, H, Tk, D, generator=g, device=cuda).to(dtype) for _ in range(2))
    g_lse = torch.randn(B, H, Tq, generator=g, device=cuda)
    out, lse = tattn.flash_attention_with_lse(q, k, v, None, causal, window=window)
    args = (q, k, v, out, lse, g_out, g_lse, D ** -0.5, causal, window)
    n = (tattn.flash_attention_backward_dq.launches, tattn.flash_attention_backward_dkv.launches)
    got = tattn._flash_backward_kernel(*args)
    assert (tattn.flash_attention_backward_dq.launches,
            tattn.flash_attention_backward_dkv.launches) == (n[0] + 1, n[1] + 1)
    want = tattn._flash_backward_plain(*args)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and torch.isfinite(a).all(), name
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol, msg=name)
    again = tattn._flash_backward_kernel(*args)
    for a, b in zip(got, again):
        assert torch.equal(a, b)  # no atomics: bitwise deterministic


WGMMA_CASES = {  # (B, H, Tq, Tk, D, causal, window)
    "serving_prefill": (1, 16, 64, 64, 64, True, None),
    "t1024_d128": (1, 2, 1024, 1024, 128, True, None),
    "ragged_causal": (2, 4, 77, 77, 64, True, None),
    "noncausal_tq_ne_tk": (2, 4, 37, 100, 64, False, None),
    "window_causal": (2, 4, 77, 77, 64, True, 16),
    "window_causal_d128": (1, 4, 200, 200, 128, True, 16),
    "window_noncausal_empty_rows": (1, 4, 150, 60, 64, False, 40),  # rows >= 99 see no key
    # the ViT train step's length (196 patches and the CLS token): a 5-row
    # second query block and a 5-key tail tile
    "vit_noncausal": (2, 4, 197, 197, 64, False, None),
}


def _moved(fn, before):
    return {r: n - before[r] for r, n in fn.launches_by_route.items() if n != before[r]}


@pytest.mark.parametrize("case", list(WGMMA_CASES))
def test_tensor_core_route_matches_plain(cuda, case):
    """K3, K4 and K5 on bf16 inputs take the wgmma route and agree with their
    plain versions; two launches give the same bits; the same inputs in f32
    move only the scalar route's counters."""
    B, H, Tq, Tk, D, causal, window = WGMMA_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(7)
    q, g_out = (torch.randn(B, H, Tq, D, generator=g, device=cuda).bfloat16() for _ in range(2))
    k, v = (torch.randn(B, H, Tk, D, generator=g, device=cuda).bfloat16() for _ in range(2))
    g_lse = torch.randn(B, H, Tq, generator=g, device=cuda)
    fwd, dkv = tattn.flash_attention_with_lse, tattn.flash_attention_backward_dkv
    dqk = tattn.flash_attention_backward_dq

    before = dict(fwd.launches_by_route)
    o, lse = fwd(q, k, v, None, causal, window=window)
    assert _moved(fwd, before) == {"wgmma_bf16": 1}
    po, plse = fwd(q, k, v, None, causal, window=window, use_kernel=False)
    torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-5)
    o2, lse2 = fwd(q, k, v, None, causal, window=window)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)

    args = (q, k, v, g_out, plse, tattn._delta(po, g_out, g_lse), D ** -0.5, causal, window)
    before = dict(dkv.launches_by_route)
    dk, dv = dkv(*args)
    assert _moved(dkv, before) == {"wgmma_bf16": 1}
    for name, a, b in zip(("dk", "dv"), (dk, dv), tattn._bwd_dkv_plain(*args)):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all(), name
        torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=2e-2, msg=name)
    dk2, dv2 = dkv(*args)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)  # no atomics

    before = dict(dqk.launches_by_route)
    dq = dqk(*args)
    assert _moved(dqk, before) == {"wgmma_bf16": 1}
    assert dq.dtype == torch.bfloat16 and torch.isfinite(dq).all()
    torch.testing.assert_close(dq.float(), tattn._bwd_dq_plain(*args).float(), atol=2e-2,
                               rtol=2e-2)
    assert torch.equal(dq, dqk(*args))  # each block owns its rows: no atomics

    before = dict(fwd.launches_by_route), dict(dkv.launches_by_route), dict(dqk.launches_by_route)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g_out))
    of, lsef = fwd(qf, kf, vf, None, causal, window=window)
    argsf = (qf, kf, vf, gf, lsef, tattn._delta(of, gf, g_lse), D ** -0.5, causal, window)
    dkv(*argsf)
    dqk(*argsf)
    assert (_moved(fwd, before[0]) == _moved(dkv, before[1]) == _moved(dqk, before[2])
            == {"simt_f32": 1})


@pytest.mark.parametrize("causal,window,D", [(True, None, 64), (False, 16, 128)])
@pytest.mark.parametrize("scale", [0.0, -0.125])
def test_tensor_core_forward_and_backward_take_any_scale(cuda, scale, causal, window, D):
    """The bf16 forward flips Q's sign in shared memory for a negative scale
    (so each row's max is still taken on the raw scores) and takes a zero
    one as the least normal float; forward, lse and the two backward kernels
    match their plain versions on the tensor-core route."""
    g = torch.Generator(device=cuda).manual_seed(10)
    q, g_out = (torch.randn(2, 4, 77, D, generator=g, device=cuda).bfloat16() for _ in range(2))
    k, v = (torch.randn(2, 4, 77, D, generator=g, device=cuda).bfloat16() for _ in range(2))
    g_lse = torch.randn(2, 4, 77, generator=g, device=cuda)
    fwd = tattn.flash_attention_with_lse
    before = dict(fwd.launches_by_route)
    o, lse = fwd(q, k, v, scale, causal, window=window)
    assert _moved(fwd, before) == {"wgmma_bf16": 1}
    po, plse = fwd(q, k, v, scale, causal, window=window, use_kernel=False)
    torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-5)
    args = (q, k, v, o, lse, g_out, g_lse, scale, causal, window)
    got = tattn._flash_backward_kernel(*args)
    want = tattn._flash_backward_plain(*args)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=2e-2, msg=name)


INT8_SHAPES = {  # (M, K, N): the decode and prefill products, the row tiles, ragged edges
    "decode_wk": (8, 1024, 512), "decode_w2": (8, 4096, 1024), "m1": (1, 1024, 1024),
    "m16": (16, 1024, 4096), "m63": (63, 1024, 4096), "m64": (64, 1024, 4096),
    "m65": (65, 1024, 4096), "m200": (200, 1024, 4096), "m32_w2": (32, 4096, 1024),
    "ragged": (100, 300, 50), "ragged_k": (20, 328, 512), "ragged_n": (20, 256, 1000),
    # wide outputs: the 8- and 16-byte loads at each row tile (on 132 SMs)
    "m8_n8448": (8, 256, 8448), "m8_n16896": (8, 256, 16896), "m16_n8448": (16, 256, 8448),
    "m16_n16896": (16, 256, 16896), "m32_n8448": (32, 256, 8448), "m32_n16896": (32, 256, 16896),
}


@pytest.mark.parametrize("case", list(INT8_SHAPES))
@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
def test_int8_matmul_kernel_matches_plain(cuda, case, dtype, atol, rtol):
    """K6 on the route ``matmul_route`` gives (bf16 with N % 16 == 0 and
    K % 8 == 0: tensor cores; f32 and ragged shapes: scalar) and, where the
    wrapper took the tensor cores, on the scalar route too."""
    M, K, N = INT8_SHAPES[case]
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(M, K, generator=g, device=cuda).to(dtype)
    w = torch.randn(K, N, generator=g, device=cuda)
    w[:, 3] = 0  # a zero column: scale 1, int8 zeros
    w_q, scales = tq.quantize_int8(w, axis=0)
    route = tq.matmul_route(dtype, M, K, N)
    assert route == ("mma_bf16" if dtype == torch.bfloat16 and N % 16 == 0 and K % 8 == 0
                     else "simt")
    n, before = tq.int8_matmul.launches, dict(tq.int8_matmul.launches_by_route)
    got = tq.int8_matmul(x, w_q, scales)
    assert tq.int8_matmul.launches == n + 1 and got.dtype == dtype
    assert _moved(tq.int8_matmul, before) == {route: 1}
    want = tq._int8_matmul_plain(x, w_q, scales, dtype)
    if dtype == torch.float32:
        atol = 1e-5 * float(want.abs().max())
    outs = [got]
    if route != "simt":
        outs.append(tq._int8_matmul_cuda(x, w_q, scales.reshape(N), dtype, route="simt"))
    for y in outs:
        torch.testing.assert_close(y.float(), want.float(), atol=atol, rtol=rtol)
        assert not y[:, 3].any()
    assert torch.equal(got, tq.int8_matmul(x, w_q, scales))  # no atomics


def test_int8_matmul_kernel_refuses_a_route_that_does_not_take_the_input(cuda):
    """No fallback inside the kernel: f32 x forced onto the tensor-core route
    raises instead of launching."""
    x = torch.randn(8, 64, device=cuda)
    w_q, s = tq.quantize_int8(torch.randn(64, 32, device=cuda), axis=0)
    n = tq.int8_matmul.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        tq._int8_matmul_cuda(x, w_q, s.reshape(-1), torch.float32, route="mma_bf16")
    assert tq.int8_matmul.launches == n


def test_train_step_on_gpu_matches_cpu(cuda):
    """One AdamW step through K3, K4 and K5 (GQA, remat "dots") against the
    same step on the CPU's plain versions, f32: loss atol 1e-4, the first
    moment (0.1 x the gradient) atol 1e-5."""
    from ray_tpu_torch.models import transformer as ttr

    cfg = ttr.TransformerConfig(vocab_size=97, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1,
                                d_ff=256, dtype=torch.float32, remat="dots")
    params = ttr.init_params(cfg, torch.Generator().manual_seed(5))
    tokens = torch.randint(0, 97, (2, 77), generator=torch.Generator().manual_seed(6))
    out = {}
    for dev in ("cpu", "cuda"):
        _, train_step = ttr.make_train_step(cfg, device=dev)
        state = ttr.new_train_state(
            ttr._rebuild(params, [t.to(dev, copy=True) for t in ttr._leaves(params)]))
        counters = (tattn.flash_attention_with_lse, tattn.flash_attention_backward_dq,
                    tattn.flash_attention_backward_dkv)
        n = [f.launches for f in counters]
        state, loss = train_step(state, tokens)
        launched = [f.launches - m for f, m in zip(counters, n)]
        assert launched == ([0, 0, 0] if dev == "cpu" else [4, 2, 2])  # K3 again in the recompute
        out[dev] = (float(loss), ttr._leaves(state["opt"]["mu"]))
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=0)


def test_bf16_train_step_matches_dense_attention_on_gpu(cuda):
    """One AdamW step in bf16 activations through K3, K4 and K5 on the tensor
    cores against the same step with the einsum attention on the card: loss
    atol 2e-2 (bf16 activations; P and dS rounded to bf16)."""
    import dataclasses

    from ray_tpu_torch.models import transformer as ttr

    cfg = ttr.TransformerConfig(vocab_size=97, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1,
                                d_ff=256, dtype=torch.bfloat16, remat="dots")
    params = ttr.init_params(cfg, torch.Generator().manual_seed(5))
    tokens = torch.randint(0, 97, (2, 77), generator=torch.Generator().manual_seed(6)).to(cuda)
    fwd, dkv = tattn.flash_attention_with_lse, tattn.flash_attention_backward_dkv
    dqk = tattn.flash_attention_backward_dq
    loss = {}
    for attention in ("flash", "dense"):
        _, train_step = ttr.make_train_step(dataclasses.replace(cfg, attention=attention),
                                             device=cuda)
        state = ttr.new_train_state(
            ttr._rebuild(params, [t.to(cuda, copy=True) for t in ttr._leaves(params)]))
        before = [dict(f.launches_by_route) for f in (fwd, dkv, dqk)]
        state, loss[attention] = train_step(state, tokens)
        moved = tuple(_moved(f, b) for f, b in zip((fwd, dkv, dqk), before))
        assert moved == (({"wgmma_bf16": 4}, {"wgmma_bf16": 2}, {"wgmma_bf16": 2})
                         if attention == "flash" else ({}, {}, {}))  # K3 again in the recompute
        assert torch.isfinite(loss[attention])
    assert abs(float(loss["flash"]) - float(loss["dense"])) <= 2e-2


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("cache_kind", ["paged", "dense"])
def test_engine_on_gpu_matches_engine_on_cpu(cuda, cache_kind, quantize):
    """Greedy tokens through the kernels equal the plain path's on the CPU
    (f32, head_dim 64 so the kernels take it); with ``quantize`` every layer
    linear is int8 and six of them a layer run K6."""
    from ray_tpu_torch.models.transformer import TransformerConfig, init_params
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = TransformerConfig(vocab_size=97, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1,
                            d_ff=256, dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(5))
    prompts = [[3, 5, 7, 11, 13], [2] * 17, list(range(1, 31)), [8, 9]]
    out = {}
    for dev in ("cpu", "cuda"):
        eng = LLMEngine(cfg, params, device=dev, max_batch_size=4, max_seq_len=64,
                        cache_kind=cache_kind, quantize=quantize)
        n = tq.int8_matmul.launches
        try:
            out[dev] = [f.result(timeout=120) for f in [eng.submit(p, max_tokens=8) for p in prompts]]
        finally:
            eng.shutdown()
        assert (tq.int8_matmul.launches > n) == (quantize and dev == "cuda")
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("cache_kind", ["paged", "dense"])
def test_moe_engine_on_gpu_matches_engine_on_cpu(cuda, cache_kind, quantize):
    """A MoE config (4 experts, top-2, dense dispatch) served through the
    kernels gives the plain path's greedy tokens on the CPU (f32); with
    ``quantize`` K6 runs wq, wk and wv, and the router and the experts are
    dequantized."""
    from ray_tpu_torch.models.transformer import TransformerConfig, init_params
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = TransformerConfig(vocab_size=97, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1,
                            d_ff=256, num_experts=4, expert_top_k=2, dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(8))
    prompts = [[3, 5, 7, 11, 13], [2] * 17, list(range(1, 31)), [8, 9]]
    decode = tdec.paged_decode_attention if cache_kind == "paged" else tdec.decode_attention
    out = {}
    for dev in ("cpu", "cuda"):
        eng = LLMEngine(cfg, params, device=dev, max_batch_size=4, max_seq_len=64,
                        cache_kind=cache_kind, quantize=quantize)
        n, d = tq.int8_matmul.launches, decode.launches
        try:
            out[dev] = [f.result(timeout=120) for f in [eng.submit(p, max_tokens=8) for p in prompts]]
        finally:
            eng.shutdown()
        assert (decode.launches > d) == (dev == "cuda")
        assert (tq.int8_matmul.launches > n) == (quantize and dev == "cuda")
    assert out["cuda"] == out["cpu"]


_PAIR_CFG = dict(vocab_size=97, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1, d_ff=256)
_PAIR_PROMPTS = [[3, 5, 7, 11, 13], [2] * 17, list(range(1, 31)), [8, 9] * 20]


def _pair_migrate(p_eng, d_eng, prompt, mig_id, max_tokens):
    """Export on ``p_eng``, pull the blocks ``d_eng`` lacks, adopt:
    ``(tokens, rungs)``."""
    from ray_tpu_torch.serve import disagg

    ticket = p_eng.prefill_export(prompt, mig_id=mig_id).result(timeout=120)
    matched = d_eng.peek_prefix_match(prompt)
    arrays, rungs = {}, []
    for bidx in range(matched // d_eng.kv_block_size, ticket["n_blocks"]):
        arrays[bidx], rung = disagg.pull_block(ticket, bidx)
        rungs.append(rung)
    out = d_eng.adopt_migration(ticket, arrays, max_tokens=max_tokens).future.result(timeout=120)
    return out, rungs


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_prefill_decode_pair_on_gpu_matches_colocated(cuda, dtype, quantize):
    """A prefill engine and a decode engine on the card, blocks migrated in
    process: the decode engine's greedy tokens equal one co-located engine's
    (the same arithmetic on the same blocks), every rung is the in-process
    one, K1 runs on the decode engine only, and neither engine leaks a page."""
    from ray_tpu_torch.models.transformer import TransformerConfig, init_params
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = TransformerConfig(**_PAIR_CFG, dtype=dtype)
    params = init_params(cfg, torch.Generator().manual_seed(5))
    kw = dict(device="cuda", max_batch_size=4, max_seq_len=64, quantize=quantize)
    co = LLMEngine(cfg, params, **kw)
    p_eng = LLMEngine(cfg, params, role="prefill", **kw)
    d_eng = LLMEngine(cfg, params, role="decode", **kw)
    try:
        ref = [co.generate(p, max_tokens=8) for p in _PAIR_PROMPTS]
        k1, k6 = tdec.paged_decode_attention.launches, tq.int8_matmul.launches
        tickets = [p_eng.prefill_export(p, mig_id=f"pair/{i}").result(timeout=120)
                   for i, p in enumerate(_PAIR_PROMPTS)]
        assert tdec.paged_decode_attention.launches == k1  # no decode on the prefill side
        assert (tq.int8_matmul.launches > k6) == quantize
        for i, (p, ticket) in enumerate(zip(_PAIR_PROMPTS, tickets)):
            assert ticket["block_dtype"] == str(dtype).removeprefix("torch.")
            assert p_eng.release_migration(f"pair/{i}")
        got = [_pair_migrate(p_eng, d_eng, p, f"pair/b{i}", 8) for i, p in enumerate(_PAIR_PROMPTS)]
        assert [g[0] for g in got] == ref
        assert {r for g in got for r in g[1]} == {"host"}
        assert tdec.paged_decode_attention.launches > k1
        for i in range(len(_PAIR_PROMPTS)):
            p_eng.release_migration(f"pair/b{i}")
        for eng in (p_eng, d_eng):
            st = eng.stats()
            assert st["kv_blocks_in_use"] == st["prefix_cache_blocks"]
            eng.flush_prefix_cache()
            assert eng.stats()["kv_blocks_in_use"] == 0
    finally:
        for eng in (co, p_eng, d_eng):
            eng.shutdown()


def _prefill_worker(cfg, seed, prompts, conn):
    """The prefill engine of another process: export every prompt, send the
    tickets, keep the staged blocks until the parent names the migrations
    to release, then report and exit."""
    from ray_tpu_torch.models.transformer import init_params
    from ray_tpu_torch.runtime import device_plane
    from ray_tpu_torch.serve.llm import LLMEngine

    eng = LLMEngine(cfg, init_params(cfg, torch.Generator().manual_seed(seed)), device="cuda",
                    max_batch_size=4, max_seq_len=64, role="prefill")
    try:
        conn.send([eng.prefill_export(p, mig_id=f"ipc/{i}").result(timeout=120)
                   for i, p in enumerate(prompts)])
        for mig_id in conn.recv():
            eng.release_migration(mig_id)
        conn.send({"pulls_served": device_plane.transfer_server().pulls_served,
                   "staged_left": device_plane.transfer_server().staged_count(),
                   **eng.stats()})
    finally:
        eng.shutdown()


def test_cuda_ipc_rung_across_a_spawned_process(cuda):
    """The prefill engine lives in a spawned child; this process's decode
    engine pulls every block over the transfer server (CUDA IPC), all over
    one connection: the rung is ``"device"``, the tokens equal a co-located
    engine's here."""
    import multiprocessing

    from ray_tpu_torch.models.transformer import TransformerConfig, init_params
    from ray_tpu_torch.runtime import device_plane
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = TransformerConfig(**_PAIR_CFG, dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(5))
    co = LLMEngine(cfg, params, device="cuda", max_batch_size=4, max_seq_len=64)
    d_eng = LLMEngine(cfg, params, device="cuda", max_batch_size=4, max_seq_len=64,
                      role="decode")
    ctx = multiprocessing.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=_prefill_worker, args=(cfg, 5, _PAIR_PROMPTS, child), daemon=True)
    proc.start()
    try:
        assert isinstance(device_plane.transfer_server(), device_plane.CudaIpcTransferServer)
        ref = [co.generate(p, max_tokens=8) for p in _PAIR_PROMPTS]
        assert parent.poll(300), "the prefill process sent no tickets"
        tickets = parent.recv()
        from ray_tpu_torch.serve import disagg

        out, rungs = [], []
        connects = device_plane.stats.snapshot()["connects"]
        for t in tickets:
            assert t["transfer_addr"] and t["transfer_addr"] != device_plane.transfer_address()
            arrays = {}
            for b in range(t["n_blocks"]):
                arrays[b], rung = disagg.pull_block(t, b)
                assert arrays[b].device.type == "cuda"
                rungs.append(rung)
            out.append(d_eng.adopt_migration(t, arrays, max_tokens=8).future.result(timeout=120))
        assert set(rungs) == {"device"}
        assert device_plane.stats.snapshot()["connects"] == connects + 1  # one for every block
        assert out == ref
        parent.send([t["mig_id"] for t in tickets])
        assert parent.poll(120)
        report = parent.recv()
        assert report["pulls_served"] == len(rungs) and report["staged_left"] == 0
        assert report["migrations_out"] == len(tickets) and report["staged_migrations"] == 0
    finally:
        proc.join(timeout=60)
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=10)
        co.shutdown()
        d_eng.shutdown()
    assert proc.exitcode == 0


def test_server_without_device_lands_on_cuda(cuda):
    from ray_tpu_torch.models.transformer import TransformerConfig, init_params
    from ray_tpu_torch.serve.llm import LLMServer

    cfg = TransformerConfig(**_PAIR_CFG, dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(5))
    srv = LLMServer(lambda: (cfg, params), max_batch_size=2, max_seq_len=64)
    try:
        assert srv.engine.device.type == "cuda"
        assert srv.engine.params["embed"].device.type == "cuda"
        n = tdec.paged_decode_attention.launches
        resp = srv({"prompt": [3, 5, 7], "max_tokens": 4})
        assert len(resp["tokens"]) == 4 and tdec.paged_decode_attention.launches > n
    finally:
        srv.engine.shutdown()


def _vit_cfg(dtype, attention="auto"):
    from ray_tpu_torch.models.vit import ViTConfig

    # 16 patches and the CLS token; head_dim 64, as the kernels take it
    return ViTConfig(image_size=32, patch_size=8, channels=3, num_classes=10, d_model=128,
                     n_layers=2, n_heads=2, d_ff=256, dtype=dtype, attention=attention)


def _vit_step(cfg, dev, params, images, labels):
    """One ViT AdamW step on ``dev`` from a copy of ``params``: (loss, the
    first moments, the attention kernels' launches by route)."""
    from ray_tpu_torch.models import transformer as ttr
    from ray_tpu_torch.models.vit import make_vit_train_step

    _, train_step = make_vit_train_step(cfg, device=dev)
    state = ttr.new_train_state(
        ttr._rebuild(params, [t.to(dev, copy=True) for t in ttr._leaves(params)]))
    fns = (tattn.flash_attention_with_lse, tattn.flash_attention_backward_dq,
           tattn.flash_attention_backward_dkv)
    before = [dict(f.launches_by_route) for f in fns]
    state, loss = train_step(state, images, labels)
    torch.cuda.synchronize()
    return loss, ttr._leaves(state["opt"]["mu"]), [_moved(f, b) for f, b in zip(fns, before)]


def test_vit_train_step_on_gpu_matches_cpu(cuda):
    """One ViT AdamW step through K3, K4 and K5 non-causal (f32: the scalar
    route) against the same step on the CPU's plain versions: loss atol
    1e-4, the first moment atol 1e-5."""
    from ray_tpu_torch.models.vit import init_vit_params

    cfg = _vit_cfg(torch.float32)
    params = init_vit_params(cfg, torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    images, labels = torch.randn(4, 32, 32, 3, generator=g), torch.randint(0, 10, (4,), generator=g)
    out = {dev: _vit_step(cfg, dev, params, images, labels) for dev in ("cpu", "cuda")}
    assert out["cpu"][2] == [{}, {}, {}]
    assert out["cuda"][2] == [{"simt_f32": 2}] * 3  # once a layer each, no recompute
    assert abs(float(out["cuda"][0]) - float(out["cpu"][0])) <= 1e-4
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=0)


def test_bf16_vit_train_step_matches_dense_attention_on_gpu(cuda):
    """The same step in bf16 activations, K3, K4 and K5 on the tensor cores,
    against the einsum attention on the card: loss atol 2e-2."""
    from ray_tpu_torch.models.vit import init_vit_params

    params = init_vit_params(_vit_cfg(torch.bfloat16), torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    images, labels = torch.randn(4, 32, 32, 3, generator=g), torch.randint(0, 10, (4,), generator=g)
    flash = _vit_step(_vit_cfg(torch.bfloat16, "flash"), cuda, params, images, labels)
    dense = _vit_step(_vit_cfg(torch.bfloat16, "dense"), cuda, params, images, labels)
    assert flash[2] == [{"wgmma_bf16": 2}] * 3 and dense[2] == [{}, {}, {}]
    assert torch.isfinite(flash[0]) and abs(float(flash[0]) - float(dense[0])) <= 2e-2


@pytest.mark.parametrize("target", ["dq", "int8", "paged", "dense"])
def test_variant_probe_builds_checks_and_times_the_source_as_it_stands(cuda, target, capsys):
    """``python -m ray_tpu_torch.ops.variant_probe <target> base:`` builds the
    source, reports its registers and spills, holds it against the plain
    version and prints timed lines."""
    import json

    assert vp.main([target, "base:"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert lines and not [ln for ln in lines if "failed" in ln]
    assert all(ln["variant"] == "base" and ln["card"] for ln in lines)
    built = [ln for ln in lines if "max_registers" in ln]
    assert len(built) == 1 and built[0]["max_registers"] > 0
    if target in ("paged", "dense"):
        assert built[0]["spill_bytes"] == 0
    timed = [ln for ln in lines if "max_registers" not in ln]
    assert timed and all(ln.get("ms", ln.get("cold_ms")) > 0 for ln in timed)


# --------------------------------------------------------------------------
# the parallel layer: two ranks sharing the card over gloo
# --------------------------------------------------------------------------
def _ring_rank():
    """Ring attention on 2 ranks, causal bf16: launches, and (rank 0) the
    gathered output and gradients against flash attention on the full
    tensors in one process."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import MeshManager, collective, gather_array, shard_array
    from ray_tpu_torch.parallel import ring_attention_sharded

    mesh = MeshManager().create_mesh({"sp": 2})
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g_out = (torch.randn(2, 4, 256, 64, generator=g, device="cuda").to(torch.bfloat16)
                      for _ in range(4))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    fns = (tattn.flash_attention_with_lse, tattn.flash_attention_backward_dq,
           tattn.flash_attention_backward_dkv)
    before = [f.launches_by_route["wgmma_bf16"] for f in fns]
    out = ring_attention_sharded(*ins, mesh, "sp", causal=True)
    with mesh:
        out.backward(shard_array(g_out, mesh, None, None, "sp", None))
        grads = [collective.allreduce(t.grad.float(), "sp") for t in ins]
    launches = [f.launches_by_route["wgmma_bf16"] - b for f, b in zip(fns, before)]
    full = gather_array(out.detach(), mesh, None, None, "sp", None)
    if dist.get_rank():
        return launches, None
    ref_ins = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = tattn.flash_attention(*ref_ins, None, True)
    ref.backward(g_out)
    torch.testing.assert_close(full.float(), ref.detach().float(), atol=2e-2, rtol=2e-2)
    rel = [float(torch.linalg.vector_norm(a - r.grad.float()) / torch.linalg.vector_norm(
        r.grad.float())) for a, r in zip(grads, ref_ins)]
    return launches, rel


def test_ring_attention_on_two_ranks_sharing_the_card(cuda):
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.parallel import run_ranks

    _build.build_all()  # the ranks load the libraries, never race to build them
    (l0, rel), (l1, _) = run_ranks(_ring_rank, 2, timeout_s=300, device="cuda", backend="gloo")
    assert l0 == [1, 1, 1] and l1 == [2, 2, 2]  # rank r: r full steps and the diagonal
    assert max(rel) <= 2e-2, rel


SHARDED_CFG = dict(vocab_size=256, d_model=256, n_layers=2, n_heads=4, d_ff=512,
                   max_seq_len=128, remat="dots")


def _train_rank(attention, axes):
    from ray_tpu_torch.models.transformer import TransformerConfig, make_train_step
    from ray_tpu_torch.parallel import MeshManager

    cfg = TransformerConfig(**SHARDED_CFG, attention=attention, dtype=torch.float32)
    mesh = MeshManager().create_mesh(axes)
    init_state, step = make_train_step(cfg, mesh=mesh)
    state = init_state(0)
    tokens = torch.randint(0, 256, (4, 128), generator=torch.Generator().manual_seed(1))
    local = step.shard_batch(tokens)
    return [float(step(state, local)[1]) for _ in range(3)]


@pytest.mark.parametrize("attention,axes", [("ring", {"sp": 2}), ("flash", {"tp": 2})],
                         ids=["ring_sp2", "flash_tp2"])
def test_sharded_train_step_on_two_ranks_matches_one_device(cuda, attention, axes):
    """f32 (the kernels' scalar route): 3 steps' losses within 1e-5
    relative of one device's (the order of the shards' sums differs)."""
    from ray_tpu_torch.models.transformer import TransformerConfig, make_train_step
    from ray_tpu_torch.parallel import run_ranks

    cfg = TransformerConfig(**SHARDED_CFG, attention="flash", dtype=torch.float32)
    init_state, step = make_train_step(cfg)
    state = init_state(0)
    tokens = torch.randint(0, 256, (4, 128), generator=torch.Generator().manual_seed(1))
    want = [float(step(state, tokens)[1]) for _ in range(3)]
    for losses in run_ranks(_train_rank, 2, attention, axes, timeout_s=300, device="cuda",
                            backend="gloo"):
        for got, ref in zip(losses, want):
            assert abs(got - ref) <= 1e-5 * abs(ref), (losses, want)


TP_CFG = dict(vocab_size=256, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=512,
              max_seq_len=64, attention="dense")


def _tp_engine_rank():
    """The tensor-parallel engine on ranks sharing the card: rank 0 serves
    two prompts (greedy, f32) and counts its kernels' launches; rank 1
    follows."""
    import torch.distributed as dist

    from ray_tpu_torch.models.transformer import TransformerConfig, init_params
    from ray_tpu_torch.parallel import MeshManager
    from ray_tpu_torch.serve.llm import LLMEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransformerConfig(**TP_CFG, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    fns = (tdec.paged_decode_attention, tdec.decode_attention, tattn.flash_attention_with_lse,
           tq.int8_matmul)
    before = [f.launches for f in fns]
    eng = LLMEngine(cfg, params, device="cuda", max_batch_size=2, max_seq_len=64,
                    mesh=MeshManager().create_mesh({"tp": 2}))
    if dist.get_rank():
        eng.follow()
        return None
    try:
        out = [eng.generate(p, max_tokens=6) for p in ([3, 14, 15], [7, 8])]
    finally:
        eng.shutdown()
    return out, [f.launches - b for f, b in zip(fns, before)]


def test_tp_engine_on_two_ranks_sharing_the_card_matches_one_device(cuda):
    """``LLMEngine(mesh=)`` on 2 gloo ranks of the card: the single-device
    dense engine's greedy tokens (f32, TF32 off), and no kernel launched on
    the tp path, as the JAX engine under a mesh."""
    from ray_tpu_torch.models.transformer import TransformerConfig, init_params
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.parallel import run_ranks
    from ray_tpu_torch.serve.llm import LLMEngine

    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransformerConfig(**TP_CFG, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    one = LLMEngine(cfg, params, device="cuda", max_batch_size=2, max_seq_len=64,
                    cache_kind="dense")
    try:
        want = [one.generate(p, max_tokens=6) for p in ([3, 14, 15], [7, 8])]
    finally:
        one.shutdown()
    (got, launches), follower = run_ranks(_tp_engine_rank, 2, timeout_s=300, device="cuda",
                                          backend="gloo")
    assert got == want and launches == [0, 0, 0, 0] and follower is None


# --------------------------------------------------------------------------
# the host runtime's device seams (ray_tpu_torch.api on the card)
# --------------------------------------------------------------------------
@pytest.fixture
def runtime(cuda):
    import ray_tpu_torch as rt

    yield rt
    rt.shutdown()


def test_init_detects_the_card_and_a_gpu_actor_lives_in_process(runtime):
    import os

    from torch_runtime_tasks import Counter

    runtime.init(num_cpus=2)
    assert runtime.cluster_resources()["GPU"] == torch.cuda.device_count()
    assert "TPU" not in runtime.cluster_resources()
    actor = runtime.remote(Counter).options(num_gpus=1).remote(0)
    assert runtime.get(actor.pid.remote()) == os.getpid()
    assert runtime.available_resources().get("GPU", 0) == torch.cuda.device_count() - 1
    runtime.kill(actor)


def test_device_tier_holds_a_cuda_tensor_and_spills_it_to_the_host(runtime):
    nbytes = 1 << 20
    runtime.init(num_cpus=2, _system_config={"object_store_hbm_bytes": 3 * nbytes})
    store = runtime.get_cluster().head_node.store
    g = torch.Generator(device="cuda").manual_seed(0)
    xs = [torch.randn(nbytes // 4, generator=g, device="cuda") for _ in range(4)]
    refs = []
    for i, x in enumerate(xs):
        refs.append(runtime.put(x))
        if i == 0:
            assert store.entry_info(refs[0].id())["tier"] == "device"
            assert store.stats()["hbm_used"] == nbytes
            assert runtime.get(refs[0]).data_ptr() == x.data_ptr()  # no copy
    assert store.stats()["spills"] == 1 and store.stats()["hbm_used"] == 3 * nbytes
    back = runtime.get(refs[0])
    assert back.device.type == "cpu" and torch.equal(back, xs[0].cpu())
    assert all(runtime.get(r).is_cuda for r in refs[1:])


def test_cuda_tensor_task_runs_in_process_and_a_process_worker_gets_a_host_copy(runtime):
    import os

    from torch_runtime_tasks import _host_view, _scale

    runtime.init(num_cpus=2)
    x = torch.arange(12.0, device="cuda").reshape(3, 4).to(torch.bfloat16)
    doubled = runtime.get(runtime.remote(_scale).remote(x, 2))  # auto: in process
    assert doubled.is_cuda and torch.equal(doubled, x * 2)
    ref = runtime.put(x)
    assert runtime.get(runtime.remote(_scale).remote(ref, 3)).is_cuda
    kind, dtype, values, cuda_in_worker = runtime.get(
        runtime.remote(_host_view).options(execution="process").remote(x))
    assert (kind, dtype, cuda_in_worker) == ("tensor", "bfloat16", False)
    assert values.tolist() == x.float().cpu().tolist()
    pid = runtime.get(runtime.remote(os.getpid).options(execution="process").remote())
    assert pid != os.getpid()


def test_cuda_tensor_reaches_a_process_worker_through_the_shm_arena(runtime, monkeypatch):
    """A 4 MiB bf16 CUDA tensor given to a process task is written from the
    card straight into the native shm arena (one ``ShmRef``), and the
    worker holds the CPU tensor of the same bits."""
    import os

    from torch_runtime_tasks import _host_view

    from ray_tpu_torch.runtime import protocol

    kinds, real = [], protocol.encode_value

    def spy(value, shm_store, id_factory):
        out = real(value, shm_store, id_factory)
        kinds.append(type(out).__name__)
        return out

    monkeypatch.setattr(protocol, "encode_value", spy)
    runtime.init(num_cpus=2)
    name = runtime.get_cluster().shm_store.name
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(1024, 2048, generator=g, device="cuda").to(torch.bfloat16)
    kind, dtype, values, cuda_in_worker = runtime.get(
        runtime.remote(_host_view).options(execution="process").remote(x))
    assert kinds == ["ShmRef"]
    assert (kind, dtype, cuda_in_worker) == ("tensor", "bfloat16", False)
    assert torch.equal(torch.tensor(values), x.float().cpu())  # values: a read-only view
    runtime.shutdown()
    assert not os.path.exists("/dev/shm" + name)


# --------------------------------------------------------------------------
# the Serve runtime on the card (ray_tpu_torch.serve)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
def test_gpu_replica_serves_through_the_kernels_as_the_cpu_engine(runtime, quantize):
    """``serve.run`` of ``LLMServer`` with ``num_gpus=1`` and no ``device``:
    the replica is an in-process GPU actor whose engine runs K1 (and K6
    under ``quantize``) on the card; greedy tokens over the handle and over
    HTTP equal the same engine's on the CPU."""
    import json
    import urllib.request

    from ray_tpu_torch import serve
    from ray_tpu_torch.models.transformer import TransformerConfig, init_params
    from ray_tpu_torch.serve.llm import LLMEngine, LLMServer

    cfg = TransformerConfig(vocab_size=97, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1,
                            d_ff=256, dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(5))
    prompts = [[3, 5, 7, 11, 13], [2] * 17, list(range(1, 31))]
    eng = LLMEngine(cfg, params, device="cpu", max_batch_size=4, max_seq_len=64,
                    cache_kind="paged", quantize=quantize)
    try:
        want = [eng.generate(p, max_tokens=8) for p in prompts]
    finally:
        eng.shutdown()
    runtime.init(num_cpus=4)
    try:
        serve.start(http_port=0)
        app = serve.deployment(LLMServer, ray_actor_options={"num_gpus": 1}).bind(
            lambda: (cfg, params), max_batch_size=4, max_seq_len=64, cache_kind="paged",
            quantize=quantize)
        handle = serve.run(app, route_prefix="/llm")
        k1, k6 = tdec.paged_decode_attention.launches, tq.int8_matmul.launches
        got = [handle.remote({"prompt": p, "max_tokens": 8}).result(timeout=120)["tokens"]
               for p in prompts]
        assert tdec.paged_decode_attention.launches - k1 >= cfg.n_layers * 7 * len(prompts)
        assert (tq.int8_matmul.launches > k6) == quantize
        req = urllib.request.Request(serve.proxy_url() + "/llm", data=json.dumps(
            {"prompt": prompts[0], "max_tokens": 8}).encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            over_http = json.loads(resp.read())["tokens"]
        assert runtime.available_resources().get("GPU", 0) == torch.cuda.device_count() - 1
    finally:
        serve.shutdown()
    assert got == want and over_http == want[0]


def test_gpu_replicas_share_the_card_in_a_split_deployment(runtime):
    """A ``roles`` deployment whose replicas ask for half the card each: the
    dispatcher's prefill -> migrate -> decode gives the co-located tokens,
    and K1 runs only in the decode replica's requests."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.models.transformer import TransformerConfig, init_params
    from ray_tpu_torch.serve.llm import LLMEngine, LLMServer

    cfg = TransformerConfig(vocab_size=97, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1,
                            d_ff=256, dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(5))
    prompt = list(range(1, 31))
    eng = LLMEngine(cfg, params, device="cuda", max_batch_size=4, max_seq_len=64)
    try:
        want = eng.generate(prompt, max_tokens=8)
    finally:
        eng.shutdown()
    runtime.init(num_cpus=4)
    try:
        serve.start(http_port=0)
        app = serve.deployment(LLMServer, roles={"prefill": 1, "decode": 1},
                               ray_actor_options={"num_gpus": 0.5}).bind(
            lambda: (cfg, params), max_batch_size=4, max_seq_len=64)
        handle = serve.run(app, route_prefix=None)
        handle._router._refresh(force=True)
        router = handle._router
        p = router.pick_role_replica("LLMServer", "prefill")
        d = router.pick_role_replica("LLMServer", "decode")
        k1 = tdec.paged_decode_attention.launches
        ticket = router.call_replica("LLMServer", p, "disagg_prefill", ({"prompt": prompt}, "t/1"))
        assert tdec.paged_decode_attention.launches == k1
        out = router.call_replica("LLMServer", d, "disagg_decode",
                                  ({"prompt": prompt, "max_tokens": 8}, ticket))
        assert tdec.paged_decode_attention.launches - k1 == cfg.n_layers * 7
        router.call_replica("LLMServer", p, "disagg_release", ("t/1",))
        assert out["tokens"] == want and out["_migration_rung"] == "host"
        assert handle.remote({"prompt": prompt, "max_tokens": 8}).result(timeout=120)[
            "tokens"] == want
    finally:
        serve.shutdown()


# --------------------------------------------------------------------------
# the utilities and the chaos fabric with GPU actors and device-tier objects
# --------------------------------------------------------------------------
class _EngineActor:
    """A GPU actor holding a paged engine; ``steps`` counts its decode steps
    (K1 launches once a layer in each)."""

    def __init__(self, cfg, params):
        from ray_tpu_torch.serve.llm import LLMEngine

        self.engine = LLMEngine(cfg, params, device="cuda", max_batch_size=4, max_seq_len=64)
        self.steps = [0]
        real, steps = self.engine._decode_k_paged, self.steps

        def counted(*args):
            steps[0] += 1
            return real(*args)

        self.engine._decode_k_paged = counted

    def generate(self, prompt, max_tokens):
        return self.engine.generate(prompt, max_tokens=max_tokens)

    def decode_steps(self):
        return self.steps[0]

    def close(self):
        self.engine.shutdown()
        return True


class _Producer:
    def produce(self, queue, n):
        sent = []
        for i in range(n):
            g = torch.Generator(device="cuda").manual_seed(i)
            t = torch.randn(1 << 18, generator=g, device="cuda")
            queue.put(t)
            sent.append((t.data_ptr(), t.cpu()))
        return sent


class _Consumer:
    def consume(self, queue, n):
        return [queue.get(timeout=60) for _ in range(n)]


def test_actor_pool_of_gpu_actors_in_a_placement_group_matches_one_engine(runtime):
    from ray_tpu_torch import util
    from ray_tpu_torch.models.transformer import TransformerConfig, init_params

    cfg = TransformerConfig(vocab_size=97, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1,
                            d_ff=256, dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(5))
    prompts = [[(3 * i + j) % 90 + 1 for j in range(20)] for i in range(4)]
    direct = _EngineActor(cfg, params)
    try:
        want = [direct.generate(p, 6) for p in prompts]
    finally:
        direct.close()
    runtime.init(num_cpus=4)
    free0 = runtime.available_resources()
    pg = util.placement_group([{"GPU": 0.5, "CPU": 1}] * 2, strategy="STRICT_PACK")
    assert pg.wait(30) and runtime.available_resources().get("GPU", 0) == 0
    actors = [runtime.remote(_EngineActor).options(
        num_gpus=0.5, num_cpus=1,
        scheduling_strategy=util.PlacementGroupSchedulingStrategy(pg, i)).remote(cfg, params)
        for i in range(2)]
    k1 = tdec.paged_decode_attention.launches
    pool = util.ActorPool(actors)
    assert list(pool.map(lambda a, p: a.generate.remote(p, 6), prompts)) == want
    assert sorted(pool.map_unordered(lambda a, p: a.generate.remote(p, 6), prompts)) == sorted(want)
    steps = runtime.get([a.decode_steps.remote() for a in actors])
    assert min(steps) > 0
    assert tdec.paged_decode_attention.launches - k1 == cfg.n_layers * sum(steps)
    runtime.get([a.close.remote() for a in actors])
    for a in actors:
        runtime.kill(a)
    util.remove_placement_group(pg)
    assert runtime.available_resources() == free0


def test_queue_carries_cuda_tensors_between_gpu_actors(runtime):
    from ray_tpu_torch import util

    runtime.init(num_cpus=4)
    q = util.Queue()
    producer = runtime.remote(_Producer).options(num_gpus=0.5).remote()
    consumer = runtime.remote(_Consumer).options(num_gpus=0.5).remote()
    got_ref = consumer.consume.remote(q, 8)
    sent = runtime.get(producer.produce.remote(q, 8), timeout=120)
    got = runtime.get(got_ref, timeout=120)
    assert all(t.is_cuda for t in got)
    assert all(torch.equal(t.cpu(), s) for t, (_, s) in zip(got, sent))
    assert [t.data_ptr() for t in got] == [ptr for ptr, _ in sent]  # the same storage
    q.shutdown()


def _draw(i):
    g = torch.Generator(device="cuda").manual_seed(i)
    return torch.randn(1 << 18, generator=g, device="cuda")


def test_lose_objects_rebuilds_device_tier_objects_bitwise(runtime):
    from ray_tpu_torch.chaos import ChaosEvent, ChaosRunner, ChaosSchedule

    runtime.init(num_cpus=4)
    store = runtime.get_cluster().head_node.store
    seen = {}

    def workload():
        f = runtime.remote(_draw).options(num_gpus=0.1, max_retries=2, execution="thread")
        refs = [f.remote(i) for i in range(8)]
        first = [t.cpu() for t in runtime.get(refs, timeout=60)]
        seen["tiers"] = {store.entry_info(r.id())["tier"] for r in refs}
        time.sleep(1.2)  # past the loss
        again = runtime.get(refs, timeout=60)
        seen["cuda"] = all(t.is_cuda for t in again)
        seen["equal"] = all(torch.equal(a.cpu(), b) for a, b in zip(again, first))
        return refs

    schedule = ChaosSchedule([ChaosEvent(0.5, "lose_objects", fraction=0.5)], seed=23)
    result = ChaosRunner(schedule, quiesce_timeout=60).run(workload)
    assert result.ok, (result.workload_error, result.invariants.violations)
    lose = next(e for e in result.events_applied if e["kind"] == "lose_objects")
    assert lose["lost"] > 0 and seen == {"tiers": {"device"}, "cuda": True, "equal": True}


# --------------------------------------------------------------------------
# the data library on the card (ray_tpu_torch.data)
# --------------------------------------------------------------------------
def test_data_llm_predictor_map_runs_on_cuda_and_matches_one_engine(runtime):
    """``map_batches(LLMPredictor, num_gpus=0.5)``: two in-process GPU actors
    share one cached engine on ``cuda:0`` (their factory is one object), and
    every row's greedy tokens equal one engine fed the same prompts."""
    from ray_tpu_torch.data import LLMPredictor, llm_inference
    from ray_tpu_torch.models.transformer import TransformerConfig, init_params
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = TransformerConfig(vocab_size=97, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1,
                            d_ff=256, dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(5))
    prompts = [[(3 * i + j) % 90 + 1 for j in range(12)] for i in range(8)]
    kw = {"max_batch_size": 8, "max_seq_len": 64, "cache_kind": "paged"}
    eng = LLMEngine(cfg, params, device="cuda", **kw)
    try:
        want = [f.result(timeout=120) for f in [eng.submit(p, max_tokens=6) for p in prompts]]
    finally:
        eng.shutdown()
    runtime.init(num_cpus=4)
    factory = lambda: (cfg, params)  # noqa: E731
    k1 = tdec.paged_decode_attention.launches
    try:
        rows = runtime.data.from_items([{"prompt": p} for p in prompts], parallelism=4).map_batches(
            LLMPredictor, fn_constructor_args=(factory,),
            fn_constructor_kwargs={"max_tokens": 6, **kw}, batch_size=2, concurrency=2,
            num_gpus=0.5).take_all()
        engines = [e for _, e, _ in llm_inference._engine_cache.values()]
        assert len(engines) == 1 and engines[0].device == torch.device("cuda")
        assert engines[0].params["embed"].is_cuda
    finally:
        llm_inference.clear_engine_cache()
    got = {tuple(int(t) for t in r["prompt"]): [int(t) for t in r["generated"]] for r in rows}
    assert [got[tuple(p)] for p in prompts] == want
    assert tdec.paged_decode_attention.launches > k1


def test_data_iter_device_batches_land_on_cuda(runtime):
    """``iter_device_batches`` with no device lands on ``cuda:0``, cast as
    named, bitwise the host batches; an object column stays on the host."""
    import numpy as np

    runtime.init(num_cpus=2)
    table = np.random.default_rng(0).integers(0, 32000, (30, 64), dtype=np.int32)
    ds = runtime.data.from_numpy(table).random_shuffle(seed=1).materialize()
    host = list(ds.iter_batches(batch_size=6, drop_last=True))
    dev = list(ds.iter_device_batches(batch_size=6, dtypes={"data": torch.int64}))
    assert len(dev) == len(host) == 5
    for h, d in zip(host, dev):
        assert d["data"].device == torch.device("cuda", 0) and d["data"].dtype == torch.int64
        assert torch.equal(d["data"].cpu(), torch.from_numpy(h["data"]).long())
    objs = runtime.data.from_items([{"s": {"k": i}, "v": i} for i in range(4)])
    batch = next(objs.iter_device_batches(batch_size=4))
    assert batch["v"].is_cuda and batch["s"].dtype == object


# --------------------------------------------------------------------------
# the compiled-graph layer on the card (ray_tpu_torch.dag)
# --------------------------------------------------------------------------
def _slow_fill(value: float, n: int = 1 << 20):
    """A tensor filled with ``value`` on the current stream after a spin of
    about 50 ms there: a reader not ordered after this stream sees zeros."""
    out = torch.zeros(n, device="cuda")
    torch.cuda._sleep(100_000_000)
    out.fill_(value)
    return out


class _Mean:
    def mean(self, t):
        return t.mean()  # on the actor thread's current stream: the default one


def test_dag_seq_channel_orders_a_side_stream_reader_after_its_writer(cuda):
    """A CUDA tensor written into a device channel by a thread computing on
    a side stream is read by another thread on another side stream: the
    reader's stream waits on the writer's event, so it sees the values."""
    import threading

    from ray_tpu_torch.runtime.channel_manager import SeqChannel

    ch = SeqChannel("fence", kind="device")
    got = []

    def writer():
        s = torch.cuda.Stream()
        for i in range(4):
            with torch.cuda.stream(s):
                ch.write(i, _slow_fill(float(i + 1)))

    def reader():
        s = torch.cuda.Stream()
        for _ in range(4):
            with torch.cuda.stream(s):
                _, t, _ = ch.read()
                got.append(float(t.sum()) / t.numel())

    threads = [threading.Thread(target=writer), threading.Thread(target=reader)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert got == [1.0, 2.0, 3.0, 4.0]


def test_dag_plan_orders_a_stage_after_an_input_written_on_a_side_stream(runtime):
    """The driver fills each input on a side stream and hands it to the plan
    without synchronising: the entry channel's fence makes the stage's
    stream wait for the fill, so the GPU actor's mean sees the values, and
    no tensor is pickled on the way."""
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.runtime import device_plane

    runtime.init(num_cpus=4)
    actor = runtime.remote(_Mean).options(num_gpus=0.5).remote()
    with InputNode() as inp:
        plan = actor.mean.bind(inp).compile_plan(name="streams")
    side = torch.cuda.Stream()
    try:
        packed = device_plane.stats.arrays_packed
        futs = []
        with torch.cuda.stream(side):
            for i in range(1, 5):
                futs.append(plan.execute_async(_slow_fill(float(i))))
        assert [float(f.result(timeout=60)) for f in futs] == [1.0, 2.0, 3.0, 4.0]
        assert device_plane.stats.arrays_packed == packed
        assert set(plan.snapshot()["channel_kinds"].values()) == {"device"}
    finally:
        plan.teardown()


class _GangStep:
    def step(self, x):
        assert x.is_cuda
        return x * 2.0 + 1.0


def test_dag_gang_splits_and_assembles_on_cuda(runtime):
    from ray_tpu_torch.dag import InputNode, StageGroup
    from ray_tpu_torch.parallel import mesh

    x = torch.randn(8, 64, device="cuda", dtype=torch.bfloat16)
    parts = mesh.split_for_group(x, 2)
    assert all(p.device == x.device for p in parts)
    assert torch.equal(mesh.assemble_from_group(parts), x)
    runtime.init(num_cpus=4)
    members = [runtime.remote(_GangStep).options(num_gpus=0.5).remote() for _ in range(2)]
    gang = StageGroup(members, "step", split_axis=0, warmup=((8, 64), "bfloat16"))
    with InputNode() as inp:
        plan = gang.bind(inp).compile_plan(name="gang")
    try:
        for _ in range(3):
            out = plan.execute(x)
            assert out.device == x.device and torch.equal(out, x * 2.0 + 1.0)
    finally:
        plan.teardown()


def test_dag_envelope_round_trip_of_a_cuda_tensor(cuda):
    """A CUDA tensor framed by the data plane crosses as its bytes (no CUDA
    IPC handle in the stream) and is rebuilt on the receiver's card."""
    import pickletools

    from ray_tpu_torch.runtime import data_plane, device_plane

    x = torch.randn(256, 128, device=cuda).to(torch.bfloat16)
    before = device_plane.stats.snapshot()
    meta, buffers = data_plane.to_frames({"x": x, "k": 3})
    names = [str(arg) for _, arg, _ in pickletools.genops(meta)]
    assert "_rebuild_device_array" in names and not any("cuda" in n.lower() and "rebuild" in n
                                                         for n in names)
    got = data_plane.from_frames(meta, [bytearray(memoryview(b).cast("B")) for b in buffers])
    assert got["x"].is_cuda and got["x"].dtype == torch.bfloat16 and got["k"] == 3
    assert torch.equal(got["x"], x)
    after = device_plane.stats.snapshot()
    assert after["arrays_packed"] == before["arrays_packed"] + 1
    assert after["arrays_restored"] == before["arrays_restored"] + 1


class _Doubler:
    def double(self, x):
        return x * 2


def test_dag_plan_of_gpu_actors_killed_and_repaired(runtime):
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.exceptions import ActorDiedError

    runtime.init(num_cpus=4)
    a = runtime.remote(_Doubler).options(num_gpus=0.5, max_restarts=1).remote()
    b = runtime.remote(_Doubler).options(num_gpus=0.5).remote()
    with InputNode() as inp:
        plan = b.double.bind(a.double.bind(inp)).compile_plan(name="repairable")
    x = torch.arange(16.0, device="cuda")
    try:
        assert torch.equal(plan.execute(x), x * 4)
        runtime.kill(a, no_restart=False)
        deadline = time.monotonic() + 30
        while plan.state != "BROKEN" and time.monotonic() < deadline:
            time.sleep(0.02)
        assert plan.state == "BROKEN"
        with pytest.raises(ActorDiedError):
            plan.execute(x)
        plan.repair(timeout=60)
        assert plan.state == "READY" and torch.equal(plan.execute(x), x * 4)
        assert plan.state_history == ["READY", "BROKEN", "READY"]
    finally:
        plan.teardown()


# --------------------------------------------------------------------------
# the training library on the card (ray_tpu_torch.train, util.collective)
# --------------------------------------------------------------------------
def _tiny_train_cfg():
    from ray_tpu_torch.models.transformer import TransformerConfig

    # head_dim 64: the flash kernels' tensor-core route
    return TransformerConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=2, d_ff=256,
                             max_seq_len=128, dtype=torch.bfloat16, attention="flash",
                             remat="dots", scan_layers=False)


def _attention_counts():
    return {"fwd": tattn.flash_attention_with_lse, "dq": tattn.flash_attention_backward_dq,
            "dkv": tattn.flash_attention_backward_dkv}


def _read(fns):
    return {k: dict(fn.launches_by_route) for k, fn in fns.items()}


def _sub(after, before):
    return {k: {r: x - before[k].get(r, 0) for r, x in per.items() if x - before[k].get(r, 0)}
            for k, per in after.items()}


def test_trainer_device_trainer_restarts_from_its_checkpoint_bitwise(runtime, tmp_path):
    """``DeviceTrainer`` with one GPU rank: the rank's device is ``cuda:0``;
    a framed checkpoint of the train state at step 2, one failure, the
    restart resumes from it; the four losses equal a direct
    ``make_train_step`` bitwise (deterministic algorithms on); each step
    launches K3/K4/K5 2/1/1 a layer on ``wgmma_bf16``."""
    import numpy as np

    from ray_tpu_torch import train
    from ray_tpu_torch.models.transformer import make_train_step

    cfg = _tiny_train_cfg()
    table = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 128), dtype=np.int32)
    fns, log = _attention_counts(), {}

    def loop(config):
        ctx = train.get_context()
        dev = ctx.get_devices()[0]
        init_state, step = make_train_step(cfg, device=dev)
        ckpt = train.get_checkpoint()
        state = init_state(5) if ckpt is None else ckpt.to_pytree(device=dev)
        start = int(state["step"])
        shard = train.get_dataset_shard("train")
        for i, batch in enumerate(shard.iter_device_batches(
                batch_size=2, dtypes={"data": torch.int64}, device=dev, drop_last=True)):
            if i < start:
                continue
            before = _read(fns)
            state, loss = step(state, batch["data"])
            torch.cuda.synchronize()
            log[i + 1] = (float(loss), str(dev), _sub(_read(fns), before))
            out = None
            if i + 1 == 2 and ctx.get_restart_count() == 0:
                out = train.Checkpoint.from_pytree(state, base_dir=str(tmp_path / "ck"))
            train.report({"step": i + 1}, checkpoint=out)
            if out is not None:
                time.sleep(1.0)  # the driver drains reports every 0.2 s
                raise RuntimeError("injected")

    runtime.init(num_cpus=4)
    torch.use_deterministic_algorithms(True)
    try:
        result = train.DeviceTrainer(
            loop, datasets={"train": runtime.data.from_numpy(table)},
            run_config=train.RunConfig(storage_path=str(tmp_path),
                                       failure_config=train.FailureConfig(max_failures=1))).fit()
        init_state, step = make_train_step(cfg, device="cuda")
        state, direct = init_state(5), []
        for i in range(4):
            state, loss = step(state, torch.from_numpy(table[2 * i:2 * i + 2]).cuda().long())
            direct.append(float(loss))
    finally:
        torch.use_deterministic_algorithms(False)
    assert result.error is None and sorted(log) == [1, 2, 3, 4]
    assert [log[i][0] for i in range(1, 5)] == direct
    want = {"fwd": {"wgmma_bf16": 4}, "dq": {"wgmma_bf16": 2}, "dkv": {"wgmma_bf16": 2}}
    assert all(log[i][1] == "cuda:0" and log[i][2] == want for i in range(1, 5)), log


def test_trainer_controller_gang_keeps_its_state_on_the_card(runtime):
    """``TrainController`` over in-process GPU actors, a decoder's loss
    over the flat row: world 2's losses within 2e-3 of world 1's; a member
    preempted (killed for good) after the step-2 checkpoint: the typed
    error, ``recover()`` shrinks, the next 2 losses bitwise ``replay``'s
    (deterministic algorithms on); params and momentum stay on the card."""
    import numpy as np

    from ray_tpu_torch.exceptions import RayActorError
    from ray_tpu_torch.models.transformer import init_params, loss_fn
    from ray_tpu_torch.train import TrainController

    cfg = _tiny_train_cfg()
    tree = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    names = [("embed",), ("final_norm",)] + [("layers", k) for k in tree["layers"]]
    shapes = [tree[n[0]].shape if len(n) == 1 else tree["layers"][n[1]].shape for n in names]
    sizes = [int(np.prod(s)) for s in shapes]

    def param_init(seed):
        t = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
        return torch.cat([(t[n[0]] if len(n) == 1 else t["layers"][n[1]]).reshape(-1)
                          for n in names])

    def loss(flat, batch):
        t = {"layers": {}}
        for n, s, leaf in zip(names, shapes, torch.split(flat, sizes)):
            (t if len(n) == 1 else t["layers"])[n[-1]] = leaf.view(s)
        return loss_fn(cfg, t, batch.long()) * batch.shape[0]

    rows = np.random.default_rng(1).integers(0, cfg.vocab_size, (8, 128)).astype(np.float32)
    runtime.init(num_cpus=4)
    ds = runtime.data.from_numpy(rows)
    kw = dict(batch_size=2, seed=3, learning_rate=1e-2, loss_fn=loss, param_init=param_init,
              dataset=ds, checkpoint_period=10**9, device="cuda")
    torch.use_deterministic_algorithms(True)
    ctl = None
    try:
        one = TrainController("cuda-w1", world_size=1, **kw)
        w1 = one.run(4)
        one.shutdown()
        gpus = runtime.available_resources().get("GPU", 0)
        ctl = TrainController("cuda-w2", world_size=2, preemptible=True, **kw)
        # the gang holds the controller's card, half of it a member
        assert runtime.available_resources().get("GPU", 0) == pytest.approx(gpus - 1.0)
        ctl.run(2)
        ctl.save_checkpoint()
        w2 = ctl.run(2)
        ctl.preempt_member(1, graceful=False)
        with pytest.raises(RayActorError):
            ctl.run(1, auto_repair=False)
        assert ctl.recover() == "shrunk" and ctl.world_size == 1
        post = ctl.run(2)[2:]
        audit = runtime.get_cluster().train_repair_audits[-1]
        assert audit["losses"] == post
        assert ctl.replay(audit["state"], audit["world_size"], 2) == post
        assert ctl._params.is_cuda and ctl._mom.is_cuda
    finally:
        torch.use_deterministic_algorithms(False)
        if ctl is not None:
            ctl.shutdown()
    np.testing.assert_allclose(w2, w1, rtol=2e-3)
    assert all(np.isfinite(w1))


def test_trainer_torch_trainer_ranks_share_the_card(runtime):
    """``TorchTrainer``: two process ranks (workers that see the card
    because they hold a GPU share) on ``cuda:0`` over gloo; the allreduce
    gives 3.0 and DDP keeps the weights identical."""
    from ray_tpu_torch.train import ScalingConfig
    from ray_tpu_torch.train.torch import TorchTrainer

    def loop(config):
        import os

        import torch as _torch
        import torch.distributed as dist

        from ray_tpu_torch import train
        from ray_tpu_torch.train.torch import get_device, prepare_model

        dev = get_device()
        t = _torch.tensor([float(train.get_context().get_world_rank() + 1)], device=dev)
        dist.all_reduce(t)
        _torch.manual_seed(42)
        model = prepare_model(_torch.nn.Linear(4, 1).to(dev))
        opt = _torch.optim.SGD(model.parameters(), lr=0.1)
        x = _torch.randn(8, 4, device=dev) * (train.get_context().get_world_rank() + 1)
        for _ in range(3):
            loss = ((model(x) - x.sum(1, keepdim=True)) ** 2).mean()
            opt.zero_grad()
            loss.backward()
            opt.step()
        w = _torch.tensor([model.module.weight[0, 0].item()])
        got = [_torch.zeros(1) for _ in range(2)]
        dist.all_gather(got, w)
        train.report({"reduced": float(t.item()), "device": str(t.device), "pid": os.getpid(),
                      "spread": float(got[0] - got[1])})

    runtime.init(num_cpus=4)
    result = TorchTrainer(loop, scaling_config=ScalingConfig(num_workers=2)).fit()
    import os

    assert result.error is None
    m = result.metrics
    assert m["reduced"] == 3.0 and m["device"] == "cuda:0" and m["spread"] == 0.0
    assert m["pid"] != os.getpid()


def test_trainer_torch_predictor_runs_on_the_card(runtime, tmp_path):
    """``TorchPredictor`` from a ``TorchCheckpoint``: the model and its
    inputs on ``cuda:0`` (the default), numpy out, the CPU's answers."""
    import numpy as np

    from ray_tpu_torch.train.torch import TorchCheckpoint, TorchPredictor

    model = torch.nn.Linear(2, 1, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.tensor([[2.0, 3.0]]))
    ckpt = TorchCheckpoint.from_model(model, base_dir=str(tmp_path))
    p = TorchPredictor.from_checkpoint(ckpt, torch.nn.Linear(2, 1, bias=False))
    assert p.device.type == "cuda" and next(p.model.parameters()).is_cuda
    out = p.predict({"a": np.array([1.0, 0.0]), "b": np.array([0.0, 1.0])})["predictions"]
    assert isinstance(out, np.ndarray) and out.ravel().tolist() == [2.0, 3.0]
    cpu = TorchPredictor.from_checkpoint(ckpt, torch.nn.Linear(2, 1, bias=False), device="cpu")
    x = np.random.default_rng(0).normal(size=(64, 2)).astype(np.float32)
    np.testing.assert_allclose(p.predict(x)["predictions"], cpu.predict(x)["predictions"],
                               rtol=1e-5, atol=1e-6)


class _ArRank:
    def __init__(self, rank):
        from ray_tpu_torch.util import collective

        collective.init_collective_group(2, rank, group_name="cuda-ar")
        g = torch.Generator(device="cuda").manual_seed(rank)
        self.x = torch.randn(1 << 20, generator=g, device="cuda")
        self.rank = rank

    def value(self):
        return self.x

    def allreduce(self):
        from ray_tpu_torch.util import collective

        return collective.allreduce(self.x, group_name="cuda-ar", rank=self.rank)


def test_trainer_collective_group_allreduces_on_the_card(runtime):
    """Two in-process GPU actors of one collective group: the allreduce of
    a CUDA tensor is bitwise the member-order sum and stays on the card."""
    from ray_tpu_torch.parallel import collective

    runtime.init(num_cpus=4)
    ranks = [runtime.remote(_ArRank).options(num_gpus=0.5).remote(r) for r in range(2)]
    try:
        x0, x1 = runtime.get([a.value.remote() for a in ranks])
        outs = runtime.get([a.allreduce.remote() for a in ranks])
        assert collective._registry.get("cuda-ar").routing == "inproc"
        assert all(o.is_cuda and torch.equal(o, x0 + x1) for o in outs)
    finally:
        collective.destroy_collective_group("cuda-ar")


# --------------------------------------------------------------------------
# Tune on the card
# --------------------------------------------------------------------------
def test_tune_gpu_trials_share_the_card(runtime):
    """``{"GPU": 0.5}`` trials: each runner is an in-process GPU actor and
    sees ``cuda:0``; two run at once, and a third waits for a slot (the
    sum over ``max_concurrent_trials`` fits one card)."""
    import os
    import threading

    from ray_tpu_torch import tune

    runtime.init(num_cpus=4)
    lock = threading.Lock()
    seen = {"now": 0, "most": 0, "rows": []}

    def trainable(config):
        x = torch.full((4,), float(config["x"]), device="cuda")
        with lock:
            seen["now"] += 1
            seen["most"] = max(seen["most"], seen["now"])
            seen["rows"].append((os.getpid(), str(x.device),
                                 runtime.available_resources().get("GPU", 0.0)))
        time.sleep(0.3)
        with lock:
            seen["now"] -= 1
        tune.report({"s": float(x.sum())})

    grid = tune.run(tune.with_resources(trainable, {"GPU": 0.5}),
                    config={"x": tune.grid_search([1, 2, 3])}, metric="s", mode="max",
                    max_concurrent_trials=2)
    assert len(grid) == 3 and not grid.errors
    assert grid.get_best_result().metrics["s"] == 12.0
    assert seen["most"] == 2
    assert all(pid == os.getpid() and dev == "cuda:0" and free <= 0.5
               for pid, dev, free in seen["rows"])


def test_tune_transformers_predictor_needs_cuda_unless_given_the_cpu(cuda, monkeypatch):
    """``TransformersPredictor`` on a model that returns ``.logits`` (no
    transformers needed): on ``cuda:0`` by default, the CPU's answers; no
    CUDA and no device: it refuses."""
    import types

    import numpy as np

    from ray_tpu_torch.train.huggingface import TransformersPredictor

    class Logits(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = torch.nn.Embedding(16, 4)

        def forward(self, input_ids):
            return types.SimpleNamespace(logits=self.emb(input_ids))

    torch.manual_seed(0)
    model = Logits()
    ids = np.array([[1, 2, 3], [4, 5, 6]], dtype=np.int64)
    want = model(torch.from_numpy(ids)).logits.detach().numpy()
    p = TransformersPredictor(model)
    assert p.device.type == "cuda" and next(p.model.parameters()).is_cuda
    got = p.predict(ids)["predictions"]
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)
    cpu = TransformersPredictor(Logits(), device="cpu")
    assert cpu.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformersPredictor(Logits())


# --------------------------------------------------------------------------
# jobs, workflows, state and runtime envs on the card (the jobs phase's
# checks at a small size: tests/torch_runtime_tasks.py's tiny decoder)
# --------------------------------------------------------------------------
def _jobs_client(runtime, tmp_path):
    """(client, working dir) for GPU jobs whose driver is
    ``torch_runtime_tasks._job_gpu_driver``."""
    import os

    from ray_tpu_torch.job_submission import JobSubmissionClient

    tests = os.path.dirname(os.path.abspath(__file__))
    workdir = tmp_path / "job"
    workdir.mkdir()
    (workdir / "driver.py").write_text(
        f"import sys\nsys.path.insert(0, {tests!r})\n"
        "import torch_runtime_tasks\ntorch_runtime_tasks._job_gpu_driver()\n")
    runtime.init(num_cpus=4, include_dashboard=True)
    return JobSubmissionClient(runtime.get_cluster().dashboard.url), str(workdir)


def _job_reports(logs):
    import json

    return [json.loads(line[len("JOBREPORT "):]) for line in logs.splitlines()
            if line.startswith("JOBREPORT ")]


def test_jobs_submitted_gpu_job_serves_on_the_card_as_in_process(runtime, tmp_path):
    import sys

    from torch_runtime_tasks import TINY, _tiny_burst

    client, workdir = _jobs_client(runtime, tmp_path)
    sid = client.submit_job(entrypoint=f"{sys.executable} driver.py",
                            runtime_env={"working_dir": workdir,
                                         "env_vars": {"JOB_MODE": "serve"}})
    info = client.wait_until_finished(sid, timeout=300)
    logs = client.get_job_logs(sid)
    assert info["status"] == "SUCCEEDED", logs
    reps = _job_reports(logs)
    assert [r["quantize"] for r in reps] == [False, True]
    for rep in reps:
        want, _ = _tiny_burst(rep["quantize"])
        assert rep["tokens"] == want
        assert rep["k1"] == TINY["n_layers"] * rep["steps"] and rep["steps"] >= 7
        if rep["quantize"]:
            assert rep["k6"] == rep["k6_mma"] > 0 and rep["k6"] % (6 * TINY["n_layers"]) == 0
        else:
            assert rep["k6"] == 0


def test_jobs_stopped_gpu_job_gives_the_card_memory_back(runtime, tmp_path):
    import os
    import sys

    from ray_tpu_torch.job.manager import group_members

    client, workdir = _jobs_client(runtime, tmp_path)
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    sid = client.submit_job(entrypoint=f"{sys.executable} driver.py",
                            runtime_env={"working_dir": workdir, "env_vars": {"JOB_MODE": "loop"}})
    deadline = time.monotonic() + 300
    while not any(r.get("ready") for r in _job_reports(client.get_job_logs(sid))):
        assert client.get_job_status(sid) == "RUNNING", client.get_job_logs(sid)
        assert time.monotonic() < deadline
        time.sleep(0.2)
    assert torch.cuda.mem_get_info()[0] < free0  # the job's context holds the card
    pgid = os.getpgid(runtime.get_cluster().dashboard.job_manager._jobs[sid].proc.pid)
    t0 = time.monotonic()
    assert client.stop_job(sid)
    assert client.wait_until_finished(sid, timeout=30)["status"] == "STOPPED"
    while (group_members(pgid) or torch.cuda.mem_get_info()[0] < free0 - (1 << 30)) \
            and time.monotonic() - t0 < 10:
        time.sleep(0.05)
    assert group_members(pgid) == []
    assert torch.cuda.mem_get_info()[0] >= free0 - (1 << 30)


def test_jobs_job_with_the_card_hidden_fails_not_on_the_cpu(runtime, tmp_path):
    import sys

    client, workdir = _jobs_client(runtime, tmp_path)
    sid = client.submit_job(entrypoint=f"{sys.executable} driver.py",
                            runtime_env={"working_dir": workdir, "env_vars": {
                                "JOB_MODE": "hidden", "CUDA_VISIBLE_DEVICES": ""}})
    info = client.wait_until_finished(sid, timeout=300)
    logs = client.get_job_logs(sid)
    assert info["status"] == "FAILED", logs
    assert "runs on CUDA by default and no CUDA device is available" in logs
    assert not any(r.get("served") for r in _job_reports(logs))


def test_jobs_workflow_gpu_steps_resume_without_new_launches(runtime, tmp_path):
    import threading
    import urllib.error

    from ray_tpu_torch import state, workflow
    from ray_tpu_torch.ops.decode_attention import paged_decode_attention
    from ray_tpu_torch.ops.quantization import int8_matmul
    from torch_runtime_tasks import _tiny_burst, _wf_check_once, _wf_gpu_burst

    runtime.init(num_cpus=4, include_dashboard=True)
    url = runtime.get_cluster().dashboard.url
    workflow.init(str(tmp_path / "wf"))
    marker = tmp_path / "fail_once"
    marker.write_text("x")
    gate = workflow.wait_for_event(workflow.QueueEventListener, "go", 60.0)
    gen = runtime.remote(_wf_gpu_burst).options(num_gpus=0.5, execution="thread")
    dag = runtime.remote(_wf_check_once).options(execution="thread").bind(
        gen.bind(gate, False), gen.bind(gate, True), str(marker))
    errors = []
    t = threading.Thread(target=lambda: errors.append(
        _raises(lambda: workflow.run(dag, workflow_id="wf_gpu"))))
    t.start()
    deadline = time.monotonic() + 60
    while True:
        try:
            _post_json(f"{url}/api/workflows/events/go", {"go": True})
            break
        except urllib.error.HTTPError as exc:
            assert exc.code == 404 and time.monotonic() < deadline
            time.sleep(0.05)
    t.join(timeout=300)
    assert errors and errors[0] is not None and workflow.get_status("wf_gpu") == "FAILED"
    launches = (paged_decode_attention.launches, int8_matmul.launches)
    out = workflow.resume("wf_gpu")
    assert (paged_decode_attention.launches, int8_matmul.launches) == launches
    assert out == {"float": _tiny_burst(False)[0], "int8": _tiny_burst(True)[0]}
    steps = [t for t in state.list_tasks() if t["name"].endswith("_wf_gpu_burst")]
    assert [t["state"] for t in steps] == ["FINISHED", "FINISHED"]


def _raises(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001
        return exc
    return None


def _post_json(url, body):
    import json
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("hide", [False, True], ids=["sees_card", "env_hides_card"])
def test_jobs_gpu_share_task_with_runtime_env_runs_where_it_sees_the_card(runtime, tmp_path, hide):
    """A ``num_gpus`` task with a ``runtime_env`` runs in a worker of its own
    that sees the card (and writes its profile there); with ``env_vars``
    that hide the card it raises before its body runs."""
    import os
    import pstats

    from torch_runtime_tasks import _gpu_matmul_task

    runtime.init(num_cpus=2)
    env = {"MY_GPU_FLAG": "on", **({"CUDA_VISIBLE_DEVICES": ""} if hide else {})}
    prof = tmp_path / "profs"
    ref = runtime.remote(_gpu_matmul_task).options(
        num_gpus=1, runtime_env={"env_vars": env, "profiling": {"dir": str(prof)}}).remote(64)
    if hide:
        with pytest.raises(runtime.RayTaskError, match="hides the card"):
            runtime.get(ref, timeout=300)
        return
    pid, flag, total = runtime.get(ref, timeout=300)
    assert pid != os.getpid() and flag == "on" and total == 64.0 ** 3
    [path] = prof.glob("*_gpu_matmul_task_*.prof")
    assert pstats.Stats(str(path)).total_calls > 0


def test_jobs_state_shows_the_gpu_and_an_actor_share(runtime):
    import json
    import urllib.request

    from ray_tpu_torch import state
    from torch_runtime_tasks import Counter

    runtime.init(num_cpus=2, include_dashboard=True)
    actor = runtime.remote(Counter).options(num_gpus=0.5).remote(0)
    runtime.get(actor.add.remote(1))
    with urllib.request.urlopen(runtime.get_cluster().dashboard.url + "/api/cluster_status",
                                timeout=60) as resp:
        status = json.loads(resp.read())
    count = torch.cuda.device_count()
    assert status["resources_total"]["GPU"] == count
    assert status["resources_available"]["GPU"] == count - 0.5
    assert [n["resources_total"]["GPU"] for n in state.list_nodes()] == [count]
    [row] = [a for a in state.list_actors() if a["class_name"] == "Counter"]
    assert row["resources"]["GPU"] == 0.5 and row["state"] == "ALIVE"
    runtime.kill(actor)


# ---------------------------------------------------------------------------
# the operator surface (-k cli): scripts, microbench rows, the autoscaler
# ---------------------------------------------------------------------------
def test_cli_llm_bench_tiny_on_the_card(cuda, monkeypatch, tmp_path):
    """``llm_bench``'s tiny run on the card: its decoder widened to head_dim
    64 (the decode kernel's), K1 once a layer in each decode step."""
    from ray_tpu_torch.scripts import llm_bench

    monkeypatch.setenv("RAY_TPU_LLM_BENCH_TINY", "1")
    out = llm_bench.main(str(tmp_path / "llm.json"))
    x = out["extra"]
    assert out["value"] > 0 and x["total_tokens"] == 2 * 4 * 3
    assert x["device"] == torch.cuda.get_device_name(0) and x["cache_kind"] == "paged"
    assert x["decode_steps"] >= 3 * 3 and x["k1_launches"] == 2 * x["decode_steps"]


def test_cli_kernel_bench_holds_k2_and_k3_against_plain(cuda):
    from ray_tpu_torch.scripts import kernel_bench as kb

    k2 = tdec.decode_attention.launches
    dec = kb.bench_decode(S=512, reps=3, warmup=1)
    assert tdec.decode_attention.launches > k2
    assert dec["decode_max_abs_err"] <= 1e-4 and dec["decode_kernel_us"] > 0
    k3 = tattn.flash_attention_with_lse.launches_by_route["wgmma_bf16"]
    fl = kb.bench_flash_blocks(T=1024, reps=2, warmup=1)
    assert tattn.flash_attention_with_lse.launches_by_route["wgmma_bf16"] > k3
    # bench_flash_blocks raised if the output's relative error left its limit
    # or a planted fault's did not
    assert fl["flash_rel_err"] <= kb.FLASH_REL_LIMIT < min(fl["flash_fault_rel_err"].values())
    assert fl["flash_tile"] == "192x64" and fl["flash_192x64_ms"] > 0


def test_cli_microbench_llm_rows_run_the_decode_kernels_on_the_card(runtime):
    """The capacity row on the card's head_dim-64 decoder: paged streams
    through K1, the dense side through K2, its 2x guard held."""
    from ray_tpu_torch.scripts.microbench import LLM_CONFIG, run_suite

    assert LLM_CONFIG["cuda"]["d_model"] // LLM_CONFIG["cuda"]["n_heads"] == 64
    runtime.init(num_cpus=2)
    k1, k2 = tdec.paged_decode_attention.launches, tdec.decode_attention.launches
    got = run_suite(runtime, select=["llm_paged_capacity_x", "hbm_put_gigabytes"], quick=True)
    assert got["llm_paged_capacity_x"][0] >= 2.0 and got["hbm_put_gigabytes"][1] == "GB/s"
    assert tdec.paged_decode_attention.launches > k1 and tdec.decode_attention.launches > k2


def test_cli_autoscaled_gpu_node_serves_through_the_kernels(runtime):
    """A head with no GPU; the monitor launches a GPU node for a
    ``num_gpus=1`` engine actor, which decodes through K1; the idle node is
    terminated after the actor goes."""
    from torch_runtime_tasks import TINY

    from ray_tpu_torch.autoscaler import (AutoscalerConfig, InProcessNodeProvider, Monitor,
                                          NodeTypeConfig)
    from ray_tpu_torch.models.transformer import TransformerConfig, init_params
    from ray_tpu_torch.serve.llm import LLMEngine

    class Engine:
        def __init__(self, cfg, params):
            self.eng = LLMEngine(cfg, params, device="cuda", max_batch_size=2,
                                 max_seq_len=64, cache_kind="paged")

        def generate(self, prompt, n):
            return self.eng.generate(prompt, max_tokens=n)

        def close(self):
            self.eng.shutdown()

    cfg = TransformerConfig(**TINY, dtype=torch.float32)  # head_dim 64
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    runtime.init(num_cpus=2, num_gpus=0)
    cluster = runtime.get_cluster()
    provider = InProcessNodeProvider(cluster)
    monitor = Monitor(cluster, AutoscalerConfig(
        node_types={"gpu": NodeTypeConfig("gpu", {"CPU": 2, "GPU": 1}, max_workers=1)},
        idle_timeout_s=0.5, update_interval_s=0.05), provider=provider).start()
    try:
        actor = runtime.remote(Engine).options(num_gpus=1).remote(cfg, params)
        k1 = tdec.paged_decode_attention.launches
        toks = runtime.get(actor.generate.remote([3, 5, 7], 4), timeout=120)
        assert len(toks) == 4 and tdec.paged_decode_attention.launches > k1
        assert monitor.autoscaler.num_launches == 1
        runtime.get(actor.close.remote())
        runtime.kill(actor)
        deadline = time.monotonic() + 60
        while provider.non_terminated_nodes() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not provider.non_terminated_nodes()
    finally:
        monitor.stop()


# --------------------------------------------------------------------------
# the multi-node core: a node agent with the card
# --------------------------------------------------------------------------
def test_multinode_gpu_actor_on_an_agent_runs_k1_there(runtime, tmp_path):
    """An agent given ``--num-gpus 1`` joins a head in this process (which
    offers no GPU); a ``num_gpus=1`` engine actor lands on it, decodes
    through K1 in the agent's process and returns the launches it counted
    there."""
    import os
    import subprocess
    import sys

    from torch_runtime_tasks import TINY

    class AgentEngine:
        def __init__(self, tiny):
            import torch as _torch

            from ray_tpu_torch.models.transformer import TransformerConfig, init_params
            from ray_tpu_torch.serve.llm import LLMEngine

            cfg = TransformerConfig(**tiny, dtype=_torch.float32)
            params = init_params(cfg, _torch.Generator(device="cuda").manual_seed(0))
            self.eng = LLMEngine(cfg, params, device="cuda", max_batch_size=2,
                                 max_seq_len=64, cache_kind="paged")

        def generate(self, prompt, n):
            import os as _os

            from ray_tpu_torch.ops import decode_attention

            k1 = decode_attention.paged_decode_attention.launches
            toks = self.eng.generate(prompt, max_tokens=n)
            return toks, decode_attention.paged_decode_attention.launches - k1, _os.getpid()

        def close(self):
            self.eng.shutdown()

    runtime.init(num_cpus=2, num_gpus=0, head_port=0)
    cluster = runtime.get_cluster()
    port = cluster.head_service.address.rsplit(":", 1)[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with open(tmp_path / "agent.log", "w") as log:
        agent = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.runtime.agent", "--address",
             f"127.0.0.1:{port}", "--num-cpus", "2", "--num-gpus", "1"],
            env=env, stdout=subprocess.DEVNULL, stderr=log)
    try:
        deadline = time.monotonic() + 120
        while sum(1 for n in cluster.nodes.values() if not n.dead) < 2:
            assert agent.poll() is None, (tmp_path / "agent.log").read_text()
            assert time.monotonic() < deadline, "the agent never joined"
            time.sleep(0.05)
        assert runtime.cluster_resources()["GPU"] == 1
        actor = runtime.remote(AgentEngine).options(num_gpus=1).remote(TINY)
        toks, k1, pid = runtime.get(actor.generate.remote([3, 5, 7], 4), timeout=300)
        assert len(toks) == 4 and pid != os.getpid() and pid == agent.pid
        # a launch a layer in each decode step, counted in the agent
        assert k1 >= TINY["n_layers"] and k1 % TINY["n_layers"] == 0
        runtime.get(actor.close.remote(), timeout=60)
    finally:
        agent.kill()
        agent.wait(timeout=30)


def _spawn_gpu_agent(cluster, tmp_path):
    import os
    import subprocess
    import sys

    port = cluster.head_service.address.rsplit(":", 1)[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with open(tmp_path / "agent.log", "w") as log:
        agent = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.runtime.agent", "--address",
             f"127.0.0.1:{port}", "--num-cpus", "2", "--num-gpus", "1"],
            env=env, stdout=subprocess.DEVNULL, stderr=log)
    deadline = time.monotonic() + 120
    while sum(1 for n in cluster.nodes.values() if not n.dead) < 2:
        assert agent.poll() is None, (tmp_path / "agent.log").read_text()
        assert time.monotonic() < deadline, "the agent never joined"
        time.sleep(0.05)
    return agent


def test_multinode_plan_stage_on_an_agent_runs_k1_there(runtime, tmp_path):
    """A compiled plan whose middle stage is a ``num_gpus=1`` engine actor
    in an agent's process (encode and decode here): the CUDA token tensors
    cross both edges card to card (CUDA IPC pulls on each consumer's side),
    the tokens equal the same engine class driven here, K1 launches in the
    agent, and ``kill -9`` of the agent gives a typed error and BROKEN."""
    import os

    from torch_runtime_tasks import TINY

    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.exceptions import ActorDiedError, WorkerCrashedError
    from ray_tpu_torch.runtime import device_plane
    from ray_tpu_torch.runtime.scheduler import NodeAffinitySchedulingStrategy

    class Encode:
        def encode(self, prompts):
            import torch as _torch

            return _torch.tensor(prompts, dtype=_torch.int32, device="cuda")

    class Decode:
        def decode(self, tokens):
            return tokens.tolist()

    class Engine:
        def __init__(self, tiny):
            import torch as _torch

            from ray_tpu_torch.models.transformer import TransformerConfig, init_params
            from ray_tpu_torch.serve.llm import LLMEngine

            cfg = TransformerConfig(**tiny, dtype=_torch.bfloat16)
            params = init_params(cfg, _torch.Generator(device="cuda").manual_seed(0))
            self.eng = LLMEngine(cfg, params, device="cuda", max_batch_size=4,
                                 max_seq_len=64, cache_kind="paged")

        def generate(self, tokens):
            import torch as _torch

            futs = [self.eng.submit(p, max_tokens=6) for p in tokens.tolist()]
            return _torch.tensor([f.result(timeout=300) for f in futs], dtype=_torch.int32,
                                 device=tokens.device)

        def k1(self):
            import os as _os

            from ray_tpu_torch.ops import decode_attention
            from ray_tpu_torch.runtime import device_plane as _dp

            return (decode_attention.paged_decode_attention.launches,
                    _dp.stats.snapshot()["ici_pulls"], _os.getpid())

    prompts = [[(5 * i + j) % 120 + 1 for j in range(8)] for i in range(4)]
    direct = Engine(TINY)
    want = direct.generate(torch.tensor(prompts, dtype=torch.int32, device="cuda")).tolist()
    direct.eng.shutdown()
    runtime.init(num_cpus=2, num_gpus=0, head_port=0)
    cluster = runtime.get_cluster()
    agent = _spawn_gpu_agent(cluster, tmp_path)
    try:
        here = dict(execution="inproc", num_cpus=0,
                    scheduling_strategy=NodeAffinitySchedulingStrategy(cluster.head_node.node_id))
        enc = runtime.remote(Encode).options(**here).remote()
        dec = runtime.remote(Decode).options(**here).remote()
        eng = runtime.remote(Engine).options(num_gpus=1).remote(TINY)
        with InputNode() as inp:
            plan = dec.decode.bind(eng.generate.bind(enc.encode.bind(inp))).compile_plan()
        k1_0, pulls_0, pid = runtime.get(eng.k1.remote(), timeout=300)
        here_0 = device_plane.stats.snapshot()["ici_pulls"]
        for _ in range(3):
            assert plan.execute(prompts) == want
        k1_1, pulls_1, _ = runtime.get(eng.k1.remote(), timeout=60)
        assert pid == agent.pid != os.getpid()
        assert k1_1 - k1_0 >= TINY["n_layers"] * 5 * 3 and (k1_1 - k1_0) % TINY["n_layers"] == 0
        assert pulls_1 - pulls_0 >= 3  # driver -> agent by CUDA IPC
        assert device_plane.stats.snapshot()["ici_pulls"] - here_0 >= 3  # and back
        agent.kill()
        with pytest.raises((ActorDiedError, WorkerCrashedError)):
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                plan.execute(prompts)
        assert plan.state == "BROKEN"
        plan.teardown()
    finally:
        agent.kill()
        agent.wait(timeout=30)


def test_multinode_rt_up_spawns_a_gpu_agent(runtime):
    """``rt up`` on the ``local`` provider with a ``{"CPU": 1, "GPU": 1}``
    node type: the spawned port agent gets ``--num-gpus 1``, joins with the
    card, a ``num_gpus=1`` actor runs in it; ``down`` ends it."""
    import os

    from ray_tpu_torch.autoscaler.launcher import ClusterLauncher

    runtime.init(num_cpus=1, num_gpus=0, head_port=0)
    launcher = ClusterLauncher({
        "cluster_name": "t", "provider": {"type": "local"},
        "available_node_types": {"g": {"resources": {"CPU": 1, "GPU": 1}, "min_workers": 1,
                                       "max_workers": 1}}})
    try:
        launcher.up(timeout_s=120)
        (_, proc), = launcher.provider._procs.items()
        assert proc.args[proc.args.index("--num-gpus") + 1] == "1"
        assert runtime.cluster_resources()["GPU"] == 1

        class Where:
            def pid(self):
                import os as _os

                import torch as _torch

                return _os.getpid(), _torch.ones(2, device="cuda").sum().item()

        actor = runtime.remote(Where).options(num_gpus=1).remote()
        assert runtime.get(actor.pid.remote(), timeout=120) == (proc.pid, 2.0)
        assert proc.pid != os.getpid()
    finally:
        launcher.down()


def test_multinode_thin_client_runs_k6_and_gets_cuda_tensors_as_cpu(runtime):
    """Through ``util.connect``: a ``num_gpus=1`` actor serves an int8
    engine (K6 on ``mma_bf16``), and a ref that holds a CUDA tensor reaches
    the client as a CPU tensor of the same dtype and values."""
    from torch_runtime_tasks import TINY

    from ray_tpu_torch.util import connect
    from ray_tpu_torch.util.client import ClientServer

    class Int8Engine:
        def __init__(self, tiny):
            import torch as _torch

            from ray_tpu_torch.models.transformer import TransformerConfig, init_params
            from ray_tpu_torch.serve.llm import LLMEngine

            cfg = TransformerConfig(**tiny, dtype=_torch.bfloat16)
            params = init_params(cfg, _torch.Generator(device="cuda").manual_seed(0))
            self.eng = LLMEngine(cfg, params, device="cuda", max_batch_size=2, max_seq_len=64,
                                 cache_kind="paged", quantize=True, quantize_min_size=4096)

        def generate(self, prompt, n):
            from ray_tpu_torch.ops import quantization

            before = dict(quantization.int8_matmul.launches_by_route)
            toks = self.eng.generate(prompt, max_tokens=n)
            after = quantization.int8_matmul.launches_by_route
            return toks, {r: after[r] - before[r] for r in after}

        def tensor(self):
            import torch as _torch

            return _torch.arange(12, dtype=_torch.bfloat16, device="cuda").reshape(3, 4)

        def close(self):
            self.eng.shutdown()

    runtime.init(num_cpus=2)
    server = ClientServer(port=0).start()
    try:
        with connect(server.address) as ctx:
            actor = ctx.remote(Int8Engine).options(num_gpus=1).remote(TINY)
            toks, routes = ctx.get(actor.generate.remote([3, 5, 7], 4), timeout=300)
            assert len(toks) == 4 and routes["mma_bf16"] > 0 and routes["simt"] == 0
            got = ctx.get(actor.tensor.remote(), timeout=60)
            assert got.device.type == "cpu" and got.dtype == torch.bfloat16
            assert torch.equal(got, torch.arange(12, dtype=torch.bfloat16).reshape(3, 4))
            ctx.get(actor.close.remote(), timeout=60)
    finally:
        server.stop()


# --------------------------------------------------------------------------
# rllib on the card
# --------------------------------------------------------------------------
def _rllib_ppo(device, **runners):
    from ray_tpu_torch.rllib import CartPole, PPOConfig

    return (PPOConfig().environment(CartPole())
            .env_runners(num_envs_per_runner=64, rollout_length=32, **runners)
            .training(minibatch_size=512).debugging(seed=0).resources(device=device))


def test_rllib_ppo_iteration_runs_on_the_card(cuda):
    """One PPO iteration: the runner's env state and the learner's params
    and Adam state live on the card; the result is finite and counts every
    env step."""
    from ray_tpu_torch.rllib.rl_module import tree_leaves

    algo = _rllib_ppo("cuda").build()
    try:
        result = algo.train()
        runner = algo.runners._runners[0]
        assert runner._obs.is_cuda and runner._env_state["s"].is_cuda
        assert all(p.is_cuda for p in tree_leaves(algo.learners.params))
        assert all(x.is_cuda for x in tree_leaves(algo.learners.learner.opt_state[1]["mu"]))
        assert result["num_env_steps_sampled_lifetime"] == 64 * 32
        assert all(map(lambda v: v == v, result["learners"].values()))  # no NaN
    finally:
        algo.stop()


def test_rllib_remote_runners_are_gpu_actors_beside_the_card(runtime):
    """Two remote runners on the card hold half a GPU each: in-process GPU
    actors that sample with CUDA tensors (a process worker hides the card,
    where a CUDA runner could not even be built)."""
    runtime.init(num_cpus=2)
    algo = _rllib_ppo("cuda", num_env_runners=2, remote=True).build()
    try:
        assert runtime.available_resources().get("GPU", 0) == torch.cuda.device_count() - 1
        result = algo.train()
        assert result["num_env_steps_sampled_lifetime"] == 2 * 64 * 32
        assert result["env_runners"]["num_episodes"] > 0
    finally:
        algo.stop()


def test_rllib_checkpoint_from_the_card_restores_on_the_cpu(cuda, tmp_path):
    """A checkpoint holds CPU tensors: saved on the card, revived on the
    CPU (and on the card), its greedy actions on 1,024 observations are the
    card's."""
    import numpy as np

    from ray_tpu_torch.rllib.algorithm import Algorithm

    algo = _rllib_ppo("cuda").build()
    try:
        algo.train()
        path = algo.save(str(tmp_path / "ppo.pkl"))
        obs = np.random.default_rng(0).normal(scale=0.2, size=(1024, 4)).astype(np.float32)
        want = algo.compute_actions(obs)
    finally:
        algo.stop()
    on_cpu = Algorithm.from_checkpoint(path, device="cpu")
    on_card = Algorithm.from_checkpoint(path)
    assert on_cpu.device.type == "cpu" and on_card.device.type == "cuda"
    assert (on_cpu.compute_actions(obs) == want).all()
    assert (on_card.compute_actions(obs) == want).all()


# --------------------------------------------------------------------------
# rllib part 2 on the card: DreamerV3 and the Decision Transformer
# --------------------------------------------------------------------------
def _rllib_tree_rel(got, want) -> float:
    """The largest error of a leaf over its largest magnitude."""
    from ray_tpu_torch.rllib.rl_module import tree_leaves

    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        b = b.detach().float().cpu()
        err = float((a.detach().float().cpu() - b).abs().max())
        worst = max(worst, err / max(float(b.abs().max()), 1e-30))
    return worst


def _rllib_dreamer(device):
    from ray_tpu_torch.rllib import CartPole
    from ray_tpu_torch.rllib.algorithms import DreamerV3Config

    cfg = DreamerV3Config().environment(CartPole()).debugging(seed=0).resources(device=device)
    cfg.num_envs, cfg.seq_len, cfg.batch_size_seqs, cfg.updates_per_iter = 8, 16, 1, 1
    return cfg


def _rllib_dt(device):
    import numpy as np

    from ray_tpu_torch.rllib import CartPole, DTConfig, SampleBatch

    rng = np.random.default_rng(0)
    data = SampleBatch({"obs": rng.normal(size=(200, 4, 4)).astype(np.float32),
                        "actions": rng.integers(0, 2, (200, 4)).astype(np.int32),
                        "rewards": np.ones((200, 4), np.float32),
                        "dones": rng.random((200, 4)) < 0.03})
    return (DTConfig().environment(CartPole()).offline_data(data)
            .training(n_layers=3, n_heads=1, d_model=128, updates_per_iter=2)
            .debugging(seed=0).resources(device=device))


def test_rllib_dreamerv3_update_on_the_card_matches_the_cpu(cuda):
    """A DreamerV3 iteration at the default widths runs on the card (state,
    replay batch and draws there); one update from the card's state (its
    reward head and critics given O(1) outputs) and the same Gumbel draws
    on the CPU gives the same losses (1e-4) and a new state within 1e-4 of
    each leaf's largest."""
    from ray_tpu_torch.rllib.learner import floats, to_device

    from ray_tpu_torch.rllib.algorithms.dreamerv3 import _linspace_bins

    algo = _rllib_dreamer("cuda").build()
    stats = algo.train()["learners"]
    assert all(v == v for v in stats.values())
    assert algo.state["wm"]["gru"]["wh"].is_cuda and algo.state["wm_opt"]["mu"]["gru"]["wh"].is_cuda
    # the reward head and the critics start at zero, where twohot_mean is
    # the rounding of the bins' sum, which differs between devices (and so
    # do the actor's advantages): peak their last biases at one bin
    lin = _linspace_bins().cuda()
    for head, c in ((algo.state["wm"]["reward"], 1.0), (algo.state["critic"], 0.5),
                    (algo.state["critic_slow"], 0.6)):
        head[-1]["b"] = -2.0 * (lin - c) ** 2
    cpu = _rllib_dreamer("cpu").build()
    state = to_device(algo.state, "cpu")
    cpu.set_state({"params": state, "iteration": 0})
    batch = algo._replay[0]
    noise = algo.draw_noise(16, 8)
    got_state, got = algo._update(algo.state, algo._tensors(batch), noise)
    want_state, want = cpu._update(cpu.state, cpu._tensors(batch), to_device(noise, "cpu"))
    got, want = floats(got), floats(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * max(abs(want[k]), 1e-1), k
    for part in ("wm", "actor", "critic", "critic_slow"):
        assert _rllib_tree_rel(got_state[part], want_state[part]) <= 1e-4, part


def test_rllib_dt_update_on_the_card_matches_the_cpu(cuda):
    """Two DT updates on the card (3 layers, 1 head, embedding 128, K 20)
    against the same windows on the CPU from the same state, three steps
    in (a first Adam step is g / (|g| + eps), ill-conditioned where a
    gradient is near 0): losses 1e-5, params within 1e-4 of each leaf's
    largest."""
    import numpy as np

    from ray_tpu_torch.rllib.learner import to_device, to_tensor

    card, cpu = _rllib_dt("cuda").build(), _rllib_dt("cpu").build()
    rng = np.random.default_rng(1)
    for _ in range(3):
        cpu._update(*(to_tensor(w, "cpu") for w in cpu._gather_windows(
            rng.integers(0, len(cpu._window_index), 64))))
    card.set_state(to_device(cpu.get_state(), "cuda"))
    for _ in range(2):
        windows = card._gather_windows(rng.integers(0, len(card._window_index), 64))
        a = float(card._update(*(to_tensor(w, "cuda") for w in windows)))
        b = float(cpu._update(*(to_tensor(w, "cpu") for w in windows)))
        assert abs(a - b) <= 1e-5 * max(1.0, abs(b))
    assert card.params["blocks"][0]["wq"].is_cuda
    assert _rllib_tree_rel(card.params, cpu.params) <= 1e-4


def test_rllib_part_two_checkpoints_from_the_card_restore_on_the_cpu(cuda, tmp_path):
    """DreamerV3 and DT saved on the card revive on the CPU
    (``from_checkpoint(device="cpu")``; DT's offline data comes with its
    config) with every leaf equal."""
    from ray_tpu_torch.rllib.algorithm import Algorithm
    from ray_tpu_torch.rllib.rl_module import tree_leaves

    for name, cfg in (("dreamer", _rllib_dreamer("cuda")), ("dt", _rllib_dt("cuda"))):
        algo = cfg.build()
        algo.train()
        path = algo.save(str(tmp_path / f"{name}.pkl"))
        kw = {"config": _rllib_dt("cuda")} if name == "dt" else {}
        revived = Algorithm.from_checkpoint(path, device="cpu", **kw)
        assert revived.device.type == "cpu" and revived.iteration == 1
        tree = (lambda a: a.state) if name == "dreamer" else (lambda a: a.params)
        for a, b in zip(tree_leaves(tree(algo)), tree_leaves(tree(revived))):
            assert b.device.type == "cpu" and torch.equal(a.cpu(), b)
