"""The port's CUDA kernels on a GPU, each against its plain PyTorch version,
and the engine and the train step on the GPU against the same on the CPU.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode; on the CPU the wrappers run the plain versions,
which tests/test_torch_ops.py holds against the JAX package). This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerances: f32 atol 1e-4 (summation order only), bf16 atol = rtol = 2e-2.
The backward kernels have no atomics: two launches give the same bits.
"""

import pytest

torch = pytest.importorskip("torch")

from ray_tpu_torch.ops import attention as tattn  # noqa: E402
from ray_tpu_torch.ops import decode_attention as tdec  # noqa: E402

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


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 16)])
@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
def test_flash_kernel_matches_plain(cuda, causal, window, dtype, atol, rtol):
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(2, 4, 77, 64, generator=g, device=cuda).to(dtype) for _ in range(3))
    o, lse = tattn.flash_attention_with_lse(q, k, v, None, causal, window)
    po, plse = tattn.flash_attention_with_lse(q, k, v, None, causal, window, use_kernel=False)
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
    out, lse = tattn.flash_attention_with_lse(q, k, v, None, causal, window)
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


@pytest.mark.parametrize("cache_kind", ["paged", "dense"])
def test_engine_on_gpu_matches_engine_on_cpu(cuda, cache_kind):
    """Greedy tokens through the kernels equal the plain path's on the CPU
    (f32, head_dim 64 so the kernels take it)."""
    from ray_tpu_torch.models.transformer import TransformerConfig, init_params
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = TransformerConfig(vocab_size=97, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1,
                            d_ff=256, dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(5))
    prompts = [[3, 5, 7, 11, 13], [2] * 17, list(range(1, 31)), [8, 9]]
    out = {}
    for dev in ("cpu", "cuda"):
        eng = LLMEngine(cfg, params, device=dev, max_batch_size=4, max_seq_len=64,
                        cache_kind=cache_kind)
        try:
            out[dev] = [f.result(timeout=120) for f in [eng.submit(p, max_tokens=8) for p in prompts]]
        finally:
            eng.shutdown()
    assert out["cuda"] == out["cpu"]
