"""The port's attention ops against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels' oracles); the JAX side runs its Pallas kernels in interpret mode
and its XLA paths, as its own tests do. Same numpy inputs on both sides,
f32, atol 1e-5 (only the summation order differs; 2e-5 on gradients,
which take one more product). The CUDA kernels
themselves are held against these plain versions on a GPU by
tests/test_torch_cuda.py and by chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ray_tpu.ops import attention as jattn  # noqa: E402
from ray_tpu.ops import decode_attention as jdec  # noqa: E402
from ray_tpu_torch.ops import attention as tattn  # noqa: E402
from ray_tpu_torch.ops import decode_attention as tdec  # noqa: E402
from ray_tpu_torch.ops import variant_probe as vprobe  # noqa: E402

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# decode attention (dense cache): K2's plain version
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_rep", [1, 2, 4])
def test_decode_attention_matches_jax(n_rep):
    rng = np.random.default_rng(n_rep)
    B, Hkv, S, D = 3, 2, 600, 16  # S not a multiple of the 512 block
    H = Hkv * n_rep
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    lengths = np.array([0, 17, S], np.int32)
    ref = jdec.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(lengths))
    got = tdec.decode_attention(_t(q), _t(k), _t(v), _t(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    assert not got[0].any()  # an empty row gives zeros, not a mean of V


# --------------------------------------------------------------------------
# paged decode attention: K1's plain version
# --------------------------------------------------------------------------
def _paged_case(seed, n_rep, B=3, Hkv=2, D=16, M=4, bs=16):
    rng = np.random.default_rng(seed)
    H = Hkv * n_rep
    N = B * M + 1
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    kp = rng.normal(size=(N, bs, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(N, bs, Hkv, D)).astype(np.float32)
    # shuffled table: physical placement must not matter
    bt = rng.permutation(np.arange(1, N))[: B * M].reshape(B, M).astype(np.int32)
    lengths = np.array([0, 21, M * bs], np.int32)
    bt[0, :] = 0  # an empty row's entries all point at the garbage page
    bt[1, 2:] = 0  # entries past the length too
    return q, kp, vp, bt, lengths


@pytest.mark.parametrize("n_rep", [1, 2, 4])
@pytest.mark.parametrize("jax_kernel", [True, False], ids=["pallas_interpret", "xla"])
def test_paged_decode_attention_matches_jax(n_rep, jax_kernel):
    q, kp, vp, bt, lengths = _paged_case(10 + n_rep, n_rep)
    ref = jdec.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lengths), use_kernel=jax_kernel,
    )
    got = tdec.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_paged_decode_never_reads_garbage_page():
    """Whatever page 0 holds, the output does not change."""
    q, kp, vp, bt, lengths = _paged_case(3, 2)
    a = tdec.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(lengths))
    kp[0], vp[0] = 1e4, -1e4
    b = tdec.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(lengths))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# --------------------------------------------------------------------------
# flash attention forward: K3's plain version
# --------------------------------------------------------------------------
@pytest.mark.parametrize(
    "Tq,Tk,causal,window",
    [
        (32, 32, True, None),
        (32, 32, False, None),
        (37, 37, True, None),   # ragged T: not a block multiple
        (20, 45, False, None),  # Tq != Tk
        (48, 48, True, 8),      # sliding window, causal
        (40, 40, False, 12),    # sliding window bounds only the past
    ],
)
def test_flash_attention_with_lse_matches_jax(Tq, Tk, causal, window):
    rng = np.random.default_rng(Tq + Tk)
    B, H, D = 2, 2, 16
    q = rng.normal(size=(B, H, Tq, D)).astype(np.float32)
    k = rng.normal(size=(B, H, Tk, D)).astype(np.float32)
    v = rng.normal(size=(B, H, Tk, D)).astype(np.float32)
    ref_o, ref_lse = jattn.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, causal, 16, 16, window
    )
    o, lse = tattn.flash_attention_with_lse(_t(q), _t(k), _t(v), None, causal, window=window)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=ATOL)


def test_sliding_window_and_flash_wrappers_match_jax():
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(1, 2, 24, 16)).astype(np.float32) for _ in range(3))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    np.testing.assert_allclose(
        tattn.sliding_window_attention(_t(q), _t(k), _t(v), 5).numpy(),
        np.asarray(jattn.sliding_window_attention(jq, jk, jv, 5, block_q=8, block_k=8)),
        atol=ATOL,
    )
    np.testing.assert_allclose(
        tattn.flash_attention(_t(q), _t(k), _t(v)).numpy(),
        np.asarray(jattn.flash_attention(jq, jk, jv, None, True, 8, 8)),
        atol=ATOL,
    )
    with pytest.raises(ValueError):
        tattn.sliding_window_attention(_t(q), _t(k), _t(v), 0)


# --------------------------------------------------------------------------
# the JAX functions' positional order (block_q, block_k before window)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False])
def test_reference_positional_call_with_blocks_matches_jax(causal):
    """``flash_attention_with_lse(q, k, v, s, causal, bq, bk)`` as
    ``ray_tpu/parallel/ring.py`` calls it: the blocks are taken and unused,
    and no window is run."""
    rng = np.random.default_rng(21)
    q, k, v = (rng.normal(size=(1, 2, 40, 16)).astype(np.float32) for _ in range(3))
    ref_o, ref_lse = jattn.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3, causal, 16, 16)
    o, lse = tattn.flash_attention_with_lse(_t(q), _t(k), _t(v), 0.3, causal, 16, 16)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=ATOL)


def test_reference_positional_calls_of_the_wrappers_match_jax():
    """``flash_attention(q, k, v, None, True, 8, 8)`` and
    ``sliding_window_attention(..., block_q=8, block_k=8)`` read as in JAX;
    the eighth positional argument of ``flash_attention_with_lse`` is the
    window."""
    rng = np.random.default_rng(22)
    q, k, v = (rng.normal(size=(2, 2, 33, 16)).astype(np.float32) for _ in range(3))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    np.testing.assert_allclose(
        tattn.flash_attention(_t(q), _t(k), _t(v), None, True, 8, 8).numpy(),
        np.asarray(jattn.flash_attention(jq, jk, jv, None, True, 8, 8)), atol=ATOL)
    np.testing.assert_allclose(
        tattn.sliding_window_attention(_t(q), _t(k), _t(v), 6, causal=False, block_q=8,
                                       block_k=8).numpy(),
        np.asarray(jattn.sliding_window_attention(jq, jk, jv, 6, causal=False, block_q=8,
                                                  block_k=8)), atol=ATOL)
    o, lse = tattn.flash_attention_with_lse(_t(q), _t(k), _t(v), None, True, 8, 8, 6)
    ref_o, ref_lse = jattn.flash_attention_with_lse(jq, jk, jv, None, True, 8, 8, 6)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=ATOL)


@pytest.mark.parametrize("block_q", [1, 4, 128])
def test_sixth_positional_argument_is_never_a_window(block_q):
    """A block size in the sixth place (the JAX ``block_q``) leaves the
    result of full causal attention unchanged, whatever its value."""
    rng = np.random.default_rng(23)
    q, k, v = (_t(rng.normal(size=(1, 2, 30, 16)).astype(np.float32)) for _ in range(3))
    want = tattn.flash_attention_with_lse(q, k, v, None, True)
    got = tattn.flash_attention_with_lse(q, k, v, None, True, block_q)
    windowed = tattn.flash_attention_with_lse(q, k, v, None, True, window=block_q)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    if block_q < 30:  # a window of that size would have changed it
        assert not torch.allclose(windowed[0], want[0])
    with pytest.raises(TypeError):  # use_kernel is keyword-only after the window
        tattn.flash_attention_with_lse(q, k, v, None, True, None, None, None, False)


@pytest.mark.parametrize("scale", [-0.125, 0.0])
@pytest.mark.parametrize("causal,window", [(True, None), (False, 7)])
def test_any_scale_forward_and_vjp_match_jax(scale, causal, window):
    """The plain forward and its VJP (the oracles of the kernels, whose bf16
    route flips Q's sign for a negative scale) at a negative and a zero
    scale, against ``jax.vjp`` of the JAX function."""
    import jax

    rng = np.random.default_rng(24)
    B, H, T, D = 1, 2, 29, 16
    q, k, v, g_out = (rng.normal(size=(B, H, T, D)).astype(np.float32) for _ in range(4))
    g_lse = rng.normal(size=(B, H, T)).astype(np.float32)
    (ref_o, ref_lse), vjp = jax.vjp(
        lambda a, b, c: jattn.flash_attention_with_lse(a, b, c, scale, causal, 16, 16, window),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_grads = vjp((jnp.asarray(g_out), jnp.asarray(g_lse)))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    o, lse = tattn.flash_attention_with_lse(tq, tk, tv, scale, causal, window=window)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(ref_o), atol=ATOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(ref_lse), atol=ATOL)
    grads = torch.autograd.grad((o, lse), (tq, tk, tv), (_t(g_out), _t(g_lse)))
    for name, got, want in zip("qkv", grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("block_s", [128, 512])
def test_decode_attention_takes_block_s_and_matches_jax(block_s):
    """``block_s`` (the TPU kernel's cache block) is accepted and unused."""
    rng = np.random.default_rng(25)
    B, H, Hkv, S, D = 2, 4, 2, 300, 16
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, Hkv, S, D)).astype(np.float32) for _ in range(2))
    lengths = np.array([299, 130], np.int32)
    ref = jdec.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(lengths), block_s=block_s)
    got = tdec.decode_attention(_t(q), _t(k), _t(v), _t(lengths), block_s=block_s)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


# --------------------------------------------------------------------------
# the decode kernels' launch plan (shapes only) and shared cases
# --------------------------------------------------------------------------
@pytest.mark.parametrize("B,Hkv,n_rep,want", [
    (8, 8, 2, (2, 16)),   # the serving engine: 64 blocks of 16 warps
    (16, 8, 2, (2, 16)),  # 128 blocks still leave SMs idle
    (64, 8, 2, (2, 4)),   # batch 64: 512 blocks fill the SMs
    (1, 8, 2, (2, 16)),
    (2, 2, 16, (4, 4)),   # n_rep 16: four heads a pass, four passes
    (3, 8, 3, (4, 4)),    # n_rep 3: one pass of four (one unused)
    (4, 8, 1, (1, 16)),
    (17, 8, 1, (1, 4)),   # 136 blocks of one head
])
def test_decode_plan_depends_on_shapes_only(B, Hkv, n_rep, want):
    assert tdec.decode_plan(B, Hkv, n_rep, 132) == want
    rows, warps = want
    assert warps <= tdec.max_warps(rows)


def test_decode_wrappers_do_not_count_launches_on_the_cpu():
    q, kp, vp, bt, lengths = _paged_case(4, 2)
    fns = (tdec.paged_decode_attention, tdec.decode_attention)
    before = [f.launches for f in fns]
    tdec.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(lengths))
    x = torch.randn(1, 2, 8, 16)
    tdec.decode_attention(x[:, :, 0], x, x, torch.tensor([3]), block_s=64)
    assert [f.launches for f in fns] == before


@pytest.mark.parametrize("case", list(vprobe.DECODE_CASES))
def test_shared_decode_cases_match_jax(case):
    """The decode cases the card runs (``variant_probe.decode_inputs``),
    built on the CPU in f32: the port's paged and dense versions against the
    JAX package's on the same pool and cache."""
    g = torch.Generator().manual_seed(3)
    q, kp, vp, bt, ln = vprobe.decode_inputs(True, *vprobe.DECODE_CASES[case], torch.float32, g)
    assert not bt[torch.arange(bt.shape[1])[None, :] * 16 >= ln[:, None]].any()
    ref = jdec.paged_decode_attention(*(jnp.asarray(t.numpy()) for t in (q, kp, vp, bt, ln)))
    got = tdec.paged_decode_attention(q, kp, vp, bt, ln)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    q, k, v, ln = vprobe.decode_inputs(False, *vprobe.DECODE_CASES[case], torch.float32, g)
    ref = jdec.decode_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v, ln)))
    got = tdec.decode_attention(q, k, v, ln)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_mha_matches_jax(causal):
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(2, 3, 12, 8)).astype(np.float32) for _ in range(3))
    ref = jattn.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got = tattn.mha(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize(
    "Tq,Tk,causal,window",
    [
        (37, 37, True, None),   # ragged T: not a block multiple
        (20, 45, False, None),  # Tq != Tk
        (37, 37, True, 8),      # sliding window, causal
        (40, 40, False, 12),    # sliding window bounds only the past
        (45, 20, False, 8),     # rows i >= 27 see no key: lse -1e30, zero grads
    ],
)
def test_flash_attention_with_lse_vjp_matches_jax(Tq, Tk, causal, window):
    """Value and VJP (K4/K5's plain versions) against ``jax.vjp`` of the JAX
    function (Pallas backward kernels in interpret mode), with random
    cotangents for both out and lse; atol 2e-5 on the gradients."""
    import jax

    rng = np.random.default_rng(100 + Tq + Tk)
    B, H, D = 2, 2, 16
    q = rng.normal(size=(B, H, Tq, D)).astype(np.float32)
    k = rng.normal(size=(B, H, Tk, D)).astype(np.float32)
    v = rng.normal(size=(B, H, Tk, D)).astype(np.float32)
    g_out = rng.normal(size=(B, H, Tq, D)).astype(np.float32)
    g_lse = rng.normal(size=(B, H, Tq)).astype(np.float32)
    (ref_o, ref_lse), vjp = jax.vjp(
        lambda a, b, c: jattn.flash_attention_with_lse(a, b, c, None, causal, 16, 16, window),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    ref_grads = vjp((jnp.asarray(g_out), jnp.asarray(g_lse)))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    o, lse = tattn.flash_attention_with_lse(tq, tk, tv, None, causal, window=window)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(ref_o), atol=ATOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(ref_lse), atol=ATOL)
    grads = torch.autograd.grad((o, lse), (tq, tk, tv), (_t(g_out), _t(g_lse)))
    for name, got, want in zip("qkv", grads, ref_grads):
        assert torch.isfinite(got).all(), name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, err_msg=f"d{name}")
    if window is not None and not causal and Tq > Tk + window - 1:
        assert not grads[0][:, :, Tk + window - 1:].any()  # rows that see no key


def test_unused_lse_folds_away_and_gqa_sums_group_grads():
    """``flash_attention`` (lse unused: its cotangent is None) gives the same
    grads as a zero lse cotangent; K/V repeated to full heads with
    expand().reshape() get the group's dk/dv summed by autograd."""
    rng = np.random.default_rng(9)
    q = _t(rng.normal(size=(1, 4, 19, 16)).astype(np.float32)).requires_grad_()
    kv = _t(rng.normal(size=(1, 2, 19, 16)).astype(np.float32)).requires_grad_()
    rep = kv[:, :, None].expand(1, 2, 2, 19, 16).reshape(1, 4, 19, 16)
    g = _t(rng.normal(size=(1, 4, 19, 16)).astype(np.float32))
    a = torch.autograd.grad(tattn.flash_attention(q, rep, rep), (q, kv), g)
    o, lse = tattn.flash_attention_with_lse(q, rep, rep)
    b = torch.autograd.grad((o, lse), (q, kv), (g, torch.zeros_like(lse)))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    ref = torch.autograd.grad(tattn.mha(q, rep, rep), (q, kv), g)
    for x, y in zip(a, ref):
        torch.testing.assert_close(x, y, rtol=0, atol=ATOL)


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma_bf16"), (torch.float32, "simt_f32")])
def test_kernel_route_by_dtype_and_head_dim(dtype, route, head_dim):
    """bf16 goes to the tensor-core kernels (forward, dq and dk/dv alike),
    f32 to the scalar ones; the head dimension only has to be one the kernels
    take."""
    assert tattn.kernel_route(dtype, head_dim) == route
    assert route in tattn.ROUTES


@pytest.mark.parametrize("dtype,head_dim,exc", [
    (torch.bfloat16, 96, ValueError), (torch.float32, 32, ValueError),
    (torch.float16, 64, TypeError), (torch.float64, 128, TypeError),
])
def test_kernel_route_refuses_what_no_kernel_takes(dtype, head_dim, exc):
    with pytest.raises(exc):
        tattn.kernel_route(dtype, head_dim)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    q, kp, vp, bt, lengths = _paged_case(1, 2)
    counters = (tdec.paged_decode_attention, tdec.decode_attention,
                tattn.flash_attention_with_lse, tattn.flash_attention_backward_dq,
                tattn.flash_attention_backward_dkv)
    before = [c.launches for c in counters]
    routes = [dict(c.launches_by_route) for c in counters[2:]]
    forced = tdec.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(lengths),
                                         use_kernel=True)
    plain = tdec.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(lengths),
                                        use_kernel=False)
    torch.testing.assert_close(forced, plain, rtol=0, atol=0)
    x = torch.randn(1, 2, 8, 16, requires_grad=True)
    tattn.flash_attention(x, x, x, use_kernel=True).sum().backward()
    tdec.decode_attention(x[:, :, 0], x, x, torch.tensor([3]))
    assert [c.launches for c in counters] == before
    assert [c.launches_by_route for c in counters[2:]] == routes


@pytest.mark.parametrize("fn", ["flash_attention_with_lse", "flash_attention_backward_dq",
                                "flash_attention_backward_dkv"])
def test_every_flash_wrapper_counts_launches_by_route(fn):
    """K3, K4 and K5 each keep one counter per route of ``kernel_route``."""
    assert set(getattr(tattn, fn).launches_by_route) == set(tattn.ROUTES)


@pytest.mark.parametrize("which", ["dq", "dkv"])
def test_backward_kernels_refuse_cpu_tensors(which):
    """The kernel wrappers launch or raise: a CPU tensor never reaches a
    launch (the Function takes the plain version before it gets there) and no
    counter moves."""
    fn = getattr(tattn, f"flash_attention_backward_{which}")
    q = torch.randn(1, 2, 8, 64)
    lse = torch.zeros(1, 2, 8)
    before = fn.launches, dict(fn.launches_by_route)
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(q, q, q, q, lse, lse, 0.125, True)
    assert (fn.launches, fn.launches_by_route) == before


def test_variant_probe_parses_definitions_and_refuses_a_bad_call(capsys):
    """The kernel-variant timing tool: ``name:DEF=V,DEF=V`` arguments, unique
    names, and a usage error (exit code 2) before it looks for a card."""
    from ray_tpu_torch.ops import variant_probe as vp

    assert vp.parse_variants(["base:", "deep:STAGES=4,DEFER=1", "bare"]) == {
        "base": [], "deep": ["STAGES=4", "DEFER=1"], "bare": []}
    for bad in (["a:", "a:X=1"], [":X=1"]):
        with pytest.raises(ValueError):
            vp.parse_variants(bad)
    assert vp.main(["no_such_kernel", "base:"]) == 2 and vp.main(["dq"]) == 2
    assert "usage" in capsys.readouterr().err
    assert set(vp.TARGETS) == {"dq", "int8", "paged", "dense"}
    assert vp.build_report("Used 40 registers\nUsed 128 registers, 8 bytes spill stores, "
                           "4 bytes spill loads") == {"max_registers": 128, "spill_bytes": 12}
