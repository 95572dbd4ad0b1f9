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
    o, lse = tattn.flash_attention_with_lse(_t(q), _t(k), _t(v), None, causal, window)
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
    o, lse = tattn.flash_attention_with_lse(tq, tk, tv, None, causal, window)
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


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    q, kp, vp, bt, lengths = _paged_case(1, 2)
    counters = (tdec.paged_decode_attention, tdec.decode_attention,
                tattn.flash_attention_with_lse, tattn.flash_attention_backward_dq,
                tattn.flash_attention_backward_dkv)
    before = [c.launches for c in counters]
    forced = tdec.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(lengths),
                                         use_kernel=True)
    plain = tdec.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(lengths),
                                        use_kernel=False)
    torch.testing.assert_close(forced, plain, rtol=0, atol=0)
    x = torch.randn(1, 2, 8, 16, requires_grad=True)
    tattn.flash_attention(x, x, x, use_kernel=True).sum().backward()
    tdec.decode_attention(x[:, :, 0], x, x, torch.tensor([3]))
    assert [c.launches for c in counters] == before
