"""Flash attention (forward and backward), and the plain attention reference.

Counterpart of ``ray_tpu/ops/attention.py``. :func:`flash_attention`,
:func:`flash_attention_with_lse` and :func:`sliding_window_attention` run, on
CUDA tensors, the CUDA kernels

* ``csrc/attention.cu::flash_attention_forward`` (replaces the TPU kernel
  ``_attn_fwd_kernel``),
* ``csrc/attention_bwd.cu::flash_attention_backward_dq`` and
  ``::flash_attention_backward_dkv`` (replace ``_bwd_dq_kernel`` and
  ``_bwd_dkv_kernel``),

wrapped in one ``torch.autograd.Function`` as the JAX package wraps its
kernels in a custom VJP (the source files say what bounds each kernel on the
H100 and what its design does about it). On CPU tensors the same Function
runs the plain PyTorch versions :func:`_flash_forward_plain` and
:func:`_flash_backward_plain`. :func:`mha` is the plain reference attention.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_PROTOTYPES = {
    # q, k, v, out, lse, BH, Tq, Tk, D, dtype, scale, causal, window, stream
    "flash_attention_forward": [_P] * 5 + [_I] * 5 + [_F, _I, _I, _P],
}
_BWD_PROTOTYPES = {
    # q, k, v, dout, lse, delta, dq, BH, Tq, Tk, D, dtype, scale, causal, window, stream
    "flash_attention_backward_dq": [_P] * 7 + [_I] * 5 + [_F, _I, _I, _P],
    # q, k, v, dout, lse, delta, dk, dv, BH, Tq, Tk, D, dtype, scale, causal, window, stream
    "flash_attention_backward_dkv": [_P] * 8 + [_I] * 5 + [_F, _I, _I, _P],
}


def _visible(Tq: int, Tk: int, causal: bool, window: Optional[int], device) -> torch.Tensor:
    """[Tq, Tk] bool: key j visible to query i (the TPU kernel's
    ``_block_mask`` over the unpadded shapes)."""
    qi = torch.arange(Tq, device=device)[:, None]
    kj = torch.arange(Tk, device=device)[None, :]
    vis = torch.ones(Tq, Tk, dtype=torch.bool, device=device)
    if causal:
        vis = vis & (kj <= qi)
    if window is not None:
        vis = vis & (kj > qi - window)
    return vis


def _flash_forward_plain(q, k, v, scale: float, causal: bool, window: Optional[int] = None):
    """Plain PyTorch version of the flash forward kernel: full [Tq, Tk]
    scores in f32, masked softmax. Returns (out [B,H,Tq,D] in q's dtype,
    lse [B,H,Tq] f32); a row that sees no key gives zeros and lse -1e30."""
    Tq, Tk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    vis = _visible(Tq, Tk, causal, window, q.device)
    s = torch.where(vis, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, 1.0, l)
    out = torch.einsum("bhqk,bhkd->bhqd", p / l_safe, v.float())
    lse = torch.where(l == 0, NEG_INF, m + torch.log(l_safe))[..., 0]
    return out.to(q.dtype), lse


def _check_kernel_inputs(what: str, q, k, v) -> None:
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if q.device.type != "cuda":
        raise RuntimeError(f"{what} runs on CUDA tensors, got {q.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in (64, 128):
        raise ValueError(f"{what} takes head_dim 64 or 128, got {D}")
    if k.shape != (B, H, Tk, D) or v.shape != k.shape:
        raise ValueError(f"k/v must be [B, H, Tk, D]; got {tuple(k.shape)}, {tuple(v.shape)}")


def _flash_forward_kernel(q, k, v, scale: float, causal: bool, window: Optional[int]):
    _check_kernel_inputs("the flash kernel", q, k, v)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)
    lib = _build.library("attention", _PROTOTYPES)
    err = lib.flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B * H, Tq, Tk, D, _build.dtype_code(q), scale, int(causal),
        0 if window is None else int(window),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attention_forward")
    flash_attention_with_lse.launches += 1
    return out, lse


# ---------------------------------------------------------------------------
# backward: plain versions and kernels
# ---------------------------------------------------------------------------
def _delta(out, g_out, g_lse):
    """rowsum(dO * O) - g_lse, f32 [B,H,Tq]: d lse / d s is the softmax P, so
    the lse cotangent folds into the P * (dP - delta) term (as the TPU
    driver folds it, in plain XLA)."""
    d = (g_out.float() * out.float()).sum(-1)
    return d if g_lse is None else d - g_lse.float()


def _p_ds_plain(q, k, v, g_out, lse, delta, scale: float, causal: bool,
                window: Optional[int]):
    """P = exp(q.k * scale - lse) on visible pairs and dS = P * (dP - delta),
    f32 [B,H,Tq,Tk]. P is selected by the mask, never multiplied by it: a row
    that sees no key has lse -1e30, and exp(s - lse) = inf there."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    vis = _visible(q.shape[2], k.shape[2], causal, window, q.device)
    p = torch.where(vis, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", g_out.float(), v.float())
    return p, p * (dp - delta[..., None])


def _bwd_dq_plain(q, k, v, g_out, lse, delta, scale: float, causal: bool,
                  window: Optional[int]):
    """Plain version of the dq kernel: dq = scale * dS . K."""
    _, ds = _p_ds_plain(q, k, v, g_out, lse, delta, scale, causal, window)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale).to(q.dtype)


def _bwd_dkv_plain(q, k, v, g_out, lse, delta, scale: float, causal: bool,
                   window: Optional[int]):
    """Plain version of the dk/dv kernel: dv = P^T . dO, dk = scale * dS^T . Q."""
    p, ds = _p_ds_plain(q, k, v, g_out, lse, delta, scale, causal, window)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g_out.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_backward_plain(q, k, v, out, lse, g_out, g_lse, scale: float, causal: bool,
                          window: Optional[int] = None):
    """Plain PyTorch version of the two backward kernels: the same formulas,
    P recomputed from the saved lse and ``g_lse`` folded into delta (None:
    no lse cotangent). Returns (dq, dk, dv) in the inputs' dtypes."""
    delta = _delta(out, g_out, g_lse)
    dq = _bwd_dq_plain(q, k, v, g_out, lse, delta, scale, causal, window)
    dk, dv = _bwd_dkv_plain(q, k, v, g_out, lse, delta, scale, causal, window)
    return dq, dk, dv


def _bwd_launch(what: str, q, k, v, g_out, lse, delta, outs, scale, causal, window):
    _check_kernel_inputs(what, q, k, v)
    B, H, Tq, D = q.shape
    if g_out.shape != q.shape or g_out.dtype != q.dtype:
        raise ValueError(f"{what}: dO must match q, got {tuple(g_out.shape)} {g_out.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, Tq) or t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be f32 [B, H, Tq], got "
                             f"{tuple(t.shape)} {t.dtype}")
    ins = [t.contiguous() for t in (q, k, v, g_out, lse, delta)]
    lib = _build.library("attention_bwd", _BWD_PROTOTYPES)
    err = getattr(lib, what)(
        *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
        B * H, Tq, k.shape[2], D, _build.dtype_code(q), scale, int(causal),
        0 if window is None else int(window),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, what)


def flash_attention_backward_dq(q, k, v, g_out, lse, delta, scale: float, causal: bool,
                                window: Optional[int] = None) -> torch.Tensor:
    """The dq kernel on CUDA tensors: q, dO [B,H,Tq,D], k, v [B,H,Tk,D], lse
    and delta f32 [B,H,Tq] -> dq [B,H,Tq,D] in q's dtype."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch("flash_attention_backward_dq", q, k, v, g_out, lse, delta, (dq,),
                scale, causal, window)
    flash_attention_backward_dq.launches += 1
    return dq


def flash_attention_backward_dkv(q, k, v, g_out, lse, delta, scale: float, causal: bool,
                                 window: Optional[int] = None):
    """The dk/dv kernel on CUDA tensors (inputs as the dq kernel) ->
    (dk, dv) [B,H,Tk,D] in k's dtype."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    _bwd_launch("flash_attention_backward_dkv", q, k, v, g_out, lse, delta, (dk, dv),
                scale, causal, window)
    flash_attention_backward_dkv.launches += 1
    return dk, dv


flash_attention_backward_dq.launches = 0
flash_attention_backward_dkv.launches = 0


def _flash_backward_kernel(q, k, v, out, lse, g_out, g_lse, scale: float, causal: bool,
                           window: Optional[int] = None):
    delta = _delta(out, g_out, g_lse)
    dq = flash_attention_backward_dq(q, k, v, g_out, lse, delta, scale, causal, window)
    dk, dv = flash_attention_backward_dkv(q, k, v, g_out, lse, delta, scale, causal, window)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, saving (q, k, v, out, lse), and the two backward
    kernels; the plain versions when ``plain``. Takes the lse cotangent too
    (``None`` when the lse is unused: it folds away)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, plain):
        # the tensors the kernel reads are the ones saved: a permuted view
        # is copied once here, not again in the backward
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        fwd = _flash_forward_plain if plain else _flash_forward_kernel
        out, lse = fwd(q, k, v, scale, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, window, plain)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        if g_out is None and g_lse is None:
            return (None,) * 7
        q, k, v, out, lse = ctx.saved_tensors
        scale, causal, window, plain = ctx.args
        if g_out is None:
            g_out = torch.zeros_like(out)
        bwd = _flash_backward_plain if plain else _flash_backward_kernel
        dq, dk, dv = bwd(q, k, v, out, lse, g_out, g_lse, scale, causal, window)
        return dq, dk, dv, None, None, None, None


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sm_scale: Optional[float] = None,
    causal: bool = True,
    window: Optional[int] = None,
    *,
    use_kernel: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention that also returns the per-row logsumexp.

    q, k, v: [B, H, T, D]. Returns (out [B,H,Tq,D], lse [B,H,Tq] f32); the
    lse makes partial results combinable (ring attention). ``window``:
    key j visible to query i iff j > i - window. Differentiable in q, k, v
    through both outputs. The TPU driver's ``block_q``/``block_k`` arguments
    have no counterpart: the kernels' tiles are fixed. ``use_kernel=False``
    runs the plain versions on any device."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window} (0 would mask every key)")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    plain = use_kernel is False or q.device.type == "cpu"
    return _FlashAttention.apply(q, k, v, scale, causal, window, plain)


flash_attention_with_lse.launches = 0


def flash_attention(q, k, v, sm_scale: Optional[float] = None, causal: bool = True, *,
                    use_kernel: Optional[bool] = None):
    """Blockwise flash attention. q, k, v: [B, H, T, D] -> [B, H, Tq, D]."""
    return flash_attention_with_lse(q, k, v, sm_scale, causal, use_kernel=use_kernel)[0]


def sliding_window_attention(
    q, k, v, window: int, *, sm_scale: Optional[float] = None, causal: bool = True,
    use_kernel: Optional[bool] = None,
):
    """Local (sliding-window) flash attention: with ``causal=True`` query i
    sees keys in (i - window, i]; with ``causal=False`` the window bounds
    only the past. Tiles wholly outside the window are skipped."""
    return flash_attention_with_lse(
        q, k, v, sm_scale, causal, window, use_kernel=use_kernel
    )[0]


def _reference_attention(q, k, v, sm_scale: float, causal: bool):
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        Tq, Tk = s.shape[-2], s.shape[-1]
        mask = torch.arange(Tk, device=q.device)[None, :] <= torch.arange(Tq, device=q.device)[:, None]
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def mha(q, k, v, *, causal: bool = True, sm_scale: Optional[float] = None):
    """Plain reference attention (for tests and small shapes)."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _reference_attention(q, k, v, scale, causal)
