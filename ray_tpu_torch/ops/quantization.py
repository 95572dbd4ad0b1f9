"""Weight quantization: int8 storage and the int8 weight-only matmul.

Counterpart of ``ray_tpu/ops/quantization.py``. Decode-time matmuls are
bound by the bytes of the WEIGHTS (the batch is small, the weights are not),
so storing them int8 halves the bytes per token against bf16; the scale is
one multiply per output next to the weight stream.

- :func:`quantize_int8` — symmetric per-channel absmax quantization; the
  int8 values and scales equal the JAX package's bit for bit
  (``torch.round`` rounds half to even, as ``jnp.round`` does).
- :func:`int8_matmul` — ``x @ (w_q * scales)`` with the weights kept int8 in
  device memory (W8A16: activations stay f32/bf16). Kernel
  ``csrc/int8_matmul.cu::int8_matmul`` (replaces the TPU kernel
  ``_int8_matmul_kernel``); the source file says what bounds it on the H100
  and what its design does about it.
- :func:`quantize_tree` / :func:`dequantize_tree` — nested-dict helpers for
  whole-model weight sets; :func:`quantize_layers` for the stacked layer
  leaves the serving engine quantizes.

Dispatch: a tensor on the CPU goes to the plain PyTorch version
(:func:`_int8_matmul_plain`); any other tensor launches the CUDA kernel or
raises. The kernel has two routes, chosen by :func:`matmul_route` from x's
dtype and the shape alone: ``"mma_bf16"`` (bf16 x with N % 16 == 0 and
K % 8 == 0, decode and prefill alike: the weights converted in registers as
the tensor cores' A operand) and ``"simt"`` (f32 x, whose parity limit rules
out rounding x to bf16, and ragged bf16 shapes: scalar FMAs). The wrapper
counts its kernel launches in ``int8_matmul.launches`` and per route in
``int8_matmul.launches_by_route``.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Tuple

import torch

from ray_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_PROTOTYPES = {
    # x, w, scales, out, M, K, N, x_dtype, route, stream
    "int8_matmul": [_P] * 4 + [_I] * 5 + [_P],
}

ROUTES = ("mma_bf16", "simt")
_ROUTE_CODES = {"simt": 0, "mma_bf16": 1}


def matmul_route(dtype: torch.dtype, M: int, K: int, N: int) -> str:
    """The kernel route of :func:`int8_matmul` for x of ``dtype`` [M, K] and
    w_q [K, N]: ``"mma_bf16"`` (tensor cores) for bf16 x at any M when the
    16-byte loads fit (N % 16 == 0, K % 8 == 0), else ``"simt"`` (scalar
    FMAs; every f32 x). Raises for a dtype no kernel takes."""
    if dtype == torch.bfloat16:
        return "mma_bf16" if N % 16 == 0 and K % 8 == 0 else "simt"
    if dtype == torch.float32:
        return "simt"
    raise TypeError(f"the int8 matmul kernel takes float32 or bfloat16 x, got {dtype}")


def _lib():
    return _build.library("int8_matmul", _PROTOTYPES)


def quantize_int8(w: torch.Tensor, axis: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 quantization, per channel along every axis
    EXCEPT ``axis`` (the contraction axis that gets summed in a matmul).

    Returns (w_q int8 same shape, scales f32 with ``axis`` reduced to 1);
    ``w ~= w_q * scales``. An all-zero channel gets scale 1."""
    wf = w.float()
    absmax = wf.abs().amax(dim=axis, keepdim=True)
    scales = torch.where(absmax == 0, 1.0, absmax / 127.0)
    w_q = torch.clamp(torch.round(wf / scales), -127, 127).to(torch.int8)
    return w_q, scales


def dequantize_int8(w_q: torch.Tensor, scales: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (w_q.float() * scales).to(dtype)


def _int8_matmul_plain(x, w_q, scales, out_dtype):
    """Plain PyTorch version of the kernel: dequantize in f32, then one f32
    product (the reference of ``tests/test_quantization.py``)."""
    return (x.float() @ dequantize_int8(w_q, scales.reshape(1, -1))).to(out_dtype)


def int8_matmul(
    x: torch.Tensor,       # [M, K] f32/bf16 activations
    w_q: torch.Tensor,     # [K, N] int8 weights
    scales: torch.Tensor,  # [1, N] or [N] f32 per-output-column scales
    *,
    block_m: int = 256,
    block_n: int = 256,
    block_k: int = 512,
    out_dtype=None,
) -> torch.Tensor:
    """``x @ (w_q * scales)`` with the weights kept int8; the sum is in f32
    and the result is ``out_dtype`` (default ``x.dtype``).

    ``block_m/n/k`` are the TPU kernel's VMEM tile sizes. They are accepted
    so calls read like the JAX ones and are ignored: the CUDA kernel picks
    its own tiles and masks ragged edges instead of padding."""
    M, K = x.shape
    K2, N = w_q.shape
    if K != K2:
        raise ValueError(f"x {tuple(x.shape)} and w_q {tuple(w_q.shape)} do not contract")
    scales = scales.reshape(N).float()
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return _int8_matmul_plain(x, w_q, scales, out_dtype)
    return _int8_matmul_cuda(x, w_q, scales, out_dtype)


int8_matmul.launches = 0
int8_matmul.launches_by_route = dict.fromkeys(ROUTES, 0)


def _int8_matmul_cuda(x, w_q, scales, out_dtype, route=None):
    """Launches the kernel on the route :func:`matmul_route` gives; ``route``
    overrides it (measurements only: the kernel refuses what a route does not
    take)."""
    if x.device.type != "cuda":
        raise RuntimeError(f"the int8 matmul kernel runs on CUDA tensors, got {x.device}")
    for name, t in (("w_q", w_q), ("scales", scales)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if w_q.dtype != torch.int8:
        raise TypeError(f"w_q must be int8, got {w_q.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    M, K = x.shape
    N = w_q.shape[1]
    # The kernel writes x's dtype. An f32 result from bf16 x is the same
    # function on x.float() (exact); a bf16 result from f32 x is the f32
    # result rounded once, as the kernel's epilogue would round it.
    if out_dtype == torch.float32:
        x = x.float()
    x, w_q, scales = x.contiguous(), w_q.contiguous(), scales.contiguous()
    out = torch.empty(M, N, dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out.to(out_dtype)
    forced, route = route is not None, route or matmul_route(x.dtype, M, K, N)
    if not forced and route == "mma_bf16" and any(t.data_ptr() % 16 for t in (x, w_q, scales, out)):
        route = "simt"  # a view at an odd offset: the narrow loads take it
    err = _lib().int8_matmul(
        x.data_ptr(), w_q.data_ptr(), scales.data_ptr(), out.data_ptr(),
        M, K, N, _build.dtype_code(x), _ROUTE_CODES[route],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "int8_matmul")
    int8_matmul.launches += 1
    int8_matmul.launches_by_route[route] += 1
    return out.to(out_dtype)


# ---------------------------------------------------------------------------
# tree helpers (nested dicts of tensors, the port's param layout)
# ---------------------------------------------------------------------------
class _NoScale:
    """Sentinel leaf marking an unquantized entry in the scales tree (one
    instance, so ``is NO_SCALE`` holds after a pickle round trip too)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "NO_SCALE"


NO_SCALE = _NoScale()


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def quantize_tree(params: Any, *, min_size: int = 4096, contract_axis: int = 0) -> Tuple[Any, Any]:
    """Quantize every float tensor leaf with >= min_size elements and
    ndim >= 2. Returns (tree with int8 leaves where quantized, scales tree
    with f32 scale leaves there and NO_SCALE elsewhere)."""

    def q(leaf):
        if (isinstance(leaf, torch.Tensor) and leaf.ndim >= 2 and leaf.numel() >= min_size
                and leaf.is_floating_point()):
            return quantize_int8(leaf, axis=contract_axis if contract_axis < leaf.ndim else 0)
        return leaf, NO_SCALE

    pairs = _map(q, params)
    return _map(lambda p: p[0], pairs), _map(lambda p: p[1], pairs)


def dequantize_tree(wq: Any, scales: Any, dtype=torch.float32) -> Any:
    return _map(lambda w, s: w if s is NO_SCALE else dequantize_int8(w, s, dtype), wq, scales)


# keys of the transformer's stacked-layer LINEAR weights (the
# ray_tpu_torch.models.transformer.init_params layout) — the bandwidth bulk
# worth quantizing; norm gains stay exact and the embedding keeps output
# quality
TRANSFORMER_LINEAR_KEYS = frozenset(
    {"wq", "wk", "wv", "wo", "w1", "w2", "w3", "we1", "we2", "we3", "router"}
)


def quantize_layers(
    layers: Dict[str, torch.Tensor],
    *,
    keys=TRANSFORMER_LINEAR_KEYS,
    min_size: int = 4096,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Quantize a stacked-layer dict ([L, ...] leaves) for int8 serving.

    Returns (layers with int8 leaves where quantized, a DENSE scales dict —
    broadcast-ones where unquantized — with leading dim L). The quantization
    axis is 1 (the first per-layer axis); ``min_size`` applies to the whole
    stacked leaf."""
    q, sc = {}, {}
    for k, w in layers.items():
        if k in keys and w.numel() >= min_size and w.is_floating_point():
            q[k], sc[k] = quantize_int8(w, axis=1)
        else:
            q[k] = w
            sc[k] = torch.ones((w.shape[0],) + (1,) * (w.ndim - 1), dtype=torch.float32,
                               device=w.device)
    return q, sc
