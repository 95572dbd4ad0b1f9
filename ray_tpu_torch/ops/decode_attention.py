"""Single-token (decode) attention over a KV cache, dense or paged.

Counterpart of ``ray_tpu/ops/decode_attention.py``. One query row per
sequence attends over its cache; K/V are read once per GQA group.

- :func:`decode_attention` — dense cache ``[B, Hkv, S, D]``; kernel
  ``csrc/decode_attention.cu::decode_attention`` (replaces the TPU kernel
  ``_decode_kernel``).
- :func:`paged_decode_attention` — shared page pool ``[N, bs, Hkv, D]`` read
  through ``int32[B, M]`` block tables (PagedAttention); kernel
  ``csrc/decode_attention.cu::paged_decode_attention`` (replaces
  ``_paged_decode_kernel``). The source file says what bounds the kernel on
  the H100 and what its design does about it.

Dispatch: a tensor on the CPU goes to the plain PyTorch version
(:func:`_decode_plain`, :func:`_paged_decode_plain`); any other tensor
launches the CUDA kernel or raises. ``use_kernel=False`` asks for the plain
version on any device (the on-card oracle). :func:`decode_plan` sets the
launch from the shapes alone: the query heads a block takes and its warps.
Each wrapper counts its kernel launches in ``launches``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.attention import NEG_INF

_P = ctypes.c_void_p
_I = ctypes.c_int
_PROTOTYPES = {
    # q, k_pages, v_pages, block_tables, lengths, out, B, H, Hkv, D,
    # block_size, max_blocks, dtype, scale, rows_per_pass, warps, stream
    "paged_decode_attention": [_P] * 6 + [_I] * 7 + [ctypes.c_float] + [_I] * 2 + [_P],
    # q, k, v, lengths, out, B, H, Hkv, S, D, dtype, scale, rows_per_pass,
    # warps, stream
    "decode_attention": [_P] * 5 + [_I] * 6 + [ctypes.c_float] + [_I] * 2 + [_P],
}



def max_warps(rows_per_pass: int) -> int:
    """The most warps a block of the kernel takes (its launch bound: 16 keep
    a thread at 128 registers, which one or two query rows fit)."""
    return 16 if rows_per_pass <= 2 else 4


def decode_plan(B: int, Hkv: int, n_rep: int, sm_count: int) -> Tuple[int, int]:
    """(rows_per_pass, warps) of a decode launch, from the shapes alone (the
    lengths are never read: that would cost a host sync a step). A block
    takes R = 1, 2 or 4 query heads of its GQA group (the kernel's register
    width; more heads are more blocks) and one row's positions. Where the
    B * Hkv * passes blocks fill the SMs, each has 4 warps; else each has
    the most warps it may."""
    rows = 1 if n_rep == 1 else 2 if n_rep == 2 else 4
    blocks = B * Hkv * -(-n_rep // rows)
    return rows, 4 if blocks >= sm_count else max_warps(rows)


_SM_COUNT: Dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    i = device.index if device.index is not None else torch.cuda.current_device()
    if i not in _SM_COUNT:
        _SM_COUNT[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SM_COUNT[i]


def _lib():
    return _build.library("decode_attention", _PROTOTYPES)


def _check_inputs(q, k, v, lengths, D):
    if q.device.type != "cuda":
        raise RuntimeError(f"the decode kernel runs on CUDA tensors, got {q.device}")
    for name, t in (("k", k), ("v", v), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in (64, 128):
        raise ValueError(f"the decode kernel takes head_dim 64 or 128, got {D}")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the KV cache must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):  # rows are read in 16-byte vectors
        raise ValueError("q and the KV cache must be 16-byte aligned")


def _decode_plain(q, k_cache, v_cache, lengths, scale):
    """Plain PyTorch version of the dense decode kernel (the math of
    ``_decode_kernel``): masked grouped einsum in f32; a row with
    ``lengths[b] == 0`` gives zeros. Returns [B, H, D] in f32."""
    B, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, D).float()
    s = torch.einsum("bgrk,bgsk->bgrs", qg, k_cache.float()) * scale
    vis = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(vis[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where((lengths > 0)[:, None, None, None], p, 0.0)
    return torch.einsum("bgrs,bgsk->bgrk", p, v_cache.float()).reshape(B, H, D)


def decode_attention(
    q: torch.Tensor,        # [B, H, D] one query row per sequence
    k_cache: torch.Tensor,  # [B, Hkv, S, D]
    v_cache: torch.Tensor,  # [B, Hkv, S, D]
    lengths: torch.Tensor,  # [B] int: valid cache entries per sequence
    *,
    sm_scale: Optional[float] = None,
    block_s: int = 512,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """Returns [B, H, D] in q's dtype. H must be a multiple of Hkv.

    ``block_s`` is the TPU kernel's cache block (VMEM tile) size. It is
    accepted so calls read like the JAX ones and is ignored: the CUDA kernel
    picks its own tiles and masks the ragged tail instead of padding."""
    del block_s
    B, H, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    if use_kernel is False or q.device.type == "cpu":
        return _decode_plain(q, k_cache, v_cache, lengths, scale).to(q.dtype)
    q = q.contiguous()
    _check_inputs(q, k_cache, v_cache, lengths, D)
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    rows, warps = decode_plan(B, Hkv, H // Hkv, _sm_count(q.device))
    err = _lib().decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, H, Hkv, S, D, _build.dtype_code(q), scale, rows, warps,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def _paged_decode_plain(q, k_pages, v_pages, block_tables, lengths, scale):
    """Plain PyTorch version of the paged decode kernel, mirroring
    ``_paged_decode_xla``: gather each sequence's pages into a dense
    [B, Hkv, M*bs, D] view and run the masked grouped einsum in f32.
    Returns [B, H, D] in f32."""
    B, H, D = q.shape
    _, bs, Hkv, _ = k_pages.shape
    M = block_tables.shape[1]
    idx = block_tables.long()
    k = k_pages[idx].permute(0, 3, 1, 2, 4).reshape(B, Hkv, M * bs, D)
    v = v_pages[idx].permute(0, 3, 1, 2, 4).reshape(B, Hkv, M * bs, D)
    qg = q.reshape(B, Hkv, H // Hkv, D).float()
    s = torch.einsum("bgrk,bgsk->bgrs", qg, k.float()) * scale
    vis = torch.arange(M * bs, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(vis[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # a fully-masked row softmaxes to uniform garbage; zero it like the kernel
    p = torch.where((lengths > 0)[:, None, None, None], p, 0.0)
    return torch.einsum("bgrs,bgsk->bgrk", p, v.float()).reshape(B, H, D)


def paged_decode_attention(
    q: torch.Tensor,             # [B, H, D] one query row per sequence
    k_pages: torch.Tensor,       # [num_blocks, block_size, Hkv, D] shared pool
    v_pages: torch.Tensor,       # [num_blocks, block_size, Hkv, D]
    block_tables: torch.Tensor,  # [B, M] int: physical page per logical block
    lengths: torch.Tensor,       # [B] int: valid cache entries per sequence
    *,
    sm_scale: Optional[float] = None,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """Decode attention over a paged KV pool; returns [B, H, D] in q's dtype.

    Table entries past ``ceil(lengths[b] / block_size)`` may point anywhere
    valid (the engine points them at the reserved garbage page 0): they are
    never read by the kernel and masked out of the plain version."""
    B, H, D = q.shape
    _, bs, Hkv, _ = k_pages.shape
    M = block_tables.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    if use_kernel is False or q.device.type == "cpu":
        return _paged_decode_plain(q, k_pages, v_pages, block_tables, lengths, scale).to(q.dtype)
    q = q.contiguous()
    _check_inputs(q, k_pages, v_pages, lengths, D)
    if block_tables.device != q.device:
        raise ValueError(f"block_tables is on {block_tables.device}, q on {q.device}")
    block_tables = block_tables.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    rows, warps = decode_plan(B, Hkv, H // Hkv, _sm_count(q.device))
    err = _lib().paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, H, Hkv, D, bs, M, _build.dtype_code(q),
        scale, rows, warps, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
