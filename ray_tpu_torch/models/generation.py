"""KV-cache autoregressive decoding for the decoder.

Counterpart of ``ray_tpu/models/generation.py``. The JAX code donates its
cache buffers to each jitted step; here the caches are plain tensors that
every call updates in place (the functions still return them, so call sites
read like the JAX ones). Shapes stay static as in the JAX code: the dense
cache is ``[L, B, Hkv, max_len, Dh]``, the paged pool
``[L, num_blocks, block_size, Hkv, Dh]`` with page 0 as the garbage page.

Kernel choice keys on the tensors' device, as the JAX code keys on the TPU
backend: on a CUDA device single-token steps go through the decode kernels
and :func:`prefill` through the flash kernel; elsewhere the grouped einsum
runs. ``use_decode_kernel=`` / ``use_prefill_kernel=`` keep their JAX
meaning, so a caller can pick the plain path on purpose. With
``layer_scales=`` (int8 weight-only serving) the layer linears go through
``int8_matmul``, the int8 matmul kernel on a CUDA device.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    _dequantized,
    _ffn,
    _product,
    _rms_norm,
    _rope,
    embed_tokens,
    gather_paged_kv,
    layer_params,
    scatter_paged_kv,
)
from ray_tpu_torch.ops.attention import NEG_INF, flash_attention
from ray_tpu_torch.ops.decode_attention import decode_attention, paged_decode_attention

KVCache = Dict[str, torch.Tensor]


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None, device=None) -> KVCache:
    """Preallocated KV cache: {"k","v"}: [L, B, Hkv, max_len, Dh]."""
    dt = dtype or cfg.dtype
    shape = (cfg.n_layers, batch, cfg.kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_paged_cache(
    cfg: TransformerConfig, num_blocks: int, block_size: int, dtype=None, device=None
) -> KVCache:
    """Paged KV pool: {"k","v"}: [L, num_blocks, block_size, Hkv, Dh].
    Page 0 is reserved as the garbage page (all-zero table entries and
    masked writes land there)."""
    dt = dtype or cfg.dtype
    shape = (cfg.n_layers, num_blocks, block_size, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def copy_paged_page(cache: KVCache, src: int, dst: int) -> KVCache:
    """Copy one physical page — every layer's K and V rows — from ``src`` to
    ``dst``, in place (the engine's copy-on-write primitive). Page 0 must
    never be a destination."""
    for kk in ("k", "v"):
        cache[kk][:, dst].copy_(cache[kk][:, src])
    return cache


def _write_kv(cache_layer: torch.Tensor, new: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """cache_layer [B,Hkv,S,Dh] <- new [B,T,Hkv,Dh] at per-row offset
    starts[B], in place. Like ``dynamic_update_slice``, a start is clamped
    to [0, S - T] so the update always fits."""
    B, T, Hkv, Dh = new.shape
    S = cache_layer.shape[2]
    st = torch.clamp(starts.long(), 0, S - T)
    idx = (st[:, None] + torch.arange(T, device=new.device)[None, :])  # [B, T]
    idx = idx[:, None, :, None].expand(B, Hkv, T, Dh)
    cache_layer.scatter_(2, idx, new.permute(0, 2, 1, 3).to(cache_layer.dtype))
    return cache_layer


def _grouped_attention(cfg, q, kc, vc, vis, scale):
    """Grouped-query attention of q [B,T,H,Dh] against a dense view
    kc/vc [B,Hkv,S,Dh]; ``vis`` [B,1,T,S] marks the visible keys."""
    B, T = q.shape[:2]
    hkv, n_rep = cfg.kv_heads, cfg.n_heads // cfg.kv_heads
    qg = q.reshape(B, T, hkv, n_rep, cfg.head_dim)
    s_ = torch.einsum("btgrk,bgsk->bgrts", qg.float(), kc.float()) * scale
    s_ = torch.where(vis[:, :, None], s_, NEG_INF)
    p = torch.softmax(s_, dim=-1)
    o = torch.einsum("bgrts,bgsk->btgrk", p, vc.float())
    return o.reshape(B, T, cfg.n_heads, cfg.head_dim)


def _layer_scales(layer_scales, i):
    """Layer ``i``'s int8-serving scales, or None for float layers."""
    return None if layer_scales is None else {k: s[i] for k, s in layer_scales.items()}


def _qkv(cfg, layer, x, positions, scales=None):
    h = _rms_norm(x, _dequantized(cfg, layer, scales, "attn_norm"))
    q, k, v = (_product(cfg, layer, scales, name, h) for name in ("wq", "wk", "wv"))
    return _rope(q, positions, cfg.rope_theta), _rope(k, positions, cfg.rope_theta), v


def _finish_layer(cfg, layer, x, o, scales=None):
    x = x + _product(cfg, layer, scales, "wo", o, n_contract=2)
    h = _rms_norm(x, _dequantized(cfg, layer, scales, "ffn_norm"))
    return x + _ffn(cfg, layer, h, scales)


def _logits(params, x):
    x = _rms_norm(x, params["final_norm"])
    return torch.einsum("btd,vd->btv", x, params["embed"].to(x.dtype)).float()


def forward_with_cache(
    cfg: TransformerConfig,
    params: Dict[str, Any],
    cache: KVCache,
    tokens: torch.Tensor,     # [B, T] (T = prompt len for prefill, 1 for decode)
    positions: torch.Tensor,  # [B, T] absolute positions (contiguous per row)
    *,
    use_decode_kernel: Optional[bool] = None,
    use_prefill_kernel: Optional[bool] = None,
    layer_scales: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """One cached forward pass: writes this call's K/V into ``cache`` (in
    place) at ``positions`` and attends over everything up to them. Returns
    (logits [B, T, V] f32, cache).

    ``use_decode_kernel``: single-token steps through the decode kernel;
    default on for CUDA tensors. ``use_prefill_kernel``: ONLY valid when
    every row's positions start at 0 (the :func:`prefill` contract) —
    attention then sees just this call's K/V, which is causal flash
    attention over T tokens. Default off here.

    ``layer_scales``: int8 weight-only serving — the scales of
    ``params['layers']`` as :func:`ray_tpu_torch.ops.quantization.quantize_layers`
    returns them (leading dim L; ones for unquantized leaves). Each layer's
    int8 linears then run the int8 matmul (K6) where their scales allow it
    and are dequantized one layer at a time otherwise (``_product``)."""
    B, T = tokens.shape
    S = cache["k"].shape[3]
    n_rep = cfg.n_heads // cfg.kv_heads
    scale = 1.0 / math.sqrt(cfg.head_dim)
    x = embed_tokens(cfg, params, tokens)
    starts = positions[:, 0]
    if use_decode_kernel is None:
        use_decode_kernel = tokens.device.type == "cuda"
    decode_kernel = use_decode_kernel and T == 1
    prefill_kernel = bool(use_prefill_kernel) and T > 1
    vis = None
    if not (decode_kernel or prefill_kernel):
        # key s visible to query t iff s <= position(t): causal over the cache
        kv_pos = torch.arange(S, device=tokens.device)
        vis = kv_pos[None, None, None, :] <= positions[:, None, :, None]  # [B,1,T,S]

    for i in range(cfg.n_layers):
        layer, sc = layer_params(params, i), _layer_scales(layer_scales, i)
        kc, vc = cache["k"][i], cache["v"][i]
        q, k, v = _qkv(cfg, layer, x, positions, sc)
        _write_kv(kc, k, starts)
        _write_kv(vc, v, starts)
        if decode_kernel:
            o = decode_attention(q[:, 0], kc, vc, starts + 1, sm_scale=scale)[:, None]
        elif prefill_kernel:
            kr = torch.repeat_interleave(k, n_rep, dim=2) if n_rep > 1 else k
            vr = torch.repeat_interleave(v, n_rep, dim=2) if n_rep > 1 else v
            o = flash_attention(
                q.permute(0, 2, 1, 3), kr.permute(0, 2, 1, 3), vr.permute(0, 2, 1, 3),
                scale, True,
            ).permute(0, 2, 1, 3)
        else:
            o = _grouped_attention(cfg, q, kc, vc, vis, scale)
        x = _finish_layer(cfg, layer, x, o.to(x.dtype), sc)
    return _logits(params, x), cache


def paged_forward_with_cache(
    cfg: TransformerConfig,
    params: Dict[str, Any],
    cache: KVCache,              # paged pool from init_paged_cache
    block_tables: torch.Tensor,  # [B, M] physical page per logical block
    tokens: torch.Tensor,        # [B, T] (T = chunk len for prefill, 1 for decode)
    positions: torch.Tensor,     # [B, T] absolute positions (contiguous per row)
    *,
    valid: Optional[torch.Tensor] = None,  # [B, T] bool: False = pad, don't cache
    use_decode_kernel: Optional[bool] = None,
    layer_scales: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """:func:`forward_with_cache` over a paged pool: writes this call's K/V
    through the block tables (in place) and attends over every cached
    position up to ``positions``. Single-token calls on CUDA run the paged
    decode kernel; otherwise the pool is gathered to a dense view and the
    attention is the dense path's. ``valid`` routes bucket-padded tail
    tokens to the garbage page 0 (their logits compute and are never read).
    Chunked prefill is this function with ``positions`` starting
    mid-sequence. ``layer_scales`` as in :func:`forward_with_cache`."""
    B, T = tokens.shape
    M = block_tables.shape[1]
    bs = cache["k"].shape[2]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    x = embed_tokens(cfg, params, tokens)
    starts = positions[:, 0]
    if use_decode_kernel is None:
        use_decode_kernel = tokens.device.type == "cuda"
    decode_kernel = use_decode_kernel and T == 1
    vis = None
    if not decode_kernel:
        kv_pos = torch.arange(M * bs, device=tokens.device)
        vis = kv_pos[None, None, None, :] <= positions[:, None, :, None]  # [B,1,T,cap]

    for i in range(cfg.n_layers):
        layer, sc = layer_params(params, i), _layer_scales(layer_scales, i)
        kc, vc = cache["k"][i], cache["v"][i]
        q, k, v = _qkv(cfg, layer, x, positions, sc)
        scatter_paged_kv(kc, k, block_tables, positions, valid)
        scatter_paged_kv(vc, v, block_tables, positions, valid)
        if decode_kernel:
            o = paged_decode_attention(
                q[:, 0], kc, vc, block_tables, starts + 1, sm_scale=scale
            )[:, None]
        else:
            # masked positions get exactly-0 weight: page-0 garbage never
            # reaches the output
            kd = gather_paged_kv(kc, block_tables)
            vd = gather_paged_kv(vc, block_tables)
            o = _grouped_attention(cfg, q, kd, vd, vis, scale)
        x = _finish_layer(cfg, layer, x, o.to(x.dtype), sc)
    return _logits(params, x), cache


def paged_decode_step(
    cfg: TransformerConfig,
    params: Dict[str, Any],
    cache: KVCache,
    tokens: torch.Tensor,        # [B] the previously sampled token per row
    positions: torch.Tensor,     # [B] the absolute position to write it at
    block_tables: torch.Tensor,  # [B, M]
    **fw_kwargs,
) -> Tuple[torch.Tensor, KVCache]:
    """One paged decode step: (logits [B, V], cache)."""
    logits, cache = paged_forward_with_cache(
        cfg, params, cache, block_tables, tokens[:, None], positions[:, None], **fw_kwargs
    )
    return logits[:, 0], cache


def prefill(
    cfg: TransformerConfig,
    params: Dict[str, Any],
    cache: KVCache,
    tokens: torch.Tensor,   # [B, Tp] right-padded prompts
    lengths: torch.Tensor,  # [B] true prompt lengths (>= 1)
    **fw_kwargs,
) -> Tuple[torch.Tensor, KVCache]:
    """Fill the cache from position 0 and return the last real token's
    logits per row: (logits [B, V], cache). Positions provably start at 0
    here, so on CUDA the flash kernel is the default."""
    B, Tp = tokens.shape
    positions = torch.arange(Tp, device=tokens.device)[None, :].expand(B, Tp)
    fw_kwargs.setdefault("use_prefill_kernel", tokens.device.type == "cuda")
    logits, cache = forward_with_cache(cfg, params, cache, tokens, positions, **fw_kwargs)
    last = logits[torch.arange(B, device=logits.device), lengths.long() - 1]
    return last, cache


def decode_step(
    cfg: TransformerConfig,
    params: Dict[str, Any],
    cache: KVCache,
    tokens: torch.Tensor,     # [B] the previously sampled token per row
    positions: torch.Tensor,  # [B] the absolute position to write it at
    **fw_kwargs,
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step: (logits [B, V], cache)."""
    logits, cache = forward_with_cache(
        cfg, params, cache, tokens[:, None], positions[:, None], **fw_kwargs
    )
    return logits[:, 0], cache


def filter_top_k_top_p(
    logits: torch.Tensor, top_k: Optional[int] = None, top_p: Optional[float] = None
) -> torch.Tensor:
    """Mask logits outside the top-k set / top-p nucleus to -1e30. Shared by
    :func:`sample_logits` and the serving engine."""
    if top_k is not None and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix with cumulative mass >= top_p (always >= 1 token)
        keep = cum - probs < top_p
        cutoff = torch.where(keep, sorted_logits, math.inf).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, NEG_INF, logits)
    return logits


def sample_logits(
    logits: torch.Tensor,  # [B, V] f32
    generator: Optional[torch.Generator] = None,
    *,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
) -> torch.Tensor:
    """Greedy (temperature == 0) or temperature/top-k/top-p sampling.
    ``generator`` must live on ``logits``' device; its numbers differ from
    ``jax.random``'s, so only greedy outputs compare across frameworks."""
    if temperature == 0:
        return torch.argmax(logits, dim=-1)
    logits = filter_top_k_top_p(logits / temperature, top_k, top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(
    cfg: TransformerConfig,
    params: Dict[str, Any],
    prompt: torch.Tensor,                          # [B, Tp] right-padded
    prompt_lengths: Optional[torch.Tensor] = None,  # [B]; defaults to full rows
    *,
    max_new_tokens: int,
    generator: Optional[torch.Generator] = None,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    eos_id: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched autoregressive generation on ``prompt``'s device.

    Returns (tokens [B, Tp + max_new_tokens] with each row = prompt followed
    by its generated continuation, lengths [B] = prompt + generated counts).
    Rows that hit ``eos_id`` stop counting (the eos itself is included) and
    pad with ``eos_id`` thereafter."""
    B, Tp = prompt.shape
    dev = prompt.device
    if prompt_lengths is None:
        prompt_lengths = torch.full((B,), Tp, dtype=torch.long, device=dev)
    prompt_lengths = prompt_lengths.long()
    total = Tp + max_new_tokens
    cache = init_cache(cfg, B, total, device=dev)
    last_logits, cache = prefill(cfg, params, cache, prompt, prompt_lengths)
    pad_tok = eos_id if eos_id is not None else 0

    def _sample(logits, done):
        tok = sample_logits(logits, generator, temperature=temperature, top_k=top_k, top_p=top_p)
        tok = torch.where(done, pad_tok, tok)
        new_done = done | (tok == eos_id) if eos_id is not None else done
        return tok, new_done

    # the first token comes straight from the prefill logits; each step then
    # decodes exactly one forward per sampled token
    tok, done = _sample(last_logits, torch.zeros(B, dtype=torch.bool, device=dev))
    toks, was_done = [tok], [torch.zeros(B, dtype=torch.bool, device=dev)]
    pos = prompt_lengths
    for _ in range(max_new_tokens - 1):
        logits, cache = decode_step(cfg, params, cache, tok, pos)
        was_done.append(done)
        tok, done = _sample(logits, done)
        toks.append(tok)
        pos = pos + 1
    toks = torch.stack(toks, dim=1)                  # [B, max_new]
    gen_counts = (~torch.stack(was_done, dim=1)).sum(dim=1)

    out = torch.zeros(B, total, dtype=torch.long, device=dev)
    out[:, :Tp] = prompt.long()
    # place each row's continuation right after its true prompt
    cols = prompt_lengths[:, None] + torch.arange(max_new_tokens, device=dev)[None, :]
    out.scatter_(1, cols, toks)
    return out, prompt_lengths + gen_counts
