"""Decoder-only transformer (GPT/Llama-style), the port's forward pass.

Counterpart of ``ray_tpu/models/transformer.py``: RMSNorm + RoPE (split-half
layout) + SwiGLU, tied embeddings scaled by sqrt(d_model), GQA. Params are
the same nested dict with stacked ``[n_layers, ...]`` layer leaves, so a
JAX param tree converts leaf by leaf (:mod:`ray_tpu_torch.convert`). Params
keep ``param_dtype`` and are cast to the activation dtype where they are
used, at the same points as the JAX code, so both sides round alike.

Attention: the flash kernels (:mod:`ray_tpu_torch.ops.attention`, forward
and backward) on CUDA tensors, the grouped einsum elsewhere. The FFN's
products (and, in cached generation, every layer product) go through
``_product``, which also takes int8 leaves with their scales (int8
weight-only serving: the int8 matmul kernel, or dequantization). The FFN is
SwiGLU, or with ``num_experts > 0`` a top-k mixture of SwiGLU experts, in
dense dispatch or, with ``moe_capacity_factor > 0``, capacity dispatch.
Training: :func:`loss_fn` and :func:`make_train_step` (AdamW as
``optax.adamw``), with per-layer rematerialisation.

Under a mesh (``mesh=``; one process a rank) the same layer math runs on
this rank's shards under a :class:`_Layout`: explicit tensor parallelism
over tp (column-parallel wq/wk/wv, w1/w3 and a vocab-parallel embedding
and log-softmax; row-parallel wo and w2 summed over tp), activations
sharded over T on sp (ring attention, or K/V all-gathered), the batch over
dp and the experts over ep. On one device the layout has no axes and every
collective is skipped.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    set_checkpoint_early_stop,
)

from ray_tpu_torch.models.common import JittedStep, as_generator, default_device
from ray_tpu_torch.ops.attention import NEG_INF, flash_attention, flash_attention_with_lse
from ray_tpu_torch.ops.quantization import dequantize_int8, int8_matmul
from ray_tpu_torch.parallel import collective
from ray_tpu_torch.parallel._compat import spmd_roll
from ray_tpu_torch.parallel.mesh import Mesh, P, block_start, shard_array, shard_tree, spec_axes
from ray_tpu_torch.parallel.ring import merge_partials, ring_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: Optional[int] = None  # None => MHA; < n_heads => GQA
    d_ff: int = 2048
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    num_experts: int = 0          # 0 => dense FFN
    expert_top_k: int = 2
    # 0 => dense dispatch (every expert computes every token; exact);
    # > 0 => capacity dispatch: ceil(top_k * T * factor / E) slots an
    # expert, overflow tokens fall through the residual
    moe_capacity_factor: float = 0.0
    dtype: torch.dtype = torch.bfloat16     # activation dtype
    param_dtype: torch.dtype = torch.float32
    attention: str = "auto"  # auto | flash | dense | ring (ring needs an sp mesh axis)
    # Rematerialisation per layer, as the JAX package's: False => save
    # everything; True/"full" => recompute the whole layer in the backward;
    # "dots" => save the matmul outputs, recompute the rest (the policy of
    # jax.checkpoint_policies.dots_saveable). The flash forward is recomputed
    # under both, as the Pallas custom VJP is in JAX.
    remat: Any = False
    # Accepted for config parity: JAX scans or unrolls the layers. Eager
    # PyTorch always loops over them, and the numbers are the same.
    scan_layers: bool = True

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by n_heads {self.n_heads}")
        if self.remat not in (False, True, "full", "dots"):
            # a typo like "Dots" would silently select full-layer recompute
            raise ValueError(f'remat must be False, True, "full", or "dots"; got {self.remat!r}')
        kv = self.n_kv_heads
        if kv is not None and (kv < 1 or kv > self.n_heads or self.n_heads % kv):
            raise ValueError(
                f"n_kv_heads {kv} must be a positive divisor of n_heads {self.n_heads}"
            )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads


def init_params(cfg: TransformerConfig, generator: torch.Generator) -> Dict[str, Any]:
    """Random params drawn from ``generator``, on its device. The shapes and
    the init recipe are the JAX package's; the numbers are not (the two
    frameworks' generators differ) — convert a JAX tree to compare."""
    from ray_tpu_torch.models.common import dense_init as _dinit

    pd = cfg.param_dtype
    d, h, hkv, dh, ff = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_ff
    dev = generator.device

    def dense_init(shape, fan_in):
        return _dinit(generator, shape, fan_in, pd)

    def one_layer():
        layer = {
            "attn_norm": torch.ones(d, dtype=pd, device=dev),
            "wq": dense_init((d, h, dh), d),
            "wk": dense_init((d, hkv, dh), d),
            "wv": dense_init((d, hkv, dh), d),
            "wo": dense_init((h, dh, d), d),
            "ffn_norm": torch.ones(d, dtype=pd, device=dev),
        }
        if cfg.num_experts > 0:
            e = cfg.num_experts
            layer["router"] = dense_init((d, e), d)
            layer["we1"] = dense_init((e, d, ff), d)
            layer["we3"] = dense_init((e, d, ff), d)
            layer["we2"] = dense_init((e, ff, d), ff)
        else:
            layer["w1"] = dense_init((d, ff), d)
            layer["w3"] = dense_init((d, ff), d)
            layer["w2"] = dense_init((ff, d), ff)
        return layer

    embed = dense_init((cfg.vocab_size, d), d)
    per_layer = [one_layer() for _ in range(cfg.n_layers)]
    layers = {k: torch.stack([lay[k] for lay in per_layer]) for k in per_layer[0]}
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": torch.ones(d, dtype=pd, device=dev),
    }


def layer_params(params: Dict[str, Any], i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s leaves (views into the stacked ``[L, ...]`` tensors)."""
    return {k: v[i] for k, v in params["layers"].items()}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _rms_norm(x, scale, eps=1e-6):
    # x * rsqrt promotes to f32 (the rsqrt is f32 in both frameworks), then
    # rounds back to x's dtype before the gain — JAX's expression order
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def _rope(x, positions, theta: float):
    # x: [B, T, H, Dh]; angles and the rotation in f32, cast back at the end
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.exp(
        -torch.arange(0, half, dtype=torch.float32, device=x.device) * (math.log(theta) / half)
    )
    angles = positions[:, :, None].float() * freqs[None, None, :]  # [B,T,half]
    cos, sin = torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _repeat_kv(x, n_rep: int):
    """[B, T, Hkv, Dh] -> [B, T, Hkv*n_rep, Dh] (GQA group broadcast)."""
    if n_rep == 1:
        return x
    B, T, Hkv, Dh = x.shape
    return x[:, :, :, None, :].expand(B, T, Hkv, n_rep, Dh).reshape(B, T, Hkv * n_rep, Dh)


def _gqa_mha(qt, k, v, *, causal: bool, sm_scale: float, q_offset: int = 0):
    """Grouped-query attention with K/V kept at kv-head width.

    qt: [B, H, T, Dh]; k, v: [B, S, Hkv, Dh]. Under ``causal`` query i
    sits at position ``q_offset + i`` of the keys (a sequence shard's
    queries against every key)."""
    B, H, T, Dh = qt.shape
    Hkv = k.shape[2]
    qg = qt.reshape(B, Hkv, H // Hkv, T, Dh)
    kt = k.permute(0, 2, 1, 3)  # [B, Hkv, S, Dh]
    vt = v.permute(0, 2, 1, 3)
    s = torch.einsum("bgrtd,bgsd->bgrts", qg.float(), kt.float()) * sm_scale
    if causal:
        S = s.shape[-1]
        mask = (torch.arange(S, device=qt.device)[None, :]
                <= q_offset + torch.arange(T, device=qt.device)[:, None])
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrts,bgsd->bgrtd", p, vt.float())
    return o.reshape(B, H, T, Dh).to(qt.dtype)


def gather_paged_kv(pages: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Dense view of a paged KV pool: ``[N, bs, Hkv, Dh]`` gathered through
    ``[B, M]`` block tables -> ``[B, Hkv, M*bs, Dh]`` (a copy)."""
    g = pages[block_tables.long()]  # [B, M, bs, Hkv, Dh]
    B, M, bs, Hkv, Dh = g.shape
    return g.permute(0, 3, 1, 2, 4).reshape(B, Hkv, M * bs, Dh)


def scatter_paged_kv(
    pages: torch.Tensor,         # [N, bs, Hkv, Dh] shared pool, updated in place
    new: torch.Tensor,           # [B, T, Hkv, Dh] this call's K or V
    block_tables: torch.Tensor,  # [B, M] physical page per logical block
    positions: torch.Tensor,     # [B, T] absolute write positions
    valid: Optional[torch.Tensor] = None,  # [B, T] bool; False -> garbage page 0
) -> torch.Tensor:
    """Write ``new`` into the pool at per-row ``positions`` routed through
    the block tables, in place; returns ``pages``. Rows marked invalid
    (bucket padding) land in the reserved garbage page 0; positions past a
    row's table are clipped to its last entry, as in the JAX code (the
    engine's inactive rows have all-zero tables, so theirs land in page 0).

    Only page 0 may receive the same (page, offset) twice in one call: which
    of the duplicates wins is unspecified on CUDA, and page 0 is never
    read."""
    bs = pages.shape[1]
    M = block_tables.shape[1]
    positions = positions.long()
    blk = torch.clamp(positions // bs, 0, M - 1)  # [B, T] logical block
    off = positions % bs
    phys = torch.gather(block_tables.long(), 1, blk)  # [B, T] physical page
    if valid is not None:
        # padded positions may exceed the table capacity entirely, where the
        # clip above would alias the LAST real block — route them to page 0
        phys = torch.where(valid, phys, 0)
    upd = new.reshape(-1, new.shape[-2], new.shape[-1]).to(pages.dtype)
    pages.index_put_((phys.reshape(-1), off.reshape(-1)), upd)
    return pages


# ---------------------------------------------------------------------------
# the layout: how a model lies on a mesh (one device: no axes)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _Layout:
    """How a model lies on a mesh: the batch (dp), sequence (sp) and tensor
    (tp) axes this mesh has (None where it lacks one), and the fitted spec
    of every param leaf (``specs``). On one device (:data:`_ONE_DEVICE`)
    there is no mesh, every axis is None and every leaf whole, so the
    layer math below runs unchanged and every collective it names is
    skipped. Collectives take the mesh from here, never from the mesh
    entered around a call: a checkpointed layer's recompute runs in the
    backward, after the call has returned."""
    mesh: Any = None
    dp: Optional[str] = None
    sp: Optional[str] = None
    tp: Optional[str] = None
    specs: Optional[Dict[str, Any]] = None
    seq_len: int = 0  # the unpadded T of the call (capacity dispatch); 0: the T it sees

    def entry(self, name: str, dim: int):
        """The spec entry of dimension ``dim`` of leaf ``name`` (top level
        or a layer leaf); None on one device."""
        if self.specs is None:
            return None
        spec = self.specs[name] if name in self.specs else self.specs["layers"][name]
        return spec[dim]

    def block(self, name: str, dim: int, size: int) -> int:
        """Where this rank's block of that dimension (of full ``size``) starts."""
        return block_start(self.mesh, self.entry(name, dim), size)

    def size(self, axis) -> int:
        return math.prod(self.mesh.shape[a] for a in spec_axes(axis))

    def index(self, axis) -> int:
        return self.mesh.axis_index(axis) if axis else 0

    @property
    def axes(self) -> Tuple[str, ...]:
        return () if self.mesh is None else self.mesh.axis_names

    @property
    def replicas(self) -> int:
        """Ranks that compute the same rows of the loss (tp, and any axis
        that shards neither the batch nor the sequence)."""
        if self.mesh is None:
            return 1
        return self.mesh.size // (self.size(self.dp) * self.size(self.sp))

    def reduce(self, x, entry):
        """Sum ``x`` over the axes of a sharded dim it has contracted."""
        for a in spec_axes(entry):
            if self.mesh.shape[a] > 1:
                x = collective.allreduce(x, a, mesh=self.mesh)
        return x


_ONE_DEVICE = _Layout()


def _local_kv(cfg: TransformerConfig, lay: _Layout, q, k, v, dim: int = 2):
    """K/V for this rank's query heads (q [B, T, H_l, Dh]; the heads of k/v
    at ``dim``): its own kv heads when wk/wv are sharded like wq; the kv
    head of each local query head (the GQA group) when they are replicated
    while wq is split."""
    q_entry = lay.entry("wq", 2)
    if not spec_axes(q_entry) or spec_axes(lay.entry("wk", 2)):
        return k, v
    n_rep = cfg.n_heads // cfg.kv_heads
    lo = lay.block("wq", 2, cfg.n_heads)
    idx = torch.arange(lo, lo + q.shape[2], device=q.device) // n_rep
    return k.index_select(dim, idx), v.index_select(dim, idx)


def _attention(cfg: TransformerConfig, lay: _Layout, q, k, v, use_flash: bool):
    """Causal attention of this rank's block: q [B, T_l, H_l, Dh], k/v
    [B, T_l, Hk, Dh] (unrepeated under GQA). Without a sequence axis: the
    flash kernel, or the grouped einsum (``attention="ring"`` without one
    is the einsum attention, as in the JAX package). Under sp: ring
    attention under ``attention="ring"``; otherwise K/V all-gathered over
    sp (one buffer) and each query shard at its causal offset, as the
    reference's GSPMD computes it."""
    k, v = _local_kv(cfg, lay, q, k, v)
    H, Hk = q.shape[2], k.shape[2]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    qt = q.permute(0, 2, 1, 3)

    def heads_first(k, v):  # full heads, [B, H, T, Dh], for the kernels
        return (_repeat_kv(x, H // Hk).permute(0, 2, 1, 3) for x in (k, v))

    if lay.sp is None:
        o = (flash_attention(qt, *heads_first(k, v), None, True) if use_flash
             else _gqa_mha(qt, k, v, causal=True, sm_scale=scale))
        return o.permute(0, 2, 1, 3)
    if cfg.attention == "ring":
        o = ring_attention(qt, *heads_first(k, v), lay.sp, causal=True, mesh=lay.mesh)
        return o.permute(0, 2, 1, 3)
    kv = collective.allgather(torch.stack([k, v]), lay.sp, axis=2, mesh=lay.mesh)
    Tl = q.shape[1]
    off = lay.index(lay.sp) * Tl
    if not use_flash:
        o = _gqa_mha(qt, kv[0], kv[1], causal=True, sm_scale=scale, q_offset=off)
        return o.permute(0, 2, 1, 3)
    kt, vt = heads_first(kv[0], kv[1])
    parts = []
    if off:  # the earlier shards' keys, all visible
        parts.append(flash_attention_with_lse(qt, kt[:, :, :off], vt[:, :, :off], scale, False))
    parts.append(flash_attention_with_lse(qt, kt[:, :, off:off + Tl], vt[:, :, off:off + Tl],
                                          scale, True))
    return merge_partials(parts).to(q.dtype).permute(0, 2, 1, 3)


def _dequantized(cfg: TransformerConfig, layer, scales, name: str) -> torch.Tensor:
    """Leaf ``name`` as the layer math takes it: an int8 leaf is dequantized
    as the JAX code does it (``w * s`` in f32, rounded to ``param_dtype``); a
    float leaf is used as it is (int8 serving gives it ones scales)."""
    w = layer[name]
    if w.dtype != torch.int8:
        return w
    return dequantize_int8(w, scales[name], cfg.param_dtype)


def _product(cfg: TransformerConfig, layer, scales, name: str, x, n_contract: int = 1):
    """``x``'s last ``n_contract`` axes contracted with the first
    ``n_contract`` axes of leaf ``name``, in ``x``'s dtype. ``scales`` are
    the layer's int8-serving scales (None for a float layer).

    An int8 leaf whose scales are constant along the contracted axes gives
    x @ (w_q * s) = (x @ w_q) * s, one f32 scale per output column: that is
    ``int8_matmul`` (K6) on x as ``[rows, K]`` and the leaf viewed as
    ``[K, N]``. Any other int8 leaf — ``wo`` [H, Dh, d] is quantized along H,
    so its scales vary along Dh, which its product contracts — and every
    float leaf are contracted as the JAX code does it, after
    :func:`_dequantized`."""
    w = layer[name]
    if w.dtype == torch.int8 and all(n == 1 for n in scales[name].shape[:n_contract]):
        K = math.prod(w.shape[:n_contract])
        y = int8_matmul(x.reshape(-1, K), w.reshape(K, -1), scales[name].reshape(-1))
        return y.reshape(*x.shape[: x.ndim - n_contract], *w.shape[n_contract:])
    w = _dequantized(cfg, layer, scales, name)
    return torch.tensordot(x, w.to(x.dtype), dims=n_contract)


def _dense_ffn(cfg: TransformerConfig, layer, x, scales=None):
    h = F.silu(_product(cfg, layer, scales, "w3", x)) * _product(cfg, layer, scales, "w1", x)
    return _product(cfg, layer, scales, "w2", h)


def _route(cfg: TransformerConfig, layer, x, scales):
    """The router's gates in f32 and its top-k: (topv, topi) [B, T, k]."""
    router = _dequantized(cfg, layer, scales, "router")
    gates = torch.softmax(torch.einsum("btd,de->bte", x.float(), router.float()), dim=-1)
    return torch.topk(gates, cfg.expert_top_k, dim=-1)


def _experts(cfg: TransformerConfig, layer, scales, dtype):
    """we1, we3, we2 in ``dtype``, as the expert products take them. Their
    int8-serving scales come from quantizing along the expert axis, so they
    vary along the contracted d / d_ff and the int8 kernel cannot take them:
    each is dequantized (one layer at a time), as the JAX code does."""
    return [_dequantized(cfg, layer, scales, n).to(dtype) for n in ("we1", "we3", "we2")]


def _moe_ffn(cfg: TransformerConfig, layer, x, scales=None, lay: _Layout = _ONE_DEVICE):
    """Top-k MoE. ``moe_capacity_factor > 0`` routes through
    :func:`_moe_ffn_capacity`; otherwise dense dispatch: every expert
    computes every token and the normalised top-k gates select.

    Under a mesh the experts are split over their axis (and d_ff over tp)
    and each rank runs its own. Where the expert axis also shards the batch
    (ep = dp), the tokens of the expert group are all-gathered first and a
    reduce-scatter returns each rank its rows summed over the experts;
    otherwise each rank runs its experts on its own tokens and the sum over
    the expert axis completes them."""
    e_entry, f_entry = lay.entry("we1", 1), lay.entry("we1", 3)
    batch_ep = lay.dp is not None and spec_axes(e_entry) == (lay.dp,)
    xin = collective.allgather(x, lay.dp, axis=0, mesh=lay.mesh) if batch_ep else x
    e0 = lay.block("we1", 1, cfg.num_experts)
    experts = slice(e0, e0 + layer["we1"].shape[0])
    if cfg.moe_capacity_factor > 0:
        out = _moe_ffn_capacity(cfg, layer, xin, scales, lay, experts)
    else:
        topv, topi = _route(cfg, layer, xin, scales)
        mask = torch.sum(F.one_hot(topi, cfg.num_experts).to(topv.dtype) * topv[..., None],
                         dim=-2)
        mask = (mask / (torch.sum(mask, -1, keepdim=True) + 1e-9)).to(x.dtype)  # [B, T, E]
        we1, we3, we2 = _experts(cfg, layer, scales, x.dtype)
        h = torch.einsum("btd,edf->betf", xin, we1)
        g = torch.einsum("btd,edf->betf", xin, we3)
        out = torch.einsum("betf,efd->betd", F.silu(g) * h, we2)
        out = torch.einsum("betd,bte->btd", out, mask[..., experts])
    if batch_ep:
        out = collective.reducescatter(out, lay.dp, scatter_dimension=0, mesh=lay.mesh)
    else:
        out = lay.reduce(out, e_entry)
    return lay.reduce(out, f_entry)


def _moe_ffn_capacity(cfg: TransformerConfig, layer, x, scales=None,
                      lay: _Layout = _ONE_DEVICE, experts: slice = slice(None)):
    """Capacity-based top-k MoE (GShard/Switch): each expert takes at most
    ``C = ceil(top_k * T * factor / E)`` tokens a row, its slots filled in
    the flattened (token, choice) order; overflow tokens are dropped (they
    pass through the residual). ``C`` depends on the T of the call, padding
    included (under a mesh: the unpadded T of the whole sequence,
    ``lay.seq_len``); padded tokens come after the real ones in that order,
    so they never take a real token's slot. ``experts``: the range of the
    experts this rank holds. Under sp the slots are numbered over the whole
    sequence: the earlier sequence blocks' counts offset this block's."""
    B, T, _ = x.shape
    E, k = cfg.num_experts, cfg.expert_top_k
    C = max(1, math.ceil(k * (lay.seq_len or T) * cfg.moe_capacity_factor / E))
    topv, topi = _route(cfg, layer, x, scales)
    topv = topv / (torch.sum(topv, -1, keepdim=True) + 1e-9)
    sel = F.one_hot(topi, E).float()                             # [B,T,k,E]
    # a choice's slot: how many earlier choices went to its expert
    flat = sel.reshape(B, T * k, E)
    pos = torch.cumsum(flat, dim=1) - flat
    if lay.sp is not None:
        counts = collective._all_gather(flat.sum(1)[None], lay.mesh.group(lay.sp), 0)
        pos = pos + counts[:lay.index(lay.sp)].sum(0)[:, None, :]
    slot = torch.sum(pos.reshape(B, T, k, E) * sel, dim=-1).long()  # [B,T,k]
    keep = (slot < C).float()
    # an overflowing slot is clamped into range, then zeroed by keep
    slot_oh = F.one_hot(slot.clamp(max=C - 1), C).float() * keep[..., None]
    sel = sel[..., experts]
    dispatch = torch.einsum("btke,btkc->btec", sel, slot_oh)    # [B,T,E,C]
    combine = torch.einsum("btk,btke,btkc->btec", topv, sel, slot_oh)
    xin = torch.einsum("btec,btd->becd", dispatch.to(x.dtype), x)
    we1, we3, we2 = _experts(cfg, layer, scales, x.dtype)
    h = torch.einsum("becd,edf->becf", xin, we1)
    g = torch.einsum("becd,edf->becf", xin, we3)
    out = torch.einsum("becf,efd->becd", F.silu(g) * h, we2)
    return torch.einsum("btec,becd->btd", combine.to(x.dtype), out)


def _ffn(cfg: TransformerConfig, layer, x, scales=None, lay: _Layout = _ONE_DEVICE):
    if cfg.num_experts > 0:
        return _moe_ffn(cfg, layer, x, scales, lay)
    return lay.reduce(_dense_ffn(cfg, layer, x, scales), lay.entry("w2", 1))


def _layer(cfg: TransformerConfig, lay: _Layout, use_flash: bool, positions, x, layer):
    """One decoder layer on this rank's block: under tp, column-parallel
    wq/wk/wv and w1/w3 (local heads, local d_ff) and row-parallel wo and w2
    summed over tp."""
    h = _rms_norm(x, layer["attn_norm"])
    q = torch.einsum("btd,dhk->bthk", h, layer["wq"].to(h.dtype))
    k = torch.einsum("btd,dhk->bthk", h, layer["wk"].to(h.dtype))
    v = torch.einsum("btd,dhk->bthk", h, layer["wv"].to(h.dtype))
    q, k = _rope(q, positions, cfg.rope_theta), _rope(k, positions, cfg.rope_theta)
    o = _attention(cfg, lay, q, k, v, use_flash)
    x = x + lay.reduce(torch.einsum("bthk,hkd->btd", o, layer["wo"].to(o.dtype)),
                       lay.entry("wo", 1))
    h = _rms_norm(x, layer["ffn_norm"])
    return x + _ffn(cfg, layer, h, lay=lay)


# the matrix products as the dispatcher sees them (einsum and @ decompose
# into these): what jax.checkpoint_policies.dots_saveable saves
_DOTS = {torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm, torch.ops.aten.baddbmm}


def _dots_policy(ctx, op, *args, **kwargs):
    if op.overloadpacket in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg, fn: Callable, lay: _Layout = _ONE_DEVICE) -> Callable:
    if not cfg.remat or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    if lay.mesh is None:
        return functools.partial(checkpoint, fn, use_reentrant=False, **kw)

    def run(*args):
        # under a mesh the recompute replays every collective of the layer,
        # in order, on every rank: no early stop (the flag is read here, as
        # the checkpoint records the forward)
        with set_checkpoint_early_stop(False):
            return checkpoint(fn, *args, use_reentrant=False, **kw)

    return run


def forward(cfg: TransformerConfig, params: Dict[str, Any], tokens: torch.Tensor, *,
            act_spec=None, mesh=None, sp_axis: Optional[str] = None) -> torch.Tensor:
    """tokens [B, T] -> logits [B, T, V] f32. ``attention="auto"`` takes the
    flash kernel when the tokens are on a CUDA device. Differentiable in the
    params; ``cfg.remat`` sets what each layer keeps for the backward.

    With ``mesh`` (a :class:`ray_tpu_torch.parallel.Mesh`; every rank calls
    it): ``params`` are this rank's shards (:func:`shard_params`), ``tokens``
    this rank's batch rows (all T), and the result is this rank's block of
    the logits, ``[B/dp, T_pad/sp, V/tp]`` (T tail-padded to a multiple of
    the sp size). ``act_spec`` (``P(dp, sp, None)``) and ``sp_axis`` name the
    batch and sequence axes; tp is the mesh's ``"tp"``."""
    lay = _call_layout(cfg, mesh, act_spec, sp_axis, tokens)
    tok, _, positions = _sequence_block(lay, tokens)
    h = _hidden(cfg, lay, params, tok, positions)
    return torch.einsum("btd,vd->btv", h, params["embed"].to(h.dtype)).float()


def embed_tokens(cfg: TransformerConfig, params, tokens, lay: _Layout = _ONE_DEVICE):
    """The tied-embedding input path: rows scaled by sqrt(d_model). JAX
    multiplies by a weakly typed constant, which takes the array's dtype,
    so the scale is rounded to the activation dtype first here too. The
    rows are gathered before the cast (same numbers, one row per token
    converted instead of the whole table). On a vocab-sharded table each
    rank looks up the ids of its block (zeros elsewhere) and the sum over
    tp assembles the rows (one non-zero term a row: exact)."""
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype).item()
    entry = lay.entry("embed", 0)
    if not spec_axes(entry):
        return params["embed"][tokens.long()].to(cfg.dtype) * scale
    ids, inside = _vocab_block(lay, tokens, cfg.vocab_size)
    rows = params["embed"][ids].to(cfg.dtype) * scale
    return lay.reduce(torch.where(inside[..., None], rows, 0), entry)


def _hidden(cfg: TransformerConfig, lay: _Layout, params, tokens, positions):
    """The final-normed hidden states [B/dp, T_pad/sp, d] of this rank's
    block."""
    use_flash = cfg.attention == "flash" or (
        cfg.attention == "auto" and tokens.device.type == "cuda")
    x = embed_tokens(cfg, params, tokens, lay)
    step = _remat(cfg, functools.partial(_layer, cfg, lay, use_flash, positions), lay)
    # one unbind per stacked leaf: its backward stacks the layers' grads once
    names = list(params["layers"])
    for leaves in zip(*(params["layers"][n].unbind(0) for n in names)):
        x = step(x, dict(zip(names, leaves)))
    return _rms_norm(x, params["final_norm"])


def loss_fn(cfg: TransformerConfig, params, tokens: torch.Tensor, *, act_spec=None, mesh=None,
            sp_axis: Optional[str] = None) -> torch.Tensor:
    """Next-token cross entropy: position t predicts tokens[:, t+1]. The
    forward runs on the full [B, T] batch and the last position (whose
    rolled target wraps around) is masked out of the mean, as in the JAX
    package.

    With ``mesh`` (as :func:`forward`): the loss of the whole batch, the
    same on every rank. Each rank's share is the sum of its rows' terms
    over the global count, divided among the ranks that compute the same
    rows; the shares' sum is the loss, whose cotangent passes through to
    each share. So its gradient on a rank is that rank's share, which the
    replicas of each leaf sum (:func:`make_train_step` does)."""
    return _loss(cfg, _call_layout(cfg, mesh, act_spec, sp_axis, tokens), params, tokens)


def _loss(cfg: TransformerConfig, lay: _Layout, params, tokens: torch.Tensor) -> torch.Tensor:
    """:func:`loss_fn` under ``lay`` (``lay.seq_len``: the call's T)."""
    B, T = tokens.shape
    tok, tgt, positions = _sequence_block(lay, tokens)
    h = _hidden(cfg, lay, params, tok, positions)
    logits = torch.einsum("btd,vd->btv", h, params["embed"].to(h.dtype)).float()
    nll = _nll(cfg, lay, logits, tgt)
    mask = (positions < T - 1).to(nll.dtype)
    share = torch.sum(nll * mask) / (B * lay.size(lay.dp) * (T - 1) * lay.replicas)
    return collective.replicated_sum(share, lay.axes, mesh=lay.mesh)


def _call_layout(cfg: TransformerConfig, mesh, act_spec, sp_axis, tokens) -> _Layout:
    """The layout of a :func:`forward` / :func:`loss_fn` call: one device,
    or dp and sp from ``act_spec`` (``P(dp, sp, None)``) or the reference's
    names, with the call's T."""
    if mesh is None:
        return _ONE_DEVICE
    _check_mesh(mesh)
    dp = act_spec[0] if act_spec is not None else "dp"
    sp = sp_axis or (act_spec[1] if act_spec is not None else "sp")
    return dataclasses.replace(_layout(cfg, mesh, dp=dp, sp=sp), seq_len=tokens.shape[1])


def _sequence_block(lay: _Layout, tokens: torch.Tensor):
    """(tokens, next-token targets, positions) of this rank's sequence block:
    T tail-padded (token 0) to a multiple of the sp size, then cut into sp
    blocks. The reference pads q/k/v inside its ring attention; here the
    activations are sharded over T through the whole layer, so the pad
    comes once, at the input. Padded positions come after every real one,
    so under the causal mask no real query sees them; their rows are
    masked out of the loss."""
    B, T = tokens.shape
    n = lay.size(lay.sp)
    Tl = -(-T // n)
    pad = n * Tl - T
    tokens = tokens.long()
    targets = spmd_roll(tokens, -1, 1)
    if pad:
        tokens, targets = (F.pad(t, (0, pad)) for t in (tokens, targets))
    lo = lay.index(lay.sp) * Tl
    positions = torch.arange(lo, lo + Tl, device=tokens.device)[None, :].expand(B, Tl)
    return tokens[:, lo:lo + Tl], targets[:, lo:lo + Tl], positions


def _vocab_block(lay: _Layout, ids: torch.Tensor, V: int):
    """(ids local to this rank's vocabulary block, in-block mask) of a
    vocab-sharded table (``embed``'s spec)."""
    n = V // lay.size(lay.entry("embed", 0))
    local = ids - lay.block("embed", 0, V)
    inside = (local >= 0) & (local < n)
    return local.clamp(0, n - 1), inside


def _nll(cfg: TransformerConfig, lay: _Layout, logits, targets):
    """-log softmax(logits)[target], f32. With the logits sharded over the
    vocabulary, the distributed log-softmax: the global max subtracted
    before the sum of exponentials, both sums over tp."""
    entry = lay.entry("embed", 0)
    if not spec_axes(entry):
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, targets[..., None])[..., 0]
    with torch.no_grad():
        m = logits.amax(dim=-1)
        for a in spec_axes(entry):
            m = collective._all_reduce(m, lay.mesh.group(a), op=torch.distributed.ReduceOp.MAX)
    sumexp = lay.reduce(torch.exp(logits - m[..., None]).sum(-1), entry)
    ids, inside = _vocab_block(lay, targets, cfg.vocab_size)
    picked = torch.gather(logits, -1, ids[..., None])[..., 0]
    target_logit = lay.reduce(torch.where(inside, picked, 0.0), entry)
    return m + torch.log(sumexp) - target_logit


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------
def param_specs(cfg: TransformerConfig, *, dp: Optional[str] = "dp", tp: Optional[str] = "tp",
                ep: Optional[str] = None, kv_tp: bool = True) -> Dict[str, Any]:
    """Megatron-style TP layout as PartitionSpecs (the leading axis of a
    stacked layer leaf is the layer dim, unsharded): wq/wk/wv over heads,
    w1/w3 over d_ff and the embedding over the vocabulary split over tp
    (column-parallel), wo and w2 over their contracted dim (row-parallel),
    the experts over ep (default: dp). ``kv_tp=False`` replicates wk/wv
    across tp, as GQA needs when the kv heads do not divide over it."""
    ep = ep or dp
    kv = tp if kv_tp else None
    layer_specs = {
        "attn_norm": P(None, None),
        "wq": P(None, None, tp, None),
        "wk": P(None, None, kv, None),
        "wv": P(None, None, kv, None),
        "wo": P(None, tp, None, None),
        "ffn_norm": P(None, None),
    }
    if cfg.num_experts > 0:
        layer_specs.update(
            router=P(None, None, None),
            we1=P(None, ep, None, tp),
            we3=P(None, ep, None, tp),
            we2=P(None, ep, tp, None),
        )
    else:
        layer_specs.update(w1=P(None, None, tp), w3=P(None, None, tp), w2=P(None, tp, None))
    return {"embed": P(tp, None), "layers": layer_specs, "final_norm": P(None)}


def _kv_tp_ok(cfg: TransformerConfig, mesh, tp: Optional[str]) -> bool:
    """Whether the kv-head axis can shard over tp (GQA may make it too small)."""
    n = mesh.shape.get(tp, 1)
    return cfg.kv_heads % n == 0


def fit_spec(shape, spec, mesh):
    """Make a PartitionSpec legal for this tensor and mesh: drop mesh axes
    on dimensions they do not divide (an odd vocabulary under tp) and
    repeated axes (MoE specs with ep folded into tp keep the first). A
    replicated dim beats a crash, but an axis the mesh does not HAVE is a
    typo and raises, not a silent full replication."""
    parts = []
    used = set()
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            parts.append(None)
            continue
        named = (ax,) if isinstance(ax, str) else tuple(ax)
        unknown = [a for a in named if a not in mesh.shape]
        if unknown:
            raise ValueError(
                f"PartitionSpec axis {unknown[0]!r} is not a mesh axis "
                f"(mesh has {sorted(mesh.shape)}): likely a typo in the "
                f"dp/tp/ep axis names passed to shard_params/param_specs"
            )
        axes = tuple(a for a in named if a not in used)
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        if not axes or dim % size != 0:
            parts.append(None)
            continue
        used.update(axes)
        parts.append(axes[0] if len(axes) == 1 else axes)
    return P(*parts)


def param_shapes(cfg: TransformerConfig) -> Dict[str, Any]:
    """The shape of every param leaf (:func:`init_params`'s tree)."""
    d, h, hkv, dh, ff, L = (cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_ff,
                            cfg.n_layers)
    layers = {"attn_norm": (L, d), "wq": (L, d, h, dh), "wk": (L, d, hkv, dh),
              "wv": (L, d, hkv, dh), "wo": (L, h, dh, d), "ffn_norm": (L, d)}
    if cfg.num_experts > 0:
        e = cfg.num_experts
        layers.update(router=(L, d, e), we1=(L, e, d, ff), we3=(L, e, d, ff), we2=(L, e, ff, d))
    else:
        layers.update(w1=(L, d, ff), w3=(L, d, ff), w2=(L, ff, d))
    return {"embed": (cfg.vocab_size, d), "layers": layers, "final_norm": (d,)}


def fitted_specs(shapes, specs, mesh):
    """:func:`fit_spec` over a tree of shapes and its tree of specs."""
    if isinstance(shapes, dict):
        return {k: fitted_specs(v, specs[k], mesh) for k, v in shapes.items()}
    return fit_spec(shapes, specs, mesh)


def _shard_axes(cfg: TransformerConfig, mesh, axes: dict) -> dict:
    """The reference's defaults of :func:`shard_params`' axis names."""
    axes = dict(axes)
    if "kv_tp" not in axes:
        axes["kv_tp"] = _kv_tp_ok(cfg, mesh, axes.get("tp", "tp"))
    if "ep" not in axes and "dp" not in axes and "dp" not in mesh.shape:
        # param_specs defaults ep to dp; on a dp-less mesh (tp-only) fold
        # experts into tp instead of raising on the IMPLICIT 'dp' default.
        # An explicitly-passed dp still goes through fit_spec's typo check.
        axes["ep"] = axes.get("tp", "tp")
    return axes


def shard_params(params, mesh, cfg: TransformerConfig, **axes):
    """This rank's shards of the full ``params`` (every rank holds the same
    tree, e.g. converted from the JAX package by
    :func:`ray_tpu_torch.convert.params_from_numpy`) under
    :func:`param_specs` fitted to the mesh (:func:`fit_spec`). ``axes``:
    ``dp``, ``tp``, ``ep``, ``kv_tp``, as :func:`param_specs` takes them."""
    specs = fitted_specs(param_shapes(cfg), param_specs(cfg, **_shard_axes(cfg, mesh, axes)),
                         mesh)
    return shard_tree(params, specs, mesh)


# ---------------------------------------------------------------------------
# layouts on a mesh
# ---------------------------------------------------------------------------
def _layout(cfg: TransformerConfig, mesh, *, dp: Optional[str] = "dp", sp: Optional[str] = "sp",
            tp: Optional[str] = "tp", ep: Optional[str] = None) -> _Layout:
    """The layout of ``cfg`` on ``mesh``: axis names the mesh lacks are
    None (a mesh without tp replicates what tp would split); an ``ep`` given
    explicitly must be a mesh axis. Experts go over ep, else dp, else tp."""
    have = lambda a: a if a and a in mesh.shape else None  # noqa: E731
    dp_ax, sp_ax, tp_ax = have(dp), have(sp), have(tp)
    specs = fitted_specs(param_shapes(cfg), param_specs(
        cfg, dp=dp_ax, tp=tp_ax, ep=ep or dp_ax or tp_ax, kv_tp=_kv_tp_ok(cfg, mesh, tp_ax)),
        mesh)
    return _Layout(mesh, dp_ax, sp_ax, tp_ax, specs)


def mesh_param_specs(cfg: TransformerConfig, mesh, *, dp: Optional[str] = "dp",
                     tp: Optional[str] = "tp", ep: Optional[str] = None) -> Dict[str, Any]:
    """The spec of every param leaf as :func:`make_train_step` lays it on
    ``mesh`` (:func:`param_specs` fitted to the mesh; with it
    :func:`ray_tpu_torch.parallel.mesh.gather_tree` reads a state back)."""
    return _layout(cfg, mesh, dp=dp, tp=tp, ep=ep).specs


def _check_mesh(mesh) -> None:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a ray_tpu_torch.parallel.Mesh, got {type(mesh).__name__}")


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------
# optax.adamw's defaults (torch.optim.AdamW's weight decay default is 1e-2)
ADAM_B1, ADAM_B2, ADAM_EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [tree]


def _rebuild(tree, leaves):
    """``tree`` with its leaves replaced, in :func:`_leaves` order."""
    return _fill(tree, iter(leaves))


def _fill(tree, it):
    # a module-level recursion: a closure calling itself would be a
    # reference cycle holding ``leaves`` (a state's moments, a step's
    # gradients) until the garbage collector's next pass
    if isinstance(tree, dict):
        return {k: _fill(v, it) for k, v in tree.items()}
    return next(it)


def _adamw_(params: list, grads: list, mu: list, nu: list, count: int, lr: float) -> None:
    """One optax.adamw update of every leaf, in place: moments, bias
    correction at ``count`` (the incremented step), eps outside the square
    root, decoupled weight decay added to the update, then -lr."""
    torch._foreach_mul_(mu, ADAM_B1)
    torch._foreach_add_(mu, grads, alpha=1 - ADAM_B1)
    torch._foreach_mul_(nu, ADAM_B2)
    torch._foreach_addcmul_(nu, grads, grads, value=1 - ADAM_B2)
    mu_hat = torch._foreach_div(mu, 1 - ADAM_B1 ** count)
    den = torch._foreach_div(nu, 1 - ADAM_B2 ** count)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, ADAM_EPS)
    upd = torch._foreach_div(mu_hat, den)
    del mu_hat, den
    torch._foreach_add_(upd, params, alpha=WEIGHT_DECAY)
    torch._foreach_add_(params, upd, alpha=-lr)


def value_and_grad(loss_of: Callable, params):
    """(loss, grads): ``loss_of(params)`` and its gradient in every param
    leaf, as a tree shaped like ``params`` (``jax.value_and_grad``; a leaf
    the loss does not use gets zeros, as there)."""
    live = [p.detach().requires_grad_() for p in _leaves(params)]
    loss = loss_of(_rebuild(params, live))
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(live, grads)]
    return loss.detach(), _rebuild(params, grads)


def loss_and_grads(cfg: TransformerConfig, params, tokens: torch.Tensor):
    """(loss, grads) of :func:`loss_fn`, by :func:`value_and_grad`."""
    return value_and_grad(lambda p: loss_fn(cfg, p, tokens), params)


def adamw_update_(state, grads, learning_rate: float) -> None:
    """One ``optax.adamw(learning_rate)`` step of a train state (as
    :func:`new_train_state` builds it), in place: count and step advance,
    then :func:`_adamw_` updates params and moments."""
    opt = state["opt"]
    opt["count"] += 1
    state["step"] += 1
    with torch.no_grad():
        _adamw_(_leaves(state["params"]), _leaves(grads), _leaves(opt["mu"]),
                _leaves(opt["nu"]), int(opt["count"]), learning_rate)


def make_train_step(
    cfg: TransformerConfig,
    *,
    learning_rate: float = 3e-4,
    device=None,
    mesh=None,
    dp: Optional[str] = "dp",
    sp: Optional[str] = "sp",
    tp: Optional[str] = "tp",
    ep: Optional[str] = None,
) -> Tuple[Callable, Callable]:
    """Build ``(init_state, train_step)``.

    The state is ``{"params", "opt": {"mu", "nu", "count"}, "step"}``:
    params and Adam moments as param-shaped trees, ``count`` and ``step``
    int32 scalars, all on ``device``. ``train_step(state, tokens)`` returns
    ``(state, loss)`` and updates the state's tensors in place (the JAX step
    donates its state, so a caller never reads the old one either); the loss
    is a 0-dim f32 tensor. The optimizer is ``optax.adamw(learning_rate)``.
    ``init_state(seed_or_generator=0)`` draws fresh params.

    With ``mesh`` (a :class:`ray_tpu_torch.parallel.Mesh`; every rank builds
    and calls it), ``dp``/``sp``/``tp``/``ep`` name its batch, sequence,
    tensor and expert axes (a name the mesh lacks is no axis; experts go
    over dp by default). The state holds this rank's shards
    (:func:`param_specs` fitted to the mesh); ``init_state`` draws the full
    params from the seed and keeps them, so every mesh trains the model one
    device does. ``train_step`` is a :class:`JittedStep` whose
    ``shard_batch(tokens)`` gives this rank's dp rows of the full ``[B, T]``
    batch, the ``tokens`` the step takes; its loss is the whole batch's on
    every rank. Gradients of a leaf's replicas are summed over every axis
    that replicates it; AdamW then updates each shard as the one-device
    update updates that slice."""
    device = default_device(device, "make_train_step")
    if mesh is None:
        def init_state(seed_or_generator=0):
            params = init_params(cfg, as_generator(seed_or_generator, device))
            return new_train_state(_rebuild(params, [t.to(device) for t in _leaves(params)]))

        def train_step(state, tokens):
            loss, grads = loss_and_grads(cfg, state["params"], tokens.to(device))
            adamw_update_(state, grads, learning_rate)
            return state, loss

        return init_state, train_step

    _check_mesh(mesh)
    lay = _layout(cfg, mesh, dp=dp, sp=sp, tp=tp, ep=ep)
    if cfg.attention == "ring" and lay.sp is None:
        raise ValueError(
            'attention="ring" needs a sequence-parallel mesh axis '
            f"(sp={sp!r} not in mesh axes {sorted(mesh.axis_names)}); "
            "silently falling back to dense would lose the memory "
            "scaling the mode promises"
        )

    def init_state(seed_or_generator=0):
        params = init_params(cfg, as_generator(seed_or_generator, device))
        return new_train_state(shard_tree(params, lay.specs, mesh))

    def train_step(state, tokens):
        tokens = tokens.to(device)
        call = dataclasses.replace(lay, seq_len=tokens.shape[1])
        loss, grads = value_and_grad(lambda p: _loss(cfg, call, p, tokens), state["params"])
        sum_replicas_(grads, lay.specs, mesh)
        adamw_update_(state, grads, learning_rate)
        return state, loss

    def shard_batch(tokens):
        return shard_array(tokens.to(device), mesh, lay.dp, None)

    return init_state, JittedStep(train_step, shard_batch,
                                  functools.partial(shard_train_state, lay.specs, mesh))


def sum_replicas_(grads, specs, mesh) -> None:
    """Sum, in place, each gradient leaf over every mesh axis its spec does
    not shard it on: the ranks holding a copy of a leaf each hold their
    share of its gradient."""
    if isinstance(grads, dict):
        for k in grads:
            sum_replicas_(grads[k], specs[k], mesh)
        return
    sharded = {a for entry in specs for a in spec_axes(entry)}
    with torch.no_grad():
        for a in mesh.axis_names:
            if a not in sharded and mesh.shape[a] > 1:
                grads.copy_(collective._all_reduce(grads, mesh.group(a)))


def shard_train_state(specs, mesh, state) -> Dict[str, Any]:
    """This rank's shards of a full train state (params and both moments
    under ``specs``; count and step copied)."""
    return {"params": shard_tree(state["params"], specs, mesh),
            "opt": {"mu": shard_tree(state["opt"]["mu"], specs, mesh),
                    "nu": shard_tree(state["opt"]["nu"], specs, mesh),
                    "count": state["opt"]["count"].clone()},
            "step": state["step"].clone()}


def new_train_state(params) -> Dict[str, Any]:
    """A step-0 train state around ``params`` (moments zero, on each leaf's
    device)."""
    leaves = _leaves(params)
    dev = leaves[0].device
    return {
        "params": params,
        "opt": {"mu": _rebuild(params, [torch.zeros_like(p) for p in leaves]),
                "nu": _rebuild(params, [torch.zeros_like(p) for p in leaves]),
                "count": torch.zeros((), dtype=torch.int32, device=dev)},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
