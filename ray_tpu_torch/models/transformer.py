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
``optax.adamw``), with per-layer rematerialisation. Not in this package
yet: ring attention and the sharding rules, expert parallelism included
(one device only).
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
)

from ray_tpu_torch.models.common import as_generator, default_device
from ray_tpu_torch.ops.attention import NEG_INF, flash_attention
from ray_tpu_torch.ops.quantization import dequantize_int8, int8_matmul


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
    attention: str = "auto"  # auto | flash | dense (ring: not ported yet)
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


def _gqa_mha(qt, k, v, *, causal: bool, sm_scale: float):
    """Grouped-query attention with K/V kept at kv-head width.

    qt: [B, H, T, Dh]; k, v: [B, T, Hkv, Dh]."""
    B, H, T, Dh = qt.shape
    Hkv = k.shape[2]
    qg = qt.reshape(B, Hkv, H // Hkv, T, Dh)
    kt = k.permute(0, 2, 1, 3)  # [B, Hkv, S, Dh]
    vt = v.permute(0, 2, 1, 3)
    s = torch.einsum("bgrtd,bgsd->bgrts", qg.float(), kt.float()) * sm_scale
    if causal:
        S = s.shape[-1]
        mask = torch.arange(S, device=qt.device)[None, :] <= torch.arange(T, device=qt.device)[:, None]
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


def _attention(cfg: TransformerConfig, q, k, v, use_flash: bool):
    # q: [B, T, H, Dh]; k, v: [B, T, Hkv, Dh] (unrepeated under GQA)
    if cfg.attention == "ring":
        raise NotImplementedError("ring attention is not ported yet")
    n_rep = cfg.n_heads // cfg.kv_heads
    qt = q.permute(0, 2, 1, 3)
    if not use_flash:
        o = _gqa_mha(qt, k, v, causal=True, sm_scale=1.0 / math.sqrt(cfg.head_dim))
        return o.permute(0, 2, 1, 3)
    # the flash kernel takes [B, H, T, Dh] with full heads
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    kt, vt = (x.permute(0, 2, 1, 3) for x in (k, v))
    o = flash_attention(qt, kt, vt, None, True)
    return o.permute(0, 2, 1, 3)


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


def _moe_ffn(cfg: TransformerConfig, layer, x, scales=None):
    """Top-k MoE. ``moe_capacity_factor > 0`` routes through
    :func:`_moe_ffn_capacity`; otherwise dense dispatch: every expert
    computes every token and the normalised top-k gates select."""
    if cfg.moe_capacity_factor > 0:
        return _moe_ffn_capacity(cfg, layer, x, scales)
    topv, topi = _route(cfg, layer, x, scales)
    mask = torch.sum(F.one_hot(topi, cfg.num_experts).to(topv.dtype) * topv[..., None], dim=-2)
    mask = (mask / (torch.sum(mask, -1, keepdim=True) + 1e-9)).to(x.dtype)  # [B, T, E]
    we1, we3, we2 = _experts(cfg, layer, scales, x.dtype)
    h = torch.einsum("btd,edf->betf", x, we1)
    g = torch.einsum("btd,edf->betf", x, we3)
    out = torch.einsum("betf,efd->betd", F.silu(g) * h, we2)
    return torch.einsum("betd,bte->btd", out, mask)


def _moe_ffn_capacity(cfg: TransformerConfig, layer, x, scales=None):
    """Capacity-based top-k MoE (GShard/Switch): each expert takes at most
    ``C = ceil(top_k * T * factor / E)`` tokens a row, its slots filled in
    the flattened (token, choice) order; overflow tokens are dropped (they
    pass through the residual). ``C`` depends on the T of the call, padding
    included; padded tokens come after the real ones in that order, so
    they never take a real token's slot."""
    B, T, _ = x.shape
    E, k = cfg.num_experts, cfg.expert_top_k
    C = max(1, math.ceil(k * T * cfg.moe_capacity_factor / E))
    topv, topi = _route(cfg, layer, x, scales)
    topv = topv / (torch.sum(topv, -1, keepdim=True) + 1e-9)
    sel = F.one_hot(topi, E).float()                             # [B,T,k,E]
    # a choice's slot: how many earlier choices went to its expert
    flat = sel.reshape(B, T * k, E)
    pos = torch.cumsum(flat, dim=1) - flat
    slot = torch.sum(pos.reshape(B, T, k, E) * sel, dim=-1).long()  # [B,T,k]
    keep = (slot < C).float()
    # an overflowing slot is clamped into range, then zeroed by keep
    slot_oh = F.one_hot(slot.clamp(max=C - 1), C).float() * keep[..., None]
    dispatch = torch.einsum("btke,btkc->btec", sel, slot_oh)    # [B,T,E,C]
    combine = torch.einsum("btk,btke,btkc->btec", topv, sel, slot_oh)
    xin = torch.einsum("btec,btd->becd", dispatch.to(x.dtype), x)
    we1, we3, we2 = _experts(cfg, layer, scales, x.dtype)
    h = torch.einsum("becd,edf->becf", xin, we1)
    g = torch.einsum("becd,edf->becf", xin, we3)
    out = torch.einsum("becf,efd->becd", F.silu(g) * h, we2)
    return torch.einsum("btec,becd->btd", combine.to(x.dtype), out)


def _ffn(cfg: TransformerConfig, layer, x, scales=None):
    if cfg.num_experts > 0:
        return _moe_ffn(cfg, layer, x, scales)
    return _dense_ffn(cfg, layer, x, scales)


def _layer(cfg: TransformerConfig, use_flash: bool, positions, x, layer):
    h = _rms_norm(x, layer["attn_norm"])
    q = torch.einsum("btd,dhk->bthk", h, layer["wq"].to(h.dtype))
    k = torch.einsum("btd,dhk->bthk", h, layer["wk"].to(h.dtype))
    v = torch.einsum("btd,dhk->bthk", h, layer["wv"].to(h.dtype))
    q, k = _rope(q, positions, cfg.rope_theta), _rope(k, positions, cfg.rope_theta)
    o = _attention(cfg, q, k, v, use_flash)
    x = x + torch.einsum("bthk,hkd->btd", o, layer["wo"].to(o.dtype))
    h = _rms_norm(x, layer["ffn_norm"])
    return x + _ffn(cfg, layer, h)


# the matrix products as the dispatcher sees them (einsum and @ decompose
# into these): what jax.checkpoint_policies.dots_saveable saves
_DOTS = {torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm, torch.ops.aten.baddbmm}


def _dots_policy(ctx, op, *args, **kwargs):
    if op.overloadpacket in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: TransformerConfig, fn: Callable) -> Callable:
    if not cfg.remat or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def forward(cfg: TransformerConfig, params: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, T] -> logits [B, T, V] f32. ``attention="auto"`` takes the
    flash kernel when the tokens are on a CUDA device. Differentiable in the
    params; ``cfg.remat`` sets what each layer keeps for the backward."""
    use_flash = cfg.attention == "flash" or (
        cfg.attention == "auto" and tokens.device.type == "cuda"
    )
    B, T = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    positions = torch.arange(T, device=tokens.device)[None, :].expand(B, T)
    step = _remat(cfg, functools.partial(_layer, cfg, use_flash, positions))
    # one unbind per stacked leaf: its backward stacks the layers' grads once
    names = list(params["layers"])
    for leaves in zip(*(params["layers"][n].unbind(0) for n in names)):
        x = step(x, dict(zip(names, leaves)))
    x = _rms_norm(x, params["final_norm"])
    logits = torch.einsum("btd,vd->btv", x, params["embed"].to(x.dtype))
    return logits.float()


def embed_tokens(cfg: TransformerConfig, params, tokens) -> torch.Tensor:
    """The tied-embedding input path: rows scaled by sqrt(d_model). JAX
    multiplies by a weakly typed constant, which takes the array's dtype,
    so the scale is rounded to the activation dtype first here too. The
    rows are gathered before the cast (same numbers, one row per token
    converted instead of the whole table)."""
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype).item()
    return params["embed"][tokens.long()].to(cfg.dtype) * scale


def loss_fn(cfg: TransformerConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy: position t predicts tokens[:, t+1]. The
    forward runs on the full [B, T] batch and the last position (whose
    rolled target wraps around) is masked out of the mean, as in the JAX
    package."""
    B, T = tokens.shape
    logits = forward(cfg, params, tokens)
    targets = torch.roll(tokens.long(), -1, dims=1)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    mask = (torch.arange(T, device=tokens.device) < T - 1).to(nll.dtype)[None, :]
    return torch.sum(nll * mask) / (B * (T - 1))


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
    it = iter(leaves)

    def go(t):
        return {k: go(v) for k, v in t.items()} if isinstance(t, dict) else next(it)

    return go(tree)


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
    dp=None,
    sp=None,
    tp=None,
    ep=None,
) -> Tuple[Callable, Callable]:
    """Build ``(init_state, train_step)`` on one device.

    The state is ``{"params", "opt": {"mu", "nu", "count"}, "step"}``:
    params and Adam moments as param-shaped trees, ``count`` and ``step``
    int32 scalars, all on ``device``. ``train_step(state, tokens)`` returns
    ``(state, loss)`` and updates the state's tensors in place (the JAX step
    donates its state, so a caller never reads the old one either); the loss
    is a 0-dim f32 tensor. The optimizer is ``optax.adamw(learning_rate)``.
    ``init_state(seed_or_generator=0)`` draws fresh params."""
    if mesh is not None or any(a is not None for a in (dp, sp, tp, ep)):
        raise NotImplementedError("sharded training (mesh/dp/sp/tp/ep) is not ported yet")
    if cfg.attention == "ring":
        raise NotImplementedError("ring attention is not ported yet")
    device = default_device(device, "make_train_step")

    def init_state(seed_or_generator=0):
        params = init_params(cfg, as_generator(seed_or_generator, device))
        return new_train_state(_rebuild(params, [t.to(device) for t in _leaves(params)]))

    def train_step(state, tokens):
        loss, grads = loss_and_grads(cfg, state["params"], tokens.to(device))
        adamw_update_(state, grads, learning_rate)
        return state, loss

    return init_state, train_step


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
