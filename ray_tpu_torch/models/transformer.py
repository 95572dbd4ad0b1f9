"""Decoder-only transformer (GPT/Llama-style), the port's forward pass.

Counterpart of ``ray_tpu/models/transformer.py``: RMSNorm + RoPE (split-half
layout) + SwiGLU, tied embeddings scaled by sqrt(d_model), GQA. Params are
the same nested dict with stacked ``[n_layers, ...]`` layer leaves, so a
JAX param tree converts leaf by leaf (:mod:`ray_tpu_torch.convert`). Params
keep ``param_dtype`` and are cast to the activation dtype where they are
used, at the same points as the JAX code, so both sides round alike.

Attention: the flash kernels (:mod:`ray_tpu_torch.ops.attention`, forward
and backward) on CUDA tensors, the grouped einsum elsewhere. Training:
:func:`loss_fn` and :func:`make_train_step` (AdamW as ``optax.adamw``), with
per-layer rematerialisation. Not in this package yet: ring attention, MoE
FFNs (``num_experts > 0``) and the sharding rules (one device only).
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

from ray_tpu_torch.models.common import default_device
from ray_tpu_torch.ops.attention import NEG_INF, flash_attention


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
    num_experts: int = 0  # > 0 (MoE) is not ported yet: raises
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
        if cfg.num_experts > 0:
            raise NotImplementedError("MoE layers (num_experts > 0) are not ported yet")
        return {
            "attn_norm": torch.ones(d, dtype=pd, device=dev),
            "wq": dense_init((d, h, dh), d),
            "wk": dense_init((d, hkv, dh), d),
            "wv": dense_init((d, hkv, dh), d),
            "wo": dense_init((h, dh, d), d),
            "ffn_norm": torch.ones(d, dtype=pd, device=dev),
            "w1": dense_init((d, ff), d),
            "w3": dense_init((d, ff), d),
            "w2": dense_init((ff, d), ff),
        }

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


def _dense_ffn(layer, x):
    h = F.silu(x @ layer["w3"].to(x.dtype)) * (x @ layer["w1"].to(x.dtype))
    return h @ layer["w2"].to(x.dtype)


def _ffn(cfg: TransformerConfig, layer, x):
    if cfg.num_experts > 0:
        raise NotImplementedError("MoE FFNs (num_experts > 0) are not ported yet")
    return _dense_ffn(layer, x)


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


def loss_and_grads(cfg: TransformerConfig, params, tokens: torch.Tensor):
    """(loss, grads): :func:`loss_fn` and its gradient in every param leaf,
    as a tree shaped like ``params`` (``jax.value_and_grad`` of it)."""
    live = [p.detach().requires_grad_() for p in _leaves(params)]
    loss = loss_fn(cfg, _rebuild(params, live), tokens)
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), _rebuild(params, grads)


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
        g = seed_or_generator
        if not isinstance(g, torch.Generator):
            g = torch.Generator(device=device).manual_seed(int(g))
        params = init_params(cfg, g)
        return new_train_state(_rebuild(params, [t.to(device) for t in _leaves(params)]))

    def train_step(state, tokens):
        loss, grads = loss_and_grads(cfg, state["params"], tokens.to(device))
        opt = state["opt"]
        opt["count"] += 1
        state["step"] += 1
        with torch.no_grad():
            _adamw_(_leaves(state["params"]), _leaves(grads), _leaves(opt["mu"]),
                    _leaves(opt["nu"]), int(opt["count"]), learning_rate)
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
