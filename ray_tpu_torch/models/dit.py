"""DiT: the diffusion transformer — training and DDIM sampling.

Counterpart of ``ray_tpu/models/dit.py`` (DiT-style, Peebles & Xie):
patchify, transformer blocks with adaLN-Zero conditioning on (timestep,
class), a linear head, unpatchify. Training is DDPM epsilon prediction on
the cosine schedule; sampling is DDIM with optional classifier-free
guidance. Params are the same nested dict with stacked ``[n_layers, ...]``
layer leaves, so a JAX param tree converts leaf by leaf.

Attention is the plain :func:`ray_tpu_torch.ops.attention.mha`
(bidirectional), as the JAX package computes it outside its kernels.

Random draws come from a ``torch.Generator`` where the JAX code takes a key,
and each function that draws is split into the draw and the computation on
the draws (:func:`_dit_loss_at`, :func:`_ddim_loop`), so the same draws can
be fed to both packages. Under a mesh (``make_dit_train_step(mesh=)``) the
batch shards over dp and the params are replicated, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.models.common import JittedStep, as_generator, default_device, dense_init
from ray_tpu_torch.models.common import patchify as _patchify, unpatchify as _unpatchify
from ray_tpu_torch.models.transformer import (
    _check_mesh,
    _leaves,
    _rebuild,
    adamw_update_,
    new_train_state,
    shard_train_state,
    sum_replicas_,
    value_and_grad,
)
from ray_tpu_torch.parallel import collective
from ray_tpu_torch.parallel.mesh import P, shard_array
from ray_tpu_torch.ops.attention import mha


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    image_size: int = 32
    patch_size: int = 4
    channels: int = 3
    num_classes: int = 10          # 0 => unconditional
    d_model: int = 256
    n_layers: int = 6
    n_heads: int = 8
    mlp_ratio: int = 4
    timesteps: int = 1000          # diffusion schedule length
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.image_size % self.patch_size:
            raise ValueError(
                f"image_size {self.image_size} not divisible by patch_size {self.patch_size}"
            )
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by n_heads {self.n_heads}")

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# ---------------------------------------------------------------------------
# schedule (cosine, Nichol & Dhariwal)
# ---------------------------------------------------------------------------
def alpha_bar(cfg: DiTConfig, device=None) -> torch.Tensor:
    """Cumulative signal fraction per step t in [0, T), f32 [T]."""
    t = torch.arange(cfg.timesteps + 1, dtype=torch.float32, device=device) / cfg.timesteps
    f = torch.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
    ab = f / f[0]
    return torch.clamp(ab[1:], 1e-5, 1.0)


def _ddim_timesteps(cfg: DiTConfig, steps: int, device=None) -> torch.Tensor:
    """``jnp.linspace(T - 1, 0, steps).astype(int32)`` as XLA computes it in
    f32: start * (1 - i * (1/div)) (its division by a constant becomes a
    product with the f32 reciprocal), the stop appended; so both packages
    truncate the same floats to the same steps."""
    start = torch.tensor(cfg.timesteps - 1, dtype=torch.float32, device=device)
    if steps == 1:
        return start.reshape(1).to(torch.int32)
    div = steps - 1
    recip = torch.tensor(1.0, dtype=torch.float32, device=device) / div
    out = start * (1 - torch.arange(div, dtype=torch.float32, device=device) * recip)
    return torch.cat([out, torch.zeros(1, device=device)]).to(torch.int32)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_dit_params(cfg: DiTConfig, generator: torch.Generator) -> Dict[str, Any]:
    """Random params drawn from ``generator``, on its device (the JAX
    recipe: adaLN-Zero, so ``ada``, ``final_ada`` and ``head`` start at
    zero and a fresh model predicts zero noise)."""
    pd = cfg.param_dtype
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    ff = cfg.mlp_ratio * d
    dev = generator.device

    def dense(shape, fan_in):
        return dense_init(generator, shape, fan_in, pd)

    def zeros(*shape):
        return torch.zeros(shape, dtype=pd, device=dev)

    def normal(*shape):
        return (torch.randn(shape, generator=generator, device=dev) * 0.02).to(pd)

    def one_layer():
        return {
            "wq": dense((d, h, dh), d),
            "wk": dense((d, h, dh), d),
            "wv": dense((d, h, dh), d),
            "wo": dense((h, dh, d), d),
            "w1": dense((d, ff), d),
            "w2": dense((ff, d), ff),
            # adaLN-Zero: each block starts as the identity
            "ada": zeros(d, 6 * d),
            "ada_b": zeros(6 * d),
        }

    per_layer = [one_layer() for _ in range(cfg.n_layers)]
    params = {
        "patch_embed": dense((cfg.patch_dim, d), cfg.patch_dim),
        "pos_embed": normal(1, cfg.num_patches, d),
        "t_mlp1": dense((256, d), 256),
        "t_mlp2": dense((d, d), d),
        "layers": {k: torch.stack([lay[k] for lay in per_layer]) for k in per_layer[0]},
        "final_ada": zeros(d, 2 * d),
        "final_ada_b": zeros(2 * d),
        "head": zeros(d, cfg.patch_dim),
    }
    if cfg.num_classes:
        # +1 slot: the null label (classifier-free guidance / unconditional)
        params["label_embed"] = normal(cfg.num_classes + 1, d)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _timestep_embedding(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    """Sinusoidal embedding of diffusion step t: [B] -> [B, dim] f32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    ang = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _modulated_ln(x, shift, scale, eps=1e-6):
    # mean and (population) variance in f32; x - mu promotes to f32 and
    # rounds back to x's dtype before the modulation, as in the JAX code
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    xn = ((x - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    return xn * (1 + scale[:, None, :]) + shift[:, None, :]


def patchify(cfg: DiTConfig, images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, patch_dim]."""
    return _patchify(images, cfg.patch_size)


def unpatchify(cfg: DiTConfig, patches: torch.Tensor) -> torch.Tensor:
    """[B, N, patch_dim] -> [B, H, W, C]."""
    return _unpatchify(patches, cfg.image_size, cfg.patch_size, cfg.channels)


def _block(cond, x, layer):
    mods = cond @ layer["ada"].to(cond.dtype) + layer["ada_b"].to(cond.dtype)
    sh1, sc1, g1, sh2, sc2, g2 = torch.chunk(mods, 6, dim=-1)
    h = _modulated_ln(x, sh1, sc1)
    q = torch.einsum("bnd,dhk->bnhk", h, layer["wq"].to(h.dtype))
    k = torch.einsum("bnd,dhk->bnhk", h, layer["wk"].to(h.dtype))
    v = torch.einsum("bnd,dhk->bnhk", h, layer["wv"].to(h.dtype))
    o = mha(q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), causal=False)
    att = torch.einsum("bnhk,hkd->bnd", o.permute(0, 2, 1, 3), layer["wo"].to(o.dtype))
    x = x + g1[:, None, :] * att
    h = _modulated_ln(x, sh2, sc2)
    # jax.nn.gelu's default is the tanh approximation
    ffn = F.gelu(h @ layer["w1"].to(h.dtype), approximate="tanh") @ layer["w2"].to(h.dtype)
    return x + g2[:, None, :] * ffn


def dit_forward(
    cfg: DiTConfig,
    params: Dict[str, Any],
    images: torch.Tensor,                   # [B, H, W, C] noisy input x_t
    t: torch.Tensor,                        # [B] int/float timesteps
    labels: Optional[torch.Tensor] = None,  # [B] int; cfg.num_classes = null label
) -> torch.Tensor:
    """Predicts epsilon (the noise), f32, with the shape of ``images``."""
    x = patchify(cfg, images).to(cfg.dtype) @ params["patch_embed"].to(cfg.dtype)
    x = x + params["pos_embed"].to(cfg.dtype)
    cond = F.silu(_timestep_embedding(t) @ params["t_mlp1"].float())
    cond = cond @ params["t_mlp2"].float()
    if cfg.num_classes and labels is not None:
        cond = cond + params["label_embed"].float()[labels.long()]
    cond = F.silu(cond).to(cfg.dtype)  # [B, d]
    names = list(params["layers"])
    for leaves in zip(*(params["layers"][n].unbind(0) for n in names)):
        x = _block(cond, x, dict(zip(names, leaves)))
    mods = cond @ params["final_ada"].to(cond.dtype) + params["final_ada_b"].to(cond.dtype)
    sh, sc = torch.chunk(mods, 2, dim=-1)
    x = _modulated_ln(x, sh, sc)
    eps = x @ params["head"].to(x.dtype)
    return unpatchify(cfg, eps.float())


# ---------------------------------------------------------------------------
# training (DDPM epsilon prediction)
# ---------------------------------------------------------------------------
def _dit_loss_at(cfg: DiTConfig, params, images, labels, t, eps, drop=None) -> torch.Tensor:
    """The loss at given draws: timesteps ``t`` [B], noise ``eps`` (the
    images' shape, f32) and ``drop`` [B] bool (labels replaced by the null
    label; None: no dropout)."""
    ab = alpha_bar(cfg, images.device)[t.long()][:, None, None, None]
    x_t = torch.sqrt(ab) * images + torch.sqrt(1.0 - ab) * eps
    if cfg.num_classes and labels is not None and drop is not None:
        # classifier-free guidance needs the null label trained too
        labels = torch.where(drop, cfg.num_classes, labels.long())
    pred = dit_forward(cfg, params, x_t, t, labels)
    return torch.mean(torch.square(pred - eps))


def _draws(cfg: DiTConfig, shape, dev, generator: torch.Generator, conditional: bool,
           label_dropout: float = 0.1):
    """(t, noise, label dropout) for a batch of ``shape`` from ``generator``
    (the dropout None when there is none)."""
    B = shape[0]
    t = torch.randint(0, cfg.timesteps, (B,), generator=generator, device=dev)
    eps = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
    drop = None
    if cfg.num_classes and conditional and label_dropout > 0:
        drop = torch.rand(B, generator=generator, device=dev) < label_dropout
    return t, eps, drop


def dit_loss_fn(
    cfg: DiTConfig, params, images, labels, generator: torch.Generator, *,
    label_dropout: float = 0.1,
) -> torch.Tensor:
    """Draws t, the noise and the label dropout from ``generator`` (on the
    images' device), then :func:`_dit_loss_at`."""
    draws = _draws(cfg, images.shape, images.device, generator, labels is not None,
                   label_dropout)
    return _dit_loss_at(cfg, params, images, labels, *draws)


def make_dit_train_step(
    cfg: DiTConfig,
    *,
    mesh=None,
    learning_rate: float = 1e-4,
    dp: Optional[str] = "dp",
    device=None,
) -> Tuple[Callable, Callable]:
    """``(init_state, step(state, images, labels, generator))``, the
    decoder's train state and optimizer (``optax.adamw(learning_rate)``):
    the step updates the state's tensors in place and returns ``(state,
    loss)``; ``generator`` (on ``device``) takes the place of the JAX key.

    With ``mesh`` (every rank builds and calls it): the batch shards over
    ``dp`` and the params are replicated. The step is a
    :class:`JittedStep` whose ``shard_batch(images, labels)`` gives this
    rank's rows; its generator draws for the whole batch (the same on every
    rank) and each rank takes its rows of the draws, so the step is the
    one-device step on the same generator. In place of the generator it
    also takes the whole batch's draws ``(t, eps, drop)`` (as
    :func:`_dit_loss_at` does; ``drop`` may be None)."""
    device = default_device(device, "make_dit_train_step")

    def init_state(seed_or_generator=0):
        params = init_dit_params(cfg, as_generator(seed_or_generator, device))
        return new_train_state(_rebuild(params, [t.to(device) for t in _leaves(params)]))

    if mesh is None:
        def step(state, images, labels, generator):
            images = images.to(device)
            labels = None if labels is None else labels.to(device)
            loss, grads = value_and_grad(
                lambda p: dit_loss_fn(cfg, p, images, labels, generator), state["params"])
            adamw_update_(state, grads, learning_rate)
            return state, loss

        return init_state, step

    _check_mesh(mesh)
    dp_ax = dp if dp in mesh.shape else None
    n_dp = mesh.shape[dp_ax] if dp_ax else 1

    def spec_tree(tree):
        return {k: spec_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else P()

    def sharded_step(state, images, labels, draws):
        images = images.to(device)
        labels = None if labels is None else labels.to(device)
        B = images.shape[0]
        lo = (collective.axis_index(dp_ax, mesh=mesh) if dp_ax else 0) * B
        if isinstance(draws, torch.Generator):
            draws = _draws(cfg, (B * n_dp, *images.shape[1:]), images.device, draws,
                           labels is not None)
        t, eps, drop = (None if d is None else d.to(device)[lo:lo + B] for d in draws)

        def loss_of(p):
            # this rank's rows' mean over the dp ranks, divided among the
            # ranks holding the same rows
            share = _dit_loss_at(cfg, p, images, labels, t, eps, drop) / mesh.size
            return collective.replicated_sum(share, mesh.axis_names, mesh=mesh)

        loss, grads = value_and_grad(loss_of, state["params"])
        sum_replicas_(grads, spec_tree(grads), mesh)
        adamw_update_(state, grads, learning_rate)
        return state, loss

    def shard_batch(images, labels):
        images = shard_array(images.to(device), mesh, dp_ax, None, None, None)
        return images, None if labels is None else shard_array(labels.to(device), mesh, dp_ax)

    def shard_state(state):
        return shard_train_state(spec_tree(state["params"]), mesh, state)

    return init_state, JittedStep(sharded_step, shard_batch, shard_state)


# ---------------------------------------------------------------------------
# sampling (DDIM)
# ---------------------------------------------------------------------------
@torch.no_grad()
def _ddim_loop(cfg: DiTConfig, params, x, *, steps: int, labels=None,
               guidance_scale: float = 0.0) -> torch.Tensor:
    """DDIM from the initial noise ``x`` [num, H, W, C] f32 over ``steps``
    steps of the schedule; with ``guidance_scale > 0`` and labels,
    classifier-free guidance (one forward over [cond; uncond] a step)."""
    num, dev = x.shape[0], x.device
    ab = alpha_bar(cfg, dev)
    ts = _ddim_timesteps(cfg, steps, dev).tolist()
    guided = guidance_scale > 0 and labels is not None and cfg.num_classes
    if guided:
        labels = labels.to(dev)
        both_labels = torch.cat([labels, torch.full_like(labels, cfg.num_classes)])
    for i in range(steps):
        t_b = torch.full((num,), ts[i], dtype=torch.int32, device=dev)
        if guided:
            both = dit_forward(cfg, params, torch.cat([x, x]), torch.cat([t_b, t_b]),
                               both_labels)
            e_cond, e_unc = both[:num], both[num:]
            eps = e_unc + (1.0 + guidance_scale) * (e_cond - e_unc)
        else:
            eps = dit_forward(cfg, params, x, t_b, labels)
        a_t = ab[ts[i]]
        a_next = ab[ts[i + 1]] if i + 1 < steps else torch.ones((), device=dev)
        x0 = torch.clamp((x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t), -3.0, 3.0)
        x = torch.sqrt(a_next) * x0 + torch.sqrt(1.0 - a_next) * eps
    return x


def ddim_sample(
    cfg: DiTConfig,
    params: Dict[str, Any],
    generator: torch.Generator,
    *,
    num: int = 4,
    steps: int = 50,
    labels: Optional[torch.Tensor] = None,
    guidance_scale: float = 0.0,
) -> torch.Tensor:
    """Generate ``num`` images [num, H, W, C] f32 on ``generator``'s device:
    the initial noise drawn from ``generator``, then :func:`_ddim_loop`."""
    shape = (num, cfg.image_size, cfg.image_size, cfg.channels)
    x = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return _ddim_loop(cfg, params, x, steps=steps, labels=labels,
                      guidance_scale=guidance_scale)
