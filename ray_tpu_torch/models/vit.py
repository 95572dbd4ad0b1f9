"""Vision Transformer: the image classifier, and its train step.

Counterpart of ``ray_tpu/models/vit.py``: patch embedding as one matmul over
unfolded patches, a CLS token and learned position embeddings, encoder
blocks with the decoder's RMSNorm/SwiGLU recipe and BIDIRECTIONAL attention,
a linear head over the CLS representation. Params are the same nested dict
with stacked ``[n_layers, ...]`` layer leaves, so a JAX param tree converts
leaf by leaf (:mod:`ray_tpu_torch.convert`).

Attention: ``"flash"``, or ``"auto"`` on CUDA tensors, runs the flash
kernels non-causal (:func:`ray_tpu_torch.ops.attention.flash_attention`:
the forward, and both backward kernels in training); ``"dense"`` the plain
:func:`ray_tpu_torch.ops.attention.mha`. At ViT-B/16's 224-pixel images the
sequence is 197 (196 patches and the CLS token), a ragged length for the
kernels' 64-row tiles. Under a mesh (``make_vit_train_step(mesh=)``) the
params shard per :func:`vit_param_specs` (tensor parallelism, explicit: the
patch embedding's columns gathered over tp, local heads through the
attention, wo, w2 and the head summed over tp) and the batch over dp.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ray_tpu_torch.models.common import JittedStep, as_generator, default_device, dense_init
from ray_tpu_torch.models.common import patchify as _patchify
from ray_tpu_torch.models.transformer import (
    _check_mesh,
    _dense_ffn,
    _ONE_DEVICE,
    _Layout,
    _leaves,
    _rebuild,
    _remat,
    _rms_norm,
    adamw_update_,
    fitted_specs,
    new_train_state,
    shard_train_state,
    sum_replicas_,
    value_and_grad,
)
from ray_tpu_torch.ops.attention import flash_attention, mha
from ray_tpu_torch.parallel import collective
from ray_tpu_torch.parallel.mesh import P, shard_array, shard_tree, spec_axes


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    num_classes: int = 1000
    d_model: int = 384
    n_layers: int = 6
    n_heads: int = 6
    d_ff: int = 1536
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    attention: str = "auto"       # auto | flash | dense
    remat: bool = False

    def __post_init__(self):
        if self.image_size % self.patch_size:
            raise ValueError(
                f"image_size {self.image_size} not divisible by patch_size {self.patch_size}"
            )
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by n_heads {self.n_heads}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels


def init_vit_params(cfg: ViTConfig, generator: torch.Generator) -> Dict[str, Any]:
    """Random params drawn from ``generator``, on its device. The shapes and
    the init recipe are the JAX package's; the numbers are not."""
    pd = cfg.param_dtype
    d, h, dh, ff = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    dev = generator.device

    def dense(shape, fan_in):
        return dense_init(generator, shape, fan_in, pd)

    def one_layer():
        return {
            "attn_norm": torch.ones(d, dtype=pd, device=dev),
            "wq": dense((d, h, dh), d),
            "wk": dense((d, h, dh), d),
            "wv": dense((d, h, dh), d),
            "wo": dense((h, dh, d), d),
            "ffn_norm": torch.ones(d, dtype=pd, device=dev),
            "w1": dense((d, ff), d),
            "w3": dense((d, ff), d),
            "w2": dense((ff, d), ff),
        }

    per_layer = [one_layer() for _ in range(cfg.n_layers)]
    pos = torch.randn(1, cfg.num_patches + 1, d, generator=generator, device=dev) * 0.02
    return {
        "patch_embed": dense((cfg.patch_dim, d), cfg.patch_dim),
        "cls_token": torch.zeros(1, 1, d, dtype=pd, device=dev),
        "pos_embed": pos.to(pd),
        "layers": {k: torch.stack([lay[k] for lay in per_layer]) for k in per_layer[0]},
        "final_norm": torch.ones(d, dtype=pd, device=dev),
        "head": dense((d, cfg.num_classes), d),
    }


def vit_param_specs(cfg: ViTConfig, *, tp: Optional[str] = "tp") -> Dict[str, Any]:
    """Megatron-style TP layout (the decoder's :func:`param_specs`)."""
    return {
        "patch_embed": P(None, tp),
        "cls_token": P(None, None, None),
        "pos_embed": P(None, None, None),
        "layers": {
            "attn_norm": P(None, None),
            "wq": P(None, None, tp, None),
            "wk": P(None, None, tp, None),
            "wv": P(None, None, tp, None),
            "wo": P(None, tp, None, None),
            "ffn_norm": P(None, None),
            "w1": P(None, None, tp),
            "w3": P(None, None, tp),
            "w2": P(None, tp, None),
        },
        "final_norm": P(None),
        "head": P(tp, None),
    }


def vit_param_shapes(cfg: ViTConfig) -> Dict[str, Any]:
    """The shape of every param leaf (:func:`init_vit_params`'s tree)."""
    d, h, dh, ff, L = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.n_layers
    return {
        "patch_embed": (cfg.patch_dim, d), "cls_token": (1, 1, d),
        "pos_embed": (1, cfg.num_patches + 1, d),
        "layers": {"attn_norm": (L, d), "wq": (L, d, h, dh), "wk": (L, d, h, dh),
                   "wv": (L, d, h, dh), "wo": (L, h, dh, d), "ffn_norm": (L, d),
                   "w1": (L, d, ff), "w3": (L, d, ff), "w2": (L, ff, d)},
        "final_norm": (d,), "head": (d, cfg.num_classes),
    }


def patchify(cfg: ViTConfig, images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, num_patches, patch_dim] via strided reshape."""
    return _patchify(images, cfg.patch_size)


def _layer(cfg: ViTConfig, lay: _Layout, use_flash: bool, x, layer):
    """One encoder layer on this rank's heads and d_ff block (wo and w2
    summed over tp under a mesh)."""
    h = _rms_norm(x, layer["attn_norm"])
    q = torch.einsum("btd,dhk->bthk", h, layer["wq"].to(h.dtype))
    k = torch.einsum("btd,dhk->bthk", h, layer["wk"].to(h.dtype))
    v = torch.einsum("btd,dhk->bthk", h, layer["wv"].to(h.dtype))
    qt, kt, vt = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    if use_flash:
        o = flash_attention(qt, kt, vt, None, False)  # bidirectional
    else:
        o = mha(qt, kt, vt, causal=False)
    o = o.permute(0, 2, 1, 3)
    x = x + lay.reduce(torch.einsum("bthk,hkd->btd", o, layer["wo"].to(o.dtype)),
                       lay.entry("wo", 1))
    h = _rms_norm(x, layer["ffn_norm"])
    return x + lay.reduce(_dense_ffn(cfg, layer, h), lay.entry("w2", 1))


def _vit_forward(cfg: ViTConfig, lay: _Layout, params, images) -> torch.Tensor:
    """The logits of this rank's images. Under tp: the patch embedding's
    column blocks gathered over tp, the layers on local heads, the head's
    row blocks summed over tp."""
    use_flash = cfg.attention == "flash" or (
        cfg.attention == "auto" and images.device.type == "cuda"
    )
    x = patchify(cfg, images.to(cfg.dtype)) @ params["patch_embed"].to(cfg.dtype)
    pe = lay.entry("patch_embed", 1)
    if spec_axes(pe):
        x = collective.allgather(x, pe, axis=-1, mesh=lay.mesh)
    B = x.shape[0]
    cls = params["cls_token"].to(cfg.dtype).expand(B, 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(cfg.dtype)
    step = _remat(cfg, functools.partial(_layer, cfg, lay, use_flash), lay)
    names = list(params["layers"])
    for leaves in zip(*(params["layers"][n].unbind(0) for n in names)):
        x = step(x, dict(zip(names, leaves)))
    cls_repr = _rms_norm(x[:, 0], params["final_norm"])
    head = lay.entry("head", 0)
    if spec_axes(head):
        lo = lay.block("head", 0, cfg.d_model)
        cls_repr = cls_repr[:, lo:lo + params["head"].shape[0]]
    return lay.reduce(cls_repr @ params["head"].to(cls_repr.dtype), head).float()


def vit_forward(cfg: ViTConfig, params: Dict[str, Any], images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, C] float -> logits [B, num_classes] f32.
    ``attention="auto"`` takes the flash kernels when the images are on a
    CUDA device. Differentiable in the params; ``cfg.remat`` recomputes
    each layer in the backward."""
    return _vit_forward(cfg, _ONE_DEVICE, params, images)


def vit_loss_fn(cfg: ViTConfig, params, images, labels) -> torch.Tensor:
    """Mean cross entropy of the logits against integer ``labels`` [B]."""
    logp = torch.log_softmax(vit_forward(cfg, params, images), dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels.long()[:, None]))


def make_vit_train_step(
    cfg: ViTConfig,
    *,
    mesh=None,
    learning_rate: float = 1e-3,
    dp: Optional[str] = "dp",
    tp: Optional[str] = "tp",
    device=None,
) -> Tuple[Callable, Callable]:
    """``(init_state, train_step(state, images, labels))``, the decoder's
    train state and optimizer (``optax.adamw(learning_rate)``): the step
    updates the state's tensors in place and returns ``(state, loss)``.
    ``init_state(seed_or_generator=0)`` draws fresh params.

    With ``mesh`` (every rank builds and calls it): the state holds this
    rank's shards per :func:`vit_param_specs` over ``tp``, and the step is
    a :class:`JittedStep` whose ``shard_batch(images, labels)`` gives this
    rank's ``dp`` rows (the arguments the step takes); the loss is the
    whole batch's on every rank (as the decoder's
    :func:`~ray_tpu_torch.models.transformer.make_train_step`)."""
    device = default_device(device, "make_vit_train_step")

    def init_full(seed_or_generator):
        params = init_vit_params(cfg, as_generator(seed_or_generator, device))
        return _rebuild(params, [t.to(device) for t in _leaves(params)])

    if mesh is None:
        def train_step(state, images, labels):
            images, labels = images.to(device), labels.to(device)
            loss, grads = value_and_grad(lambda p: vit_loss_fn(cfg, p, images, labels),
                                         state["params"])
            adamw_update_(state, grads, learning_rate)
            return state, loss

        return (lambda seed_or_generator=0: new_train_state(init_full(seed_or_generator)),
                train_step)

    _check_mesh(mesh)
    dp_ax = dp if dp in mesh.shape else None
    tp_ax = tp if tp in mesh.shape else None
    specs = fitted_specs(vit_param_shapes(cfg), vit_param_specs(cfg, tp=tp_ax), mesh)
    lay = _Layout(mesh, dp_ax, None, tp_ax, specs)

    def sharded_loss(params, images, labels):
        logp = torch.log_softmax(_vit_forward(cfg, lay, params, images), dim=-1)
        nll = -torch.gather(logp, -1, labels.long()[:, None])
        share = torch.sum(nll) / (nll.shape[0] * lay.size(dp_ax) * lay.replicas)
        return collective.replicated_sum(share, lay.axes, mesh=mesh)

    def train_step(state, images, labels):
        images, labels = images.to(device), labels.to(device)
        loss, grads = value_and_grad(lambda p: sharded_loss(p, images, labels), state["params"])
        sum_replicas_(grads, specs, mesh)
        adamw_update_(state, grads, learning_rate)
        return state, loss

    def shard_batch(images, labels):
        return (shard_array(images.to(device), mesh, dp_ax, None, None, None),
                shard_array(labels.to(device), mesh, dp_ax))

    def init_state(seed_or_generator=0):
        return new_train_state(shard_tree(init_full(seed_or_generator), specs, mesh))

    return init_state, JittedStep(train_step, shard_batch,
                                  functools.partial(shard_train_state, specs, mesh))
