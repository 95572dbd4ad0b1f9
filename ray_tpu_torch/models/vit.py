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
kernels' 64-row tiles. Not in this package yet: the tensor-parallel layout
(``vit_param_specs``) and ``mesh=`` (one device only).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Tuple

import torch

from ray_tpu_torch.models.common import as_generator, default_device, dense_init
from ray_tpu_torch.models.common import patchify as _patchify
from ray_tpu_torch.models.transformer import (
    _dense_ffn,
    _leaves,
    _rebuild,
    _remat,
    _rms_norm,
    adamw_update_,
    new_train_state,
    value_and_grad,
)
from ray_tpu_torch.ops.attention import flash_attention, mha


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


def patchify(cfg: ViTConfig, images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, num_patches, patch_dim] via strided reshape."""
    return _patchify(images, cfg.patch_size)


def _layer(cfg: ViTConfig, use_flash: bool, x, layer):
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
    x = x + torch.einsum("bthk,hkd->btd", o, layer["wo"].to(o.dtype))
    h = _rms_norm(x, layer["ffn_norm"])
    return x + _dense_ffn(cfg, layer, h)


def vit_forward(cfg: ViTConfig, params: Dict[str, Any], images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, C] float -> logits [B, num_classes] f32.
    ``attention="auto"`` takes the flash kernels when the images are on a
    CUDA device. Differentiable in the params; ``cfg.remat`` recomputes
    each layer in the backward."""
    use_flash = cfg.attention == "flash" or (
        cfg.attention == "auto" and images.device.type == "cuda"
    )
    x = patchify(cfg, images.to(cfg.dtype)) @ params["patch_embed"].to(cfg.dtype)
    B = x.shape[0]
    cls = params["cls_token"].to(cfg.dtype).expand(B, 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(cfg.dtype)
    step = _remat(cfg, functools.partial(_layer, cfg, use_flash))
    names = list(params["layers"])
    for leaves in zip(*(params["layers"][n].unbind(0) for n in names)):
        x = step(x, dict(zip(names, leaves)))
    cls_repr = _rms_norm(x[:, 0], params["final_norm"])
    return (cls_repr @ params["head"].to(cls_repr.dtype)).float()


def vit_loss_fn(cfg: ViTConfig, params, images, labels) -> torch.Tensor:
    """Mean cross entropy of the logits against integer ``labels`` [B]."""
    logp = torch.log_softmax(vit_forward(cfg, params, images), dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels.long()[:, None]))


def make_vit_train_step(
    cfg: ViTConfig,
    *,
    mesh=None,
    learning_rate: float = 1e-3,
    dp: str = "dp",
    tp: str = "tp",
    device=None,
) -> Tuple[Callable, Callable]:
    """``(init_state, train_step(state, images, labels))`` on one device, the
    decoder's train state and optimizer (``optax.adamw(learning_rate)``):
    the step updates the state's tensors in place and returns ``(state,
    loss)``. ``init_state(seed_or_generator=0)`` draws fresh params.
    ``dp``/``tp`` name mesh axes and matter only with ``mesh=``, which is
    not ported yet."""
    del dp, tp
    if mesh is not None:
        raise NotImplementedError("sharded training (mesh=) is not ported yet")
    device = default_device(device, "make_vit_train_step")

    def init_state(seed_or_generator=0):
        params = init_vit_params(cfg, as_generator(seed_or_generator, device))
        return new_train_state(_rebuild(params, [t.to(device) for t in _leaves(params)]))

    def train_step(state, images, labels):
        images, labels = images.to(device), labels.to(device)
        loss, grads = value_and_grad(lambda p: vit_loss_fn(cfg, p, images, labels),
                                     state["params"])
        adamw_update_(state, grads, learning_rate)
        return state, loss

    return init_state, train_step

