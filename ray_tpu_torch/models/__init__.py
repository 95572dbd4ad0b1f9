"""The model zoo: the decoder-only transformer (dense or MoE; forward, train
step, cached generation), the ViT classifier, the DiT diffusion model and
the MLP, and model checkpoints."""

from ray_tpu_torch.models.checkpoint import load_model, register_config, save_model
from ray_tpu_torch.models.dit import (
    DiTConfig,
    ddim_sample,
    dit_forward,
    dit_loss_fn,
    init_dit_params,
    make_dit_train_step,
)
from ray_tpu_torch.models.generation import (
    decode_step,
    generate,
    init_cache,
    prefill,
    sample_logits,
)
from ray_tpu_torch.models.mlp import MLPConfig, mlp_apply, mlp_init
from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    forward,
    init_params,
    loss_fn,
    make_train_step,
)
from ray_tpu_torch.models.vit import (
    ViTConfig,
    init_vit_params,
    make_vit_train_step,
    patchify,
    vit_forward,
    vit_loss_fn,
)

__all__ = [
    "DiTConfig",
    "MLPConfig",
    "TransformerConfig",
    "ViTConfig",
    "ddim_sample",
    "decode_step",
    "dit_forward",
    "dit_loss_fn",
    "forward",
    "generate",
    "init_cache",
    "init_dit_params",
    "init_params",
    "init_vit_params",
    "load_model",
    "loss_fn",
    "make_dit_train_step",
    "make_train_step",
    "make_vit_train_step",
    "mlp_apply",
    "mlp_init",
    "patchify",
    "prefill",
    "register_config",
    "sample_logits",
    "save_model",
    "vit_forward",
    "vit_loss_fn",
]
