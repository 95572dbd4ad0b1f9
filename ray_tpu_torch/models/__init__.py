"""The decoder-only transformer: its forward and train step, cached
generation, and model checkpoints."""

from ray_tpu_torch.models.checkpoint import load_model, register_config, save_model
from ray_tpu_torch.models.generation import (
    decode_step,
    generate,
    init_cache,
    prefill,
    sample_logits,
)
from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    forward,
    init_params,
    loss_fn,
    make_train_step,
)

__all__ = [
    "TransformerConfig",
    "decode_step",
    "forward",
    "generate",
    "init_cache",
    "init_params",
    "load_model",
    "loss_fn",
    "make_train_step",
    "prefill",
    "register_config",
    "sample_logits",
    "save_model",
]
