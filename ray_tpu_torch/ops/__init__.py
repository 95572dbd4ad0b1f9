"""Ops with hand-written CUDA kernels and plain PyTorch versions: attention
(forward and backward) and the int8 weight-only matmul with its
quantization helpers. The decode kernels live in
:mod:`ray_tpu_torch.ops.decode_attention`."""

from ray_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_with_lse,
    mha,
    sliding_window_attention,
)
from ray_tpu_torch.ops.quantization import (
    NO_SCALE,
    TRANSFORMER_LINEAR_KEYS,
    dequantize_int8,
    dequantize_tree,
    int8_matmul,
    quantize_int8,
    quantize_layers,
    quantize_tree,
)

__all__ = [
    "NO_SCALE",
    "TRANSFORMER_LINEAR_KEYS",
    "dequantize_int8",
    "dequantize_tree",
    "flash_attention",
    "flash_attention_with_lse",
    "int8_matmul",
    "mha",
    "quantize_int8",
    "quantize_layers",
    "quantize_tree",
    "sliding_window_attention",
]
