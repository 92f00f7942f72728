"""CUDA kernels and their plain PyTorch versions (attention)."""

from ray_tpu_torch.ops.attention import (
    attention,
    flash_attention_fwd,
    flash_attention_fwd_plain,
    reference_attention,
)

__all__ = [
    "attention",
    "flash_attention_fwd",
    "flash_attention_fwd_plain",
    "reference_attention",
]
