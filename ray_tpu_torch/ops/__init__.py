"""CUDA kernels and their plain PyTorch versions (attention), and the
sequence-parallel attention built on them."""

from ray_tpu_torch.ops.attention import (
    attention,
    flash_attention_fwd,
    flash_attention_fwd_plain,
    reference_attention,
)
from ray_tpu_torch.ops.ring_attention import ring_attention, ulysses_attention

__all__ = [
    "attention",
    "flash_attention_fwd",
    "flash_attention_fwd_plain",
    "reference_attention",
    "ring_attention",
    "ulysses_attention",
]
