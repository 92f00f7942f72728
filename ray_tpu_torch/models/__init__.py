"""Model zoo of the port: the flagship decoder LM (dense + MoE) and the ViT
classifier. The RL nets are not ported yet (ROADMAP.md queue 1)."""

from ray_tpu_torch.models.transformer import (
    CONFIGS,
    MoEMLP,
    Transformer,
    TransformerConfig,
    lm_loss,
)
from ray_tpu_torch.models.vit import (
    VIT_CONFIGS,
    VisionTransformer,
    ViTConfig,
    accuracy,
    classification_loss,
)
from ray_tpu_torch.models.convert import (from_jax_opt_state,
                                          from_jax_params, init_params)

__all__ = [
    "Transformer", "TransformerConfig", "CONFIGS", "MoEMLP", "lm_loss",
    "VisionTransformer", "ViTConfig", "VIT_CONFIGS",
    "classification_loss", "accuracy",
    "from_jax_opt_state", "from_jax_params", "init_params",
]
