"""Model zoo of the port: the flagship decoder LM (dense path)."""

from ray_tpu_torch.models.transformer import (
    CONFIGS,
    Transformer,
    TransformerConfig,
    lm_loss,
)
from ray_tpu_torch.models.convert import (from_jax_opt_state,
                                          from_jax_params, init_params)

__all__ = [
    "Transformer", "TransformerConfig", "CONFIGS", "lm_loss",
    "from_jax_opt_state", "from_jax_params", "init_params",
]
