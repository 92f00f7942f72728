"""Training of the flagship LM: the optimizer and the single-device step."""

from ray_tpu_torch.parallel.train import (
    AdamW,
    OptState,
    TrainStepBundle,
    make_optimizer,
)

__all__ = ["AdamW", "OptState", "TrainStepBundle", "make_optimizer"]
