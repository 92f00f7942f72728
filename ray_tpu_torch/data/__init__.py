"""The port's training input: the native token-file loader
(``token_loader``), the counterpart of ``ray_tpu/data/token_loader.py``.
The JAX package's datasets (``ray_tpu.data``'s blocks over the object
store) wait for the runtime's port."""

from ray_tpu_torch.data.token_loader import (TokenFileLoader, to_device,
                                             write_token_file)

__all__ = ["TokenFileLoader", "to_device", "write_token_file"]
