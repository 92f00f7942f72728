"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package of its own beside ``ray_tpu`` (the JAX reference), importing none
of it. Ported so far: the paged-KV LLM serving path (``llm``), the decoder
LMs and the ViT (``models``), their training step on one device or on a
mesh of five axes, traced or not (``parallel``), the collective group on
``torch.distributed`` with its codecs and bucketed tier (``collective``),
metrics, spans and the goodput ledger (``util``), the token-file loader
(``data``), the checkpoint plane with its storage tiers (``ckpt``, over
the mesh geometry of ``weights``), and the flash-attention forward and
backward as CUDA kernels with ring and Ulysses attention on them
(``ops``). Entry points run on the card unless given
``device="cpu"``.

Submodules load lazily: importing this package imports neither the model
code nor the kernels, and kernels are built only when first launched.
"""

import importlib

_SUBMODULES = ("ckpt", "collective", "data", "llm", "models", "ops",
               "parallel", "train", "util", "utils", "weights")


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"ray_tpu_torch.{name}")
    raise AttributeError(name)


__version__ = "0.1.0"

__all__ = list(_SUBMODULES) + ["__version__"]
