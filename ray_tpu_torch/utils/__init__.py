"""Device resolution for the port's entry points.

Counterpart of ``ray_tpu/utils/__init__.py:is_tpu``, which steers the JAX
package's kernel dispatch. Here every entry point (``TorchLLMEngine``,
``LLMServer``, ``Transformer``, ``init_cache``) takes ``device=``: it means
the card unless the caller asks for the CPU, and a missing card is an error,
never a silent move to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``. Raises if the card is asked for and absent;
    gives the CPU only when ``device`` names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def device_report() -> dict:
    """The card this process runs on, in the keys the chip smoke prints."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


__all__ = ["resolve_device", "device_report"]
