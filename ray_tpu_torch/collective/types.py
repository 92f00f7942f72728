"""Collective types: a copy of ``ray_tpu/collective/types.py`` for torch.

The JAX package's backends are XLA (the device tier) and a store-actor CPU
tier. Here both are ``torch.distributed`` process groups: NCCL on the card,
gloo on the CPU. The JAX names stay valid and map onto their torch
counterparts (``xla`` to ``nccl``, ``cpu`` to ``gloo``), so a caller that
names the tier as it did for the JAX package gets the same tier here.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class ReduceOp(enum.Enum):
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"
    AVERAGE = "average"


class Backend:
    """The torch backends, and the JAX package's names for the same tiers."""

    NCCL = "nccl"
    GLOO = "gloo"
    XLA = "xla"  # the device tier: NCCL here
    CPU = "cpu"  # the CPU tier: gloo here

    _ALIASES = {XLA: NCCL, CPU: GLOO}

    @staticmethod
    def validate(name: str) -> str:
        """The torch backend ``name`` stands for; raises for any other."""
        name = Backend._ALIASES.get(name, name)
        if name not in (Backend.NCCL, Backend.GLOO):
            raise ValueError(f"unknown collective backend {name!r}")
        return name

    @staticmethod
    def for_device(device_type: str) -> str:
        """The backend that follows the device: NCCL for ``cuda``, gloo for
        ``cpu``."""
        if device_type == "cuda":
            return Backend.NCCL
        if device_type == "cpu":
            return Backend.GLOO
        raise ValueError(f"no collective backend for device {device_type!r}")


@dataclass
class GroupInfo:
    group_name: str
    world_size: int
    backend: str
