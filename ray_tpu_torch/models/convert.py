"""Parameters between the JAX package's flax tree and the port's state dict.

The port keeps flax's key paths and shapes (``models/transformer.py``), so
``from_jax_params`` is a copy: the unboxed tree ``{"params": {...}}`` with
numpy leaves becomes a flat state dict whose keys are the paths joined by
dots, without the ``params`` root. ``init_params`` draws the port's own
weights from a ``torch.Generator`` with the flax initialisers' laws:
normal(0.02 / sqrt(2 L)) for the projections, normal(0.02) for the
embedding and lm_head, ones for the norm scales.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ray_tpu_torch.models.transformer import TransformerConfig, state_dict_shapes
from ray_tpu_torch.utils import DeviceLike, resolve_device


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path))
        else:
            flat[path] = val
    return flat


def from_jax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The flax tree (``{"params": {...}}`` or its inner dict, numpy leaves)
    as a flat CPU state dict of the same dtypes and shapes."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in _flatten(tree).items()}


def check_params(params: Mapping[str, Any], cfg: TransformerConfig) -> None:
    """Raise unless ``params`` holds exactly the config's leaves and shapes."""
    want = state_dict_shapes(cfg)
    missing = sorted(set(want) - set(params))
    extra = sorted(set(params) - set(want))
    if missing or extra:
        raise KeyError(f"params do not fit the config: missing {missing[:4]}, "
                       f"unexpected {extra[:4]}")
    for key, shape in want.items():
        got = tuple(params[key].shape)
        if got != shape:
            raise ValueError(f"{key} has shape {got}, the config wants {shape}")


def init_params(cfg: TransformerConfig, seed: int = 0,
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Random weights from ``seed`` (a ``torch.Generator`` on ``device``) in
    ``cfg.param_dtype``. The draws differ from flax's for the same seed; the
    laws are the same."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    proj_std = 0.02 / math.sqrt(2 * cfg.n_layers)
    params = {}
    for key, shape in state_dict_shapes(cfg).items():
        if key.endswith(".scale"):
            params[key] = torch.ones(shape, dtype=torch.float32, device=dev)
            continue
        std = 0.02 if key in ("embed", "lm_head") else proj_std
        w = torch.empty(shape, dtype=cfg.param_dtype, device=dev)
        params[key] = w.normal_(0.0, std, generator=gen)
    return params
