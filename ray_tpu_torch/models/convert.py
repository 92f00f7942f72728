"""Parameters between the JAX package's flax tree and the port's state dict.

The port keeps flax's key paths and shapes (``models/transformer.py``), so
``from_jax_params`` is a copy: the unboxed tree ``{"params": {...}}`` with
numpy leaves becomes a flat state dict whose keys are the paths joined by
dots, without the ``params`` root. ``init_params`` draws the port's own
weights from a ``torch.Generator`` with the flax initialisers' laws. For
the LM: normal(0.02 / sqrt(2 L)) for the projections and the expert stacks,
normal(0.02) for the embedding, the lm_head and the MoE router, ones for
the norm scales. For the ViT (``models/vit.py``): lecun_normal (a normal
truncated at two deviations, std sqrt(1 / fan_in) / 0.8796) for the patch
embedding, the attention projections and the head, xavier_uniform for the
MLP, normal(0.02) for the position embedding, zeros for the biases and the
class token, ones for the norm scales. ``from_jax_opt_state`` carries the
optimizer's state across, so a JAX run resumes in the port, also from a
checkpoint the JAX package wrote (``ckpt.restore_tree``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Mapping, Tuple, Union

import numpy as np
import torch

from ray_tpu_torch.models import transformer, vit
from ray_tpu_torch.utils import DeviceLike, resolve_device

Config = Union[transformer.TransformerConfig, vit.ViTConfig]


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


def state_dict_shapes(cfg: Config) -> Dict[str, tuple]:
    """The flax paths and shapes of either model family's parameters."""
    if isinstance(cfg, vit.ViTConfig):
        return vit.state_dict_shapes(cfg)
    return transformer.state_dict_shapes(cfg)


def check_params(params: Mapping[str, Any], cfg: Config) -> None:
    """Raise unless ``params`` holds exactly the config's leaves and shapes
    (an LM's ``TransformerConfig`` or a ``ViTConfig``)."""
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


def init_params(cfg: Config, seed: int = 0,
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Random weights from ``seed`` (a ``torch.Generator`` on ``device``) in
    ``cfg.param_dtype``, for either model family. The draws differ from
    flax's for the same seed; the laws are the same."""
    return dict(iter_init_params(cfg, seed, device))


def iter_init_params(cfg: Config, seed: int = 0, device: DeviceLike = None
                     ) -> Iterator[Tuple[str, torch.Tensor]]:
    """``init_params``' leaves one at a time, in the same draws: a mesh's
    rank keeps its piece of each and drops the rest."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    draw = _vit_law if isinstance(cfg, vit.ViTConfig) else _lm_law
    for key, shape in state_dict_shapes(cfg).items():
        if key.endswith(".scale"):
            yield key, torch.ones(shape, dtype=torch.float32, device=dev)
            continue
        w = torch.empty(shape, dtype=cfg.param_dtype, device=dev)
        yield key, draw(cfg, key, w, gen)


def _lm_law(cfg, key, w, gen):
    if key in ("embed", "lm_head") or key.endswith(".router.kernel"):
        return w.normal_(0.0, 0.02, generator=gen)
    return w.normal_(0.0, 0.02 / math.sqrt(2 * cfg.n_layers), generator=gen)


# flax's truncated_normal: the std of a standard normal cut at +-2
_TRUNCATED_STD = 0.87962566103423978


def _vit_law(cfg, key, w, gen):
    if key.endswith(".bias") or key == "cls_token":
        return w.zero_()
    if key == "pos_embed":
        return w.normal_(0.0, 0.02, generator=gen)
    if ".fc" in key:  # xavier_uniform over the (in, out) kernel
        limit = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
        return w.uniform_(-limit, limit, generator=gen)
    # lecun_normal: fan_in is every kernel dim but the output ones
    out_dims = 2 if key.endswith(("query.kernel", "key.kernel",
                                  "value.kernel")) else 1
    std = math.sqrt(1.0 / math.prod(w.shape[:-out_dims])) / _TRUNCATED_STD
    return torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                       generator=gen)


def from_jax_opt_state(opt_state):
    """optax's state of the JAX package's ``make_optimizer`` chain (the
    clip's empty state, then ``ScaleByAdamState(count, mu, nu)``, the weight
    decay's empty state and the schedule's ``ScaleByScheduleState(count)``),
    with numpy leaves, as the port's ``OptState``: the moments keyed by the
    same flax paths, on the CPU, and the step count. The state may be
    optax's own, or as ``ckpt.restore_tree`` gives it back from a checkpoint
    the JAX package wrote: the same tuples, with the optax states rebuilt
    as the named tuples of ``weights.spec.OPTAX_STATES``."""
    from ray_tpu_torch.parallel.train import OptState

    found = {}

    def walk(node):  # optax states are named tuples inside plain tuples
        fields = getattr(node, "_fields", ())
        if {"count", "mu", "nu"} <= set(fields):
            found["adam"] = node
        elif "count" in fields:
            found["schedule"] = node
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)

    walk(opt_state)
    if set(found) != {"adam", "schedule"}:
        raise ValueError("not the state of clip_by_global_norm + adamw over a "
                         f"schedule: found {sorted(found)}")
    count = int(np.asarray(found["adam"].count))
    if int(np.asarray(found["schedule"].count)) != count:
        raise ValueError("the schedule's count differs from Adam's")
    return OptState(count, from_jax_params(found["adam"].mu),
                    from_jax_params(found["adam"].nu))
