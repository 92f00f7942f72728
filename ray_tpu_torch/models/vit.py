"""The Vision Transformer classifier, in PyTorch.

Counterpart of ``ray_tpu/models/vit.py``. Parameters keep the flax tree's
paths and shapes (``patch_embed.kernel`` is the (p, p, 3, D) HWIO conv
kernel, ``block_0.attn.query.kernel`` is (D, H, hd) with its (H, hd) bias,
``block_0.attn.out.kernel`` is (H, hd, D)), so a JAX checkpoint converts by
copying (``models/convert.py``). Where flax's defaults differ from
PyTorch's, flax's are kept:

- ``nn.gelu`` is the tanh approximation;
- ``nn.LayerNorm`` takes eps 1e-6 and fp32 statistics (the variance as
  E[x^2] - E[x]^2, clipped at 0) and returns the compute dtype;
- a Dense adds its bias after the product, in the compute dtype;
- the head is an fp32 Dense on the bf16-rounded class token.

The patch embedding is the conv's product written as one matrix product:
its stride equals its kernel, so each patch meets the kernel once and flax's
SAME padding adds nothing. Attention goes through
``ray_tpu_torch.ops.attention`` with ``causal=False``; the scores are
scaled by 1/sqrt(hd), where flax divides q by sqrt(hd) first. Which route
it takes is fixed when the model is built (``attention_route``): the flash
kernels on the card where the head dim is one they take, else plain
attention.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.transformer import Dense
from ray_tpu_torch.ops.attention import KERNEL_HEAD_DIMS
from ray_tpu_torch.ops.attention import attention as attention_op
from ray_tpu_torch.utils import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 32
    patch_size: int = 4
    num_classes: int = 10
    d_model: int = 192
    n_layers: int = 6
    n_heads: int = 6
    d_ff: int = 768
    dropout: float = 0.0
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    attention_impl: str = "auto"  # auto | flash | xla (ops.attention)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


VIT_CONFIGS = {
    "vit-tiny": ViTConfig(),
    "vit-s16-224": ViTConfig(image_size=224, patch_size=16, num_classes=1000,
                             d_model=384, n_layers=12, n_heads=6, d_ff=1536),
    "vit-b16-224": ViTConfig(image_size=224, patch_size=16, num_classes=1000,
                             d_model=768, n_layers=12, n_heads=12, d_ff=3072),
}


def attention_route(cfg: ViTConfig) -> str:
    """The ``impl`` the model gives ``ops.attention``: ``auto`` (the flash
    kernels on the card, their plain versions on the CPU) becomes ``xla``
    (plain attention) where the head dim is not one the kernels take, as
    vit-tiny's 32; vit-s16 and vit-b16 (64) keep the kernels. ``flash`` at
    such a head dim raises."""
    if cfg.head_dim in KERNEL_HEAD_DIMS or cfg.attention_impl == "xla":
        return cfg.attention_impl
    if cfg.attention_impl == "auto":
        return "xla"
    raise ValueError(f"the flash kernels take head_dim {KERNEL_HEAD_DIMS}, "
                     f"not {cfg.head_dim}")


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm``: fp32 mean and E[x^2] - mean^2 (at least 0),
    eps 1e-6, scale and bias in fp32, output in the compute dtype."""

    def __init__(self, dim: int, dtype, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(
            torch.zeros(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((x32 - mean) * mul + self.bias).to(self.dtype)


class MultiHeadAttention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` on one input: q, k, v and the
    output projection with biases; full (non-causal) attention."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                  device=device, use_bias=True)
        self.impl = attention_route(cfg)
        self.query = Dense((d, H, hd), 1, **kw)
        self.key = Dense((d, H, hd), 1, **kw)
        self.value = Dense((d, H, hd), 1, **kw)
        self.out = Dense((H, hd, d), 2, **kw)

    def forward(self, x):
        o = attention_op(self.query(x), self.key(x), self.value(x),
                         causal=False, impl=self.impl)
        return self.out(o)


class EncoderBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                  device=device, use_bias=True)
        self.ln1 = LayerNorm(cfg.d_model, cfg.dtype, device=device)
        self.attn = MultiHeadAttention(cfg, device=device)
        self.ln2 = LayerNorm(cfg.d_model, cfg.dtype, device=device)
        self.fc1 = Dense((cfg.d_model, cfg.d_ff), 1, **kw)
        self.fc2 = Dense((cfg.d_ff, cfg.d_model), 1, **kw)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        h = F.gelu(self.fc1(self.ln2(x)), approximate="tanh")
        return x + self.fc2(h)


class VisionTransformer(nn.Module):
    """(B, H, W, C) images -> (B, num_classes) fp32 logits.

    ``params`` is a state dict keyed by flax paths (``convert.from_jax_params``
    or ``convert.init_params``); without it the weights are drawn from
    ``seed`` with the flax initialisers' laws."""

    def __init__(self, cfg: ViTConfig, device: DeviceLike = None,
                 params: Optional[Mapping[str, Any]] = None, seed: int = 0):
        super().__init__()
        from ray_tpu_torch.models.convert import init_params

        dev = resolve_device(device)
        self.cfg = cfg
        p, d = cfg.patch_size, cfg.d_model
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=dev,
                  use_bias=True)
        self.patch_embed = Dense((p, p, 3, d), 3, **kw)
        self.cls_token = nn.Parameter(
            torch.empty((1, 1, d), dtype=cfg.param_dtype, device=dev))
        self.pos_embed = nn.Parameter(torch.empty(
            (1, cfg.num_patches + 1, d), dtype=cfg.param_dtype, device=dev))
        for i in range(cfg.n_layers):
            self.add_module(f"block_{i}", EncoderBlock(cfg, device=dev))
        self.ln_final = LayerNorm(d, cfg.dtype, device=dev)
        self.head = Dense((d, cfg.num_classes), 1, dtype=torch.float32,
                          param_dtype=cfg.param_dtype, device=dev,
                          use_bias=True)
        if params is None:
            params = init_params(cfg, seed=seed, device=dev)
        self.load_state_dict(
            {k: torch.as_tensor(v) for k, v in params.items()})

    def forward(self, images):
        cfg = self.cfg
        B, Hi, Wi, C = images.shape
        p, d = cfg.patch_size, cfg.d_model
        # (B, Hi/p, p, Wi/p, p, C) -> one (p, p, C) patch per row, in the
        # conv output's row-major order
        patches = images.to(cfg.dtype).reshape(B, Hi // p, p, Wi // p, p, C)
        patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(
            B, (Hi // p) * (Wi // p), p, p, C)
        x = self.patch_embed(patches)
        cls = self.cls_token.to(cfg.dtype).expand(B, 1, d)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(cfg.dtype)
        for i in range(cfg.n_layers):
            x = getattr(self, f"block_{i}")(x)
        x = self.ln_final(x)
        return self.head(x[:, 0].float())


def classification_loss(logits: torch.Tensor, labels: torch.Tensor
                        ) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels[:, None].long()).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()


def state_dict_shapes(cfg: ViTConfig) -> Dict[str, tuple]:
    """Flax path (without the ``params`` root) -> shape."""
    p, d, f, H, hd = (cfg.patch_size, cfg.d_model, cfg.d_ff, cfg.n_heads,
                      cfg.head_dim)
    shapes = {"patch_embed.kernel": (p, p, 3, d), "patch_embed.bias": (d,),
              "cls_token": (1, 1, d), "pos_embed": (1, cfg.num_patches + 1, d)}
    for i in range(cfg.n_layers):
        b = f"block_{i}"
        shapes.update({f"{b}.ln1.scale": (d,), f"{b}.ln1.bias": (d,)})
        for name in ("query", "key", "value"):
            shapes.update({f"{b}.attn.{name}.kernel": (d, H, hd),
                           f"{b}.attn.{name}.bias": (H, hd)})
        shapes.update({
            f"{b}.attn.out.kernel": (H, hd, d), f"{b}.attn.out.bias": (d,),
            f"{b}.ln2.scale": (d,), f"{b}.ln2.bias": (d,),
            f"{b}.fc1.kernel": (d, f), f"{b}.fc1.bias": (f,),
            f"{b}.fc2.kernel": (f, d), f"{b}.fc2.bias": (d,),
        })
    shapes.update({"ln_final.scale": (d,), "ln_final.bias": (d,),
                   "head.kernel": (d, cfg.num_classes),
                   "head.bias": (cfg.num_classes,)})
    return shapes
