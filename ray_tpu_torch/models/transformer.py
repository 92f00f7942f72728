"""The flagship decoder-only LM (llama family), dense path, in PyTorch.

Counterpart of ``ray_tpu/models/transformer.py``. Parameters keep the flax
tree's key paths and shapes, so a state dict key reads as the flax path
without its ``params`` root (``layer_0.attn.q_proj.kernel`` is (d, H, hd),
``layer_0.attn.o_proj.kernel`` is (H, hd, d), ``lm_head`` is (d, V)), and a
JAX checkpoint converts by copying (``models/convert.py``).

As in the JAX model, weights are stored in ``param_dtype`` (fp32) and cast to
the compute ``dtype`` (bf16) in every forward; products of bf16 operands are
accumulated in fp32, and the logits are an fp32 product of the bf16-rounded
operands. Attention goes through ``ray_tpu_torch.ops.attention`` (the CUDA
flash kernels on the card, forward and backward), which takes K/V with their
own KV head count. With ``cfg.remat`` and grad enabled each block is
recomputed in the backward (``torch.utils.checkpoint``), as the JAX model's
``nn.remat(Block, policy=nothing_saveable)``.

Not ported yet (ROADMAP.md): ``MoEMLP`` (building a config with experts
raises).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops.attention import attention as attention_op
from ray_tpu_torch.utils import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 8
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 1408
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True
    attention_impl: str = "auto"  # auto | flash | xla
    n_experts: int = 0
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    moe_every: int = 1
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def num_params(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        attn = (
            d * d  # q
            + 2 * d * (self.n_kv_heads * self.head_dim)  # k, v
            + d * d  # o
            + 2 * d  # norms
        )
        dense_mlp = 3 * d * f
        total = 0
        for i in range(self.n_layers):
            moe = self.n_experts > 0 and i % max(self.moe_every, 1) == 0
            total += attn + (self.n_experts * 3 * d * f + d * self.n_experts
                             if moe else dense_mlp)
        return v * d + total + d + (0 if self.tie_embeddings else d * v)

    def active_params(self) -> int:
        """Params touched per token: MoE layers count only the
        experts_per_token experts a token is routed to."""
        if self.n_experts == 0:
            return self.num_params()
        d, f = self.d_model, self.d_ff
        total = self.num_params()
        for i in range(self.n_layers):
            if i % max(self.moe_every, 1) == 0:
                inactive = self.n_experts - self.experts_per_token
                total -= inactive * 3 * d * f
        return total

    def flops_per_token(self) -> float:
        """Approximate training FLOPs/token (fwd+bwd ~ 6*N_active +
        attention)."""
        return (6.0 * self.active_params()
                + 12.0 * self.n_layers * self.d_model * self.max_seq_len)


# preset configs (name -> config); "tiny" is the test config
CONFIGS = {
    "tiny": TransformerConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                              n_kv_heads=2, d_ff=128, max_seq_len=128, remat=False),
    "125m": TransformerConfig(vocab_size=32000, d_model=768, n_layers=12, n_heads=12,
                              n_kv_heads=12, d_ff=2048, max_seq_len=2048),
    "350m": TransformerConfig(vocab_size=32000, d_model=1024, n_layers=24, n_heads=16,
                              n_kv_heads=16, d_ff=2816, max_seq_len=2048),
    "1b": TransformerConfig(vocab_size=32000, d_model=2048, n_layers=16, n_heads=16,
                            n_kv_heads=8, d_ff=5632, max_seq_len=2048),
    "7b": TransformerConfig(vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
                            n_kv_heads=32, d_ff=11008, max_seq_len=4096),
    "moe-tiny": TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4,
        d_ff=128, max_seq_len=128, remat=False, n_experts=4,
        experts_per_token=2),
    "moe-1b": TransformerConfig(
        vocab_size=32000, d_model=1024, n_layers=16, n_heads=16, n_kv_heads=16,
        d_ff=2816, max_seq_len=2048, n_experts=8, experts_per_token=2,
        moe_every=2),
}


def check_dense(cfg: TransformerConfig) -> None:
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "MoEMLP is not ported yet (ROADMAP.md queue 1, item 'MoE'); "
            "only dense configs build")


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float
          ) -> torch.Tensor:
    """Rotary position embedding over the last dim (half-split pairs), with
    fp32 angles; x is (B, S, heads, D), positions (B, S)."""
    half = x.shape[-1] // 2
    exponent = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exponent)
    angles = positions[..., None].float() * freqs  # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, dtype, eps: float = 1e-6
             ) -> torch.Tensor:
    x32 = x.float()
    norm = x32 * torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (norm * scale).to(dtype)


class RMSNorm(nn.Module):
    """fp32 math, eps inside the rsqrt, output in the compute dtype."""

    def __init__(self, dim: int, dtype=torch.bfloat16, eps: float = 1e-6,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        return rms_norm(x, self.scale, self.dtype, self.eps)


class Dense(nn.Module):
    """A flax DenseGeneral kernel without bias: ``kernel`` keeps its flax
    shape; inputs contract over ``in_dims`` leading kernel dims."""

    def __init__(self, shape, in_dims: int, dtype, param_dtype, device=None):
        super().__init__()
        self.in_dims = in_dims
        self.dtype = dtype
        self.kernel = nn.Parameter(
            torch.empty(shape, dtype=param_dtype, device=device))

    def forward(self, x):
        w = self.kernel.to(self.dtype)
        n_in = math.prod(w.shape[:self.in_dims])
        lead = x.shape[:x.dim() - self.in_dims]
        y = x.reshape(-1, n_in) @ w.reshape(n_in, -1)
        return y.reshape(*lead, *w.shape[self.in_dims:])


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.head_dim
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        self.q_proj = Dense((d, cfg.n_heads, hd), 1, **kw)
        self.k_proj = Dense((d, cfg.n_kv_heads, hd), 1, **kw)
        self.v_proj = Dense((d, cfg.n_kv_heads, hd), 1, **kw)
        self.o_proj = Dense((cfg.n_heads, hd, d), 2, **kw)

    def forward(self, x, positions, segment_ids=None):
        cfg = self.cfg
        q = _rope(self.q_proj(x), positions, cfg.rope_theta)
        k = _rope(self.k_proj(x), positions, cfg.rope_theta)
        v = self.v_proj(x)
        out = attention_op(q, k, v, causal=True, impl=cfg.attention_impl,
                           segment_ids=segment_ids)
        return self.o_proj(out)


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        self.gate_proj = Dense((d, f), 1, **kw)
        self.up_proj = Dense((d, f), 1, **kw)
        self.down_proj = Dense((f, d), 1, **kw)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.dtype, device=device)
        self.attn = Attention(cfg, device=device)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.dtype, device=device)
        self.mlp = MLP(cfg, device=device)

    def forward(self, x, positions, segment_ids=None):
        h = x + self.attn(self.attn_norm(x), positions, segment_ids)
        return h + self.mlp(self.mlp_norm(h))


class Transformer(nn.Module):
    """Decoder-only LM. ``forward`` returns fp32 logits (B, S, V).

    ``params`` is a state dict keyed by flax paths (``convert.from_jax_params``
    or ``convert.init_params``); without it the weights are drawn from
    ``seed`` as the flax initialisers draw them."""

    def __init__(self, cfg: TransformerConfig, device: DeviceLike = None,
                 params: Optional[Mapping[str, Any]] = None, seed: int = 0):
        super().__init__()
        check_dense(cfg)
        from ray_tpu_torch.models.convert import init_params

        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(
            (cfg.vocab_size, cfg.d_model), dtype=cfg.param_dtype, device=dev))
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", Block(cfg, device=dev))
        self.final_norm = RMSNorm(cfg.d_model, cfg.dtype, device=dev)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(
                (cfg.d_model, cfg.vocab_size), dtype=cfg.param_dtype,
                device=dev))
        if params is None:
            params = init_params(cfg, seed=seed, device=dev)
        self.load_state_dict(
            {k: torch.as_tensor(v) for k, v in params.items()})

    def forward(self, tokens, positions=None, segment_ids=None):
        cfg = self.cfg
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
            positions = positions[None].expand(tokens.shape)
        x = self.embed.to(cfg.dtype)[tokens]
        remat = cfg.remat and torch.is_grad_enabled()
        for i in range(cfg.n_layers):
            block = getattr(self, f"layer_{i}")
            if remat:  # keep only the block's input; recompute the rest
                x = checkpoint(block, x, positions, segment_ids,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = block(x, positions, segment_ids)
        x = self.final_norm(x)
        if cfg.tie_embeddings:
            return (x @ self.embed.to(cfg.dtype).T).float()
        # fp32 product of the bf16 operands (preferred_element_type=f32)
        return x.float() @ self.lm_head.to(cfg.dtype).float()


def lm_loss(logits: torch.Tensor, targets: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross entropy; ``targets`` are the inputs shifted by one."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def state_dict_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    """Flax path (without the ``params`` root) -> shape, for a dense config."""
    check_dense(cfg)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    shapes = {"embed": (cfg.vocab_size, d)}
    for i in range(cfg.n_layers):
        p = f"layer_{i}"
        shapes.update({
            f"{p}.attn_norm.scale": (d,),
            f"{p}.attn.q_proj.kernel": (d, H, hd),
            f"{p}.attn.k_proj.kernel": (d, KVH, hd),
            f"{p}.attn.v_proj.kernel": (d, KVH, hd),
            f"{p}.attn.o_proj.kernel": (H, hd, d),
            f"{p}.mlp_norm.scale": (d,),
            f"{p}.mlp.gate_proj.kernel": (d, f),
            f"{p}.mlp.up_proj.kernel": (d, f),
            f"{p}.mlp.down_proj.kernel": (f, d),
        })
    shapes["final_norm.scale"] = (d,)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes
