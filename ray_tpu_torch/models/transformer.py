"""The flagship decoder-only LM (llama family), dense and MoE, in PyTorch.

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

A config with experts puts ``MoEMLP`` in every ``moe_every``-th block
(``layer_i.moe``). Its load-balancing loss is an output of the block, not
a side effect, so the recompute under remat cannot count it twice;
``Transformer(..., return_aux=True)`` gives it per layer, keyed like the
flax ``losses`` collection.

On a mesh (``parallel.TrainStepBundle``) each parameter holds this rank's
piece (``Transformer(..., pieces=...)``): modules read their weights through
``gather`` (``parallel/fsdp.py``, the whole leaf over the ``fsdp`` axis,
and the router's columns over ``expert``), and ``Attention``, ``MLP`` and
the embedding and lm_head run on this rank's heads, hidden columns and
vocabulary rows through ``tensor`` (``parallel/tensor_parallel.py``).
With ``seq`` (the mesh's seq group) the model holds a contiguous chunk of
every row: RoPE takes the tokens' global positions and ``Attention`` runs
ring attention over the group (``ops/ring_attention.py``), K and V repeated
to the query heads first, as the JAX model repeats them. ``MoEMLP`` runs
its experts and the global grouping through ``ep``
(``parallel/expert_parallel.py``). All are None without a mesh, and the
modules are then what they are on one device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops.attention import _repeat_kv
from ray_tpu_torch.ops.attention import attention as attention_op
from ray_tpu_torch.ops.ring_attention import ring_attention
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
            total += attn + (self.n_experts * 3 * d * f + d * self.n_experts
                             if uses_moe(self, i) else dense_mlp)
        return v * d + total + d + (0 if self.tie_embeddings else d * v)

    def active_params(self) -> int:
        """Params touched per token: MoE layers count only the
        experts_per_token experts a token is routed to."""
        if self.n_experts == 0:
            return self.num_params()
        d, f = self.d_model, self.d_ff
        total = self.num_params()
        for i in range(self.n_layers):
            if uses_moe(self, i):
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


def uses_moe(cfg: TransformerConfig, layer: int) -> bool:
    """Whether block ``layer`` holds ``MoEMLP`` rather than ``MLP``."""
    return cfg.n_experts > 0 and layer % max(cfg.moe_every, 1) == 0


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


def _param(module: nn.Module, name: str) -> torch.Tensor:
    """``module``'s parameter ``name``, whole: gathered over the mesh's fsdp
    axis where the module holds a piece of it (``module.gather``)."""
    p = getattr(module, name)
    return p if module.gather is None else module.gather(name, p)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, dtype, eps: float = 1e-6
             ) -> torch.Tensor:
    x32 = x.float()
    norm = x32 * torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (norm * scale).to(dtype)


class RMSNorm(nn.Module):
    """fp32 math, eps inside the rsqrt, output in the compute dtype."""

    gather = None

    def __init__(self, dim: int, dtype=torch.bfloat16, eps: float = 1e-6,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        return rms_norm(x, _param(self, "scale"), self.dtype, self.eps)


class Dense(nn.Module):
    """A flax DenseGeneral: ``kernel`` keeps its flax shape; inputs, in
    ``dtype``, contract over ``in_dims`` leading kernel dims. With
    ``use_bias`` the ``bias`` (the kernel's output dims) is added after the
    product, in ``dtype``, as flax adds it."""

    gather = None

    def __init__(self, shape, in_dims: int, dtype, param_dtype, device=None,
                 use_bias: bool = False):
        super().__init__()
        self.in_dims = in_dims
        self.dtype = dtype
        self.kernel = nn.Parameter(
            torch.empty(shape, dtype=param_dtype, device=device))
        self.bias = nn.Parameter(torch.empty(
            shape[in_dims:], dtype=param_dtype, device=device)) \
            if use_bias else None

    def forward(self, x):
        w = _param(self, "kernel").to(self.dtype)
        n_in = math.prod(w.shape[:self.in_dims])
        lead = x.shape[:x.dim() - self.in_dims]
        y = x.reshape(-1, n_in) @ w.reshape(n_in, -1)
        y = y.reshape(*lead, *w.shape[self.in_dims:])
        return (y if self.bias is None
                else y + _param(self, "bias").to(self.dtype))


class Attention(nn.Module):
    """GQA self-attention with RoPE. With a ``tensor`` axis the projections
    hold this rank's query and KV heads, and the output projection's
    partial product is summed over the axis. With a ``seq`` group ``x`` is
    this rank's chunk of each row and attention is the ring over the group
    (no ``segment_ids`` on more than one rank: the ring takes none)."""

    tensor = None
    seq = None

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.head_dim
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        self.q_proj = Dense((d, cfg.n_heads, hd), 1, **kw)
        self.k_proj = Dense((d, cfg.n_kv_heads, hd), 1, **kw)
        self.v_proj = Dense((d, cfg.n_kv_heads, hd), 1, **kw)
        self.o_proj = Dense((cfg.n_heads, hd, d), 2, **kw)

    def project(self, x, positions):
        """q, k, v of ``x`` at ``positions``, RoPE applied to q and k; k
        and v keep their KV heads."""
        theta = self.cfg.rope_theta
        return (_rope(self.q_proj(x), positions, theta),
                _rope(self.k_proj(x), positions, theta), self.v_proj(x))

    def forward(self, x, positions, segment_ids=None):
        cfg = self.cfg
        if self.tensor is not None:
            x = self.tensor.copy_to_region(x)
        q, k, v = self.project(x, positions)
        if self.seq is None or (segment_ids is not None
                                and self.seq.world_size == 1):
            out = attention_op(q, k, v, causal=True, impl=cfg.attention_impl,
                               segment_ids=segment_ids)
        elif segment_ids is not None:
            raise ValueError(
                f"segment_ids on a seq axis of {self.seq.world_size} ranks: "
                "ring attention takes no segments")
        else:
            heads = q.shape[2]
            out = ring_attention(q, _repeat_kv(k, heads), _repeat_kv(v, heads),
                                 self.seq, causal=True)
        out = self.o_proj(out)
        return out if self.tensor is None else \
            self.tensor.reduce_from_region(out)


class MLP(nn.Module):
    """SwiGLU. With a ``tensor`` axis, gate and up hold this rank's hidden
    columns and down its rows, whose partial product is summed over the
    axis."""

    tensor = None

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        self.gate_proj = Dense((d, f), 1, **kw)
        self.up_proj = Dense((d, f), 1, **kw)
        self.down_proj = Dense((f, d), 1, **kw)

    def forward(self, x):
        if self.tensor is not None:
            x = self.tensor.copy_to_region(x)
        out = self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))
        return out if self.tensor is None else \
            self.tensor.reduce_from_region(out)


class Routing(NamedTuple):
    """``MoEMLP.route``'s choice for (G, g) tokens: the router's fp32
    ``probs`` (G, g, E); per (token, k) slot the ``expert`` index, its
    ``gate`` (fp32, normalised over the K slots before any drop), its
    ``pos`` in that expert's capacity buffer of the group, and ``keep``
    (pos < C); and the capacity ``capacity`` (C)."""

    probs: torch.Tensor
    expert: torch.Tensor
    gate: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    capacity: int


class MoEMLP(nn.Module):
    """Top-K routed mixture-of-experts MLP with the JAX package's semantics
    (``ray_tpu/models/transformer.py:MoEMLP``): tokens are cut into G groups
    of g (the largest divisor of B*S up to ``GROUP_SIZE``); each expert
    takes at most C = max(1, int(capacity_factor * g * K / E)) slots of a
    group, filled in (token, k) order; a slot past C is dropped (its token
    keeps only the residual). ``forward`` returns ``(out, aux)``, aux the
    load-balancing loss E * sum_e f_e p_e.

    The JAX model dispatches and combines with one-hot einsums, which keep a
    TPU's matrix unit busy; here they are index operations with the same
    results. A buffer row of the (E, G*C, D) expert input holds one token
    (a token's K experts are distinct), so dispatch is a copy; a token's
    output sums its K kept slots, each expert output times bf16(gate), in
    fp32, rounded to the compute dtype. The expert FFN is three batched
    products over the stacked weights. Nothing syncs with the host.

    Built alone, it lies on the card unless ``device`` names another, with
    weights drawn from ``seed`` (``reset_parameters``)."""

    GROUP_SIZE = 4096  # tokens per dispatch group, as in the JAX model
    gather = None
    ep = None

    def __init__(self, cfg: TransformerConfig, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        # the meta device: a mesh's model, whose pieces are made afterwards
        meta = device is not None and torch.device(device).type == "meta"
        dev = torch.device("meta") if meta else resolve_device(device)
        self.cfg = cfg
        d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = Dense((d, E), 1, dtype=torch.float32,
                            param_dtype=torch.float32, device=dev)
        kw = dict(dtype=cfg.param_dtype, device=dev)
        self.gate_proj = nn.Parameter(torch.empty((E, d, f), **kw))
        self.up_proj = nn.Parameter(torch.empty((E, d, f), **kw))
        self.down_proj = nn.Parameter(torch.empty((E, f, d), **kw))
        if not meta:
            self.reset_parameters(seed)

    def reset_parameters(self, seed: int = 0) -> None:
        """The weights drawn from ``seed`` with the LM's laws
        (``convert.init_params``): the router normal(0.02), the expert
        stacks normal(0.02 / sqrt(2 L))."""
        from ray_tpu_torch.models.convert import _lm_law

        gen = torch.Generator(device=self.gate_proj.device).manual_seed(seed)
        with torch.no_grad():
            for key, w in self.named_parameters(prefix="moe"):
                _lm_law(self.cfg, key, w, gen)

    def group_size(self, n_tokens: int) -> int:
        return next(c for c in range(min(self.GROUP_SIZE, n_tokens), 0, -1)
                    if n_tokens % c == 0)

    def capacity(self, g: int) -> int:
        """C, the slots of one expert in a group of ``g`` tokens."""
        cfg = self.cfg
        return max(1, int(cfg.capacity_factor * g * cfg.experts_per_token
                          / cfg.n_experts))

    def choose(self, xf: torch.Tensor, expert: Optional[torch.Tensor] = None):
        """The router on tokens ``xf`` (..., D) in the compute dtype: its
        fp32 product, the softmax ``probs`` (..., E), the top-K ``expert``
        (..., K) (or the given one) and their ``gate`` normalised over the K
        slots."""
        K = self.cfg.experts_per_token
        probs = torch.softmax(self.router(xf.float()), dim=-1)
        if expert is None:
            expert = torch.topk(probs, K, dim=-1).indices
        gate = probs.gather(-1, expert)
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
        return probs, expert, gate

    def slot_positions(self, expert: torch.Tensor) -> torch.Tensor:
        """Each slot's position in its expert's buffer of its group, for the
        choices ``expert`` (G, g, K): the number of earlier slots of the
        group, in (token, k) order, that chose the same expert."""
        G, g, K = expert.shape
        E = self.cfg.n_experts
        # a running count along each expert's row of a (G, E, g*K)
        # indicator (the scan runs along the innermost dim), read at the
        # slot's own expert
        slots = expert.reshape(G, 1, g * K)
        chose = slots == torch.arange(E, device=expert.device)[:, None]
        pos = chose.int().cumsum(-1).gather(1, slots) - 1
        return pos.reshape(G, g, K)

    def route(self, xf: torch.Tensor,
              expert: Optional[torch.Tensor] = None) -> Routing:
        """The routing of ``xf`` (G, g, D) in the compute dtype: an fp32
        router product on it, softmax, top-K, and the capacity slots. A
        given ``expert`` (G, g, K) replaces the top-K choice (its gates are
        the probabilities at those experts), so that a routing can be
        replayed on another run's inputs."""
        C = self.capacity(xf.shape[1])
        probs, expert, gate = self.choose(xf, expert)
        pos = self.slot_positions(expert)
        return Routing(probs, expert, gate, pos, pos < C, C)

    def experts(self, x: torch.Tensor, dest: torch.Tensor,
                rows: int) -> torch.Tensor:
        """This module's experts on the slots of tokens ``x`` (N, D): slot
        (n, k) is copied into buffer row ``dest[n * K + k]`` of ``rows``
        (``rows`` itself: no row here) and the expert FFN runs on each
        expert's (rows / E_here) rows. Returns the (rows, D) output; a row
        no slot took stays zero through the FFN."""
        cfg = self.cfg
        N, D = x.shape
        K = cfg.experts_per_token
        w_gate, w_up, w_down = (_param(self, name).to(cfg.dtype) for name in (
            "gate_proj", "up_proj", "down_proj"))
        # dispatch: each slot's copy of its token into its row of a zeroed
        # buffer; its backward gathers the rows back and sums each token's
        # K slots, with no atomics
        x_slots = x.reshape(N, 1, D).expand(N, K, D).reshape(N * K, D)
        expert_in = x.new_zeros(rows + 1, D).index_copy(0, dest, x_slots)
        expert_in = expert_in[:rows].view(w_gate.shape[0], -1, D)
        # the experts: batched products over the stacked weights
        h = F.silu(torch.bmm(expert_in, w_gate)) * torch.bmm(expert_in, w_up)
        return torch.bmm(h, w_down).reshape(rows, D)

    def combine(self, expert_out: torch.Tensor, dest: torch.Tensor,
                gate: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        """Each token's output: its slots' expert outputs (rows ``dest`` of
        ``expert_out``; zero for a dropped slot) times bf16(gate * keep),
        summed over the K slots in fp32, in the compute dtype (N, D)."""
        cfg = self.cfg
        K, D = cfg.experts_per_token, expert_out.shape[1]
        out_pad = torch.cat([expert_out, expert_out.new_zeros(1, D)])
        picked = out_pad.index_select(0, dest).view(-1, K, D)
        weight = (gate * keep).to(cfg.dtype).reshape(-1, K, 1)
        return (picked.float() * weight.float()).sum(1).to(cfg.dtype)

    def forward(self, x):
        if self.ep is not None:
            return MoEMLP.forward_ranks([self], [x], self.ep)[0]
        cfg = self.cfg
        B, S, D = x.shape
        N, E = B * S, cfg.n_experts
        g = self.group_size(N)
        G = N // g
        r = self.route(x.reshape(G, g, D))
        C = r.capacity
        rows = E * G * C
        # each slot's row in the (E, G*C) buffer; a dropped slot's is the
        # spare row past the end
        group = torch.arange(G, device=x.device)[:, None, None]
        dest = r.expert * (G * C) + group * C + r.pos
        dest = torch.where(r.keep, dest, rows).reshape(-1)
        expert_out = self.experts(x.reshape(N, D), dest, rows)
        out = self.combine(expert_out, dest, r.gate, r.keep)
        # load balance: top-1 token share times mean router prob, per expert
        token_frac = F.one_hot(r.expert[..., 0], E).float().mean((0, 1))
        aux = E * (token_frac * r.probs.mean((0, 1))).sum()
        return out.reshape(B, S, D), aux

    @staticmethod
    def forward_ranks(layers, xs, axes) -> list:
        """``forward`` on a mesh, for the ranks this process runs: rank i's
        module ``layers[i]`` (its experts, E / ep of them, and its columns
        of their mlp dim; the router whole) on its tokens ``xs[i]`` (B_l,
        S_l, D), through the collectives of ``axes``
        (``parallel.expert_parallel``). The JAX layer's semantics on the
        global (B, S) token array: the groups, C and each slot's position
        from the global choices, aux from the global statistics. Returns
        each rank's ``(out, aux)``."""
        cfg, lead = layers[0].cfg, layers[0]
        E, K = cfg.n_experts, cfg.experts_per_token
        D = xs[0].shape[-1]
        chosen = [layer.choose(x) for layer, x in zip(layers, xs)]
        with torch.no_grad():
            experts = axes.gather_tokens([c[1] for c in chosen])
        B, S = experts[0].shape[:2]
        N = B * S
        g = lead.group_size(N)
        G, C = N // g, lead.capacity(g)
        stats = axes.sum_tokens([torch.cat([
            F.one_hot(expert[..., 0], E).float().sum((0, 1)),
            probs.sum((0, 1))]) for probs, expert, _ in chosen])
        x_in = axes.to_experts(xs)
        partial, slots = [], []
        for i, layer in enumerate(layers):
            _, expert, gate = chosen[i]
            with torch.no_grad():
                pos = lead.slot_positions(experts[i].reshape(G, g, K))
                pos = axes.local(i, pos.reshape(B, S, K))
                token = torch.arange(N, device=pos.device).reshape(B, S)
                group = axes.local(i, token)[..., None] // g
            keep = pos < C
            slot = expert * (G * C) + group * C + pos
            n_here = layer.gate_proj.shape[0]
            first = axes.expert_rank(i) * n_here * G * C
            here = keep & (slot >= first) & (slot < first + n_here * G * C)
            rows = n_here * G * C
            local = torch.where(here, slot - first, rows).reshape(-1)
            partial.append(layer.experts(x_in[i].reshape(-1, D), local, rows))
            slots.append((torch.where(keep, slot, E * G * C).reshape(-1),
                          gate, keep))
        whole = axes.from_experts(partial)
        out = []
        for i, layer in enumerate(layers):
            dest, gate, keep = slots[i]
            y = layer.combine(whole[i].reshape(-1, D), dest, gate, keep)
            frac, prob = (stats[i] / N).split(E)
            out.append((y.reshape(xs[i].shape), E * (frac * prob).sum()))
        return out


class Block(nn.Module):
    """Attention then the MLP (``MoEMLP`` when ``use_moe``), pre-norm with
    residuals. ``forward`` returns ``(x, aux)``: the MoE layer's loss, or
    None."""

    def __init__(self, cfg: TransformerConfig, use_moe: bool = False,
                 device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.dtype, device=device)
        self.attn = Attention(cfg, device=device)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.dtype, device=device)
        if use_moe:
            self.moe = MoEMLP(cfg, device=device)
        else:
            self.mlp = MLP(cfg, device=device)

    def forward(self, x, positions, segment_ids=None):
        h = x + self.attn(self.attn_norm(x), positions, segment_ids)
        if hasattr(self, "moe"):
            out, aux = self.moe(self.mlp_norm(h))
            return h + out, aux
        return h + self.mlp(self.mlp_norm(h)), None


class Transformer(nn.Module):
    """Decoder-only LM. ``forward`` returns fp32 logits (B, S, V), and with
    ``return_aux=True`` ``(logits, aux)``: each MoE layer's load-balancing
    loss keyed ``layer_<i>.moe.moe_aux`` (the path of the flax model's
    ``losses`` collection; empty for a dense config).

    ``params`` is a state dict keyed by flax paths (``convert.from_jax_params``
    or ``convert.init_params``); without it the weights are drawn from
    ``seed`` as the flax initialisers draw them.

    ``pieces`` (path -> shape, for a mesh's rank: ``parallel.mesh.
    piece_shape``) makes each parameter at the shape of this rank's piece,
    uninitialised; the train step fills them and sets ``gather``,
    ``tensor`` and ``vocab_start`` (the first vocabulary row of this rank's
    embedding and lm_head), and ``seq``. With a ``tensor`` axis the logits
    are this rank's columns of the vocabulary; with ``seq`` the tokens are
    this rank's chunk of each row, at positions offset by the rank's
    place on the seq axis."""

    gather = None
    tensor = None
    seq = None
    vocab_start = 0

    def __init__(self, cfg: TransformerConfig, device: DeviceLike = None,
                 params: Optional[Mapping[str, Any]] = None, seed: int = 0,
                 pieces: Optional[Mapping[str, tuple]] = None):
        super().__init__()
        from ray_tpu_torch.models.convert import init_params

        dev = resolve_device(device)
        build = dev if pieces is None else torch.device("meta")
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(
            (cfg.vocab_size, cfg.d_model), dtype=cfg.param_dtype,
            device=build))
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}",
                            Block(cfg, uses_moe(cfg, i), device=build))
        self.final_norm = RMSNorm(cfg.d_model, cfg.dtype, device=build)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(
                (cfg.d_model, cfg.vocab_size), dtype=cfg.param_dtype,
                device=build))
        if pieces is not None:
            for name, p in list(self.named_parameters()):
                owner, _, leaf = name.rpartition(".")
                setattr(self.get_submodule(owner), leaf, nn.Parameter(
                    torch.empty(pieces[name], dtype=p.dtype, device=dev)))
            return
        if params is None:
            params = init_params(cfg, seed=seed, device=dev)
        self.load_state_dict(
            {k: torch.as_tensor(v) for k, v in params.items()})

    def forward(self, tokens, positions=None, segment_ids=None,
                return_aux: bool = False):
        cfg = self.cfg
        if positions is None:
            S = tokens.shape[1]
            start = 0 if self.seq is None else self.seq.rank * S
            positions = torch.arange(start, start + S, device=tokens.device)
            positions = positions[None].expand(tokens.shape)
        embed = _param(self, "embed").to(cfg.dtype)
        x = (embed[tokens] if self.tensor is None
             else self.tensor.embedding(embed, tokens, self.vocab_start))
        remat = cfg.remat and torch.is_grad_enabled()
        aux = {}
        for i in range(cfg.n_layers):
            block = getattr(self, f"layer_{i}")
            if remat:  # keep only the block's input; recompute the rest
                x, layer_aux = checkpoint(
                    block, x, positions, segment_ids, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                x, layer_aux = block(x, positions, segment_ids)
            if layer_aux is not None:
                aux[f"layer_{i}.moe.moe_aux"] = layer_aux
        x = self.final_norm(x)
        if self.tensor is not None:
            x = self.tensor.copy_to_region(x)
        if cfg.tie_embeddings:
            logits = (x @ _param(self, "embed").to(cfg.dtype).T).float()
        else:
            # fp32 product of the bf16 operands (preferred_element_type=f32)
            logits = x.float() @ _param(self, "lm_head").to(cfg.dtype).float()
        return (logits, aux) if return_aux else logits


def lm_loss(logits: torch.Tensor, targets: torch.Tensor,
            mask: Optional[torch.Tensor] = None,
            count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross entropy; ``targets`` are the inputs shifted by one.
    ``count``, where given, is what the (masked) sum of the token losses is
    divided by in place of the mask's own sum: the data-parallel step
    passes the mask's sum over all ranks, so that each rank's loss is its
    share of the global mean."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return masked_mean(nll, mask, count)


def masked_mean(nll: torch.Tensor, mask: Optional[torch.Tensor] = None,
                count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``lm_loss`` from the token losses: their mean, or with ``mask`` their
    masked sum over the mask's sum (over ``count`` where given)."""
    if mask is None and count is None:
        return nll.mean()
    total = nll.sum() if mask is None else (nll * mask.float()).sum()
    if count is None:
        count = mask.float().sum()
    return total / torch.clamp(count, min=1.0)


def state_dict_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    """Flax path (without the ``params`` root) -> shape. A MoE layer's
    expert stacks are bare parameters (no ``.kernel``), as in flax."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    H, KVH, E = cfg.n_heads, cfg.n_kv_heads, cfg.n_experts
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
        })
        if uses_moe(cfg, i):
            shapes.update({
                f"{p}.moe.router.kernel": (d, E),
                f"{p}.moe.gate_proj": (E, d, f),
                f"{p}.moe.up_proj": (E, d, f),
                f"{p}.moe.down_proj": (E, f, d),
            })
        else:
            shapes.update({
                f"{p}.mlp.gate_proj.kernel": (d, f),
                f"{p}.mlp.up_proj.kernel": (d, f),
                f"{p}.mlp.down_proj.kernel": (f, d),
            })
    shapes["final_norm.scale"] = (d,)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes
