"""Model partitioning: the flagship transformer as S pipeline stages, the
port of ``ray_tpu/train/pipeline/partition.py``.

The cut is at block granularity and **name-preserving**: a stage module
re-creates exactly the parameters the full :class:`Transformer` owns under
the same top-level names (``embed``, ``layer_<i>``, ``final_norm``,
``lm_head``), so

- a stage's parameter dict is a key-subset of the full model's state dict
  (flax paths, ``layer_0.attn.q_proj.kernel``): :func:`split_params` /
  :func:`merge_params` are pure dict selection, a JAX stage tree converts by
  ``models/convert.py:from_jax_params``, and a pipeline checkpoint saved
  per stage can be re-partitioned onto a DIFFERENT stage count by reading
  only the leaves each new stage needs (no gather, no rewrite);
- :meth:`StagePrograms.init` with the full model's seed reproduces the full
  model's values for its slice (``convert.iter_init_params`` draws each
  leaf from its own path).

Backward runs as stage-granularity rematerialization: FWD stashes the
microbatch *input* only, BWD re-runs the forward under autograd from it —
the standard 1F1B memory trade (activation stash per stage is bounded by
the warmup depth, not the microbatch count; see schedule.py). Within that
recompute, ``cfg.remat`` checkpoints each block as the full model does.

MoE aux losses compose across the cut without shipping a scalar: stage
``s``'s backward takes cotangent ``moe_aux_coef`` on its own aux, and the
aux-sensitivity of *downstream* stages arrives folded into the incoming
activation gradient (the chain rule does the bookkeeping).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.models.transformer import (Block, RMSNorm,
                                              TransformerConfig, lm_loss,
                                              uses_moe)
from ray_tpu_torch.parallel.train import AdamW, OptState
from ray_tpu_torch.utils import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]


def partition_layers(n_layers: int, num_stages: int) -> List[Tuple[int, int]]:
    """Balanced contiguous [start, stop) layer ranges, earlier stages get
    the remainder (they also carry the embed table, but block cost
    dominates at depth)."""
    if not 1 <= num_stages <= n_layers:
        raise ValueError(
            f"cannot cut {n_layers} layers into {num_stages} stages")
    base, rem = divmod(n_layers, num_stages)
    out, start = [], 0
    for s in range(num_stages):
        stop = start + base + (1 if s < rem else 0)
        out.append((start, stop))
        start = stop
    return out


def stage_param_keys(cfg: TransformerConfig, stage: int, num_stages: int,
                     boundaries: Optional[List[Tuple[int, int]]] = None
                     ) -> List[str]:
    """The top-level parameter names stage ``stage`` owns."""
    bounds = boundaries or partition_layers(cfg.n_layers, num_stages)
    start, stop = bounds[stage]
    keys = [f"layer_{i}" for i in range(start, stop)]
    if stage == 0:
        keys.insert(0, "embed")
    if stage == num_stages - 1:
        keys.append("final_norm")
        if not cfg.tie_embeddings:
            keys.append("lm_head")
    return keys


def rank_chunk_keys(cfg: TransformerConfig, rank: int, num_stages: int,
                    num_chunks: int = 1,
                    boundaries: Optional[List[Tuple[int, int]]] = None
                    ) -> Dict[int, List[str]]:
    """Top-level names per model chunk for one pipeline rank hosting
    ``num_chunks`` interleaved chunks (Megatron-style virtual stages).

    Chunk ``v`` on rank ``r`` is virtual stage ``q = v*num_stages + r``
    of the ``num_stages*num_chunks``-way cut. Returns ``{q: [keys...]}``
    in local chunk order (ascending ``v``); the union across all ranks
    partitions the full key set."""
    num_virtual = num_stages * num_chunks
    return {v * num_stages + rank:
            stage_param_keys(cfg, v * num_stages + rank, num_virtual,
                             boundaries)
            for v in range(num_chunks)}


def top_key(path: str) -> str:
    """The top-level name of a state-dict path (``layer_0.attn...`` ->
    ``layer_0``)."""
    return path.split(".", 1)[0]


def select_keys(params: Mapping[str, Any], keys) -> Dict[str, Any]:
    """The entries of ``params`` (a flat state dict) under the top-level
    names ``keys``, in ``params``' order."""
    keys = set(keys)
    return {k: v for k, v in params.items() if top_key(k) in keys}


def split_params(full_params: Mapping[str, Any], cfg: TransformerConfig,
                 num_stages: int,
                 boundaries: Optional[List[Tuple[int, int]]] = None
                 ) -> List[Dict[str, Any]]:
    """Cut a full model state dict into per-stage dicts (pure key
    selection — values are shared, not copied)."""
    return [select_keys(full_params,
                        stage_param_keys(cfg, s, num_stages, boundaries))
            for s in range(num_stages)]


def merge_params(stage_params: List[Mapping[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for p in stage_params:
        out.update(p)
    return out


class StageModule(nn.Module):
    """Layers [start, stop) of the flagship transformer, plus the embed
    table (first stage) / final norm + LM head (last stage). Absolute layer
    names keep the parameter paths identical to the full model's.

    ``forward(x)`` gives ``(y, aux)``: the stage's output (the activation,
    or on the last stage the fp32 logits) and the sum of its MoE layers'
    load-balancing losses (an fp32 zero for a dense stage)."""

    def __init__(self, cfg: TransformerConfig, start: int, stop: int,
                 first: bool, last: bool, device=None):
        super().__init__()
        self.cfg, self.start, self.stop = cfg, start, stop
        self.first, self.last = first, last
        if first:
            self.embed = nn.Parameter(torch.empty(
                (cfg.vocab_size, cfg.d_model), dtype=cfg.param_dtype,
                device=device))
        for i in range(start, stop):
            self.add_module(f"layer_{i}",
                            Block(cfg, uses_moe(cfg, i), device=device))
        if last:
            self.final_norm = RMSNorm(cfg.d_model, cfg.dtype, device=device)
            if not cfg.tie_embeddings:
                self.lm_head = nn.Parameter(torch.empty(
                    (cfg.d_model, cfg.vocab_size), dtype=cfg.param_dtype,
                    device=device))

    def forward(self, x):
        cfg = self.cfg
        if self.first:
            x = self.embed.to(cfg.dtype)[x]
        positions = torch.arange(x.shape[1], device=x.device)
        positions = positions[None].expand(x.shape[:2])
        remat = cfg.remat and torch.is_grad_enabled()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(self.start, self.stop):
            block = getattr(self, f"layer_{i}")
            if remat:  # keep only the block's input; recompute the rest
                x, layer_aux = checkpoint(
                    block, x, positions, None, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                x, layer_aux = block(x, positions)
            if layer_aux is not None:
                aux = aux + layer_aux
        if not self.last:
            return x, aux
        x = self.final_norm(x)
        if cfg.tie_embeddings:
            # only reachable single-stage (StagePrograms rejects tied heads
            # for S > 1), so ``embed`` is here
            logits = (x @ self.embed.to(cfg.dtype).T).float()
        else:
            # fp32 product of the bf16 operands, as the full model's head
            logits = x.float() @ self.lm_head.to(cfg.dtype).float()
        return logits, aux


class StagePrograms:
    """The programs one pipeline stage runs, on ``device`` (the card unless
    given), over the stage module's own parameters (``params``: a flat
    state dict; a dict of other tensors is copied into them first).

    - first/middle stage: ``fwd(params, x) -> (y, aux)`` (no autograd) and
      ``bwd(params, x, dy) -> dparams`` (first: tokens take no gradient)
      or ``-> (dparams, dx)`` (middle), which recompute the forward from
      the stashed input with cotangent ``moe_aux_coef`` on aux;
    - last stage: ``bwd(params, x, targets, mask) -> (loss, aux, dparams,
      dx)`` — one forward and backward yield the step's loss AND grads (its
      FWD op only stashes the input; 1F1B runs F and B back to back on the
      last stage, so a separate forward would double its compute).
      ``fwd_loss`` stays as the eval entry;
    - every stage: ``acc_grads`` (microbatch accumulation, in place),
      ``grad_sqnorm`` (for the controller's coordinated global-norm clip)
      and ``opt_apply(grads, scale, opt_state, params)`` (the optimizer on
      ``params`` in place, the grads scaled by ``scale`` first).
    """

    def __init__(self, cfg: TransformerConfig, stage: int, num_stages: int,
                 optimizer: AdamW,
                 boundaries: Optional[List[Tuple[int, int]]] = None,
                 device: DeviceLike = None):
        if cfg.tie_embeddings and num_stages > 1:
            raise ValueError(
                "tie_embeddings shares the embed table between the first "
                "and last stage; pipeline partitioning needs untied heads")
        self.cfg = cfg
        self.stage = stage
        self.num_stages = num_stages
        self.first = stage == 0
        self.last = stage == num_stages - 1
        self.device = resolve_device(device)
        bounds = boundaries or partition_layers(cfg.n_layers, num_stages)
        self.start, self.stop = bounds[stage]
        self.module = StageModule(cfg, self.start, self.stop, self.first,
                                  self.last, device=self.device)
        self.params: Params = dict(self.module.named_parameters())
        self.optimizer = optimizer
        self.coef = float(cfg.moe_aux_coef)
        if self.last:
            self.bwd = self._bwd_last
        elif self.first:
            self.bwd = self._bwd_first
        else:
            self.bwd = self._bwd_mid

    # -- parameters -----------------------------------------------------

    def init(self, seed: int = 0) -> Params:
        """The full model's initial values (``convert.iter_init_params`` at
        ``seed``) for this stage's leaves, written into the module."""
        from ray_tpu_torch.models.convert import iter_init_params

        with torch.no_grad():
            for key, whole in iter_init_params(self.cfg, seed, self.device):
                if key in self.params:
                    self.params[key].copy_(whole)
        return self.params

    def bind(self, params: Mapping[str, Any]) -> Params:
        """The module's own parameters, holding ``params``' values (copied
        in unless they already are the module's tensors)."""
        own = self.params
        if set(params) != set(own):
            raise ValueError(
                f"stage {self.stage}: params hold {sorted(params)[:4]}..., "
                f"the stage owns {sorted(own)[:4]}...")
        if any(params[k] is not p for k, p in own.items()):
            with torch.no_grad():
                for k, p in own.items():
                    p.copy_(torch.as_tensor(params[k]))
        return own

    def _tensor(self, x: Any) -> torch.Tensor:
        """An input (tokens as numpy or a tensor, an activation or gradient
        from a channel) on this stage's device. A read-only array (an
        object-store value) is copied: torch takes no read-only memory."""
        if isinstance(x, np.ndarray) and not x.flags.writeable:
            x = x.copy()
        return torch.as_tensor(x).to(self.device)

    # -- forward and backward ---------------------------------------------

    def fwd(self, params: Mapping[str, Any], x: Any):
        self.bind(params)
        with torch.no_grad():
            return self.module(self._tensor(x))

    def fwd_loss(self, params: Mapping[str, Any], x: Any, targets: Any,
                 mask: Any):
        self.bind(params)
        with torch.no_grad():
            logits, aux = self.module(self._tensor(x))
            loss = lm_loss(logits, self._tensor(targets), self._tensor(mask))
            return loss + self.coef * aux, aux

    def _grads(self, outputs, inputs, grad_outputs=None):
        grads = torch.autograd.grad(outputs, inputs, grad_outputs,
                                    allow_unused=True)
        return [torch.zeros_like(x) if g is None else g
                for x, g in zip(inputs, grads)]

    def _cotangents(self, y, aux, dy):
        """The outputs of a first or middle stage's forward and their
        cotangents: dy on the activation, ``moe_aux_coef`` on aux."""
        outs, cots = [y], [self._tensor(dy).to(y.dtype)]
        if aux.requires_grad:
            outs.append(aux)
            cots.append(torch.tensor(self.coef, dtype=aux.dtype,
                                     device=aux.device))
        return outs, cots

    def _bwd_first(self, params: Mapping[str, Any], tokens: Any, dy: Any
                   ) -> Params:
        own = self.bind(params)
        with torch.enable_grad():
            y, aux = self.module(self._tensor(tokens))
            outs, cots = self._cotangents(y, aux, dy)
            grads = self._grads(outs, list(own.values()), cots)
        return dict(zip(own, grads))

    def _bwd_mid(self, params: Mapping[str, Any], x: Any, dy: Any):
        own = self.bind(params)
        with torch.enable_grad():
            xi = self._tensor(x).detach().requires_grad_(True)
            y, aux = self.module(xi)
            outs, cots = self._cotangents(y, aux, dy)
            grads = self._grads(outs, list(own.values()) + [xi], cots)
        return dict(zip(own, grads[:-1])), grads[-1]

    def _bwd_last(self, params: Mapping[str, Any], x: Any, targets: Any,
                  mask: Any):
        own = self.bind(params)
        with torch.enable_grad():
            if self.first:  # single-stage pipeline: x is int tokens
                xi = self._tensor(x)
                inputs = list(own.values())
            else:
                xi = self._tensor(x).detach().requires_grad_(True)
                inputs = list(own.values()) + [xi]
            logits, aux = self.module(xi)
            loss = lm_loss(logits, self._tensor(targets),
                           self._tensor(mask)) + self.coef * aux
            grads = self._grads(loss, inputs)
        dparams = dict(zip(own, grads))
        dx = None if self.first else grads[-1]
        return loss.detach(), aux.detach(), dparams, dx

    # -- the step boundary ------------------------------------------------

    @staticmethod
    def acc_grads(acc: Params, g: Params) -> Params:
        """``acc += g``, leaf by leaf, in place."""
        torch._foreach_add_(list(acc.values()), [g[k] for k in acc])
        return acc

    @staticmethod
    def grad_sqnorm(g: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The fp32 sum of squares over every leaf, leaf sums added in
        order."""
        total = None
        for a in g.values():
            s = torch.sum(torch.square(a.float()))
            total = s if total is None else total + s
        return total

    def opt_apply(self, grads: Mapping[str, torch.Tensor], scale: float,
                  opt_state: OptState, params: Mapping[str, torch.Tensor]):
        """The optimizer on ``params`` (tensors, updated in place) with the
        grads scaled by ``scale`` (1/M and the coordinated clip) in fp32,
        rounded back to each grad's dtype."""
        g = [(grads[k].float() * scale).to(grads[k].dtype) for k in params]
        self.optimizer.update(params, g, opt_state)
        return params, opt_state

    def opt_init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        return self.optimizer.init(params)


def make_stage_optimizer(learning_rate: float = 3e-4,
                         weight_decay: float = 0.1,
                         warmup_steps: int = 100,
                         total_steps: int = 10000,
                         b1: float = 0.9, b2: float = 0.95) -> AdamW:
    """Per-stage optimizer matching ``parallel.train.make_optimizer``
    MINUS the global-norm clip: clipping needs the global norm across
    stages, which the pipeline controller coordinates (local sqnorms ->
    one scale for everyone) before ``opt_apply``."""
    return AdamW(learning_rate, weight_decay, warmup_steps, total_steps, b1,
                 b2, clip=None)
