"""Inference forward passes with a paged KV cache.

Counterpart of ``ray_tpu/llm/model_runner.py``. The cache geometry is the
same: KV lives in fixed-shape pages, sequences own pages through a block
table, and page 0 is scratch.

Layout:
- ``k``/``v``:      [n_layers, num_pages, page_size, n_kv_heads, hd]
- ``block_tables``: [max_num_seqs, pages_per_seq] int page ids
- page 0 is scratch: masked-out writes (padding, inactive slots) land there.

Differences from the JAX runner, none of which changes a value:
- ``params`` are the engine's compute copies (``compute_params``): the
  projection weights cast once to the compute dtype at load, the norm scales
  kept in fp32 and the lm_head kept as its compute-dtype values in fp32. The
  JAX runner casts its fp32 params inside every step to the same values.
- The cache is updated in place (``index_copy_``) where JAX donates it.
  Duplicate write indices all point at scratch page 0, where the order of
  the writes does not matter.
- Prefill hands K/V to the attention op with their own KV head count: the
  CUDA flash kernel reads KV head h // (H // KVH) for query head h, so the
  ``jnp.repeat`` of the JAX runner is gone.
- Sampling keeps its semantics but draws other random bits (``sample_tokens``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.models.transformer import TransformerConfig, _rope, rms_norm
from ray_tpu_torch.ops.attention import attention as attention_op
from ray_tpu_torch.utils import DeviceLike, resolve_device

_MASKED = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, NP, P, KVH, HD]
    v: torch.Tensor


def init_cache(cfg: TransformerConfig, num_pages: int, page_size: int,
               device: DeviceLike = None) -> KVCache:
    dev = resolve_device(device)
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   torch.zeros(shape, dtype=cfg.dtype, device=dev))


def compute_params(params: Mapping[str, Any], cfg: TransformerConfig,
                   device: torch.device) -> Dict[str, torch.Tensor]:
    """The engine's copies of a flax-path state dict: projections and the
    embedding in the compute dtype, norm scales in fp32, and the lm_head as
    its compute-dtype values held in fp32 (the logits are an fp32 product of
    bf16 operands)."""
    out = {}
    for key, val in params.items():
        t = torch.as_tensor(val).to(device)
        if key.endswith(".scale"):
            out[key] = t.float()
        elif key == "lm_head":
            out[key] = t.to(cfg.dtype).float()
        else:
            out[key] = t.to(cfg.dtype)
    return out


# ---------------------------------------------------------------------------
# shared layer math (mirrors models/transformer.py, reading its state dict)
# ---------------------------------------------------------------------------


def _rmsnorm(x, scale, eps=1e-6):
    return rms_norm(x, scale, x.dtype, eps)


def _mlp(x, p: Dict[str, torch.Tensor], i: int):
    pre = f"layer_{i}.mlp"
    gate = x @ p[f"{pre}.gate_proj.kernel"]
    up = x @ p[f"{pre}.up_proj.kernel"]
    return (F.silu(gate) * up) @ p[f"{pre}.down_proj.kernel"]


def _qkv(x, p: Dict[str, torch.Tensor], i: int, cfg: TransformerConfig,
         positions):
    pre = f"layer_{i}.attn"
    d, hd = cfg.d_model, cfg.head_dim
    lead = x.shape[:-1]
    q = (x @ p[f"{pre}.q_proj.kernel"].reshape(d, -1)).reshape(*lead, -1, hd)
    k = (x @ p[f"{pre}.k_proj.kernel"].reshape(d, -1)).reshape(*lead, -1, hd)
    v = (x @ p[f"{pre}.v_proj.kernel"].reshape(d, -1)).reshape(*lead, -1, hd)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    return q, k, v


def _o_proj(attn, p: Dict[str, torch.Tensor], i: int, cfg: TransformerConfig):
    w = p[f"layer_{i}.attn.o_proj.kernel"]
    return attn.reshape(*attn.shape[:-2], -1) @ w.reshape(-1, cfg.d_model)


def _scatter_kv(cache_layer: torch.Tensor, new: torch.Tensor,
                flat_idx: torch.Tensor) -> None:
    """Write new KV rows into the flat page view at flat_idx, in place.
    Every masked-out row is written to scratch page 0; duplicate indices
    occur only there."""
    NP, P, KVH, HD = cache_layer.shape
    flat = cache_layer.view(NP * P, KVH, HD)
    flat.index_copy_(0, flat_idx.reshape(-1), new.reshape(-1, KVH, HD))


def _logits(last, p: Dict[str, torch.Tensor], cfg: TransformerConfig):
    last = _rmsnorm(last, p["final_norm.scale"])
    if cfg.tie_embeddings:
        return (last @ p["embed"].T).float()
    return last.float() @ p["lm_head"]


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill(params: Dict[str, torch.Tensor], cfg: TransformerConfig,
            cache: KVCache, tokens: torch.Tensor, lengths: torch.Tensor,
            block_tables: torch.Tensor) -> Tuple[torch.Tensor, KVCache]:
    """Run the prompt forward, write KV pages, return last-position logits.

    tokens: [B, S] padded with PAD after ``lengths``; block_tables: [B, MP].
    Returns fp32 logits [B, vocab] at position lengths-1 and the cache
    (updated in place).
    """
    B, S = tokens.shape
    P = cache.k.shape[2]
    dev = tokens.device
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    in_prompt = positions < lengths[:, None]
    # padding tokens scatter to scratch page 0
    page_for = torch.gather(block_tables.long(), 1, positions // P)
    flat_idx = torch.where(in_prompt, page_for * P + positions % P, 0)

    x = params["embed"][tokens]
    for i in range(cfg.n_layers):
        h = _rmsnorm(x, params[f"layer_{i}.attn_norm.scale"])
        q, k, v = _qkv(h, params, i, cfg, positions)
        _scatter_kv(cache.k[i], k, flat_idx)
        _scatter_kv(cache.v[i], v, flat_idx)
        attn = attention_op(q, k, v, causal=True, impl=cfg.attention_impl)
        h2 = x + _o_proj(attn, params, i, cfg)
        x = h2 + _mlp(_rmsnorm(h2, params[f"layer_{i}.mlp_norm.scale"]),
                      params, i)

    # hidden at the last prompt position only -> [B, d]
    last_pos = torch.clamp(lengths.long() - 1, min=0)
    last = x[torch.arange(B, device=dev), last_pos]
    return _logits(last, params, cfg), cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


@torch.no_grad()
def decode_step(params: Dict[str, torch.Tensor], cfg: TransformerConfig,
                cache: KVCache, last_tokens: torch.Tensor,
                seq_lens: torch.Tensor, block_tables: torch.Tensor,
                active: torch.Tensor) -> Tuple[torch.Tensor, KVCache]:
    """One batched decode step over all slots: [B] tokens -> [B, vocab].

    Inactive slots compute garbage into scratch page 0. The new token's KV is
    written at position seq_lens before attention, so the mask is
    pos <= seq_lens. Grouped-query attention gathers each slot's pages and
    groups the query heads over their KV head, with no repeat.
    """
    B = last_tokens.shape[0]
    L, NP, P, KVH, HD = cache.k.shape
    MP = block_tables.shape[1]
    Lmax = MP * P
    G = cfg.n_heads // cfg.n_kv_heads
    dev = last_tokens.device
    bt = block_tables.long()
    seq_lens = seq_lens.long()

    positions = seq_lens[:, None]  # [B, 1]
    cur_page = torch.gather(bt, 1, positions // P)[:, 0]
    flat_write = torch.where(active, cur_page * P + seq_lens % P, 0)
    # gather view: every slot's pages flattened to [B, Lmax]
    gather_idx = (bt[:, :, None] * P
                  + torch.arange(P, device=dev)[None, None]).reshape(B, Lmax)
    kv_mask = (torch.arange(Lmax, device=dev)[None] <= seq_lens[:, None]) \
        & active[:, None]
    scale = 1.0 / math.sqrt(HD)

    x = params["embed"][last_tokens[:, None]]  # [B, 1, d]
    for i in range(cfg.n_layers):
        h = _rmsnorm(x, params[f"layer_{i}.attn_norm.scale"])
        q, k, v = _qkv(h, params, i, cfg, positions)  # q [B, 1, H, hd]
        _scatter_kv(cache.k[i], k, flat_write)
        _scatter_kv(cache.v[i], v, flat_write)
        k_all = cache.k[i].view(NP * P, KVH, HD)[gather_idx]  # [B, Lmax, KVH, HD]
        v_all = cache.v[i].view(NP * P, KVH, HD)[gather_idx]
        qg = q[:, 0].reshape(B, KVH, G, HD)
        # fp32 scores from the compute-dtype operands
        scores = torch.matmul(qg.float(), k_all.permute(0, 2, 3, 1).float())
        scores = scores * scale  # [B, KVH, G, Lmax]
        scores = scores.masked_fill(~kv_mask[:, None, None, :], _MASKED)
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        attn = torch.matmul(probs, v_all.permute(0, 2, 1, 3))  # [B,KVH,G,HD]
        attn = attn.reshape(B, 1, cfg.n_heads, HD)
        h2 = x + _o_proj(attn, params, i, cfg)
        x = h2 + _mlp(_rmsnorm(h2, params[f"layer_{i}.mlp_norm.scale"]),
                      params, i)

    return _logits(x[:, 0], params, cfg), cache


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    u = u.clamp(min=1e-20, max=1.0 - 1e-7)
    return -torch.log(-torch.log(u))


@torch.no_grad()
def sample_tokens(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temps: torch.Tensor, top_ks: torch.Tensor,
                  top_ps: torch.Tensor, seeds: torch.Tensor,
                  steps: torch.Tensor, max_top_k: int = 64) -> torch.Tensor:
    """Per-slot sampling: greedy when temp == 0, else temp/top-k/top-p over
    a static top-``max_top_k`` shortlist.

    ``seeds[b] >= 0`` gives that slot its own reproducible stream, keyed by
    (seed, step) and independent of batch composition; ``seeds[b] < 0``
    draws from ``generator`` (a CPU generator, the engine-global stream).
    The random bits are not JAX's: only greedy matches the JAX engine token
    for token. ``seeds`` and ``steps`` are read on the host."""
    B, V = logits.shape
    dev = logits.device
    greedy = torch.argmax(logits, dim=-1)
    temps = temps.to(dev)
    if not bool((temps > 0).any()):
        return greedy
    K = min(max_top_k, V)
    vals, idx = torch.topk(logits, K, dim=-1)  # [B, K] descending
    scaled = vals / torch.clamp(temps, min=1e-6)[:, None]
    ranks = torch.arange(K, device=dev)[None]
    top_ks = top_ks.to(dev)
    k_lim = torch.where(top_ks <= 0, K, torch.clamp(top_ks, max=K))[:, None]
    mask = ranks < k_lim
    probs = torch.softmax(torch.where(mask, scaled, _MASKED), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep tokens whose cumulative prob before them is < top_p
    mask = mask & ((cum - probs) < top_ps.to(dev)[:, None])
    final = torch.where(mask, scaled, _MASKED)

    u = torch.rand((B, K), generator=generator, dtype=torch.float32)
    for b, (seed, step) in enumerate(zip(seeds.tolist(), steps.tolist())):
        if seed >= 0:
            rng = np.random.default_rng([seed, step])
            u[b] = torch.from_numpy(rng.random(K, dtype=np.float32))
    sampled_pos = torch.argmax(final + _gumbel(u).to(dev), dim=-1)
    sampled = torch.gather(idx, 1, sampled_pos[:, None])[:, 0]
    return torch.where(temps <= 0, greedy, sampled)
