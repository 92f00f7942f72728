"""Continuous-batching PyTorch LLM engine on one CUDA card.

Counterpart of ``ray_tpu/llm/engine.py`` (``JaxLLMEngine`` becomes
``TorchLLMEngine``): a host-side scheduler over two forward passes of the
paged-KV model runner (prefill per shape bucket, one decode step):

- slots: ``max_num_seqs`` concurrent sequences, a fixed decode batch;
- pages: a free list of KV pages; sequences allocate pages on demand as they
  cross page boundaries (admission blocks when no pages are free);
- scheduling per ``step()``: admit waiting requests into free slots (batched
  bucketed prefill, whose attention runs the CUDA flash kernel), then run
  one decode step for all active slots; recompute preemption when pages run
  out.

Weights: a flax-path state dict (``models.convert``), or random weights from
``seed``. They are cast once, at load, into compute copies
(``model_runner.compute_params``); the JAX engine keeps fp32 params and
casts them in every step to the same values.

The engine is synchronous and single-threaded by design; ``serve_llm``'s
``LLMServer`` gives it an async front end. Loading and saving params through
the checkpoint plane wait for that plane's port (ROADMAP.md).
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.llm import model_runner
from ray_tpu_torch.llm.config import EngineConfig, LLMConfig, SamplingParams
from ray_tpu_torch.llm.tokenizer import get_tokenizer
from ray_tpu_torch.models.convert import check_params, init_params
from ray_tpu_torch.utils import DeviceLike, resolve_device


@dataclasses.dataclass
class _Request:
    request_id: str
    prompt_tokens: List[int]  # original prompt (never mutated)
    params: SamplingParams
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    pages: List[int] = dataclasses.field(default_factory=list)
    finished: bool = False
    finish_reason: Optional[str] = None
    arrival: float = dataclasses.field(default_factory=time.perf_counter)
    ttft_s: Optional[float] = None  # add_request to the first emitted token

    @property
    def cache_tokens(self) -> List[int]:
        """Tokens re-prefilled on (re)admission: prompt + anything already
        generated before a preemption (vLLM's recompute preemption, without
        dropping emitted tokens from the output)."""
        return self.prompt_tokens + self.generated


@dataclasses.dataclass
class RequestOutput:
    request_id: str
    token_ids: List[int]
    finished: bool
    finish_reason: Optional[str]
    text: Optional[str] = None
    ttft_s: Optional[float] = None


class TorchLLMEngine:
    """Synchronous continuous-batching engine over the paged-KV model runner.

    ``params``: a state dict keyed by flax paths (``models.convert``);
    ``None`` draws random weights from ``seed``. ``device`` defaults to the
    card and raises where there is none."""

    def __init__(self, config: LLMConfig, params: Any = None, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.config = config
        self.ecfg: EngineConfig = config.engine_config
        self.mcfg = config.transformer_config()
        if self.mcfg.n_experts > 0:
            raise NotImplementedError(
                f"TorchLLMEngine serves dense models only, as the JAX engine "
                f"does (its model runner reads each layer's dense mlp); "
                f"{config.model_id!r} has {self.mcfg.n_experts} experts")
        self.tokenizer = get_tokenizer(config.tokenizer)
        if config.checkpoint_path:
            raise NotImplementedError(
                "loading params from a checkpoint waits for the checkpoint "
                "plane's port (ROADMAP.md); pass params= instead")

        if params is None:
            params = init_params(self.mcfg, seed=seed, device=self.device)
        check_params(params, self.mcfg)
        self.params = model_runner.compute_params(params, self.mcfg,
                                                  self.device)
        del params

        e = self.ecfg
        self.cache = model_runner.init_cache(self.mcfg, e.num_pages,
                                             e.page_size, device=self.device)
        B, MP = e.max_num_seqs, e.pages_per_seq
        self._block_tables = np.zeros((B, MP), np.int64)
        self._seq_lens = np.zeros(B, np.int64)
        self._last_tokens = np.zeros(B, np.int64)
        self._active = np.zeros(B, bool)
        self._temps = np.zeros(B, np.float32)
        self._top_ks = np.zeros(B, np.int64)
        self._top_ps = np.ones(B, np.float32)
        self._seeds = np.full(B, -1, np.int64)  # -1 = engine-global stream
        self._slots: List[Optional[_Request]] = [None] * B
        self._free_pages = collections.deque(range(1, e.num_pages))
        self._waiting: collections.deque[_Request] = collections.deque()
        self._requests: Dict[str, _Request] = {}
        self._gen = torch.Generator().manual_seed(seed)
        # prefill_s / decode_s: host seconds of each phase of step(), up to
        # the sampled tokens on the host (which waits for the card)
        self.metrics = {"prefill_tokens": 0, "decode_steps": 0,
                        "generated_tokens": 0, "preempted": 0,
                        "prefill_calls": 0, "decode_tokens": 0,
                        "prefill_s": 0.0, "decode_s": 0.0}

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    # -- request lifecycle -------------------------------------------------

    def add_request(self, request_id: str, prompt: Any,
                    params: Optional[SamplingParams] = None) -> None:
        params = params or SamplingParams()
        if isinstance(prompt, str):
            tokens = self.tokenizer.encode(prompt)
        else:
            tokens = [int(t) for t in prompt]
        limit = self.ecfg.max_model_len - 1
        if len(tokens) > limit:
            tokens = tokens[-limit:]
        # reject requests the page pool can never satisfy (even alone) —
        # otherwise admission would livelock retrying forever
        final_len = min(self.ecfg.max_model_len,
                        len(tokens) + params.max_tokens)
        need_total = math.ceil(final_len / self.ecfg.page_size)
        if need_total > self.ecfg.num_pages - 1:
            raise ValueError(
                f"request needs {need_total} KV pages but the engine has "
                f"{self.ecfg.num_pages - 1}; raise num_pages or lower "
                f"max_tokens/prompt length")
        req = _Request(request_id, tokens, params)
        self._requests[request_id] = req
        self._waiting.append(req)

    def abort_request(self, request_id: str) -> None:
        req = self._requests.pop(request_id, None)
        if req is None:
            return
        if req.slot >= 0:
            self._release(req)
        else:
            try:
                self._waiting.remove(req)
            except ValueError:
                pass

    def has_unfinished(self) -> bool:
        return bool(self._waiting) or bool(self._active.any())

    # -- scheduling internals ----------------------------------------------

    def _release(self, req: _Request) -> None:
        self._free_pages.extend(req.pages)
        req.pages = []
        if req.slot >= 0:
            self._active[req.slot] = False
            self._slots[req.slot] = None
            self._seq_lens[req.slot] = 0
            self._block_tables[req.slot, :] = 0
            req.slot = -1

    def _set_sampling(self, slot: int, p: SamplingParams) -> None:
        self._temps[slot] = p.temperature
        self._top_ks[slot] = p.top_k
        self._top_ps[slot] = p.top_p
        self._seeds[slot] = -1 if p.seed is None else p.seed

    def _try_admit(self) -> List[_Request]:
        admitted = []
        free_slots = [i for i, s in enumerate(self._slots) if s is None]
        while self._waiting and free_slots:
            req = self._waiting[0]
            need = max(1, math.ceil(len(req.cache_tokens)
                                    / self.ecfg.page_size))
            if len(self._free_pages) < need:
                break
            self._waiting.popleft()
            req.slot = free_slots.pop(0)
            req.pages = [self._free_pages.popleft() for _ in range(need)]
            self._slots[req.slot] = req
            row = self._block_tables[req.slot]
            row[:] = 0
            row[:need] = req.pages
            self._seq_lens[req.slot] = len(req.cache_tokens)
            self._set_sampling(req.slot, req.params)
            admitted.append(req)
        return admitted

    def _prefill_bucket(self, n: int) -> int:
        b = self.ecfg.prefill_bucket_min
        while b < n:
            b *= 2
        return min(b, self.ecfg.max_model_len)

    def _ensure_page(self, req: _Request) -> bool:
        """Allocate the page for the next token position if needed."""
        pos = int(self._seq_lens[req.slot])
        need = pos // self.ecfg.page_size + 1
        if need <= len(req.pages):
            return True
        if not self._free_pages:
            return False
        page = self._free_pages.popleft()
        req.pages.append(page)
        self._block_tables[req.slot, need - 1] = page
        return True

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        steps = np.array(
            [len(s.generated) if s is not None else 0 for s in self._slots],
            np.int64)
        toks = model_runner.sample_tokens(
            logits, self._gen, torch.from_numpy(self._temps),
            torch.from_numpy(self._top_ks), torch.from_numpy(self._top_ps),
            torch.from_numpy(self._seeds), torch.from_numpy(steps),
            max_top_k=self.ecfg.max_top_k)
        return toks.cpu().numpy()

    def _prefill(self, admitted: List[_Request]) -> torch.Tensor:
        """The bucketed prefill of one admitted batch (full-B, padded):
        writes the batch's KV pages and returns its last-position logits."""
        e = self.ecfg
        B = e.max_num_seqs
        max_len = max(len(r.cache_tokens) for r in admitted)
        S = self._prefill_bucket(max_len)
        toks = np.zeros((B, S), np.int64)
        lens = np.zeros(B, np.int64)
        for r in admitted:
            full = r.cache_tokens
            toks[r.slot, :len(full)] = full
            lens[r.slot] = len(full)
        logits, self.cache = model_runner.prefill(
            self.params, self.mcfg, self.cache, self._dev(toks),
            self._dev(lens), self._dev(self._block_tables))
        self.metrics["prefill_tokens"] += int(lens.sum())
        self.metrics["prefill_calls"] += 1
        return logits

    # -- the step ----------------------------------------------------------

    def step(self, decode: bool = True) -> List[RequestOutput]:
        """One scheduling step. ``decode=False`` runs only the admit+prefill
        phase (the prefill side of prefill/decode disaggregation)."""
        outputs: List[RequestOutput] = []

        # 1) admit + batched prefill (one bucketed pass, full-B batch)
        admitted = self._try_admit()
        if admitted:
            t0 = time.perf_counter()
            toks_np = self._sample(self._prefill(admitted))
            self.metrics["prefill_s"] += time.perf_counter() - t0
            for r in admitted:
                self._active[r.slot] = True
                self._emit(r, int(toks_np[r.slot]), outputs)

        # 2) one decode step for all active slots
        if decode and self._active.any():
            t0 = time.perf_counter()
            # page-boundary allocation; preempt to waiting on exhaustion
            for req in [s for s in self._slots if s is not None]:
                if self._active[req.slot] and not self._ensure_page(req):
                    self.metrics["preempted"] += 1
                    self._requeue(req)
            if self._active.any():
                logits, self.cache = model_runner.decode_step(
                    self.params, self.mcfg, self.cache,
                    self._dev(self._last_tokens), self._dev(self._seq_lens),
                    self._dev(self._block_tables), self._dev(self._active))
                toks_np = self._sample(logits)
                self.metrics["decode_steps"] += 1
                for req in list(self._slots):
                    if req is not None and self._active[req.slot]:
                        self._seq_lens[req.slot] += 1
                        self.metrics["decode_tokens"] += 1
                        self._emit(req, int(toks_np[req.slot]), outputs)
            self.metrics["decode_s"] += time.perf_counter() - t0
        return outputs

    def _requeue(self, req: _Request) -> None:
        """Preempt a running request back to the waiting queue; its KV is
        recomputed from prompt+generated on re-admission (vLLM's recompute
        preemption). ``generated`` is kept so emitted tokens and the
        max_tokens budget survive preemption."""
        self._release(req)
        self._waiting.appendleft(req)

    def _emit(self, req: _Request, token: int, outputs: List[RequestOutput]):
        req.generated.append(token)
        if req.ttft_s is None:
            req.ttft_s = time.perf_counter() - req.arrival
        self._last_tokens[req.slot] = token
        self.metrics["generated_tokens"] += 1
        eos = self.tokenizer.eos_token_id
        total = len(req.prompt_tokens) + len(req.generated)
        if token == eos or token in req.params.stop_token_ids:
            req.finished, req.finish_reason = True, "stop"
        elif len(req.generated) >= req.params.max_tokens:
            req.finished, req.finish_reason = True, "length"
        elif total >= self.ecfg.max_model_len:
            req.finished, req.finish_reason = True, "length"
        if req.finished:
            self._release(req)
            self._requests.pop(req.request_id, None)
        outputs.append(RequestOutput(
            req.request_id, list(req.generated), req.finished,
            req.finish_reason, ttft_s=req.ttft_s))

    # -- PD disaggregation (KV page export / import) -----------------------
    # The paged layout makes a sequence's KV state a gather of its pages.

    def prefill_only(self, request_id: str, prompt: Any,
                     params: Optional[SamplingParams] = None,
                     max_steps: int = 1000) -> dict:
        """Prefill one request (emitting its first token) and export its KV
        state; the request is then released here — a decode engine imports
        the state and continues without re-prefilling."""
        self.add_request(request_id, prompt, params)
        req = self._requests[request_id]
        for _ in range(max_steps):
            self.step(decode=False)
            if req.finished or req.generated:
                break
        else:
            self.abort_request(request_id)
            raise RuntimeError(f"prefill of {request_id} did not get admitted")
        if req.finished:
            # done at prefill (e.g. max_tokens=1): no KV to hand off
            return {"request_id": request_id,
                    "prompt_tokens": list(req.prompt_tokens),
                    "generated": list(req.generated), "seq_len": 0,
                    "finished": True, "finish_reason": req.finish_reason,
                    "params": req.params}
        return self.export_kv(request_id)

    def export_kv(self, request_id: str) -> dict:
        """Gather a live request's KV pages + scheduling state, releasing
        the request locally. The pages come back as CPU tensors in the
        cache dtype, [L, n_pages, P, KVH, HD]."""
        req = self._requests.get(request_id)
        if req is None or req.slot < 0:
            raise KeyError(f"no live request {request_id}")
        pages = torch.tensor(req.pages, dtype=torch.long, device=self.device)
        state = {
            "request_id": req.request_id,
            "prompt_tokens": list(req.prompt_tokens),
            "generated": list(req.generated),
            "seq_len": int(self._seq_lens[req.slot]),
            "finished": req.finished,
            "finish_reason": req.finish_reason,
            "params": req.params,
            "ttft_s": req.ttft_s,
            "k": self.cache.k[:, pages].cpu(),
            "v": self.cache.v[:, pages].cpu(),
        }
        self.abort_request(request_id)
        return state

    def add_request_with_kv(self, state: dict) -> None:
        """Admit a prefilled request directly into a decode slot: allocate
        fresh pages, scatter the imported KV into them, and resume decoding
        at the imported position (no re-prefill)."""
        if state.get("finished"):
            # finished during prefill (e.g. max_tokens=1): nothing to decode
            raise ValueError("request already finished at prefill")
        free_slots = [i for i, s in enumerate(self._slots) if s is None]
        n_pages = state["k"].shape[1]
        if not free_slots or len(self._free_pages) < n_pages:
            raise RuntimeError("decode engine has no capacity; retry")
        req = _Request(state["request_id"], list(state["prompt_tokens"]),
                       state["params"])
        req.generated = list(state["generated"])
        req.ttft_s = state.get("ttft_s")
        req.slot = free_slots[0]
        req.pages = [self._free_pages.popleft() for _ in range(n_pages)]
        pages = torch.tensor(req.pages, dtype=torch.long, device=self.device)
        dtype = self.cache.k.dtype
        self.cache.k[:, pages] = torch.as_tensor(state["k"]).to(self.device,
                                                                dtype)
        self.cache.v[:, pages] = torch.as_tensor(state["v"]).to(self.device,
                                                                dtype)
        row = self._block_tables[req.slot]
        row[:] = 0
        row[:n_pages] = req.pages
        self._seq_lens[req.slot] = state["seq_len"]
        self._last_tokens[req.slot] = req.generated[-1]
        self._set_sampling(req.slot, req.params)
        self._slots[req.slot] = req
        self._active[req.slot] = True
        self._requests[req.request_id] = req

    # -- convenience -------------------------------------------------------

    def generate(self, prompts: List[Any],
                 params: Optional[SamplingParams] = None,
                 decode_text: bool = True) -> List[RequestOutput]:
        """Blocking batch generation; preserves input order."""
        ids = [f"gen-{i}-{time.monotonic_ns()}" for i in range(len(prompts))]
        for rid, prompt in zip(ids, prompts):
            self.add_request(rid, prompt, params)
        done: Dict[str, RequestOutput] = {}
        while self.has_unfinished():
            for out in self.step():
                if out.finished:
                    done[out.request_id] = out
        results = [done[rid] for rid in ids]
        if decode_text:
            for r in results:
                toks = [t for t in r.token_ids
                        if t != self.tokenizer.eos_token_id]
                r.text = self.tokenizer.decode(toks)
        return results
