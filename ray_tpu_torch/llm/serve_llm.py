"""Serve-LLM: ``LLMServer`` deployments and the OpenAI-style app builder,
the port of ``ray_tpu/llm/serve_llm.py`` (reference:
llm/_internal/serve/core/server/llm_server.py, build_openai_app).

Each replica owns one ``TorchLLMEngine``; requests are enqueued to the
engine and a single pump task drives ``engine.step()`` in a worker thread
while anything is unfinished, so concurrent requests batch continuously on
the card. ``update_weights`` pulls a version from the weight plane
(``weights.WeightStore``), builds new compute copies on the replica's
device off the event loop, and assigns ``engine.params`` on the loop: the
pump runs one step at a time on a worker thread and each step reads the
dict it started with, so the swap lands between steps and no tensor a
running step reads is written. Rolled out with
``handle.broadcast("update_weights", store_name)``: requests in flight
during the swap may see either weights; requests submitted after every
replica has acknowledged see only the new ones.

Prefix-aware routing (reference: routing_policies/prefix_aware/): the
``LLMHandle`` hashes a prompt prefix to prefer a consistent replica, which
keeps likely-shared KV prefixes on the same engine.
"""

from __future__ import annotations

import asyncio
import logging
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.llm.config import LLMConfig, SamplingParams
from ray_tpu_torch.serve import api as serve_api
from ray_tpu_torch.utils import DeviceLike

_log = logging.getLogger(__name__)


class LLMServer:
    """Deployment callable owning one engine (reference: llm_server.py);
    ``device`` defaults to the card. ``params`` may be the pickled blob
    that ``build_llm_deployment`` ships to a replica."""

    def __init__(self, config: LLMConfig, params: Any = None, seed: int = 0,
                 device: DeviceLike = None):
        from ray_tpu_torch.llm.engine import TorchLLMEngine

        if isinstance(params, bytes):
            # driver-authored params blob: deserialize only through the
            # audited serialization boundary
            from ray_tpu_torch._private.serialization import loads_trusted

            params = loads_trusted(params)
        self.config = config
        self.engine = TorchLLMEngine(config, params=params, seed=seed,
                                     device=device)
        self._futures: Dict[str, asyncio.Future] = {}
        self._pump_task: Optional[asyncio.Task] = None

    async def _pump(self):
        loop = asyncio.get_running_loop()
        try:
            while self.engine.has_unfinished():
                outputs = await loop.run_in_executor(None, self.engine.step)
                for out in outputs:
                    if out.finished and out.request_id in self._futures:
                        fut = self._futures.pop(out.request_id)
                        if not fut.done():
                            toks = [t for t in out.token_ids
                                    if t != self.engine.tokenizer.eos_token_id]
                            fut.set_result(
                                {"token_ids": out.token_ids,
                                 "text": self.engine.tokenizer.decode(toks),
                                 "finish_reason": out.finish_reason,
                                 "ttft_s": out.ttft_s})
                await asyncio.sleep(0)
        except Exception as e:
            # fail every pending request rather than hanging its caller; the
            # error reaches each of them, so the pump task ends cleanly
            _log.exception("engine step failed")
            for rid, fut in list(self._futures.items()):
                if not fut.done():
                    fut.set_exception(RuntimeError(f"engine step failed: {e}"))
                self.engine.abort_request(rid)
            self._futures.clear()
        finally:
            self._pump_task = None

    async def _submit(self, prompt: Any, params: SamplingParams) -> dict:
        rid = uuid.uuid4().hex
        fut = asyncio.get_running_loop().create_future()
        self._futures[rid] = fut
        self.engine.add_request(rid, prompt, params)
        if self._pump_task is None or self._pump_task.done():
            self._pump_task = asyncio.ensure_future(self._pump())
        return await fut

    async def completions(self, prompt: Any, *, max_tokens: int = 64,
                          temperature: float = 0.0, top_k: int = 0,
                          top_p: float = 1.0) -> dict:
        params = SamplingParams(max_tokens=max_tokens, temperature=temperature,
                                top_k=top_k, top_p=top_p)
        return await self._submit(prompt, params)

    async def chat(self, messages: List[dict], **kw) -> dict:
        prompt = "".join(
            f"<{m.get('role', 'user')}>{m.get('content', '')}" for m in messages
        ) + "<assistant>"
        return await self.completions(prompt, **kw)

    async def __call__(self, body: dict) -> dict:
        """OpenAI-ish JSON entry point (used by the HTTP proxy). Beside the
        JAX server's body, the answer carries ``usage`` (the completion's
        token count and the engine's time to its first token, ``ttft_s``)
        and, when the body sets ``return_token_ids`` (vLLM's spelling), the
        choice's ``token_ids``: the byte tokenizer's text drops ids past
        its range, so only the ids tell two answers apart token for
        token."""
        kw = {k: body[k] for k in ("max_tokens", "temperature", "top_k", "top_p")
              if k in body}
        if "messages" in body:
            out = await self.chat(body["messages"], **kw)
            choice = {"index": 0,
                      "message": {"role": "assistant", "content": out["text"]},
                      "finish_reason": out["finish_reason"]}
            kind = "chat.completion"
        else:
            out = await self.completions(body.get("prompt", ""), **kw)
            choice = {"index": 0, "text": out["text"],
                      "finish_reason": out["finish_reason"]}
            kind = "text_completion"
        if body.get("return_token_ids"):
            choice["token_ids"] = out["token_ids"]
        return {"id": uuid.uuid4().hex, "object": kind, "choices": [choice],
                "usage": {"completion_tokens": len(out["token_ids"]),
                          "ttft_s": out["ttft_s"]}}

    async def update_weights(self, store_name: str,
                             version: Optional[int] = None) -> dict:
        """Live weight update from the weight plane: pull ``version``
        (default: newest) from the named WeightStore, build the new compute
        copies on this replica's device off the event loop, and swap
        ``engine.params`` between steps. In-flight requests keep decoding:
        the swap is one attribute assignment on the event loop, while the
        pump's step (on a worker thread) reads the dict it started with.
        Returns the version and the seconds of the pull and of the
        copies."""
        import time

        loop = asyncio.get_running_loop()

        def _pull():
            from ray_tpu_torch.weights import WeightStore

            t0 = time.perf_counter()
            tree, ver = WeightStore(store_name, create=False).pull(
                version, return_version=True)
            t1 = time.perf_counter()
            fresh = self.engine.compute_params(tree)
            _sync(self.engine.device)
            return fresh, ver, t1 - t0, time.perf_counter() - t1

        fresh, ver, pull_s, copy_s = await loop.run_in_executor(None, _pull)
        self.engine.params = fresh
        return {"version": ver, "model_id": self.config.model_id,
                "pull_s": pull_s, "swap_s": copy_s}

    async def save_engine_state(self, path: str, *, step: int = 0) -> dict:
        """Checkpoint the engine params through the checkpoint plane
        (``ray_tpu_torch/ckpt``): ``path`` becomes a manifest + chunk store,
        so rolling saves across replicas dedup identical params to the same
        chunks. Runs off-loop — in-flight requests keep decoding."""
        loop = asyncio.get_running_loop()
        params = self.engine.params

        def _save():
            from ray_tpu_torch.llm.engine import save_params

            return save_params(params, path, step=step)

        manifest_path = await loop.run_in_executor(None, _save)
        return {"manifest": manifest_path, "model_id": self.config.model_id}

    async def load_engine_state(self, path: str) -> dict:
        """Swap engine params from a checkpoint-plane store (or legacy
        msgpack file); the copies are built off-loop and the swap is one
        attribute assignment between steps, like ``update_weights``."""
        loop = asyncio.get_running_loop()

        def _load():
            from ray_tpu_torch.llm.engine import _load_params

            fresh = self.engine.compute_params(_load_params(path))
            _sync(self.engine.device)
            return fresh

        self.engine.params = await loop.run_in_executor(None, _load)
        return {"model_id": self.config.model_id, "source": path}

    def engine_metrics(self) -> dict:
        return dict(self.engine.metrics)

    def memory_stats(self) -> Dict[str, int]:
        """This replica's device memory: allocated now and at its peak, in
        bytes (0 on the CPU)."""
        import torch

        dev = self.engine.device
        if dev.type != "cuda":
            return {"allocated_bytes": 0, "max_allocated_bytes": 0}
        return {"allocated_bytes": torch.cuda.memory_allocated(dev),
                "max_allocated_bytes": torch.cuda.max_memory_allocated(dev)}

    def kernel_launches(self, reset: bool = False) -> Dict[str, int]:
        """This process's launch count of each attention kernel wrapper
        (``ops.attention``), set to 0 after reading when ``reset``."""
        from ray_tpu_torch.ops.attention import launch_counts

        return launch_counts(reset)


def _sync(device) -> None:
    """Wait for the copies queued on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def build_llm_deployment(config: LLMConfig, params: Any = None,
                         name: Optional[str] = None, *,
                         device: DeviceLike = None
                         ) -> serve_api.Application:
    """Deployment app for one LLMConfig (reference: build_llm_deployment).
    ``params`` ships pickled to every replica; without it each replica
    loads ``config.checkpoint_path`` or draws random weights from seed 0.
    Each replica's engine runs on ``device`` (the card by default)."""
    opts = dict(config.ray_actor_options) or {"num_cpus": 1.0}
    params_blob = None
    if params is not None:
        from ray_tpu_torch._private.serialization import dumps

        params_blob = dumps(params)
    dep = serve_api.deployment(
        LLMServer, name=name or f"llm:{config.model_id}",
        num_replicas=config.num_replicas,
        max_ongoing_requests=config.engine_config.max_num_seqs * 2,
        ray_actor_options=opts)
    return dep.bind(config, params_blob, device=device)


def build_openai_app(configs: List[LLMConfig], params: Any = None, *,
                     device: DeviceLike = None
                     ) -> Dict[str, serve_api.DeploymentHandle]:
    """Deploy one LLMServer per config; returns name->handle (the HTTP proxy
    then serves POST /<name> with OpenAI-style bodies)."""
    handles = {}
    for cfg in configs:
        app = build_llm_deployment(cfg, params=params, device=device)
        handles[app.deployment.name] = serve_api.run(app)
    return handles


class LLMHandle:
    """Prefix-aware handle: same prompt prefix -> same replica when healthy,
    keeping likely-shared KV prefixes on one engine. Thin veneer over the
    first-class ``routing_policy="prefix"`` handle policy
    (``serve/autoscale/router.py`` — consistent-hash ring, so replica
    churn remaps only ~1/N of the prefix space; hit/miss counters land on
    ``ray_tpu.serve.prefix_cache_*``)."""

    def __init__(self, deployment_name: str, prefix_len: int = 64):
        self._inner = serve_api.DeploymentHandle(
            deployment_name, routing_policy="prefix")
        self._inner._router().prefix_len = prefix_len

    def remote(self, body: dict):
        return self._inner.remote(body)
