"""LLMServer: the async front end of one ``TorchLLMEngine``.

Counterpart of ``LLMServer`` in ``ray_tpu/llm/serve_llm.py`` (reference:
llm/_internal/serve/core/server/llm_server.py). Requests are enqueued to the
engine and a single pump task drives ``engine.step()`` in a worker thread
while anything is unfinished, so concurrent requests batch continuously on
the card. It is called directly here; the deployment builders
(``build_llm_deployment``, ``build_openai_app``), ``update_weights`` and the
engine-state save wait for the runtime, weights and checkpoint planes' port
(ROADMAP.md).
"""

from __future__ import annotations

import asyncio
import logging
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.llm.config import LLMConfig, SamplingParams
from ray_tpu_torch.utils import DeviceLike

_log = logging.getLogger(__name__)


class LLMServer:
    """Callable owning one engine; ``device`` defaults to the card."""

    def __init__(self, config: LLMConfig, params: Any = None, seed: int = 0,
                 device: DeviceLike = None):
        from ray_tpu_torch.llm.engine import TorchLLMEngine

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
        """OpenAI-ish JSON entry point."""
        kw = {k: body[k] for k in ("max_tokens", "temperature", "top_k", "top_p")
              if k in body}
        if "messages" in body:
            out = await self.chat(body["messages"], **kw)
            return {"id": uuid.uuid4().hex, "object": "chat.completion",
                    "choices": [{"index": 0,
                                 "message": {"role": "assistant",
                                             "content": out["text"]},
                                 "finish_reason": out["finish_reason"]}]}
        out = await self.completions(body.get("prompt", ""), **kw)
        return {"id": uuid.uuid4().hex, "object": "text_completion",
                "choices": [{"index": 0, "text": out["text"],
                             "finish_reason": out["finish_reason"]}]}

    def engine_metrics(self) -> dict:
        return dict(self.engine.metrics)
