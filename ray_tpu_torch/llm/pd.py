"""LLM serving patterns: prefill/decode disaggregation + data-parallel, the
port of ``ray_tpu/llm/pd.py``.

Reference: llm/_internal/serve/serving_patterns/prefill_decode/pd_server.py:31
(prefill replicas hand KV state to decode replicas through a KV-transfer
connector) and serving_patterns/data_parallel/{dp_server.py:14,
dp_rank_assigner.py} (engine replicas coordinate ranks, the router spreads
load across them).

The engine's paged KV layout makes a sequence's KV state a gather of pages
(``engine.export_kv`` / ``add_request_with_kv``). The prefill worker keeps
that gather on its card behind a device-object marker
(``experimental/device_objects.py``); the decode worker pulls it from the
prefill worker directly, through the host, and the router never touches
the KV bytes. The workers' engines run on ``device`` (the card by
default); on one card, give each worker a share of it
(``ray_actor_options={"num_gpus": 0.5}``). ``PDServer`` and the rank
assigner take no ``GPU`` lease and never touch CUDA: this module loads
neither torch nor an engine until a worker builds one.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import TYPE_CHECKING, Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.llm.config import LLMConfig, SamplingParams
from ray_tpu_torch.serve import api as serve_api

if TYPE_CHECKING:
    from ray_tpu_torch.utils import DeviceLike


def _load_params_blob(params_blob):
    if params_blob is None:
        return None
    # driver-authored params blob: decode only through the audited
    # serialization boundary
    from ray_tpu_torch._private.serialization import loads_trusted

    return loads_trusted(params_blob)


def _dump_params(params) -> Optional[bytes]:
    if params is None:
        return None
    from ray_tpu_torch._private.serialization import dumps

    return dumps(params)


class _EngineWorker:
    """What both PD workers share: one engine on ``device`` and its
    counters."""

    def __init__(self, config: LLMConfig, params_blob: Optional[bytes] = None,
                 device: "DeviceLike" = None):
        from ray_tpu_torch.llm.engine import TorchLLMEngine

        self.engine = TorchLLMEngine(config, params=_load_params_blob(
            params_blob), device=device)

    def metrics(self) -> dict:
        return dict(self.engine.metrics)

    def memory_stats(self) -> Dict[str, int]:
        """This worker's device memory now and at its peak, in bytes (0 on
        the CPU)."""
        import torch

        dev = self.engine.device
        if dev.type != "cuda":
            return {"allocated_bytes": 0, "max_allocated_bytes": 0}
        return {"allocated_bytes": torch.cuda.memory_allocated(dev),
                "max_allocated_bytes": torch.cuda.max_memory_allocated(dev)}

    def kernel_launches(self, reset: bool = False) -> Dict[str, int]:
        """This process's launch count of each attention kernel wrapper,
        set to 0 after reading when ``reset``."""
        from ray_tpu_torch.ops.attention import launch_counts

        return launch_counts(reset)


class PrefillWorker(_EngineWorker):
    """Actor owning a prefill-only engine (reference: the P side of
    pd_server.py). Prompts run the batched prefill program; the KV state
    leaves immediately, so this engine never decodes and its page pool
    turns over at prompt-ingest rate."""

    @ray_tpu_torch.method(tensor_transport="device")
    def prefill(self, prompt: Any, params: Optional[SamplingParams] = None) -> dict:
        # tensor_transport="device": the KV state STAYS in this worker, on
        # its card; the reply is a small marker, and the decode worker
        # pulls the state directly from here (the router never touches
        # the KV bytes; reference: the KV-transfer connectors of
        # pd_server.py)
        rid = uuid.uuid4().hex
        return self.engine.prefill_only(rid, prompt, params)


class DecodeWorker(_EngineWorker):
    """Actor owning a decode engine: imports prefilled KV and runs the
    completion (reference: the D side of pd_server.py)."""

    def decode(self, state: dict) -> dict:
        eng = self.engine
        rid = state["request_id"]
        if state.get("finished"):
            token_ids = list(state["generated"])
            reason = state.get("finish_reason")
        else:
            eng.add_request_with_kv(state)
            token_ids, reason = list(state["generated"]), None
            while True:
                done = None
                for out in eng.step():
                    if out.request_id == rid and out.finished:
                        done = out
                if done is not None:
                    token_ids, reason = done.token_ids, done.finish_reason
                    break
        toks = [t for t in token_ids if t != eng.tokenizer.eos_token_id]
        return {"token_ids": token_ids, "text": eng.tokenizer.decode(toks),
                "finish_reason": reason, "ttft_s": state.get("ttft_s")}

    def kv_pulls(self, reset: bool = False) -> dict:
        """This worker's pulls of KV state from prefill workers: count,
        bytes and seconds (``device_objects.pull_stats``)."""
        from ray_tpu_torch.experimental.device_objects import pull_stats

        return pull_stats(reset)


class PDServer:
    """Deployment callable routing each completion prefill -> decode
    (reference: pd_server.py's PDProxyServer). ``actor_options`` are the
    workers'; ``device`` is where their engines run."""

    def __init__(self, config: LLMConfig, params_blob: Optional[bytes] = None,
                 num_prefill: int = 1, num_decode: int = 1,
                 actor_options: Optional[dict] = None,
                 device: "DeviceLike" = None):
        opts = actor_options or {"num_cpus": 0.5}
        prefill_cls = ray_tpu_torch.remote(**opts)(PrefillWorker)
        decode_cls = ray_tpu_torch.remote(**opts)(DecodeWorker)
        self.prefill_workers = [prefill_cls.remote(config, params_blob,
                                                   device=device)
                                for _ in range(num_prefill)]
        self.decode_workers = [decode_cls.remote(config, params_blob,
                                                 device=device)
                               for _ in range(num_decode)]
        self._rr = 0

    def _pick(self, group: List[Any]):
        self._rr += 1
        return group[self._rr % len(group)]

    def workers(self) -> Dict[str, list]:
        """The worker actors' handles, by role."""
        return {"prefill": list(self.prefill_workers),
                "decode": list(self.decode_workers)}

    async def completions(self, prompt: str, *, max_tokens: int = 64,
                          temperature: float = 0.0, top_k: int = 0,
                          top_p: float = 1.0) -> dict:
        params = SamplingParams(max_tokens=max_tokens, temperature=temperature,
                                top_k=top_k, top_p=top_p)
        # hand the REF (not the value) to decode: the KV goes prefill
        # worker -> decode worker, never through this router
        state_ref = self._pick(self.prefill_workers).prefill.remote(
            prompt, params)
        return await self._pick(self.decode_workers).decode.remote(state_ref)

    async def __call__(self, body: dict) -> dict:
        """OpenAI-ish JSON entry point. As the port's ``LLMServer``, the
        answer also carries ``usage`` (the completion's token count and the
        prefill engine's time to its first token) and, when the body sets
        ``return_token_ids``, the choice's ``token_ids``."""
        kw = {k: body[k] for k in ("max_tokens", "temperature", "top_k", "top_p")
              if k in body}
        out = await self.completions(body.get("prompt", ""), **kw)
        choice = {"index": 0, "text": out["text"],
                  "finish_reason": out["finish_reason"]}
        if body.get("return_token_ids"):
            choice["token_ids"] = out["token_ids"]
        return {"id": uuid.uuid4().hex, "object": "text_completion",
                "choices": [choice],
                "usage": {"completion_tokens": len(out["token_ids"]),
                          "ttft_s": out["ttft_s"]}}


def _server_options(worker_opts: dict) -> dict:
    """The router's actor options: the workers' without their card share
    (the router holds no engine)."""
    return {k: v for k, v in worker_opts.items() if k != "num_gpus"} or {
        "num_cpus": 0.5}


def build_pd_openai_app(config: LLMConfig, params: Any = None,
                        num_prefill: int = 1, num_decode: int = 1, *,
                        device: "DeviceLike" = None
                        ) -> serve_api.DeploymentHandle:
    """Deploy the PD pattern; returns the handle serving OpenAI-ish bodies.
    ``config.ray_actor_options`` are each worker's (``num_gpus`` there is a
    worker's share of a card); the router takes the same without the
    card."""
    worker_opts = dict(config.ray_actor_options) or {"num_cpus": 0.5}
    dep = serve_api.deployment(
        PDServer, name=f"llm-pd:{config.model_id}", num_replicas=1,
        max_ongoing_requests=config.engine_config.max_num_seqs * 2,
        ray_actor_options=_server_options(worker_opts))
    return serve_api.run(dep.bind(config, _dump_params(params), num_prefill,
                                  num_decode, worker_opts, device=device))


# ---------------------------------------------------------------------------
# data-parallel serving
# ---------------------------------------------------------------------------


class DPRankAssigner:
    """Named actor handing out dense dp ranks to engine replicas
    (reference: dp_rank_assigner.py:14). Ranks are LEASES: replicas renew
    periodically, and a rank whose holder stopped renewing (controller
    replaced the replica, worker died) is evicted so the replacement can
    claim a slot — without this, dp serving cannot survive replica churn."""

    LEASE_TTL_S = 60.0

    def __init__(self, dp_size: int):
        self.dp_size = dp_size
        self._time = time
        self._next = 0
        self._ranks: Dict[str, int] = {}
        self._last_seen: Dict[str, float] = {}

    def _evict_expired(self):
        now = self._time.time()
        for rid in [r for r, ts in self._last_seen.items()
                    if now - ts > self.LEASE_TTL_S]:
            self._ranks.pop(rid, None)
            self._last_seen.pop(rid, None)

    def assign(self, replica_id: str) -> int:
        now = self._time.time()
        if replica_id in self._ranks:
            self._last_seen[replica_id] = now
            return self._ranks[replica_id]
        if self._next >= self.dp_size:
            self._evict_expired()
            # restarted/replacement replica re-uses the lowest freed slot
            used = set(self._ranks.values())
            for r in range(self.dp_size):
                if r not in used:
                    self._ranks[replica_id] = r
                    self._last_seen[replica_id] = now
                    return r
            raise RuntimeError(f"all {self.dp_size} dp ranks assigned")
        rank = self._next
        self._next += 1
        self._ranks[replica_id] = rank
        self._last_seen[replica_id] = now
        return rank

    def renew(self, replica_id: str) -> bool:
        if replica_id not in self._ranks:
            return False  # evicted: the replica should re-assign
        self._last_seen[replica_id] = self._time.time()
        return True

    def release(self, replica_id: str) -> None:
        self._ranks.pop(replica_id, None)
        self._last_seen.pop(replica_id, None)

    def ranks(self) -> Dict[str, int]:
        return dict(self._ranks)


class DPLLMServer:
    """LLMServer variant that claims a dp rank at start (reference:
    dp_server.py — rank coordination around SPMD engine replicas).

    Rank leases are time-based, not fenced: a replica that stalls past the
    lease TTL can briefly coexist with its replacement on the same rank
    until its next renew tick observes the eviction and re-assigns. Ranks
    here tag responses and drive engine sharding identity at START; they
    are not a mutual-exclusion token mid-request."""

    def __init__(self, config: LLMConfig, params_blob: Optional[bytes] = None,
                 assigner_name: str = "", device: "DeviceLike" = None):
        from ray_tpu_torch.llm.serve_llm import LLMServer

        self._inner = LLMServer(config, params_blob, device=device)
        self.replica_id = uuid.uuid4().hex
        self.dp_rank = -1
        self._stopped = False
        self._assigner_name = assigner_name
        if assigner_name:
            assigner = ray_tpu_torch.get_actor(assigner_name)
            self.dp_rank = ray_tpu_torch.get(
                assigner.assign.remote(self.replica_id), timeout=60)
            # keep the rank lease alive (a dead replica's lease expires and
            # its slot is recycled for the controller's replacement)

            def _renew_loop():
                while not getattr(self, "_stopped", False):
                    time.sleep(DPRankAssigner.LEASE_TTL_S / 4)
                    try:
                        ok = ray_tpu_torch.get(
                            assigner.renew.remote(self.replica_id),
                            timeout=30)
                        if not ok:
                            # evicted while we were unreachable: re-assign
                            # (possibly a NEW rank — the old slot may have
                            # been handed to our replacement already)
                            self.dp_rank = ray_tpu_torch.get(
                                assigner.assign.remote(self.replica_id),
                                timeout=30)
                    except Exception:  # raylint: disable=EXC001 assigner briefly unavailable; retry next tick
                        pass
            threading.Thread(target=_renew_loop, daemon=True,
                             name="dp-rank-renew").start()

    async def __call__(self, body: dict) -> dict:
        out = await self._inner(body)
        out["dp_rank"] = self.dp_rank
        return out

    def rank(self) -> int:
        return self.dp_rank

    def shutdown(self):
        """Stop the lease renew loop and release the rank promptly (a
        killed replica's lease otherwise only frees after the TTL)."""
        self._stopped = True
        try:
            assigner = ray_tpu_torch.get_actor(self._assigner_name)
            assigner.release.remote(self.replica_id)
        except Exception:  # raylint: disable=EXC001 TTL eviction reclaims the slot eventually
            pass

    def __del__(self):
        self._stopped = True


def build_dp_openai_app(config: LLMConfig, dp_size: int, params: Any = None,
                        *, device: "DeviceLike" = None
                        ) -> serve_api.DeploymentHandle:
    """Deploy dp_size engine replicas behind the serve router; each claims a
    dp rank from a named DPRankAssigner (reference: dp_server.py:14). Each
    replica's engine runs on ``device`` (the card by default)."""
    assigner_name = f"dp_assigner:{config.model_id}"
    # get-or-create: a redeploy must reuse the existing detached assigner
    # instead of silently colliding on the name
    ray_tpu_torch.remote(num_cpus=0.1)(DPRankAssigner).options(
        name=assigner_name, lifetime="detached",
        get_if_exists=True).remote(dp_size)
    dep = serve_api.deployment(
        DPLLMServer, name=f"llm-dp:{config.model_id}", num_replicas=dp_size,
        max_ongoing_requests=config.engine_config.max_num_seqs * 2,
        ray_actor_options=dict(config.ray_actor_options) or {"num_cpus": 0.5})
    return serve_api.run(dep.bind(config, _dump_params(params), assigner_name,
                                  device=device))
