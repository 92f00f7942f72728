"""Data-LLM: batch inference processors over Datasets, the port of
``ray_tpu/llm/data_llm.py``.

Reference: ray.data.llm build_llm_processor
(llm/_internal/batch/processor/vllm_engine_proc.py + data/llm.py) — a
processor maps a Dataset of prompts through a shared engine with
preprocess/postprocess stages. The engine lives in one actor per processor
(an engine per map task would rebuild the model per block); map tasks route
their batch of prompts to it, and it runs one ``generate`` per batch, in
the order the calls arrive. The actor's options come from
``config.ray_actor_options`` (``num_gpus`` where the JAX one has
``num_tpus``: on the card it holds a ``GPU`` lease); its engine runs on
``device`` (the card by default). The map tasks hold no ``GPU`` lease and
never touch CUDA.
"""

from __future__ import annotations

import uuid
from typing import TYPE_CHECKING, Any, Callable, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.llm.config import LLMConfig, SamplingParams

if TYPE_CHECKING:
    from ray_tpu_torch.utils import DeviceLike


@ray_tpu_torch.remote
class _EngineActor:
    def __init__(self, config_blob: bytes, params_blob: Optional[bytes],
                 device: "DeviceLike" = None):
        # driver-authored blobs: decode only through the audited
        # serialization boundary
        from ray_tpu_torch._private.serialization import loads_trusted
        from ray_tpu_torch.llm.engine import TorchLLMEngine

        config = loads_trusted(config_blob)
        params = loads_trusted(params_blob) if params_blob else None
        self.engine = TorchLLMEngine(config, params=params, device=device)

    def generate(self, prompts, params_blob: bytes):
        from ray_tpu_torch._private.serialization import loads_trusted

        params = loads_trusted(params_blob)
        outs = self.engine.generate(list(prompts), params)
        return [{"text": o.text, "token_ids": o.token_ids,
                 "finish_reason": o.finish_reason} for o in outs]

    def metrics(self) -> dict:
        return dict(self.engine.metrics)

    def kernel_launches(self, reset: bool = False) -> Dict[str, int]:
        """This process's launch count of each attention kernel wrapper,
        set to 0 after reading when ``reset``."""
        from ray_tpu_torch.ops.attention import launch_counts

        return launch_counts(reset)

    def memory_stats(self) -> Dict[str, int]:
        """The engine's device memory now and at its peak, in bytes (0 on
        the CPU)."""
        import torch

        dev = self.engine.device
        if dev.type != "cuda":
            return {"allocated_bytes": 0, "max_allocated_bytes": 0}
        return {"allocated_bytes": torch.cuda.memory_allocated(dev),
                "max_allocated_bytes": torch.cuda.max_memory_allocated(dev)}


def build_llm_processor(
    config: LLMConfig,
    params: Any = None,
    *,
    sampling_params: Optional[SamplingParams] = None,
    preprocess: Optional[Callable[[dict], str]] = None,
    postprocess: Optional[Callable[[dict, dict], dict]] = None,
    device: "DeviceLike" = None,
) -> Callable:
    """Returns ``processor(dataset) -> dataset`` adding generation columns.

    ``preprocess(row) -> prompt`` defaults to ``row["prompt"]``;
    ``postprocess(row, out) -> row`` defaults to merging ``generated_text``.
    ``processor.shutdown()`` kills the engine actor.
    """
    from ray_tpu_torch._private.serialization import dumps

    sampling_params = sampling_params or SamplingParams()
    actor_name = f"_llm_proc_{uuid.uuid4().hex[:8]}"
    cfg_blob = dumps(config)
    p_blob = dumps(params) if params is not None else None
    opts = dict(config.ray_actor_options) or {"num_cpus": 1.0}
    # named but NOT detached: the engine actor dies with the driver job, so
    # an abandoned processor can't pin a card forever
    engine = _EngineActor.options(
        name=actor_name, get_if_exists=True,
        num_cpus=opts.get("num_cpus", 1.0),
        num_gpus=opts.get("num_gpus", 0.0)).remote(cfg_blob, p_blob,
                                                   device=device)
    sp_blob = dumps(sampling_params)

    def processor(dataset):
        def _infer_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
            import numpy as np

            import ray_tpu_torch as _rt

            eng = _rt.get_actor(actor_name)
            keys = list(batch.keys())
            n = len(batch[keys[0]]) if keys else 0
            rows = [{k: batch[k][i] for k in keys} for i in range(n)]
            if preprocess is not None:
                prompts = [preprocess(r) for r in rows]
            else:
                prompts = [str(r.get("prompt", "")) for r in rows]
            outs = _rt.get(eng.generate.remote(prompts, sp_blob),
                           timeout=600)
            out_rows = []
            for r, o in zip(rows, outs):
                if postprocess is not None:
                    out_rows.append(postprocess(r, o))
                else:
                    r = dict(r)
                    r["generated_text"] = o["text"]
                    out_rows.append(r)
            cols = {k: np.array([row[k] for row in out_rows], dtype=object)
                    for k in out_rows[0]} if out_rows else {}
            return cols

        return dataset.map_batches(_infer_batch)

    processor.engine_actor = engine  # keepalive + test access
    processor.shutdown = lambda: ray_tpu_torch.kill(engine)
    return processor
