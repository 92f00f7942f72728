"""LLM layer of the port: continuous-batching paged-KV engine + server.

Counterpart of ``ray_tpu/llm``. The engine and server load lazily, so
importing this package builds and loads no kernel.
"""

from ray_tpu_torch.llm.config import EngineConfig, LLMConfig, SamplingParams


def __getattr__(name):
    if name == "TorchLLMEngine":
        from ray_tpu_torch.llm.engine import TorchLLMEngine

        return TorchLLMEngine
    if name == "LLMServer":
        from ray_tpu_torch.llm.serve_llm import LLMServer

        return LLMServer
    raise AttributeError(name)


__all__ = [
    "EngineConfig",
    "LLMConfig",
    "SamplingParams",
    "TorchLLMEngine",
    "LLMServer",
]
