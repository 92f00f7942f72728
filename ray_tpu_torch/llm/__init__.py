"""LLM layer of the port: continuous-batching paged-KV engine, its server,
the Serve deployment builders, prefill/decode disaggregation and
data-parallel serving (``pd``), and batch inference over a Dataset
(``data_llm``).

Counterpart of ``ray_tpu/llm``. The engine and server load lazily, so
importing this package builds and loads no kernel.
"""

from ray_tpu_torch.llm.config import EngineConfig, LLMConfig, SamplingParams


def __getattr__(name):
    if name == "TorchLLMEngine":
        from ray_tpu_torch.llm.engine import TorchLLMEngine

        return TorchLLMEngine
    if name in ("LLMServer", "LLMHandle", "build_llm_deployment",
                "build_openai_app"):
        from ray_tpu_torch.llm import serve_llm

        return getattr(serve_llm, name)
    if name == "build_llm_processor":
        from ray_tpu_torch.llm.data_llm import build_llm_processor

        return build_llm_processor
    raise AttributeError(name)


__all__ = [
    "EngineConfig",
    "LLMConfig",
    "SamplingParams",
    "TorchLLMEngine",
    "LLMServer",
    "LLMHandle",
    "build_llm_deployment",
    "build_openai_app",
    "build_llm_processor",
]
