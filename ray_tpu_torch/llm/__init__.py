"""LLM layer of the port: continuous-batching paged-KV engine, its server
and the Serve deployment builders.

Counterpart of ``ray_tpu/llm`` (``pd.py`` and ``data_llm.py`` are not ported
yet: ROADMAP.md). The engine and server load lazily, so importing this
package builds and loads no kernel.
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
]
