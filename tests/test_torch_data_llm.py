"""Batch inference over a Dataset in the port (``ray_tpu_torch/llm/
data_llm.py``) on a port cluster, on the CPU, against the JAX processor: a
mirror of ``tests/test_llm.py::test_data_llm_processor``. The tiny model
takes the JAX engine's fp32 parameters (``from_jax_params``; plain
attention on the JAX side). Each row's ``generated_text`` equals the JAX
processor's (run in the JAX runtime's local mode, as its own test runs
it) on the same blocks of prompts, and each block equals an in-process
``generate`` of its prompts; ``preprocess`` / ``postprocess`` apply; the
engine actor holds its options and ``shutdown`` kills it.

Every JAX-side call runs under a timeout. Nothing here imports JAX or the
JAX package at module level."""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as pdata
from ray_tpu_torch.llm.config import EngineConfig, LLMConfig, SamplingParams

from test_torch_data import jax_side  # noqa: E402

T = 120
ENGINE = dict(max_num_seqs=4, max_model_len=128, page_size=16,
              prefill_bucket_min=16)
PROMPTS = [f"p{i}" for i in range(6)] + ["a longer prompt for the batch"]
MAX_TOKENS = 3


def make_config(**kw):
    return LLMConfig(model_id="tiny", engine_config=EngineConfig(**ENGINE),
                     model_overrides={"dtype": "float32"}, **kw)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX processor's rows over the prompts in 2 blocks (the JAX
    runtime's local mode), and the params it ran, as a port state dict."""
    pytest.importorskip("flax")
    pytest.importorskip("pyarrow")  # the JAX package's blocks
    import jax
    import jax.numpy as jnp

    import ray_tpu
    from ray_tpu import data as jdata
    from ray_tpu.llm.config import EngineConfig as JaxEngineConfig
    from ray_tpu.llm.config import LLMConfig as JaxLLMConfig
    from ray_tpu.llm.config import SamplingParams as JaxSamplingParams
    from ray_tpu.llm.data_llm import build_llm_processor
    from ray_tpu.llm.engine import JaxLLMEngine
    from ray_tpu_torch.models import from_jax_params

    cfg = JaxLLMConfig(model_id="tiny", engine_config=JaxEngineConfig(**ENGINE),
                       model_overrides={"attention_impl": "xla",
                                        "dtype": jnp.float32})
    params = jax.tree_util.tree_map(np.asarray,
                                    JaxLLMEngine(cfg, seed=0).params)

    def run():
        ray_tpu.shutdown()
        ray_tpu.init(local_mode=True)
        try:
            proc = build_llm_processor(
                cfg, params, sampling_params=JaxSamplingParams(
                    max_tokens=MAX_TOKENS))
            ds = jdata.from_items([{"prompt": p} for p in PROMPTS],
                                  parallelism=2)
            rows = proc(ds).take_all()
            proc.shutdown()
            return rows
        finally:
            ray_tpu.shutdown()

    return {"rows": jax_side(run, timeout=T),
            "params": from_jax_params(params)}


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_data_llm_processor(jax_ref, cluster):
    from ray_tpu_torch.llm import build_llm_processor
    from ray_tpu_torch.llm.engine import TorchLLMEngine

    cfg = make_config(ray_actor_options={"num_cpus": 0.5})
    ds = pdata.from_items([{"prompt": p} for p in PROMPTS], parallelism=2)
    proc = build_llm_processor(
        cfg, jax_ref["params"],
        sampling_params=SamplingParams(max_tokens=MAX_TOKENS), device="cpu")
    try:
        rows = proc(ds).take_all()
        assert len(rows) == len(PROMPTS)
        assert all("generated_text" in r for r in rows)
        assert [r["prompt"] for r in rows] == PROMPTS
        assert [r["generated_text"] for r in rows] == \
            [r["generated_text"] for r in jax_ref["rows"]]
        assert rows == jax_ref["rows"]
        # each block equals an in-process generate of its prompts
        engine = TorchLLMEngine(cfg, params=jax_ref["params"], device="cpu")
        per = -(-len(PROMPTS) // 2)
        for start in range(0, len(PROMPTS), per):
            block = PROMPTS[start:start + per]
            outs = engine.generate(block,
                                   SamplingParams(max_tokens=MAX_TOKENS))
            assert [o.text for o in outs] == [
                r["generated_text"] for r in rows[start:start + per]]
        eng = proc.engine_actor
        assert ray_tpu_torch.get(eng.metrics.remote(),
                                 timeout=T)["prefill_tokens"] > 0
        # the plain attention on the CPU: no kernel launches
        launches = ray_tpu_torch.get(eng.kernel_launches.remote(), timeout=T)
        assert launches["flash_attention_fwd"] == 0 and not any(
            launches.values())
    finally:
        proc.shutdown()
    with pytest.raises(Exception):
        ray_tpu_torch.get(proc.engine_actor.metrics.remote(), timeout=30)


def test_data_llm_processor_pre_and_postprocess(jax_ref, cluster):
    from ray_tpu_torch.llm import build_llm_processor

    cfg = make_config(ray_actor_options={"num_cpus": 0.5})
    ds = pdata.from_items([{"q": p, "n": i} for i, p in enumerate(PROMPTS)],
                          parallelism=3)
    proc = build_llm_processor(
        cfg, jax_ref["params"],
        sampling_params=SamplingParams(max_tokens=MAX_TOKENS),
        preprocess=lambda row: row["q"],
        postprocess=lambda row, out: {"n": row["n"],
                                      "ids": len(out["token_ids"]),
                                      "why": out["finish_reason"]},
        device="cpu")
    try:
        rows = proc(ds).take_all()
    finally:
        proc.shutdown()
    assert [r["n"] for r in rows] == list(range(len(PROMPTS)))
    assert all(r["ids"] <= MAX_TOKENS and r["why"] in ("length", "stop")
               for r in rows)
