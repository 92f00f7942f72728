"""The port's paged-KV serving path against the JAX engine, on the CPU.

Both engines hold the same tiny params (the JAX engine's, converted with
``from_jax_params``) in fp32. The JAX engine runs its Pallas flash kernel in
interpret mode (``attention_impl="flash_interpret"``); the port runs its
attention op on CPU tensors. Greedy decoding must then match token for
token. Mirrors ``tests/test_llm.py``.
"""

import asyncio

import numpy as np
import pytest
import torch

pytest.importorskip("flax")  # the JAX reference; the card's machine lacks it

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ray_tpu.llm import model_runner as jax_mr
from ray_tpu.llm.config import EngineConfig as JaxEngineConfig
from ray_tpu.llm.config import LLMConfig as JaxLLMConfig
from ray_tpu.llm.engine import JaxLLMEngine
from ray_tpu_torch.llm import model_runner as mr
from ray_tpu_torch.llm.config import EngineConfig, LLMConfig, SamplingParams
from ray_tpu_torch.llm.engine import TorchLLMEngine
from ray_tpu_torch.llm.serve_llm import LLMServer
from ray_tpu_torch.models import CONFIGS, Transformer, from_jax_params

# fp32 on both sides: the same products summed in other orders
LOGITS_TOL = dict(atol=1e-5, rtol=1e-4)
ENGINE = dict(max_num_seqs=4, max_model_len=128, page_size=16,
              prefill_bucket_min=16)


def _jax_config(**ekw):
    return JaxLLMConfig(
        model_id="tiny", engine_config=JaxEngineConfig(**{**ENGINE, **ekw}),
        model_overrides={"attention_impl": "flash_interpret",
                         "dtype": jnp.float32})


def _config(**ekw):
    return LLMConfig(model_id="tiny",
                     engine_config=EngineConfig(**{**ENGINE, **ekw}),
                     model_overrides={"dtype": "float32"})


@pytest.fixture(scope="module")
def jax_engine():
    return JaxLLMEngine(_jax_config(), seed=0)


@pytest.fixture(scope="module")
def params(jax_engine):
    return from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                  jax_engine.params))


def _engine(params, seed=0, **ekw):
    return TorchLLMEngine(_config(**ekw), params=params, seed=seed,
                          device="cpu")


def _batch(S=32, B=4):
    """Tokens padded to a bucket, prompt lengths crossing a page, and block
    tables over distinct pages."""
    rng = np.random.default_rng(0)
    lens = np.array([20, 7, 32, 0][:B], np.int32)
    toks = np.zeros((B, S), np.int32)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(3, 256, n)
    bt = np.zeros((B, 8), np.int32)
    bt[0, :2], bt[1, :1], bt[2, :2] = [5, 2], [7], [1, 9]
    return toks, lens, bt


def test_prefill_and_decode_match_jax(jax_engine, params):
    cfg = jax_engine.mcfg
    tcfg = _config().transformer_config()
    toks, lens, bt = _batch()
    NP, P = 12, 16
    jcache = jax_mr.init_cache(cfg, NP, P)
    jlogits, jcache = jax_mr.prefill(jax_engine.params, cfg, jcache,
                                     jnp.asarray(toks), jnp.asarray(lens),
                                     jnp.asarray(bt))
    cp = mr.compute_params(params, tcfg, torch.device("cpu"))
    cache = mr.init_cache(tcfg, NP, P, device="cpu")
    logits, cache = mr.prefill(cp, tcfg, cache, torch.from_numpy(toks).long(),
                               torch.from_numpy(lens).long(),
                               torch.from_numpy(bt).long())
    active = lens > 0
    np.testing.assert_allclose(logits.numpy()[active],
                               np.asarray(jlogits)[active], **LOGITS_TOL)
    # every page a prompt wrote (page 0 is scratch and holds padding)
    for page in (1, 2, 5, 7, 9):
        np.testing.assert_allclose(cache.k[:, page].numpy(),
                                   np.asarray(jcache.k[:, page]), atol=1e-5)
        np.testing.assert_allclose(cache.v[:, page].numpy(),
                                   np.asarray(jcache.v[:, page]), atol=1e-5)

    last = np.argmax(np.asarray(jlogits), -1).astype(np.int32)
    jdec, jcache = jax_mr.decode_step(
        jax_engine.params, cfg, jcache, jnp.asarray(last), jnp.asarray(lens),
        jnp.asarray(bt), jnp.asarray(active))
    dec, cache = mr.decode_step(
        cp, tcfg, cache, torch.from_numpy(last).long(),
        torch.from_numpy(lens).long(), torch.from_numpy(bt).long(),
        torch.from_numpy(active))
    np.testing.assert_allclose(dec.numpy()[active], np.asarray(jdec)[active],
                               **LOGITS_TOL)


def _same_greedy(jax_engine, engine, prompts, max_tokens):
    sp = SamplingParams(max_tokens=max_tokens)
    from ray_tpu.llm.config import SamplingParams as JaxSamplingParams

    want = jax_engine.generate(prompts, JaxSamplingParams(max_tokens=max_tokens))
    got = engine.generate(prompts, sp)
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    assert all(o.finished for o in got)
    return got


def test_generate_matches_jax_token_for_token(jax_engine, params):
    """Prompts crossing page boundaries, more requests than slots."""
    engine = _engine(params)
    prompts = ["hello world", list(range(3, 3 + 30)), "a",
               list(range(40, 40 + 17)), "the quick brown fox", "zz"]
    _same_greedy(jax_engine, engine, prompts, max_tokens=20)


def test_preemption_matches_jax(jax_engine, params):
    """2 slots with pages for ~1.5 long sequences: decode-time page
    exhaustion preempts, and recompute gives the same greedy tokens."""
    engine = _engine(params, max_num_seqs=2, max_model_len=64, num_pages=7)
    jax_small = JaxLLMEngine(_jax_config(max_num_seqs=2, max_model_len=64,
                                         num_pages=7),
                             params=jax_engine.params, seed=0)
    prompts = [list(range(3, 3 + 30)), list(range(40, 40 + 30))]
    got = _same_greedy(jax_small, engine, prompts, max_tokens=30)
    assert engine.metrics["preempted"] > 0
    assert all(len(o.token_ids) <= 30 for o in got)


def test_seeded_sampling_reproducible_and_batch_independent(params):
    sp = SamplingParams(max_tokens=10, temperature=1.0, top_k=16, top_p=0.9,
                        seed=42)
    alone = _engine(params).generate(["seeded prompt"], sp)[0].token_ids
    mixed = _engine(params, seed=999).generate(
        ["seeded prompt", "other a", "other b"], sp)
    assert mixed[0].token_ids == alone
    # the engine-global stream: same engine seed, same tokens
    sp = SamplingParams(max_tokens=10, temperature=0.8, top_k=8)
    a = _engine(params, seed=7).generate(["unseeded"], sp)[0].token_ids
    b = _engine(params, seed=7).generate(["unseeded"], sp)[0].token_ids
    assert a == b and len(a) <= 10


def test_export_and_import_kv_round_trip(params):
    prompt = list(range(3, 3 + 21))
    sp = SamplingParams(max_tokens=12)
    want = _engine(params).generate([prompt], sp)[0].token_ids
    state = _engine(params).prefill_only("r0", prompt, sp)
    assert state["k"].shape[1] == 2 and state["seq_len"] == len(prompt)
    decode = _engine(params)
    decode.add_request_with_kv(state)
    got = list(state["generated"])
    while decode.has_unfinished():
        for out in decode.step():
            got = out.token_ids
    assert got == want


def test_server_answers_concurrent_requests(params):
    server = LLMServer(_config(), params=params, device="cpu")

    async def run():
        return await asyncio.gather(
            *(server.completions(f"request {i}", max_tokens=6)
              for i in range(6)),
            server.chat([{"role": "user", "content": "hi"}], max_tokens=4),
            server({"prompt": "body", "max_tokens": 3}))

    outs = asyncio.run(run())
    assert all(o["finish_reason"] in ("length", "stop") for o in outs[:7])
    assert outs[-1]["object"] == "text_completion"
    metrics = server.engine_metrics()
    assert metrics["generated_tokens"] >= 8 and metrics["prefill_calls"] >= 1
    # greedy answers do not depend on what else was in flight
    alone = _engine(params).generate(["request 3"],
                                     SamplingParams(max_tokens=6))[0]
    assert outs[3]["token_ids"] == alone.token_ids


def test_server_fails_pending_requests_when_a_step_raises(params):
    server = LLMServer(_config(), params=params, device="cpu")

    def broken_step(decode=True):
        raise RuntimeError("device lost")

    server.engine.step = broken_step

    async def run():
        return await asyncio.gather(
            *(server.completions(f"r{i}", max_tokens=4) for i in range(3)),
            return_exceptions=True)

    outs = asyncio.run(run())
    assert all(isinstance(o, RuntimeError) and "device lost" in str(o)
               for o in outs)
    assert not server.engine.has_unfinished()


def test_byte_tokenizer_skips_ids_past_its_vocab():
    """The 1b config's vocab (32000) is wider than the byte tokenizer's:
    generated ids past the byte range decode to nothing."""
    from ray_tpu_torch.llm.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    assert tok.decode(tok.encode("hi", add_bos=True) + [300, 31999]) == "hi"


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch, params):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = CONFIGS["tiny"]
    for make in (lambda: TorchLLMEngine(_config(), params=params),
                 lambda: LLMServer(_config(), params=params),
                 lambda: Transformer(cfg),
                 lambda: mr.init_cache(cfg, 4, 16)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert mr.init_cache(cfg, 4, 16, device="cpu").k.device.type == "cpu"
