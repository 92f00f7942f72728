"""The port's LLM serving glue (``ray_tpu_torch/llm/serve_llm.py``) on a port
cluster, on the CPU, against the JAX engine.

A tiny LM from the JAX engine's fp32 params (its Pallas flash forward in
interpret mode) is served by ``build_llm_deployment`` on two replicas; its
greedy answers, by handle and over the HTTP proxy, equal the JAX engine's
``generate`` token for token. After a second JAX param set is published
to a ``WeightStore`` and broadcast with ``update_weights``, the answers
equal that set's. Engine state saved by ``save_engine_state`` loads back
bit-equal, and ``checkpoint_path`` loads what the JAX ``save_params`` wrote
(and the legacy ``params.msgpack``), as the JAX ``_load_params`` reads what
the port wrote. Mirrors ``tests/test_llm.py``'s serving tests.
"""

import asyncio
import json
import urllib.request

import numpy as np
import pytest
import torch

pytest.importorskip("flax")  # the JAX reference; the card's machine lacks it

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch import serve  # noqa: E402
from ray_tpu_torch.llm.config import EngineConfig, LLMConfig  # noqa: E402

T = 120
ENGINE = dict(max_num_seqs=4, max_model_len=128, page_size=16,
              prefill_bucket_min=16)
PROMPTS = ["hello world", "a", "the quick brown fox", "zz top",
           "serve me", "one more prompt"]
MAX_TOKENS = 8


def _jax_engine(seed):
    from ray_tpu.llm.config import EngineConfig as JaxEngineConfig
    from ray_tpu.llm.config import LLMConfig as JaxLLMConfig
    from ray_tpu.llm.engine import JaxLLMEngine

    return JaxLLMEngine(JaxLLMConfig(
        model_id="tiny", engine_config=JaxEngineConfig(**ENGINE),
        model_overrides={"attention_impl": "flash_interpret",
                         "dtype": jnp.float32}), seed=seed)


def _config(**kw):
    return LLMConfig(model_id="tiny", engine_config=EngineConfig(**ENGINE),
                     model_overrides={"dtype": "float32"}, **kw)


def _numpy_tree(jax_engine):
    return jax.tree_util.tree_map(np.asarray, jax_engine.params)


def _want(jax_engine):
    from ray_tpu.llm.config import SamplingParams as JaxSamplingParams

    return [(list(o.token_ids), o.text, o.finish_reason)
            for o in jax_engine.generate(
                PROMPTS, JaxSamplingParams(max_tokens=MAX_TOKENS))]


@pytest.fixture(scope="module")
def jax_runs():
    """Two JAX engines' params and greedy answers (seeds 0 and 1)."""
    out = {}
    for seed in (0, 1):
        engine = _jax_engine(seed)
        out[seed] = {"tree": _numpy_tree(engine), "want": _want(engine)}
    return out


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=6, device="cpu")
    yield ray_tpu_torch
    try:
        serve.shutdown()
    except Exception:
        pass
    ray_tpu_torch.shutdown()


def _by_handle(handle):
    comp = handle.options(method_name="completions")
    refs = [comp.remote(p, max_tokens=MAX_TOKENS) for p in PROMPTS]
    return [(out["token_ids"], out["text"], out["finish_reason"])
            for out in ray_tpu_torch.get(refs, timeout=T)]


def _by_http(port, name):
    out = []
    for p in PROMPTS:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/{name}",
            data=json.dumps({"prompt": p, "max_tokens": MAX_TOKENS,
                             "return_token_ids": True}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=T) as resp:
            result = json.loads(resp.read())["result"]
        choice = result["choices"][0]
        assert result["usage"]["completion_tokens"] == \
            len(choice["token_ids"])
        assert result["usage"]["ttft_s"] > 0
        out.append((choice["token_ids"], choice["text"],
                    choice["finish_reason"]))
    return out


def test_deployment_answers_as_jax_before_and_after_update_weights(
        cluster, jax_runs):
    from ray_tpu_torch.llm import build_llm_deployment, build_openai_app
    from ray_tpu_torch.llm.serve_llm import LLMHandle
    from ray_tpu_torch.weights import WeightStore

    cfg = _config(num_replicas=2, ray_actor_options={"num_cpus": 0.5})
    app = build_llm_deployment(cfg, params=jax_runs[0]["tree"],
                               device="cpu")
    assert app.deployment.name == "llm:tiny"
    handles = build_openai_app([cfg], params=jax_runs[0]["tree"],
                               device="cpu")
    assert list(handles) == ["llm:tiny"]
    handle = handles["llm:tiny"]
    port = serve.start_http_proxy()
    want0 = jax_runs[0]["want"]
    assert _by_handle(handle) == want0
    assert _by_http(port, "llm:tiny") == want0
    # prefix routing: the same prompt twice -> the same answer
    lh = LLMHandle("llm:tiny", prefix_len=4)
    a, b = ray_tpu_torch.get([lh.remote({"prompt": PROMPTS[2],
                                         "max_tokens": MAX_TOKENS})
                              for _ in range(2)], timeout=T)
    assert a["choices"][0]["text"] == b["choices"][0]["text"] == want0[2][1]

    store = WeightStore("tiny_weights")
    v1 = store.publish(jax_runs[1]["tree"])
    acks = handle.broadcast("update_weights", "tiny_weights", timeout=T)
    assert [a["version"] for a in acks] == [v1, v1]
    assert all(a["model_id"] == "tiny" for a in acks)
    want1 = jax_runs[1]["want"]
    assert want1 != want0
    assert _by_handle(handle) == want1
    assert _by_http(port, "llm:tiny") == want1
    launches = handle.broadcast("kernel_launches")
    # on the CPU the attention op is the plain version: no kernel launches
    assert all(c["flash_attention_fwd"] == 0 for c in launches)
    serve.delete("llm:tiny")


def test_update_weights_keeps_serving(cluster, jax_runs):
    """Requests in flight while ``update_weights`` swaps the params all
    complete; those done before the publish have the old weights' answers,
    and every request submitted after the acks gets the new weights'."""
    import threading
    import time

    from ray_tpu_torch.llm import build_llm_deployment
    from ray_tpu_torch.weights import WeightStore

    cfg = _config(num_replicas=2, ray_actor_options={"num_cpus": 0.5})
    handle = serve.run(build_llm_deployment(cfg, params=jax_runs[0]["tree"],
                                            device="cpu", name="swap"))
    comp = handle.options(method_name="completions")
    answers = {s: dict((p, w[0]) for p, w in zip(PROMPTS, jax_runs[s]["want"]))
               for s in (0, 1)}
    results, failures = [], []
    stop = threading.Event()

    def client(i):
        while not stop.is_set():
            p = PROMPTS[i % len(PROMPTS)]
            t_submit = time.monotonic()
            try:
                out = ray_tpu_torch.get(comp.remote(p, max_tokens=MAX_TOKENS),
                                        timeout=T)
                results.append((t_submit, time.monotonic(), p,
                                out["token_ids"]))
            except Exception as e:  # a dropped request fails the test
                failures.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(3)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 60
    while len(results) < 3 and time.monotonic() < deadline:
        time.sleep(0.05)
    t_published = time.monotonic()
    v = WeightStore("swap_weights").publish(jax_runs[1]["tree"])
    acks = handle.broadcast("update_weights", "swap_weights", timeout=T)
    t_acked = time.monotonic()
    assert [a["version"] for a in acks] == [v, v]
    time.sleep(1.0)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    assert not failures, failures[:3]
    assert len(results) > 6
    # a request decoding across the swap may mix the two sets' weights, as
    # in the JAX package
    early = [(p, toks) for _, done, p, toks in results if done < t_published]
    assert early and all(toks == answers[0][p] for p, toks in early)
    late = [(p, toks) for t, _, p, toks in results if t > t_acked]
    assert late and all(toks == answers[1][p] for p, toks in late)
    serve.delete("swap")


def _server(params, **kw):
    from ray_tpu_torch.llm.serve_llm import LLMServer

    return LLMServer(_config(**kw), params=params, device="cpu")


def _same_params(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_save_and_load_engine_state_round_trip(jax_runs, tmp_path):
    seed0 = _server(jax_runs[0]["tree"])
    seed1 = _server(jax_runs[1]["tree"])
    path = str(tmp_path / "engine_state")
    saved = asyncio.run(seed0.save_engine_state(path, step=3))
    assert saved["manifest"].endswith(".json") and saved["model_id"] == "tiny"
    loaded = asyncio.run(seed1.load_engine_state(path))
    assert loaded == {"model_id": "tiny", "source": path}
    _same_params(seed1.engine.params, seed0.engine.params)
    got = asyncio.run(seed1.completions(PROMPTS[0], max_tokens=MAX_TOKENS))
    assert got["token_ids"] == jax_runs[0]["want"][0][0]
    # the JAX engine's loader reads the port's save as its own params
    from ray_tpu.llm.engine import _load_params as jax_load

    tree = jax_load(path)
    for k, v in jax.tree_util.tree_leaves_with_path(jax_runs[0]["tree"]):
        got_leaf = tree
        for part in k:
            got_leaf = got_leaf[part.key]
        np.testing.assert_array_equal(np.asarray(got_leaf), v)


def test_checkpoint_path_loads_what_jax_wrote(jax_runs, tmp_path):
    import flax.serialization

    from ray_tpu.llm.engine import save_params as jax_save
    from ray_tpu_torch.llm.engine import TorchLLMEngine

    want = _server(jax_runs[1]["tree"]).engine.params
    store = str(tmp_path / "jax_store")
    jax_save(jax_runs[1]["tree"], store, step=1)
    legacy = tmp_path / "legacy"
    legacy.mkdir()
    (legacy / "params.msgpack").write_bytes(
        flax.serialization.msgpack_serialize(jax_runs[1]["tree"]))
    for path in (store, str(legacy), str(legacy / "params.msgpack")):
        engine = TorchLLMEngine(_config(checkpoint_path=path), seed=0,
                                device="cpu")
        _same_params(engine.params, want)
    from ray_tpu_torch.llm.config import SamplingParams

    out = engine.generate(PROMPTS[:2], SamplingParams(max_tokens=MAX_TOKENS))
    assert [o.token_ids for o in out] == \
        [w[0] for w in jax_runs[1]["want"][:2]]
    assert engine.num_waiting() == 0 and engine.num_active() == 0
    engine.add_request("r", PROMPTS[0])
    assert engine.num_waiting() == 1
    engine.step()
    assert (engine.num_waiting(), engine.num_active()) == (0, 1)
