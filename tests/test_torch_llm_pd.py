"""Prefill/decode disaggregation and data-parallel serving of the port
(``ray_tpu_torch/llm/pd.py``), on the CPU, against the JAX engine: a mirror
of ``tests/test_llm_pd_dp.py`` and ``tests/test_device_plane.py::
test_pd_kv_rides_device_plane``.

The tiny model takes the JAX engine's fp32 parameters (``from_jax_params``;
the JAX side runs plain attention, ``attention_impl="xla"``). Greedy
completions through a prefill engine, the KV hand-off and a decode engine
(in-process, in port actors, and through ``build_pd_openai_app``) equal the
JAX monolithic engine's token for token, one request at a time; the prefill
side never decodes and the decode side never prefills; the KV travels as a
device object; DP replicas hold ranks {0, 1}, and a released rank is
reused.

Every cluster call carries its own timeout. Nothing here imports JAX at
module level: the workers import this module."""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.llm.config import EngineConfig, LLMConfig, SamplingParams

T = 120  # seconds, each cluster call
ENGINE = dict(max_num_seqs=4, max_model_len=128, page_size=16,
              prefill_bucket_min=16)
PROMPTS = ["the quick brown fox jumps", "hello distributed serving",
           "a", "zz top, once more, with a longer prompt past a page"]
MAX_TOKENS = 10


def make_config(**kw):
    return LLMConfig(model_id="tiny", engine_config=EngineConfig(**ENGINE),
                     model_overrides={"dtype": "float32"}, **kw)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX monolithic engine's fp32 params (as a port state dict) and
    its greedy answer to each prompt, one request at a time."""
    pytest.importorskip("flax")
    import jax
    import jax.numpy as jnp

    from ray_tpu.llm.config import EngineConfig as JaxEngineConfig
    from ray_tpu.llm.config import LLMConfig as JaxLLMConfig
    from ray_tpu.llm.config import SamplingParams as JaxSamplingParams
    from ray_tpu.llm.engine import JaxLLMEngine
    from ray_tpu_torch.models import from_jax_params

    mono = JaxLLMEngine(JaxLLMConfig(
        model_id="tiny", engine_config=JaxEngineConfig(**ENGINE),
        model_overrides={"attention_impl": "xla", "dtype": jnp.float32}),
        seed=0)
    want = {}
    for p in PROMPTS:
        out = mono.generate([p], JaxSamplingParams(max_tokens=MAX_TOKENS))[0]
        want[p] = (list(out.token_ids), out.text, out.finish_reason)
    one = mono.generate(["hello"], JaxSamplingParams(max_tokens=1))[0]
    want["hello/1"] = (list(one.token_ids), one.text, one.finish_reason)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, mono.params))
    return {"params": params, "want": want,
            "n_layers": mono.mcfg.n_layers}


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=6, device="cpu")
    yield ray_tpu_torch
    try:
        from ray_tpu_torch import serve

        serve.shutdown()
    except Exception:
        pass
    ray_tpu_torch.shutdown()


def _engine(params):
    from ray_tpu_torch.llm.engine import TorchLLMEngine

    return TorchLLMEngine(make_config(), params=params, device="cpu")


def _blob(params):
    from ray_tpu_torch._private.serialization import dumps

    return dumps(params)


def test_kv_export_import_matches_monolithic(jax_ref):
    """prefill engine -> KV hand-off -> decode engine equals the JAX
    monolithic engine exactly, one prompt after another through the same
    two engines."""
    prefill_eng = _engine(jax_ref["params"])
    decode_eng = _engine(jax_ref["params"])
    for prompt in PROMPTS:
        state = prefill_eng.prefill_only(
            "r1", prompt, SamplingParams(max_tokens=MAX_TOKENS))
        assert state["generated"], "prefill must emit the first token"
        assert state["k"].shape[0] == jax_ref["n_layers"]
        assert state["ttft_s"] > 0
        # the prefill engine released its slot and pages
        assert prefill_eng.num_active() == 0
        decode_eng.add_request_with_kv(state)
        done = None
        while done is None:
            for out in decode_eng.step():
                if out.finished:
                    done = out
        want = jax_ref["want"][prompt]
        assert (done.token_ids, done.finish_reason) == (want[0], want[2])
    assert prefill_eng.metrics["decode_steps"] == 0
    assert decode_eng.metrics["prefill_tokens"] == 0


def test_prefill_only_single_token_request(jax_ref):
    eng = _engine(jax_ref["params"])
    state = eng.prefill_only("r1", "hello", SamplingParams(max_tokens=1))
    assert state["finished"] and state["finish_reason"] == "length"
    assert state["generated"] == jax_ref["want"]["hello/1"][0]


def test_pd_actors_end_to_end(cluster, jax_ref):
    """A prefill worker and a decode worker serve completions end to end,
    and split the work."""
    from ray_tpu_torch.llm.pd import DecodeWorker, PrefillWorker

    cfg = make_config()
    blob = _blob(jax_ref["params"])
    p = ray_tpu_torch.remote(num_cpus=0.5)(PrefillWorker).remote(
        cfg, blob, device="cpu")
    d = ray_tpu_torch.remote(num_cpus=0.5)(DecodeWorker).remote(
        cfg, blob, device="cpu")
    for prompt in PROMPTS[:2]:
        state = ray_tpu_torch.get(
            p.prefill.remote(prompt, SamplingParams(max_tokens=MAX_TOKENS)),
            timeout=T)
        out = ray_tpu_torch.get(d.decode.remote(state), timeout=T)
        want = jax_ref["want"][prompt]
        assert (out["token_ids"], out["text"], out["finish_reason"]) == want
    # division of labour: the prefill engine never decoded, decode never
    # prefilled
    pm = ray_tpu_torch.get(p.metrics.remote(), timeout=T)
    dm = ray_tpu_torch.get(d.metrics.remote(), timeout=T)
    assert pm["prefill_tokens"] > 0 and pm["decode_steps"] == 0
    assert dm["decode_steps"] > 0 and dm["prefill_tokens"] == 0
    # on the CPU the attention is the plain version: no kernel launches
    launches = ray_tpu_torch.get(p.kernel_launches.remote(), timeout=T)
    assert launches["flash_attention_fwd"] == 0 and not any(
        launches.values())
    assert ray_tpu_torch.get(p.memory_stats.remote(), timeout=T) == {
        "allocated_bytes": 0, "max_allocated_bytes": 0}
    ray_tpu_torch.kill(p)
    ray_tpu_torch.kill(d)


def test_pd_kv_rides_device_plane(cluster, jax_ref):
    """prefill's reply is a device-object marker (the KV stays in the
    prefill worker); decode pulls it from there and the result matches
    the monolithic engine exactly; the pull is counted."""
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.experimental.device_objects import DeviceObjectMarker
    from ray_tpu_torch.llm.pd import DecodeWorker, PrefillWorker

    cfg = make_config()
    blob = _blob(jax_ref["params"])
    pre = ray_tpu_torch.remote(num_cpus=0.5)(PrefillWorker).remote(
        cfg, blob, device="cpu")
    dec = ray_tpu_torch.remote(num_cpus=0.5)(DecodeWorker).remote(
        cfg, blob, device="cpu")
    prompt = PROMPTS[3]
    state_ref = pre.prefill.remote(prompt, SamplingParams(max_tokens=MAX_TOKENS))
    out = ray_tpu_torch.get(dec.decode.remote(state_ref), timeout=T)
    assert (out["token_ids"], out["text"], out["finish_reason"]) == \
        jax_ref["want"][prompt]
    # the driver-visible reply value is a marker, not the KV payload
    raw = global_worker().memory_store.get(state_ref.id)
    assert isinstance(raw, DeviceObjectMarker), type(raw)
    pulls = ray_tpu_torch.get(dec.kv_pulls.remote(), timeout=T)
    # 2 pages of fp32 k and v: 2 layers x 2 pages x 16 x 2 heads x 16 dims
    kv_bytes = 2 * 2 * 2 * 16 * 2 * 16 * 4
    assert pulls["pulls"] == 1 and pulls["bytes"] > kv_bytes
    assert pulls["seconds"] > 0
    ray_tpu_torch.kill(pre)
    ray_tpu_torch.kill(dec)


def test_pd_app_answers_as_jax(cluster, jax_ref):
    """``build_pd_openai_app``: the router sends each request prefill ->
    decode; its answers, one at a time, equal the JAX engine's."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.pd import build_pd_openai_app

    cfg = make_config(ray_actor_options={"num_cpus": 0.5})
    handle = build_pd_openai_app(cfg, params=jax_ref["params"], device="cpu")
    for prompt in PROMPTS:
        out = ray_tpu_torch.get(handle.remote(
            {"prompt": prompt, "max_tokens": MAX_TOKENS,
             "return_token_ids": True}), timeout=T)
        choice = out["choices"][0]
        assert (choice["token_ids"], choice["text"],
                choice["finish_reason"]) == jax_ref["want"][prompt]
        assert out["usage"]["completion_tokens"] == len(choice["token_ids"])
        assert out["usage"]["ttft_s"] > 0
    workers = ray_tpu_torch.get(
        handle.options(method_name="workers").remote(), timeout=T)
    pm = ray_tpu_torch.get(workers["prefill"][0].metrics.remote(), timeout=T)
    dm = ray_tpu_torch.get(workers["decode"][0].metrics.remote(), timeout=T)
    assert pm["decode_steps"] == 0 and dm["prefill_tokens"] == 0
    serve.delete(f"llm-pd:{cfg.model_id}")


def test_dp_replicas_get_distinct_ranks_and_spread(cluster, jax_ref):
    """The router spreads completions across 2 DP engine replicas, each
    holding a distinct dp rank; a replica's ``shutdown`` releases its rank,
    which the next claimant reuses."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.pd import DPRankAssigner, build_dp_openai_app

    cfg = make_config(ray_actor_options={"num_cpus": 0.5})
    handle = build_dp_openai_app(cfg, dp_size=2, params=jax_ref["params"],
                                 device="cpu")
    seen_ranks = set()
    for i in range(8):
        out = ray_tpu_torch.get(handle.remote({"prompt": f"ping {i}",
                                               "max_tokens": 2}), timeout=T)
        assert out["choices"][0]["text"] is not None
        seen_ranks.add(out["dp_rank"])
    assert seen_ranks == {0, 1}, f"router did not spread: {seen_ranks}"
    out = ray_tpu_torch.get(handle.remote(
        {"prompt": PROMPTS[0], "max_tokens": MAX_TOKENS,
         "return_token_ids": True}), timeout=T)
    assert out["choices"][0]["token_ids"] == jax_ref["want"][PROMPTS[0]][0]

    assigner = ray_tpu_torch.get_actor(f"dp_assigner:{cfg.model_id}")
    ranks = ray_tpu_torch.get(assigner.ranks.remote(), timeout=T)
    assert sorted(ranks.values()) == [0, 1]
    # one replica shuts down: its rank is released and reused
    handle.options(method_name="shutdown").remote()
    for _ in range(100):
        left = ray_tpu_torch.get(assigner.ranks.remote(), timeout=T)
        if len(left) == 1:
            break
        import time

        time.sleep(0.05)
    assert len(left) == 1
    freed = ({0, 1} - set(left.values())).pop()
    assert ray_tpu_torch.get(assigner.assign.remote("newcomer"),
                             timeout=T) == freed
    with pytest.raises(Exception, match="dp ranks assigned"):
        ray_tpu_torch.get(assigner.assign.remote("one too many"), timeout=T)
    serve.delete(f"llm-dp:{cfg.model_id}")
    ray_tpu_torch.kill(assigner)

    # the lease table in-process: TTL eviction frees a silent holder's slot
    a = DPRankAssigner(2)
    assert [a.assign("x"), a.assign("y"), a.assign("x")] == [0, 1, 0]
    a._last_seen["x"] -= DPRankAssigner.LEASE_TTL_S + 1
    assert a.assign("z") == 0 and a.renew("x") is False
