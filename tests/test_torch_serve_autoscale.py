"""The port's Serve autoscale plane (``ray_tpu_torch/serve/autoscale``): a
mirror of ``tests/test_serve_autoscale.py``.

Unit tier, side by side with the JAX package's modules on the same inputs:
the rate window and the policy's decisions (burst, hysteresis, cooldown,
queue and TTFT SLO pressure), the consistent-hash ring's key-to-replica
map, the prefix router, and the fair queue's pop order. The port's modules
are the JAX ones copied, so every output must be equal.

Integration tier, on a port cluster: a burst scales a deployment up and the
drain scales it down with nothing dropped; ingress admission sheds a full
tenant queue and an expired budget; the prefix policy keeps a prompt on one
replica; the controller mirrors its state into the GCS KV ``serve``
namespace.
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.serve import autoscale as port_autoscale
from ray_tpu_torch.serve.api import AutoscalingConfig

T = 120


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's autoscale modules and config class."""
    pytest.importorskip("flax")
    from ray_tpu.serve import autoscale
    from ray_tpu.serve.api import AutoscalingConfig as JaxAutoscalingConfig

    return autoscale, JaxAutoscalingConfig


def _both(jax_side):
    return ((port_autoscale, AutoscalingConfig), jax_side)


def _stat(arrived=0, completed=0, execute_sum=0.0, execute_count=0,
          ongoing=0, peak=0, queue_samples=(), ttft_samples=()):
    return {"arrived": arrived, "completed": completed,
            "execute_sum": execute_sum, "execute_count": execute_count,
            "ongoing": ongoing, "peak": peak,
            "queue_samples": list(queue_samples),
            "ttft_samples": list(ttft_samples)}


def _window(mod, ticks, window_s=10.0):
    w = mod.DeploymentMetricsWindow(window_s=window_s)
    for now, stat in ticks:
        w.observe([stat], now=now)
    return w


def _decisions(mod, cfg_cls):
    """One sequence of windows and decisions covering every branch of the
    policy; returns each decision and each window's rollup."""
    out = []

    def record(d, w, now):
        out.append((d.direction, d.want, d.reason, d.metrics,
                    w.rollup(now)))
        return d

    # the burst that drained between two polls: priced by the counters
    w = _window(mod, [(10.0, _stat()),
                      (11.0, _stat(arrived=100, completed=100,
                                   execute_sum=30.0, execute_count=100,
                                   peak=2))])
    auto = cfg_cls(min_replicas=1, max_replicas=8,
                   target_ongoing_requests=2.0, upscale_delay_s=0.0,
                   scale_cooldown_s=0.0)
    record(mod.decide(w, current_target=1, config=auto,
                      state=mod.PolicyState(), now=11.0), w, 11.0)

    # hysteresis and cooldown on one policy state
    auto = cfg_cls(min_replicas=1, max_replicas=4,
                   target_ongoing_requests=2.0, upscale_delay_s=0.0,
                   downscale_delay_s=0.0, hysteresis=0.1,
                   scale_cooldown_s=5.0)
    st = mod.PolicyState()
    for conc, now, cur in ((6.0, 100.0, 1), (8.0, 101.0, 3),
                           (3.8, 110.0, 2), (0.2, 120.0, 3)):
        w = _window(mod, [(now - 1.0, _stat()),
                          (now, _stat(arrived=int(conc * 10),
                                      completed=int(conc * 10),
                                      execute_sum=conc,
                                      execute_count=int(conc * 10)))])
        record(mod.decide(w, current_target=cur, config=auto, state=st,
                          now=now), w, now)

    # SLO pressure: queue wait, then time to first token
    auto = cfg_cls(min_replicas=1, max_replicas=4,
                   target_ongoing_requests=2.0, upscale_delay_s=0.0,
                   scale_cooldown_s=0.0)
    w = _window(mod, [(10.0, _stat()),
                      (11.0, _stat(arrived=10, completed=10,
                                   execute_sum=0.5, execute_count=10,
                                   queue_samples=[2.0] * 8,
                                   ttft_samples=[0.05] * 6 + [1.5, 2.5]))])
    for kw in ({}, {"queue_target_s": 0.5}, {"ttft_target_s": 0.5}):
        record(mod.decide(w, current_target=1, config=auto,
                          state=mod.PolicyState(), now=11.0, **kw), w, 11.0)
    # a replica death steps the summed counter down: the rate clamps at 0
    w = _window(mod, [(50.0, _stat(arrived=500)), (51.0, _stat(arrived=120))])
    out.append(("clamp", w.arrival_rate(51.0), w.ttft_p99_s(51.0 + 11.0)))
    return out


def test_window_and_policy_decide_as_the_jax_ones(jax_side):
    (ours, our_cfg), (theirs, their_cfg) = _both(jax_side)
    got, want = _decisions(ours, our_cfg), _decisions(theirs, their_cfg)
    assert got == want
    # and what the JAX package's own tests hold of these decisions
    assert got[0][:2] == ("up", 8)  # 100/s x 0.3 s = 30 -> 15, clamped
    assert [d[:2] for d in got[1:5]] == [("up", 3), ("hold", 3),
                                         ("hold", 2), ("down", 2)]
    assert got[5][0] == "hold"
    assert got[6][0] == "up" and "SLO" in got[6][2]
    assert got[7][0] == "up" and "ttft" in got[7][2]
    assert got[7][3]["ttft_p99_s"] == pytest.approx(2.5)
    assert got[8] == ("clamp", 0.0, None)


def test_configs_parse_as_the_jax_ones(jax_side):
    (ours, our_cfg), (theirs, their_cfg) = _both(jax_side)
    d = {"min_replicas": 1, "max_replicas": 3,
         "target_ongoing_requests": 2.0, "upscale_delay_s": 0.5,
         "downscale_delay_s": 1.0}
    assert vars(our_cfg.from_dict(d)) == vars(their_cfg.from_dict(d))
    assert our_cfg.from_dict(d).window_s == 10.0
    slo = {"ttft_target_s": 0.5, "queue_target_s": 0.2,
           "max_queue_depth": 8, "tenant_weights": {"vip": 2.0}}
    assert ours.SLOConfig.from_dict(slo).to_dict() == \
        theirs.SLOConfig.from_dict(slo).to_dict()
    for bad in ({"max_replicaz": 2},):
        with pytest.raises(ValueError):
            our_cfg.from_dict(bad)
    with pytest.raises(ValueError):
        ours.SLOConfig.from_dict({"ttft_target_s": 0.5, "bogus": 1})


class _R:
    """A replica handle stand-in: the ring keys on the actor id's hex."""

    def __init__(self, h):
        self._actor_id = type("A", (), {"hex": lambda s, h=h: h})()


def _ring_map(mod, ids, keys):
    reps = [_R(h) for h in ids]
    ring = mod.ConsistentHashRing(reps)
    return [ring.lookup(k)._actor_id.hex() for k in keys]


def test_hash_ring_maps_keys_as_the_jax_one(jax_side):
    (ours, _), (theirs, _) = _both(jax_side)
    ids = [f"{i:02x}" * 8 for i in (0xaa, 0xbb, 0xcc, 0xdd)]
    keys = [f"conversation-{i}" for i in range(400)]
    before = _ring_map(ours, ids, keys)
    assert before == _ring_map(theirs, ids, keys)
    after = _ring_map(ours, ids[:3], keys)  # the last replica left
    assert after == _ring_map(theirs, ids[:3], keys)
    moved = sum(1 for b, a in zip(before, after) if b != ids[3] and a != b)
    assert moved == 0  # only the leaver's keys remap
    assert 0 < sum(1 for b in before if b == ids[3]) < 200


def test_prefix_router_as_the_jax_one(jax_side):
    (ours, _), (theirs, _) = _both(jax_side)
    bodies = [{"prompt": "abcdefghij-tail"}, "raw prompt string",
              {"messages": [{"role": "user", "content": "hi"}]}, 12345]
    reps = [_R(h) for h in ("aa", "bb", "cc")]
    got, want = [], []
    for mod, out in ((ours, got), (theirs, want)):
        r = mod.PrefixRouter("dep", prefix_len=8)
        out.append([r.key_of(b) for b in bodies])
        out.append([r.pick(f"key-{i % 5}", reps, version=1)._actor_id.hex()
                    for i in range(20)])
    assert got == want
    assert got[0][0] == "abcdefgh" and got[0][3] is None


def _drain(mod, weights, pushes, depth=16):
    q = mod.FairQueue(max_depth_per_tenant=depth, weights=weights)
    accepted = [q.push(t, (t, i)) for t, i in pushes]
    popped = []
    while True:
        item = q.pop()
        if item is None:
            break
        popped.append(item)
    return accepted, popped


def test_fair_queue_order_as_the_jax_one(jax_side):
    (ours, _), (theirs, _) = _both(jax_side)
    pushes = [(t, i) for i in range(6) for t in ("a", "b", "c")]
    pushes += [("flood", i) for i in range(20)]
    weights = {"a": 2.0, "b": 1.0, "c": 0.5}
    got = _drain(ours, weights, pushes, depth=8)
    assert got == _drain(theirs, weights, pushes, depth=8)
    accepted, popped = got
    assert accepted.count(False) == 12  # the flood beyond its bound shed
    assert [i for t, i in popped if t == "a"] == list(range(6))  # FIFO
    first9 = [t for t, _ in popped[:9]]
    assert first9.count("a") > first9.count("b") > first9.count("c")


# ---------------------------------------------------------------------------
# integration
# ---------------------------------------------------------------------------


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


def _serve_kv(name):
    from ray_tpu_torch._private import wire
    from ray_tpu_torch.experimental.internal_kv import _internal_kv_get

    blob = _internal_kv_get(name.encode(), namespace="serve")
    return None if blob is None else wire.loads(blob)


def test_sustained_load_scale_up_drain_down(cluster):
    """Burst -> the rate window prices demand -> scale up; drain -> demand
    decays under the hysteresis band -> scale down; every request
    completes, the scale history chains, and the KV mirror follows."""
    from ray_tpu_torch.serve import api as serve_api

    @serve.deployment(
        name="surge", max_ongoing_requests=32,
        autoscaling_config={"min_replicas": 1, "max_replicas": 3,
                            "target_ongoing_requests": 2.0,
                            "upscale_delay_s": 0.3,
                            "downscale_delay_s": 0.8,
                            "window_s": 3.0, "scale_cooldown_s": 0.3},
        ray_actor_options={"num_cpus": 0.25})
    class Surge:
        async def __call__(self, body):
            import asyncio

            await asyncio.sleep(0.15)
            return body["i"]

    handle = serve.run(Surge.bind(), name="surge")
    controller = serve_api._get_controller(create=False)
    refs = []
    for i in range(80):  # open loop: 80 requests over ~2 s
        refs.append(handle.remote({"i": i}))
        time.sleep(0.025)
    assert sorted(ray_tpu_torch.get(refs, timeout=T)) == list(range(80))

    state = ray_tpu_torch.get(
        controller.get_autoscale_state.remote("surge"), timeout=30)
    ups = [t for t in state["transitions"] if t["direction"] == "up"]
    assert ups, f"no scale-up recorded: {state}"
    assert ups[0]["to"] > ups[0]["from"]
    assert ups[0]["metrics"]["arrival_rate"] > 0

    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        state = ray_tpu_torch.get(
            controller.get_autoscale_state.remote("surge"), timeout=30)
        if state["target"] == 1 and any(
                t["direction"] == "down" for t in state["transitions"]):
            break
        time.sleep(0.5)
    assert any(t["direction"] == "down" for t in state["transitions"])
    assert state["target"] == 1
    trs = state["transitions"]
    for prev, nxt in zip(trs, trs[1:]):
        assert nxt["from"] == prev["to"]
    mirror = _serve_kv("surge")
    assert mirror is not None and "arrival_rate" in mirror["rollup"]
    serve.delete("surge")
    deadline = time.monotonic() + 15.0
    while _serve_kv("surge") is not None and time.monotonic() < deadline:
        time.sleep(0.2)
    assert _serve_kv("surge") is None  # delete cleans the mirror up


def test_ingress_shed_and_fair_admission(cluster):
    @serve.deployment(name="gated", max_ongoing_requests=2,
                      ray_actor_options={"num_cpus": 0.25})
    class Gated:
        async def __call__(self, body):
            import asyncio

            await asyncio.sleep(0.1)
            return body["tenant"]

    serve.run(Gated.bind(), name="gated")
    ingress = serve.build_ingress(
        "gated", {"max_queue_depth": 8, "latency_budget_s": 30.0,
                  "tenant_weights": {"vip": 2.0}},
        max_inflight_per_replica=2)
    futures, shed_sync = [], 0
    for _ in range(40):
        f = ingress.submit({"tenant": "flood"}, tenant="flood")
        if f.done() and isinstance(f.exception(), serve.LoadShedError):
            shed_sync += 1
        else:
            futures.append(f)
    vip = [ingress.submit({"tenant": "vip"}, tenant="vip")
           for _ in range(4)]
    assert shed_sync > 0, "the flood never hit the bounded queue"
    assert len(futures) <= 8 + 4
    assert all(f.result(timeout=60) == "flood" for f in futures)
    assert all(f.result(timeout=60) == "vip" for f in vip)
    st = ingress.stats()
    assert st["shed"] == shed_sync
    assert st["completed"] == len(futures) + len(vip)
    ingress.close()

    # a request whose latency budget expires while queued is shed
    slow = serve.build_ingress("gated", {"max_queue_depth": 64,
                                         "latency_budget_s": 0.05},
                               max_inflight_per_replica=1)
    outcomes = {"ok": 0, "shed": 0}
    for f in [slow.submit({"tenant": "x"}) for _ in range(8)]:
        try:
            f.result(timeout=60)
            outcomes["ok"] += 1
        except serve.LoadShedError:
            outcomes["shed"] += 1
    assert outcomes["ok"] >= 1 and outcomes["shed"] >= 1, outcomes
    slow.close()
    serve.delete("gated")


def test_prefix_routing_policy_sticks(cluster):
    from ray_tpu_torch._private.serialization import dumps, loads_trusted

    @serve.deployment(name="kv", num_replicas=2,
                      ray_actor_options={"num_cpus": 0.25})
    class KV:
        def __call__(self, body):
            import os

            return os.getpid()

    handle = serve.run(KV.bind(), name="kv").options(routing_policy="prefix")
    prompts = [{"prompt": f"conversation-{i}: tell me more"}
               for i in range(48)]
    first = [ray_tpu_torch.get(handle.remote(p), timeout=T) for p in prompts]
    for _ in range(3):
        assert [ray_tpu_torch.get(handle.remote(p), timeout=T)
                for p in prompts] == first
    # the spread, with no room for chance: each key lands on the replica a
    # ring over the handle's own replicas names (the ids are random, so in
    # some layouts a ring puts every key on one replica)
    pids = handle.broadcast("__call__", {}, timeout=T)
    replicas = list(handle._replicas)
    ring = port_autoscale.ConsistentHashRing(replicas)
    owners = [ring.lookup(handle._router().key_of(p)) for p in prompts]
    want = [pids[next(i for i, r in enumerate(replicas) if r is owner)]
            for owner in owners]
    assert first == want
    assert len(set(first)) == len({id(owner) for owner in owners})
    h2 = loads_trusted(dumps(handle))
    assert h2._routing_policy == "prefix"
    with pytest.raises(ValueError):
        handle.options(routing_policy="bogus")
    serve.delete("kv")
