"""The port's weight plane (``ray_tpu_torch/weights``) on a port cluster,
on the CPU: a mirror of ``tests/test_weight_plane.py``'s cluster flows
(the two ``jax_reshard`` tests aside, whose tier is not ported), with the
collective tier over gloo.

Covers the learner broadcast to N subscriber actors, the cross-mesh
publish/pull with ``plan.no_gather()``, the elastic re-form through
``TrainWorker.publish_weight_shards`` / ``pull_weight_shards``, the rolling
serve update with zero dropped requests, ``collective_reshard`` and a
multi-round ``redistribute`` on one mesh, and the delta and quantized
publishes. Against the JAX store (``ray_tpu.weights``, in the JAX runtime's
local mode) for one numpy tree from a seed: the manifests (keys, boxes,
sha256, bytes, chunk counts, encodings, and a delta's reused set) are
equal, and quantized pulls are within the codec's bound (int8: half a
step of the block's amax / 127; the port's codes are the numpy codecs' bit
for bit, the JAX encoder's scale may differ by an ulp, as in
``tests/test_torch_collective.py``).

Actor and deployment classes at this module's top level travel by name (the
workers import this module), so JAX is imported inside the tests only.
"""

import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.collective import CollectiveActorMixin
from ray_tpu_torch.weights import (
    MeshSpec,
    ShardedTreeSpec,
    WeightStore,
    collective_reshard,
    local_shards_of,
    plan_reshard,
    publish_host_shards,
)

T = 120  # every cluster call's timeout


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8, device="cpu")
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _tree(scale: float = 1.0):
    return {
        "layer0": {"w": (np.arange(64, dtype=np.float32).reshape(8, 8)
                         * scale),
                   "b": np.arange(8, dtype=np.float32) * scale},
        "step": np.asarray([scale], np.float32),
    }


def _delta_tree(rng, n_leaves=8, rows=128):
    return {f"l{i}": rng.normal(size=(rows, 64)).astype(np.float32)
            for i in range(n_leaves)}


def _replicated_leaves(dst):
    return {leaf for leaf in dst.meta if all(a is None for a in
                                             dst.part_of(leaf))}


def _moved_sharded(plan, dst):
    rep = _replicated_leaves(dst)
    return sum(e.nbytes for e in plan.edges
               if not e.local and e.leaf not in rep)


def _unique_sharded(src, dst):
    from ray_tpu_torch.weights.spec import box_nbytes, unique_boxes

    rep = _replicated_leaves(dst)
    total = 0
    for leaf, (shape, dtype) in src.meta.items():
        if leaf in rep:
            continue
        item = np.dtype(dtype).itemsize
        for box in unique_boxes(src.mesh, src.part_of(leaf), shape):
            total += box_nbytes(box, item)
    return total


# ---------------------------------------------------------------------------
# (a) learner -> N subscriber broadcast, version monotonicity
# ---------------------------------------------------------------------------


@ray_tpu_torch.remote(num_cpus=0.2)
class _Learner:
    """The publishing side: holds its params and publishes each version
    zero-copy (``durable=False``; the refs live while this process does)."""

    def __init__(self, store_name):
        self.store = WeightStore(store_name)
        self.params = {"w": np.zeros(4, np.float32)}

    def update(self):
        self.params = {"w": self.params["w"] + 1.0}
        return float(self.params["w"][0])

    def publish(self):
        return self.store.publish(self.params)


@ray_tpu_torch.remote(num_cpus=0.2)
class _Subscriber:
    def __init__(self, store_name):
        self.sub = WeightStore(store_name, create=False).subscribe(
            start_after=-1)
        self.seen = []
        self.weights = None

    def poll(self, timeout=0.0):
        got = self.sub.poll(timeout=timeout)
        if got is None:
            return None
        version, self.weights = got
        self.seen.append(version)
        return version

    def report(self):
        return {"versions": list(self.seen),
                "w0": float(self.weights["w"][0])
                if self.weights is not None else None}


def test_learner_broadcast_to_subscribers(cluster):
    store_name = "bcast_test"
    learner = _Learner.remote(store_name)
    v1 = ray_tpu_torch.get(learner.publish.remote(), timeout=T)
    subs = [_Subscriber.remote(store_name) for _ in range(4)]
    try:
        got = ray_tpu_torch.get([s.poll.remote(timeout=30.0) for s in subs],
                                timeout=T)
        assert got == [v1] * 4
        # nothing new: poll returns None, the version does not regress
        assert ray_tpu_torch.get([s.poll.remote(0.0) for s in subs],
                                 timeout=T) == [None] * 4
        ray_tpu_torch.get(learner.update.remote(), timeout=T)
        v2 = ray_tpu_torch.get(learner.publish.remote(), timeout=T)
        assert v2 > v1
        got = ray_tpu_torch.get([s.poll.remote(timeout=30.0) for s in subs],
                                timeout=T)
        assert got == [v2] * 4
        reports = ray_tpu_torch.get([s.report.remote() for s in subs],
                                    timeout=T)
        for rep in reports:
            assert rep["versions"] == [v1, v2]
            assert rep["w0"] == 1.0  # the updated params reached everyone
        stats = WeightStore(store_name).stats()
        assert stats["latest"] == v2
        assert stats["versions"][str(v2)]["num_pulls"] >= 4
    finally:
        for a in subs + [learner]:
            ray_tpu_torch.kill(a)


# ---------------------------------------------------------------------------
# (b) train mesh -> differently-sharded serve replicas through the store
# ---------------------------------------------------------------------------


@ray_tpu_torch.remote(num_cpus=0.2)
class _SrcHost:
    """One host of the train mesh: holds ONLY its shards (cut locally from
    the deterministic test tree — the full tree never crosses a boundary)."""

    def __init__(self, store_name, host, src_spec, dst_spec):
        self.store_name = store_name
        self.host = host
        self.src = src_spec
        self.dst = dst_spec

    def publish(self, version):
        shards = local_shards_of(_tree(), self.src, self.host)
        return publish_host_shards(
            WeightStore(self.store_name), version, self.src, self.host,
            shards, dst_spec=self.dst, durable=False)


@ray_tpu_torch.remote(num_cpus=0.2)
class _DstHost:
    def __init__(self, store_name, host, dst_spec):
        self.store_name = store_name
        self.host = host
        self.dst = dst_spec

    def pull(self, version):
        shards = WeightStore(self.store_name).pull_shards(
            self.dst, self.host, version)
        return {leaf: {str(box): arr for box, arr in boxes.items()}
                for leaf, boxes in shards.items()}


def test_cross_mesh_publish_pull_no_gather(cluster):
    tree = _tree()
    store_name = "reshard_test"
    src_mesh = MeshSpec((4,), ("data",), tuple(f"t{i}" for i in range(4)))
    dst_mesh = MeshSpec((2,), ("model",), ("s0", "s1"))
    src = ShardedTreeSpec.from_tree(tree, src_mesh, default_part=("data",))
    src.parts["step"] = ()
    dst = ShardedTreeSpec.from_tree(
        tree, dst_mesh,
        parts={"layer0/w": (None, "model"), "layer0/b": ("model",),
               "step": ()})
    plan = plan_reshard(src, dst)
    assert plan.no_gather()
    assert _moved_sharded(plan, dst) <= _unique_sharded(src, dst)

    srcs = [_SrcHost.remote(store_name, h, src, dst)
            for h in src_mesh.hosts]
    dsts = [_DstHost.remote(store_name, h, dst) for h in dst_mesh.hosts]
    try:
        version = 1
        ray_tpu_torch.get([s.publish.remote(version) for s in srcs],
                          timeout=T)
        out = ray_tpu_torch.get([d.pull.remote(version) for d in dsts],
                                timeout=T)
        # s0 gets columns 0:4, s1 columns 4:8 of w; halves of b; all of step
        for i, host_out in enumerate(out):
            wbox = f"((0, 8), ({i * 4}, {i * 4 + 4}))"
            np.testing.assert_array_equal(
                host_out["layer0/w"][wbox],
                tree["layer0"]["w"][:, i * 4:(i + 1) * 4])
            bbox = f"(({i * 4}, {i * 4 + 4}),)"
            np.testing.assert_array_equal(
                host_out["layer0/b"][bbox],
                tree["layer0"]["b"][i * 4:(i + 1) * 4])
            np.testing.assert_array_equal(host_out["step"]["((0, 1),)"],
                                          tree["step"])
        stats = WeightStore(store_name).stats()["versions"][str(version)]
        # published exactly the planned unique chunks; every dst host
        # pulled only its own shard bytes
        assert stats["bytes_published"] == plan.unique_chunk_bytes()
        assert stats["bytes_pulled"] == plan.bytes_moved()
    finally:
        for a in srcs + dsts:
            ray_tpu_torch.kill(a)


# ---------------------------------------------------------------------------
# (c) elastic re-form: a killed group's state reshards onto a smaller mesh
# ---------------------------------------------------------------------------


def test_elastic_reform_reshards_state(cluster):
    import torch

    from ray_tpu_torch.train.config import ScalingConfig
    from ray_tpu_torch.train.scaling_policy import (ElasticScalingPolicy,
                                                    mesh_spec_for)
    from ray_tpu_torch.train.worker_group import TrainWorker

    store_name = "elastic_test"
    old_world = 4
    workers = [TrainWorker.options(num_cpus=0.2).remote(i, old_world)
               for i in range(old_world)]
    # every rank durably publishes ITS shard (dim 0) of the optimizer
    # state; rank 0's is a tensor, the others' numpy arrays
    version = 1
    ray_tpu_torch.get([
        w.publish_weight_shards.remote(
            store_name, version,
            {"opt": {"m": (torch.full((2, 3), float(i)) if i == 0 else
                           np.full((2, 3), float(i), np.float32))}})
        for i, w in enumerate(workers)], timeout=T)
    for w in workers:  # the whole incarnation dies
        ray_tpu_torch.kill(w)

    scaling = ScalingConfig(num_workers=old_world, elastic=True,
                            min_workers=1, elastic_granularity="pow2",
                            resources_per_worker={"CPU": 1.0})
    new_world = ElasticScalingPolicy(scaling).size_after_failure(
        old_world, {"CPU": 2.0})
    assert new_world == 2
    assert mesh_spec_for(new_world).hosts == ("rank0", "rank1")

    new_workers = [TrainWorker.options(num_cpus=0.2).remote(i, new_world)
                   for i in range(new_world)]
    try:
        out = ray_tpu_torch.get([
            w.pull_weight_shards.remote(store_name) for w in new_workers],
            timeout=T)
        for rank, res in enumerate(out):
            assert res["version"] == version
            m = res["tree"]["opt"]["m"]
            assert m.shape == (4, 3)  # global dim0=8 resharded 4 -> 2
            expect = np.repeat(np.arange(rank * 2, rank * 2 + 2,
                                         dtype=np.float32), 2)[:, None]
            np.testing.assert_array_equal(m, np.broadcast_to(expect, (4, 3)))
    finally:
        for w in new_workers:
            ray_tpu_torch.kill(w)


# ---------------------------------------------------------------------------
# (d) rolling serve weight update: zero dropped requests
# ---------------------------------------------------------------------------


class _ServedModel:
    def __init__(self, store_name):
        self.store_name = store_name
        self.version = 0
        self.w = np.zeros(4, np.float32)

    def __call__(self, body):
        time.sleep(0.005)
        return {"version": self.version, "w0": float(self.w[0])}

    def update_weights(self, version=None):
        tree, ver = WeightStore(self.store_name).pull(
            version, return_version=True)
        # attribute swap is atomic under the GIL: in-flight requests keep
        # serving the old tree, the next request sees the new one
        self.w, self.version = tree["w"], ver
        return ver


def test_rolling_serve_weight_update_zero_drops(cluster):
    from ray_tpu_torch.serve import api as serve

    store_name = "serve_weights_test"
    store = WeightStore(store_name)
    app = serve.deployment(
        _ServedModel, name="wmodel", num_replicas=3,
        ray_actor_options={"num_cpus": 0.3}).bind(store_name)
    handle = serve.run(app)
    try:
        failures, responses = [], []
        stop = threading.Event()

        def hammer():
            while not stop.is_set():
                t_submit = time.monotonic()
                try:
                    responses.append((t_submit, ray_tpu_torch.get(
                        handle.remote({}), timeout=60)))
                except Exception as e:  # any dropped request fails the test
                    failures.append(repr(e))

        threads = [threading.Thread(target=hammer, daemon=True)
                   for _ in range(4)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60  # traffic flows before the update
        while len(responses) < 4 and time.monotonic() < deadline:
            time.sleep(0.05)
        v1 = store.publish({"w": np.full(4, 7.0, np.float32)})
        acks = handle.broadcast("update_weights", timeout=T)
        t_acked = time.monotonic()
        assert acks == [v1] * 3  # every replica applied the update
        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not failures, failures[:3]
        assert len(responses) > 20
        # traffic flowed before, during and after the update; every
        # request submitted after all acks got the new weights
        assert responses[0][1]["version"] == 0
        late = [r for t_submit, r in responses if t_submit > t_acked]
        assert late and all(r == {"version": v1, "w0": 7.0} for r in late)
    finally:
        serve.delete("wmodel")


# ---------------------------------------------------------------------------
# same-mesh lowering: the collective tier over gloo (no store involved)
# ---------------------------------------------------------------------------


def _same_mesh_specs(tree):
    mesh = MeshSpec((2,), ("x",), ("m0", "m1"))
    src = ShardedTreeSpec.from_tree(
        tree, mesh, parts={"layer0/w": ("x",), "layer0/b": ("x",),
                           "step": ()})
    dst = ShardedTreeSpec.from_tree(
        tree, mesh, parts={"layer0/w": (None, "x"), "layer0/b": ("x",),
                           "step": ()})
    return src, dst


@ray_tpu_torch.remote(num_cpus=0.3)
class _MeshMember(CollectiveActorMixin):
    def __init__(self, rank, src_spec, dst_spec):
        self.rank = rank
        self.src = src_spec
        self.dst = dst_spec

    def reshard(self, group_name, limit=None):
        from ray_tpu_torch import collective as col
        from ray_tpu_torch.weights import lower_collective, redistribute

        host = self.src.mesh.hosts[self.rank]
        shards = local_shards_of(_tree(), self.src, host)
        plan = plan_reshard(self.src, self.dst)
        group = col.get_group(group_name)
        if limit is None:
            out, rounds = collective_reshard(plan, group, host, shards), None
        else:
            program = lower_collective(plan, inflight_limit_bytes=limit)
            out, rounds = redistribute(program, group, host, shards), \
                len(program.rounds)
        return rounds, {leaf: {str(b): a for b, a in boxes.items()}
                        for leaf, boxes in out.items()}

    def leave(self, group_name):
        from ray_tpu_torch import collective as col

        col.destroy_collective_group(group_name)
        return True


def _check_same_mesh(out, tree):
    for i, (_, res) in enumerate(out):
        np.testing.assert_array_equal(
            res["layer0/w"][f"((0, 8), ({i * 4}, {i * 4 + 4}))"],
            tree["layer0"]["w"][:, i * 4:(i + 1) * 4])
        # b: the same partition on both sides -> pure local edges
        np.testing.assert_array_equal(
            res["layer0/b"][f"(({i * 4}, {i * 4 + 4}),)"],
            tree["layer0"]["b"][i * 4:(i + 1) * 4])
        np.testing.assert_array_equal(res["step"]["((0, 1),)"],
                                      tree["step"])


def test_collective_reshard_and_multi_round_redistribute(cluster):
    """``collective_reshard`` on one mesh, then the same exchange as a
    program lowered under a byte-tight in-flight budget: many rounds, and
    every byte still lands (twice on one group, so the epoch fence between
    calls is exercised)."""
    from ray_tpu_torch.collective import create_collective_group

    tree = _tree()
    src, dst = _same_mesh_specs(tree)
    plan = plan_reshard(src, dst)
    biggest = max(e.nbytes for e in plan.edges if not e.local)
    members = [_MeshMember.remote(i, src, dst) for i in range(2)]
    try:
        create_collective_group(members, 2, [0, 1], backend="gloo",
                                group_name="wp_reshard")
        _check_same_mesh(ray_tpu_torch.get(
            [m.reshard.remote("wp_reshard") for m in members], timeout=T),
            tree)
        for _ in range(2):
            out = ray_tpu_torch.get(
                [m.reshard.remote("wp_reshard", biggest) for m in members],
                timeout=T)
            _check_same_mesh(out, tree)
            assert out[0][0] > 1 and out[0][0] == out[1][0]
        ray_tpu_torch.get([m.leave.remote("wp_reshard") for m in members],
                          timeout=T)
    finally:
        for m in members:
            ray_tpu_torch.kill(m)


# ---------------------------------------------------------------------------
# delta + quantized publishes (the compression tier of the weight plane)
# ---------------------------------------------------------------------------


def test_delta_publish_byte_exact_and_under_half_bytes(cluster):
    rng = np.random.default_rng(0)
    tree = _delta_tree(rng)
    store = WeightStore("w_delta")
    v1 = store.publish(tree, durable=True)
    tree2 = dict(tree)
    tree2["l3"] = tree["l3"] + 1.0  # 1 of 8 leaves changed
    v2 = store.publish(tree2, durable=True, delta_from=v1)
    pulled = store.pull(v2)
    for k in tree2:
        np.testing.assert_array_equal(pulled[k], tree2[k])
    vs = store.stats()["versions"]
    full, delta = vs[str(v1)], vs[str(v2)]
    assert delta["bytes_published"] < 0.5 * full["bytes_published"]
    assert delta["bytes_reused"] == 7 * tree["l0"].nbytes


def test_chained_deltas_survive_retention(cluster):
    rng = np.random.default_rng(1)
    tree = _delta_tree(rng)
    store = WeightStore("w_chain")
    v = store.publish(tree, durable=True)
    for i in range(3):  # three chained deltas -> the base retires
        tree = dict(tree)
        tree[f"l{i}"] = tree[f"l{i}"] * 2.0 + i
        v = store.publish(tree, durable=True, delta_from=v)
    pulled = store.pull(v)
    for k in tree:
        np.testing.assert_array_equal(pulled[k], tree[k])
    vs = sorted(int(x) for x in store.stats()["versions"])
    with pytest.raises(Exception):
        store.manifest(vs[0])


def test_delta_base_vanished_falls_back_to_full(cluster):
    rng = np.random.default_rng(2)
    tree = _delta_tree(rng, n_leaves=4)
    store = WeightStore("w_fall")
    for _ in range(4):  # roll versions so v1 retires
        store.publish(tree, durable=True)
    v = store.publish(tree, durable=True, delta_from=1)  # retired base
    vs = store.stats()["versions"][str(v)]
    assert vs["bytes_reused"] == 0  # full publish, no silent aliasing
    pulled = store.pull(v)
    for k in tree:
        np.testing.assert_array_equal(pulled[k], tree[k])


def test_quantized_publish_pull_and_compose_with_delta(cluster):
    rng = np.random.default_rng(3)
    tree = _delta_tree(rng)
    raw = sum(a.nbytes for a in tree.values())
    store = WeightStore("w_quant")
    v1 = store.publish(tree, durable=True, compression="int8")
    p1 = store.pull(v1)
    for k in tree:
        rel = np.abs(p1[k] - tree[k]).max() / np.abs(tree[k]).max()
        assert rel < 0.02, (k, rel)
    vs = store.stats()["versions"]
    assert vs[str(v1)]["bytes_published"] < 0.3 * raw
    dst_mesh = MeshSpec((2,), ("data",), ("h0", "h1"))
    dst = ShardedTreeSpec.from_tree(tree, dst_mesh, default_part=("data",))
    shards = store.pull_shards(dst, "h0", v1)
    box = next(iter(shards["l0"]))
    np.testing.assert_array_equal(shards["l0"][box], p1["l0"][:64])
    # a delta on an unchanged tree: zero new bytes, pulls match the base
    v2 = store.publish(tree, durable=True, delta_from=v1,
                       compression="int8")
    assert store.stats()["versions"][str(v2)]["bytes_published"] == 0
    p2 = store.pull(v2)
    for k in tree:
        np.testing.assert_array_equal(p2[k], p1[k])


def test_plain_publish_unchanged_by_compression_tier(cluster):
    rng = np.random.default_rng(4)
    tree = _delta_tree(rng, n_leaves=3)
    store = WeightStore("w_plain")
    v = store.publish(tree, durable=True)
    man = store.manifest(v)
    for c in man["chunks"].values():
        assert c["enc"] is None
        assert c["sha"]  # content address recorded for future deltas
    pulled = store.pull(v)
    for k in tree:
        np.testing.assert_array_equal(pulled[k], tree[k])


def test_durable_root_restores_without_a_cluster(cluster, tmp_path):
    """A durable publish on a store with a ``durable_root`` lands in the
    checkpoint plane; ``load_durable`` rebuilds it with no store actor."""
    from ray_tpu_torch.weights import durable_versions, load_durable

    rng = np.random.default_rng(5)
    tree = _delta_tree(rng, n_leaves=2)
    store = WeightStore("w_cold", durable_root=str(tmp_path))
    v = store.publish(tree, durable=True, compression="bf16")
    pulled = store.pull(v)
    assert set(durable_versions(str(tmp_path), "w_cold")) == {v}
    got_v, got = load_durable(str(tmp_path), "w_cold")
    assert got_v == v
    for k in tree:
        np.testing.assert_array_equal(got[k], pulled[k])
    store.shutdown()


# ---------------------------------------------------------------------------
# against the JAX store, on one tree from a seed
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_store():
    """The JAX package's store in its runtime's local mode (actors run in
    this process), beside the port's cluster."""
    pytest.importorskip("flax")
    import ray_tpu

    ray_tpu.shutdown()
    ray_tpu.init(local_mode=True)
    yield ray_tpu
    ray_tpu.shutdown()


def _manifest_view(man):
    """What two packages' manifests must agree on: per chunk key (leaf and
    box), the sha256, the stored bytes and dtype, and the encoding; the
    skeleton and the spec."""
    return {"chunks": {k: (c["sha"], c["nbytes"], c["dtype"], c["enc"])
                       for k, c in man["chunks"].items()},
            "num_chunks": len(man["chunks"]),
            "skeleton": man["skeleton"], "spec": man["spec"]}


def _reused(stats, version):
    return stats["versions"][str(version)]["bytes_reused"]


@pytest.mark.parametrize("compression", [None, "int8", "bf16"])
def test_manifests_equal_the_jax_store(cluster, jax_store, compression):
    """The same numpy tree and the same delta through both stores: equal
    manifests and reused sets, and pulls that agree — bit for bit plain,
    within the codec's bound quantized."""
    from ray_tpu.weights import WeightStore as JaxWeightStore

    rng = np.random.default_rng(11)
    tree = {"embed": rng.normal(size=(96, 40)).astype(np.float32),
            "layers": {"w": rng.normal(size=(3, 40, 40)).astype(np.float32),
                       "scale": np.ones(40, np.float32)},
            "step": np.arange(4, dtype=np.int32)}
    tree2 = {**tree, "embed": tree["embed"] * 0.5}
    name = f"cmp_{compression}"
    ours, theirs = WeightStore(name), JaxWeightStore(name)
    got, want = {}, {}
    for side, store in (("port", ours), ("jax", theirs)):
        v1 = store.publish(tree, durable=True, compression=compression)
        v2 = store.publish(tree2, durable=True, delta_from=v1,
                           compression=compression)
        out = got if side == "port" else want
        out["man"] = [_manifest_view(store.manifest(v)) for v in (v1, v2)]
        out["reused"] = [_reused(store.stats(), v) for v in (v1, v2)]
        out["pull"] = store.pull(v2)
    assert got["man"] == want["man"]
    assert got["reused"] == want["reused"]
    assert got["reused"][1] > 0
    keys = [k for k, c in got["man"][1]["chunks"].items()]
    assert keys and all("|" in k for k in keys)

    from ray_tpu_torch.weights.spec import flatten_tree

    _, mine = flatten_tree(got["pull"])
    _, ref = flatten_tree(want["pull"])
    _, raw = flatten_tree(tree2)
    for leaf, x in raw.items():
        if compression is None or not np.issubdtype(x.dtype, np.floating):
            np.testing.assert_array_equal(mine[leaf], x)
            np.testing.assert_array_equal(ref[leaf], x)
            continue
        if compression == "bf16":  # a narrowing: exactly the JAX one's
            np.testing.assert_array_equal(mine[leaf], ref[leaf])
            bound = np.abs(x) * 2.0 ** -8
        else:  # int8: half a step of the block's scale, per block of 256
            flat = np.abs(x).reshape(-1)
            pad = (-flat.size) % 256
            amax = np.pad(flat, (0, pad)).reshape(-1, 256).max(axis=1)
            step = np.repeat(amax / 127.0, 256)[:flat.size].reshape(x.shape)
            bound = step * (0.5 + 1e-6)
            # the JAX encoder's scale may differ by an ulp: codes may too,
            # by one, where a value sits on a rounding boundary
            assert np.all(np.abs(mine[leaf] - ref[leaf]) <= 2 * bound)
        assert np.all(np.abs(mine[leaf] - x) <= bound), leaf
