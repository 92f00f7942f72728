"""The port's checkpoint plane (``ray_tpu_torch/ckpt``) against the JAX
package's (``ray_tpu/ckpt``), on the CPU.

The port mirrors ``tests/test_ckpt_plane.py``'s tests that need no cluster
(dedup and diff, retention, crash mid-save, the async save's bounded pause,
the refused partial save) and its elastic 4 -> 2 restore, with the hosts as
plain calls of ``save_host_shards`` per host name. Both packages write one
format: the same numpy tree gives the same manifest leaves and chunk hashes,
and each package restores the other's checkpoints, whole and in shards. A
checkpoint the JAX ``TrainStepBundle`` wrote resumes in the port, and the
port's own save, restore and resume equals the uninterrupted run bit for
bit.
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

pytest.importorskip("flax")  # the JAX reference; the card's machine lacks it

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ray_tpu import ckpt as jax_ckpt  # noqa: E402
from ray_tpu.ckpt import manifest as jax_mf  # noqa: E402
from ray_tpu.models.transformer import CONFIGS as JAX_CONFIGS  # noqa: E402
from ray_tpu.parallel import TrainStepBundle as JaxBundle  # noqa: E402
from ray_tpu.parallel import create_mesh  # noqa: E402
from ray_tpu.parallel import make_optimizer as jax_make_optimizer  # noqa: E402
from ray_tpu_torch import ckpt  # noqa: E402
from ray_tpu_torch.ckpt import manifest as mf  # noqa: E402
from ray_tpu_torch.models import (CONFIGS, from_jax_opt_state,  # noqa: E402
                                  from_jax_params)
from ray_tpu_torch.parallel import (OptState, TrainStepBundle,  # noqa: E402
                                    make_optimizer)
from ray_tpu.weights import spec as jax_spec  # noqa: E402
from ray_tpu_torch.weights import spec as port_spec  # noqa: E402
from test_torch_ckpt_tier import _norm  # noqa: E402


def _tree(scale: float = 1.0, n: int = 1 << 16):
    return {
        "layers": {
            "w0": np.full((n,), scale, np.float32),
            "w1": np.arange(n, dtype=np.float32) * scale,
        },
        "opt": {"step": int(scale), "lr": 0.1},
    }


PACKAGES = {"port": ckpt, "jax": jax_ckpt}
MANIFESTS = {"port": mf, "jax": jax_mf}
SPECS = {"port": port_spec, "jax": jax_spec}


def _same(scenario, tmp_path):
    """Run ``scenario(package_name, root)`` for the port and for the JAX
    package, each in a directory of its own, and assert that what they
    observed agrees once checkpoint ids, directories and wall-clock fields
    are normalised (``test_torch_ckpt_tier._norm``)."""
    records = {}
    for name in PACKAGES:
        root = tmp_path / name
        root.mkdir()
        records[name] = _norm(scenario(name, root), [str(root)])
    assert records["port"] == records["jax"]
    return records["port"]


def _arrays(tree):
    """A tree's array leaves as (dtype, shape, bytes), comparable by ==."""
    if isinstance(tree, dict):
        return {k: _arrays(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return (tree.dtype.str, tree.shape, tree.tobytes())
    return tree


def _chunks(manifest):
    return {path: (e.kind, tuple(e.shape), e.dtype, sorted(e.chunks.items()))
            for path, e in manifest.leaves.items()}


# ---------------------------------------------------------------------------
# the JAX plane's own tests, through both packages
# ---------------------------------------------------------------------------


def _incremental_dedup(name, root):
    c = PACKAGES[name]
    store = c.CheckpointStore(str(root), name="dedup")
    m1 = c.save_checkpoint(store, _tree(1.0), step=1)
    assert m1.stats["bytes_reused"] == 0
    # second save: only w0 changes — w1 and the opt leaves dedup
    tree2 = _tree(1.0)
    tree2["layers"]["w0"][:] = 2.0
    m2 = c.save_checkpoint(store, tree2, step=2)
    assert m2.parent == m1.ckpt_id
    diff = c.diff_manifests(m1, m2)
    assert diff["changed_leaves"] == ["layers/w0"]
    assert diff["shared_bytes"] == m2.stats["bytes_reused"]
    out = c.restore_tree(store)
    assert _arrays(out) == _arrays(tree2)
    return {"stats": [m1.stats, m2.stats], "parent": m2.parent,
            "diff": diff, "chunks": [_chunks(m1), _chunks(m2)],
            "restored": _arrays(out)}


def test_incremental_save_dedup(tmp_path):
    record = _same(_incremental_dedup, tmp_path)
    assert record["stats"][1]["chunks_written"] == 1  # just the new w0
    assert record["stats"][1]["dedup_ratio"] > 0.45  # w1 is half the bytes


def _retention(name, root):
    c, m = PACKAGES[name], MANIFESTS[name]
    store = c.CheckpointStore(str(root), name="ret")
    ids = [c.save_checkpoint(store, _tree(float(i)), step=i).ckpt_id
           for i in range(5)]
    store.pin(ids[0])
    out = store.retention(keep_last=2, grace_s=0)
    left = store.list_ids()
    assert ids[0] in left and ids[3] in left and ids[4] in left
    assert ids[1] not in left and ids[2] not in left
    np.testing.assert_array_equal(
        c.restore_tree(store, ids[0])["layers"]["w1"],
        _tree(0.0)["layers"]["w1"])
    # a young orphan chunk (an in-flight save whose manifest has not
    # committed yet) survives a default-grace retention pass
    h, created = m.write_chunk(store.root, b"in-flight chunk bytes")
    assert created
    again = store.retention(keep_last=2)
    assert os.path.exists(m.chunk_path(store.root, h))
    return {"retention": out, "left": sorted(left),
            "drops": store.stats()["drops"], "again": again,
            "pool": sorted(os.listdir(os.path.join(store.root, "chunks")))}


def test_retention_keeps_pins_and_counts_drops(tmp_path):
    record = _same(_retention, tmp_path)
    assert record["retention"]["dropped_manifests"] == 2  # ids[1], ids[2]
    assert record["retention"]["dropped_chunks"] > 0


def _crash_mid_save(name, root, monkeypatch):
    c, m = PACKAGES[name], MANIFESTS[name]
    store = c.CheckpointStore(str(root), name="torn")
    good = c.save_checkpoint(store, _tree(1.0), step=1)
    assert store.latest_id() == good.ckpt_id

    def _die(root, manifest):
        raise OSError("simulated crash before manifest rename")

    monkeypatch.setattr(m, "commit", _die)
    saver = c.CheckpointSaver(store)
    saver.save(_tree(2.0), step=2)
    with pytest.raises(RuntimeError, match="background checkpoint save") as ei:
        saver.wait()
    monkeypatch.undo()

    latest = store.latest_id()
    assert latest == good.ckpt_id
    out = c.restore_tree(store)
    assert _arrays(out) == _arrays(_tree(1.0))
    # a literally torn manifest file is skipped by listing AND by the
    # LATEST pointer validation
    torn = os.path.join(store.root, "manifests", "stepzzz-torn.json")
    with open(torn, "w") as f:
        f.write('{"ckpt_id": "stepzzz-torn", "step":')  # truncated JSON
    m.atomic_write(os.path.join(store.root, "LATEST"),
                   json.dumps({"ckpt_id": "stepzzz-torn"}).encode())
    assert store.latest_id() == good.ckpt_id
    assert "stepzzz-torn" not in store.list_ids()
    return {"error": str(ei.value), "latest": latest,
            "ids": store.list_ids(), "restored": _arrays(out)}


def test_crash_mid_save_latest_unmoved(tmp_path, monkeypatch):
    _same(lambda name, root: _crash_mid_save(name, root, monkeypatch),
          tmp_path)


def _async_save(name, root):
    """3 steps with a blocking save each, then 3 with the async saver, on
    torch tensors in the port and numpy arrays in the JAX package. Returns
    the record both packages must agree on and the port's timings."""
    c = PACKAGES[name]
    n = 1 << 20  # 4 MiB per leaf: serialize+hash+write dwarfs the snapshot
    zeros = torch.zeros if name == "port" else (
        lambda k: np.zeros(k, np.float32))
    state = {"w": zeros(n), "m": zeros(n)}
    step_s = 0.12  # simulated step compute, the window writes overlap into

    def step():
        state["w"] += 1.0  # mutate in place: the snapshot must isolate
        state["m"] *= 0.9
        time.sleep(step_s)

    bstore = c.CheckpointStore(str(root / "blocking"))
    saves = []
    t0 = time.perf_counter()
    for i in range(3):
        step()
        t1 = time.perf_counter()
        c.save_checkpoint(bstore, state, step=i)
        saves.append(time.perf_counter() - t1)
    blocking_total = time.perf_counter() - t0

    state["w"][:] = 0.0
    state["m"][:] = 0.0
    astore = c.CheckpointStore(str(root / "async"))
    saver = c.CheckpointSaver(astore)
    pauses = []
    overlapped = 0
    t0 = time.perf_counter()
    for i in range(3):
        step()
        t1 = time.perf_counter()
        saver.save(state, step=i)
        pauses.append(time.perf_counter() - t1)
        if saver.in_flight():
            overlapped += 1
    manifest = saver.wait()
    async_total = time.perf_counter() - t0
    assert manifest is not None and astore.latest_id() == manifest.ckpt_id
    # the tensors' in-place updates after save() did not reach the snapshot
    restored = c.restore_tree(astore)
    np.testing.assert_array_equal(restored["w"], np.full(n, 3.0, np.float32))
    record = {"blocking": [_chunks(bstore.read(i))
                           for i in sorted(bstore.list_ids())],
              "async": [_chunks(astore.read(i))
                        for i in sorted(astore.list_ids())],
              "restored": _arrays(restored)}
    timings = dict(saves=saves, blocking_total=blocking_total, pauses=pauses,
                   overlapped=overlapped, async_total=async_total,
                   step_s=step_s, stats=manifest.stats)
    return record, timings


def test_async_save_overlaps_train_loop(tmp_path):
    timings = {}

    def scenario(name, root):
        record, timings[name] = _async_save(name, root)
        return record

    _same(scenario, tmp_path)
    # the port's timings, held as the JAX test holds its own
    t = timings["port"]
    blocking_save_s = sorted(t["saves"])[1]
    assert sum(t["pauses"]) / len(t["pauses"]) < 0.6 * blocking_save_s, (
        t["pauses"], blocking_save_s)
    assert t["overlapped"] >= 1
    assert t["async_total"] < t["blocking_total"], t
    assert t["stats"]["pause_s"] < t["stats"]["write_s"] + t["step_s"]


def _sharded_spec(num_hosts, s=port_spec):
    mesh = s.MeshSpec((num_hosts,), ("data",),
                      tuple(f"rank{i}" for i in range(num_hosts)))
    return s.ShardedTreeSpec(
        mesh=mesh,
        parts={"opt/m": ("data", None), "opt/v": ("data", None)},
        meta={"opt/m": ((8, 4), "<f4"), "opt/v": ((8, 4), "<f4")})


def _global_tree():
    return {"opt/m": np.arange(32, dtype=np.float32).reshape(8, 4),
            "opt/v": np.arange(32, 64, dtype=np.float32).reshape(8, 4)}


def _save_hosts(store, spec, cid, ranks, step=7, name="port"):
    """Each host of ``spec``'s mesh in ``ranks`` saves its dim-0 shard
    alone, as the JAX test's host actors do."""
    c, s = PACKAGES[name], SPECS[name]
    full = _global_tree()
    for rank in ranks:
        host = spec.mesh.hosts[rank]
        shards = {}
        for leaf in spec.meta:
            box = s.host_boxes(spec.mesh, spec.part_of(leaf),
                               spec.meta[leaf][0], host)[0]
            shard = full[leaf][s.box_slices(box)]
            # a host's shard may be a tensor: the port's saver copies it
            shards[leaf] = {box: torch.from_numpy(shard) if name == "port"
                            else shard}
        c.save_host_shards(store, cid, spec, host, shards, step=step)


def _elastic(name, root):
    c = PACKAGES[name]
    store = c.CheckpointStore(str(root / "elastic"), name="elastic")
    spec4, spec2 = (_sharded_spec(k, SPECS[name]) for k in (4, 2))
    cid = c.new_ckpt_id(7)
    _save_hosts(store, spec4, cid, range(4), name=name)
    assert c.commit_host_parts(store, cid, spec4, step=7).ckpt_id == cid

    man = store.read(cid)
    plan = c.restore_plan(man, spec2)
    assert plan.no_gather()
    full = _global_tree()
    assert plan.max_host_leaf_bytes("opt/m") < full["opt/m"].nbytes
    hosts = []
    for rank, host in enumerate(spec2.mesh.hosts):
        shards, stats = c.restore_shards(store, spec2, host, cid)
        assert stats["no_gather"]
        # each of the 2 hosts reads exactly its half of every leaf
        assert stats["bytes_read"] == sum(a.nbytes for a in full.values()) // 2
        for leaf, arr in full.items():
            (box, shard), = shards[leaf].items()
            assert box == ((rank * 4, rank * 4 + 4), (0, 4))
            np.testing.assert_array_equal(shard,
                                          arr[rank * 4:(rank + 1) * 4])
        hosts.append({"stats": stats,
                      "shards": {leaf: {str(b): _arrays(a) for b, a in
                                        s.items()}
                                 for leaf, s in shards.items()}})
    return {"chunks": _chunks(man), "hosts": hosts,
            "max_host_leaf_bytes": plan.max_host_leaf_bytes("opt/m")}


def test_elastic_4_to_2_restore_no_gather(tmp_path):
    _same(_elastic, tmp_path)


def test_commit_refuses_partial_sharded_save(tmp_path):
    store = ckpt.CheckpointStore(str(tmp_path), name="partial")
    spec = _sharded_spec(4)
    cid = ckpt.new_ckpt_id(1)
    _save_hosts(store, spec, cid, range(3))  # only 3 of 4 hosts land
    with pytest.raises(TimeoutError, match="refusing"):
        ckpt.commit_host_parts(store, cid, spec, timeout=0.3)
    assert store.latest_id() is None


# ---------------------------------------------------------------------------
# one format: the port and the JAX package read each other's checkpoints
# ---------------------------------------------------------------------------


def _parity_tree():
    rng = np.random.default_rng(0)
    return {"f32": rng.standard_normal((8, 6)).astype(np.float32),
            "i32": rng.integers(-1000, 1000, (8, 3), dtype=np.int32),
            "nest": {"i64": rng.integers(-2**40, 2**40, (8,),
                                         dtype=np.int64),
                     "scalar": np.float32(2.5).reshape(())},
            "meta": {"step": 3, "lr": 0.1, "name": "run"}}  # a pickled leaf


def test_same_tree_gives_the_same_manifest(tmp_path):
    tree = _parity_tree()
    port = ckpt.save_checkpoint(ckpt.CheckpointStore(str(tmp_path / "p")),
                                tree, step=3)
    ref = jax_ckpt.save_checkpoint(
        jax_ckpt.CheckpointStore(str(tmp_path / "j")), tree, step=3)
    assert _chunks(port) == _chunks(ref)
    assert port.skeleton == ref.skeleton
    assert port.stats["bytes_total"] == ref.stats["bytes_total"]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_restore_tree_reads_the_other_package(tmp_path, writer, reader):
    tree = _parity_tree()
    w, r = PACKAGES[writer], PACKAGES[reader]
    w.save_checkpoint(w.CheckpointStore(str(tmp_path)), tree, step=1)
    out = r.restore_tree(r.CheckpointStore(str(tmp_path)))
    for path, want in (("f32", tree["f32"]), ("i32", tree["i32"])):
        assert out[path].dtype == want.dtype
        np.testing.assert_array_equal(out[path], want)
    for key, want in tree["nest"].items():
        assert out["nest"][key].dtype == want.dtype
        np.testing.assert_array_equal(out["nest"][key], want)
    assert out["meta"] == tree["meta"]


@pytest.mark.parametrize("hosts", [2, 4])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_restore_tree_shards_reads_the_other_package(tmp_path, writer,
                                                     reader, hosts):
    tree = {k: v for k, v in _parity_tree().items() if k in ("f32", "i32")}
    w, r = PACKAGES[writer], PACKAGES[reader]
    w.save_checkpoint(w.CheckpointStore(str(tmp_path)), tree, step=1)
    rows = 8 // hosts
    for rank in range(hosts):
        out = r.restore_tree_shards(r.CheckpointStore(str(tmp_path)), hosts,
                                    rank)
        assert out["stats"]["bytes_read"] == sum(
            a.nbytes for a in tree.values())  # the unsharded save's chunks
        for key, arr in tree.items():
            np.testing.assert_array_equal(
                out["tree"][key], arr[rank * rows:(rank + 1) * rows])


def test_sharded_restore_reads_a_jax_sharded_save(tmp_path):
    """4 JAX hosts save their shards; the port restores onto 2, reading
    only each host's share, with ``no_gather``."""
    jstore = jax_ckpt.CheckpointStore(str(tmp_path))
    jspec = _sharded_spec(4, jax_spec)
    cid = jax_ckpt.new_ckpt_id(5)
    _save_hosts(jstore, jspec, cid, range(4), step=5, name="jax")
    jax_ckpt.commit_host_parts(jstore, cid, jspec, step=5)
    store = ckpt.CheckpointStore(str(tmp_path))
    full = _global_tree()
    for rank, host in enumerate(_sharded_spec(2).mesh.hosts):
        shards, stats = ckpt.restore_shards(store, _sharded_spec(2), host)
        assert stats["no_gather"]
        assert stats["bytes_read"] == sum(a.nbytes for a in full.values()) // 2
        for leaf, arr in full.items():
            (shard,) = shards[leaf].values()
            np.testing.assert_array_equal(shard,
                                          arr[rank * 4:(rank + 1) * 4])


# ---------------------------------------------------------------------------
# training state: a JAX-written checkpoint resumes in the port; the port's
# own save, restore and resume is exact
# ---------------------------------------------------------------------------

# 2 layers at head_dim 64, fp32 compute (tests/test_torch_train.py's shape)
SHAPE = dict(d_model=128, n_heads=2, n_kv_heads=1)
OPT = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
BATCH, SEQ = 4, 32
LOSS_RTOL = 1e-5  # the same fp32 arithmetic in other sum orders
ADAM_RATIO = 1.2  # |m_hat / (sqrt(v_hat) + eps)| < 1.2 for b1 .9, b2 .95


def _tiny_configs():
    jcfg = dataclasses.replace(JAX_CONFIGS["tiny"], dtype=jnp.float32, **SHAPE)
    tcfg = dataclasses.replace(CONFIGS["tiny"], dtype=torch.float32, **SHAPE)
    return jcfg, tcfg


def test_resume_from_a_jax_written_checkpoint(tmp_path):
    """The JAX bundle takes 2 steps, saves {"params", "opt"} with
    ``ray_tpu.ckpt`` and takes 2 more. The port restores that checkpoint
    with its own ``restore_tree`` and takes the same 2 steps: the losses to
    LOSS_RTOL, the params within Adam's bound 2 x 1.2 x sum(lr_t)."""
    jcfg, tcfg = _tiny_configs()
    mesh = create_mesh({"data": 1, "fsdp": 1, "seq": 1, "tensor": 1,
                        "expert": 1}, devices=jax.devices()[:1])
    jbundle = JaxBundle(jcfg, mesh, optimizer=jax_make_optimizer(**OPT))
    params, opt = jbundle.init(jax.random.PRNGKey(0))
    batch = jbundle.make_batch(np.random.default_rng(0), BATCH, SEQ)
    losses = []
    for i in range(4):
        if i == 2:
            jax_ckpt.save_checkpoint(jax_ckpt.CheckpointStore(str(tmp_path)),
                                     {"params": params, "opt": opt}, step=2)
        params, opt, loss = jbundle.step(params, opt, batch)
        losses.append(float(loss))
    want_params = from_jax_params(jax.tree_util.tree_map(np.asarray, params))

    tree = ckpt.restore_tree(ckpt.CheckpointStore(str(tmp_path)))
    t_opt = from_jax_opt_state(tree["opt"])
    assert isinstance(t_opt, OptState) and t_opt.count == 2
    t_params = from_jax_params(tree["params"])
    assert set(t_opt.mu) == set(t_params)
    bundle = TrainStepBundle(tcfg, device="cpu",
                             optimizer=make_optimizer(**OPT))
    t_batch = bundle.make_batch(np.random.default_rng(0), BATCH, SEQ)
    got = []
    for _ in range(2):
        t_params, t_opt, loss = bundle.step(t_params, t_opt, t_batch)
        got.append(loss.item())
    np.testing.assert_allclose(got, losses[2:], rtol=LOSS_RTOL)
    sched = make_optimizer(**OPT).schedule
    atol = 2 * ADAM_RATIO * sum(sched(t) for t in (2, 3))
    worst = max((t_params[k].detach() - want_params[k]).abs().max().item()
                for k in want_params)
    assert worst <= atol, f"params part by {worst:.3e} > {atol:.3e}"


CONFIG_KEYS = ("ckpt_io_threads", "ckpt_io_inflight_bytes",
               "ckpt_io_coalesce_gap", "ckpt_mirror_enabled",
               "ckpt_multipart_bytes", "ckpt_sweep_grace_s")


@pytest.mark.parametrize("key", CONFIG_KEYS)
def test_config_keys_read_the_jax_packages_environment(key, monkeypatch):
    from ray_tpu._private.config import RAY_CONFIG as JAX_CONFIG
    from ray_tpu_torch._private.config import RAY_CONFIG

    assert getattr(RAY_CONFIG, key) == getattr(JAX_CONFIG, key)
    default = getattr(JAX_CONFIG, key)
    value = {bool: "0", int: "7", float: "1.5"}[type(default)]
    monkeypatch.setenv("RAY_TPU_" + key.upper(), value)
    assert getattr(RAY_CONFIG, key) == getattr(JAX_CONFIG, key) != default


def test_jax_optax_states_come_back_as_named_tuples(tmp_path):
    """The optax classes a JAX-written optimizer state names are rebuilt
    from the port's table (the port imports no optax:
    tests/test_torch_imports.py); others degrade to tuples."""
    import optax

    from ray_tpu_torch.weights.spec import OPTAX_STATES

    state = (optax.EmptyState(),
             (optax.ScaleByAdamState(count=np.int32(3),
                                     mu={"w": np.ones(2, np.float32)},
                                     nu={"w": np.zeros(2, np.float32)}),
              optax.ScaleByScheduleState(count=np.int32(3))),
             optax.MaskedState(inner_state=()))
    jax_ckpt.save_checkpoint(jax_ckpt.CheckpointStore(str(tmp_path)),
                             {"opt": state})
    out = ckpt.restore_tree(ckpt.CheckpointStore(str(tmp_path)))["opt"]
    adam, sched = out[1]
    assert type(out[0]) is OPTAX_STATES["EmptyState"]
    assert type(adam) is OPTAX_STATES["ScaleByAdamState"]
    assert type(sched) is OPTAX_STATES["ScaleByScheduleState"]
    assert adam._fields == ("count", "mu", "nu") and int(adam.count) == 3
    np.testing.assert_array_equal(adam.mu["w"], np.ones(2, np.float32))
    assert type(out[2]) is tuple  # a class outside the table


def test_port_save_restore_resume_is_exact(tmp_path):
    """2 steps, a save, 2 more: a fresh bundle restored from the save takes
    the same 2 steps bit for bit. ``OptState`` comes back as an OptState
    with every moment an ``nd`` leaf of the manifest."""
    _, tcfg = _tiny_configs()

    def fresh():
        return TrainStepBundle(tcfg, device="cpu",
                               optimizer=make_optimizer(**OPT))

    bundle = fresh()
    params, opt = bundle.init(seed=0)
    batch = bundle.make_batch(np.random.default_rng(0), BATCH, SEQ)
    store = ckpt.CheckpointStore(str(tmp_path))
    saver = ckpt.CheckpointSaver(store)
    losses = []
    for i in range(4):
        if i == 2:
            saver.save({"params": params, "opt": opt}, step=2)
        params, opt, loss = bundle.step(params, opt, batch)
        losses.append(loss.item())
    manifest = saver.wait()
    kinds = {path: e.kind for path, e in manifest.leaves.items()}
    moments = [p for p in kinds if p.startswith(("opt/mu/", "opt/nu/"))]
    assert len(moments) == 2 * len(params)
    assert all(kinds[p] == mf.ND for p in moments)
    assert all(kinds[f"params/{k}"] == mf.ND for k in params)
    assert kinds["opt/count"] == mf.PY

    tree = ckpt.to_torch(ckpt.restore_tree(store), "cpu")
    r_opt = tree["opt"]
    assert isinstance(r_opt, OptState) and r_opt.count == 2
    resumed = fresh()
    r_params = tree["params"]
    got = []
    for _ in range(2):
        r_params, r_opt, loss = resumed.step(r_params, r_opt, batch)
        got.append(loss.item())
    assert got == losses[2:]
    for k, p in params.items():
        assert torch.equal(r_params[k], p), k
        assert torch.equal(r_opt.mu[k], opt.mu[k]), k
        assert torch.equal(r_opt.nu[k], opt.nu[k]), k


def test_bf16_leaf_raises_naming_it(tmp_path):
    store = ckpt.CheckpointStore(str(tmp_path))
    with pytest.raises(TypeError, match="'layer/w'"):
        ckpt.save_checkpoint(
            store, {"layer": {"w": torch.zeros(2, dtype=torch.bfloat16)}})
    assert store.latest_id() is None
