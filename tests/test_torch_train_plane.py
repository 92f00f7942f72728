"""The port's train plane on its runtime, on the CPU: a mirror of
``tests/test_train.py``'s cluster tests on ``TorchTrainer`` (the e2e run
with checkpoints, the restart after ``os._exit``, ``TrainingFailedError``,
grad sync over gloo at world 2), ``CheckpointManager`` and the scaling
policies against the JAX ones in-process, the collective actors against the
JAX ``CpuStoreGroup``'s store, and the slice as a whole: a tiny LM from JAX
parameters trained by ``TorchTrainer`` on the declared card
(``RAY_TPU_TORCH_GPUS=1``, the bundle on ``device="cpu"``), checkpointed,
crashed once and resumed, each step's loss held against the JAX
``TrainStepBundle``; and one fit with ``cloudpickle``, ``msgpack`` and the
JAX package blocked in every process.

Every cluster call carries its own timeout. Nothing here imports JAX at
module level: the workers import this module to reach its loops."""

import asyncio
import json
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.collective import CollectiveActorMixin
from ray_tpu_torch.train import (Checkpoint, FailureConfig, RunConfig,
                                 ScalingConfig, TorchTrainer)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 60  # seconds, each cluster call
FIT_T = 180  # seconds, each fit


def fit_within(trainer, seconds: float = FIT_T):
    """``trainer.fit()`` bounded in time: a fit that hangs fails its test
    rather than stalling the suite. Re-raises what the fit raised."""
    box = {}

    def run():
        try:
            box["result"] = trainer.fit()
        except BaseException as e:  # handed to the test's thread
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"fit did not return within {seconds} s"
    if "error" in box:
        raise box["error"]
    return box["result"]


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    saved = os.environ.get("RAY_TPU_TORCH_GPUS")
    os.environ["RAY_TPU_TORCH_GPUS"] = "1"  # the raylet detects one card
    try:
        ray_tpu_torch.init(num_cpus=4)
    finally:
        if saved is None:
            os.environ.pop("RAY_TPU_TORCH_GPUS")
        else:
            os.environ["RAY_TPU_TORCH_GPUS"] = saved
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# tests/test_train.py's cluster tests on TorchTrainer
# ---------------------------------------------------------------------------


def _sgd_loop(config):
    """A tiny numpy "training" loop with report + checkpoint."""
    import json

    import numpy as np

    from ray_tpu_torch import train

    ctx = train.get_context()
    w = np.zeros(4)
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        with open(os.path.join(ckpt.as_directory(), "state.json")) as f:
            state = json.load(f)
        w = np.array(state["w"])
        start = state["step"]
    target = np.arange(4.0)
    for step in range(start, config["steps"]):
        w = w + 0.5 * (target - w)
        loss = float(((target - w) ** 2).mean())
        if (step + 1) % config["ckpt_every"] == 0 and ctx.get_world_rank() == 0:
            import tempfile

            with tempfile.TemporaryDirectory() as d:
                with open(os.path.join(d, "state.json"), "w") as f:
                    json.dump({"w": w.tolist(), "step": step + 1}, f)
                train.report({"loss": loss, "step": step + 1},
                             checkpoint=Checkpoint.from_directory(d))
        else:
            train.report({"loss": loss, "step": step + 1})
    return {"final_loss": loss, "rank": ctx.get_world_rank()}


def test_torch_trainer_e2e(cluster, tmp_path):
    trainer = TorchTrainer(
        _sgd_loop,
        train_loop_config={"steps": 6, "ckpt_every": 2},
        scaling_config=ScalingConfig(num_workers=2,
                                     resources_per_worker={"CPU": 1.0}),
        run_config=RunConfig(storage_path=str(tmp_path), name="e2e"),
    )
    result = fit_within(trainer)
    assert result.error is None
    assert result.metrics["step"] == 6
    assert result.metrics["loss"] < 1e-2
    assert result.checkpoint is not None
    assert os.path.exists(os.path.join(result.checkpoint.path, "state.json"))


def _flaky_loop(config):
    import json

    from ray_tpu_torch import train

    ctx = train.get_context()
    marker = config["marker"]
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        with open(os.path.join(ckpt.as_directory(), "state.json")) as f:
            start = json.load(f)["step"]
    for step in range(start, config["steps"]):
        if step == 3 and ctx.get_world_rank() == 0 and not os.path.exists(marker):
            open(marker, "w").close()
            os._exit(1)  # simulate worker death mid-run
        if ctx.get_world_rank() == 0:
            import tempfile

            with tempfile.TemporaryDirectory() as d:
                with open(os.path.join(d, "state.json"), "w") as f:
                    json.dump({"step": step + 1}, f)
                train.report({"step": step + 1},
                             checkpoint=Checkpoint.from_directory(d))
        else:
            train.report({"step": step + 1})
    return {"done": True, "resumed_from": start}


def test_failure_policy_restart(cluster, tmp_path):
    marker = str(tmp_path / "died_once")
    trainer = TorchTrainer(
        _flaky_loop,
        train_loop_config={"steps": 5, "marker": marker},
        scaling_config=ScalingConfig(num_workers=2,
                                     resources_per_worker={"CPU": 1.0}),
        run_config=RunConfig(storage_path=str(tmp_path), name="flaky",
                             failure_config=FailureConfig(max_failures=2)),
    )
    result = fit_within(trainer)
    assert result.error is None
    assert result.metrics["step"] == 5
    assert os.path.exists(marker)  # the crash really happened


def test_training_failed_raises(cluster, tmp_path):
    def always_fails(config):
        raise RuntimeError("bad loop")

    from ray_tpu_torch.train import TrainingFailedError

    trainer = TorchTrainer(
        always_fails,
        train_loop_config={},
        scaling_config=ScalingConfig(num_workers=1,
                                     resources_per_worker={"CPU": 1.0}),
        run_config=RunConfig(storage_path=str(tmp_path), name="failing"),
    )
    with pytest.raises(TrainingFailedError, match="bad loop"):
        fit_within(trainer)


def _grad_sync_loop(config):
    """Train-loop side of the wiring test: allreduce a deterministic tree
    through the context's bucket reducer and report what came back."""
    import torch

    from ray_tpu_torch import train

    ctx = train.get_context()
    assert ctx.grad_sync is not None
    tree = {"w": torch.full((8, 4), float(ctx.get_world_rank() + 1)),
            "b": torch.ones(4)}
    red = ctx.make_bucket_reducer(tree)
    try:
        out = red.reduce_tree(tree)
    finally:
        red.shutdown()
    train.report({"w_sum": float(out["w"][0, 0]),
                  "b_sum": float(out["b"][0]), "step": 1})
    return {"ok": True}


def test_trainer_grad_sync_e2e(cluster, tmp_path):
    trainer = TorchTrainer(
        _grad_sync_loop,
        train_loop_config={},
        scaling_config=ScalingConfig(num_workers=2,
                                     resources_per_worker={"CPU": 1.0},
                                     grad_sync_backend="gloo",
                                     grad_sync_bucket_bytes=1 << 10),
        run_config=RunConfig(storage_path=str(tmp_path), name="gsync"),
    )
    result = fit_within(trainer)
    assert result.error is None
    assert result.metrics["w_sum"] == 3.0  # 1 + 2 across the two ranks
    assert result.metrics["b_sum"] == 2.0


def test_grad_sync_compression_needs_gloo():
    """The JAX refusal: the explicit quantized exchange runs on the CPU
    tier only (``worker_group.py:55-63``)."""
    from ray_tpu_torch.train.worker_group import TrainWorker

    worker = TrainWorker.cls(0, 2)
    with pytest.raises(ValueError, match="grad_sync_backend='gloo'"):
        worker.setup_grad_sync("g", "nccl", 1 << 10, compression="int8")


# ---------------------------------------------------------------------------
# the collective actors against the JAX CpuStoreGroup's store
# ---------------------------------------------------------------------------


@ray_tpu_torch.remote(num_cpus=1)
class Peer(CollectiveActorMixin):
    def __init__(self, rank, world):
        self.rank = rank
        self.world = world

    def ops(self, x):
        from ray_tpu_torch import collective as col

        out = {"allreduce": col.allreduce(torch.as_tensor(x)),
               "broadcast": col.broadcast(torch.as_tensor(x), src_rank=1),
               "allgather": col.allgather(torch.as_tensor(x))}
        col.destroy_collective_group()
        return out


def _store_results(xs):
    """Each rank's allreduce, broadcast (from rank 1) and allgather as the
    JAX ``CpuStoreGroup`` computes them: through its ``CollectiveStore``'s
    ``collect``, every rank's call in one event loop."""
    from ray_tpu.collective.collective_group import CollectiveStore

    store = CollectiveStore(len(xs))

    async def one(key, op):
        return await asyncio.gather(*(store.collect(key, r, np.asarray(x), op)
                                      for r, x in enumerate(xs)))

    async def run():
        summed = await one("ar:1", "sum")
        gathered = await one("bc:2", None)
        return {"allreduce": summed,
                "broadcast": [g[1] for g in gathered],
                # CpuStoreGroup's allgather is the ranks' list; TorchGroup's
                # their concatenation along axis 0
                "allgather": [np.concatenate(g, axis=0)
                              for g in await one("ag:3", None)]}

    return asyncio.run(run())


def test_collective_actors_match_the_jax_store(cluster):
    """``create_collective_group`` over two actors with the mixin's hooks on
    gloo (the JAX ``backend="cpu"``): ``allreduce``, ``broadcast`` and
    ``allgather`` equal the JAX ``CpuStoreGroup``'s on the same inputs."""
    pytest.importorskip("jax")
    from ray_tpu_torch import collective as col

    world = 2
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((3, 4)).astype(np.float32)
          for _ in range(world)]
    peers = [Peer.remote(r, world) for r in range(world)]
    col.create_collective_group(peers, world, list(range(world)),
                                backend="cpu")
    got = ray_tpu_torch.get([p.ops.remote(x) for p, x in zip(peers, xs)],
                            timeout=T)
    want = _store_results(xs)
    for op in ("allreduce", "broadcast", "allgather"):
        for rank in range(world):
            np.testing.assert_array_equal(got[rank][op].numpy(),
                                          want[op][rank], err_msg=op)
    for p in peers:
        ray_tpu_torch.kill(p)


# ---------------------------------------------------------------------------
# CheckpointManager and the scaling policies against the JAX ones
# ---------------------------------------------------------------------------

REPORTS = [{"step": i + 1, "score": s} for i, s in
           enumerate((0.5, 2.0, 1.0, 3.0, 0.25))]


def _manager_run(manager_cls, run_dir, tmp, num_to_keep, attr, order):
    manager = manager_cls(str(run_dir), num_to_keep, attr, order)
    for metrics in REPORTS:
        src = tmp / f"src_{metrics['step']}"
        (src / "sub").mkdir(parents=True)
        (src / "state.json").write_text(json.dumps(metrics))
        (src / "sub" / "blob.bin").write_bytes(bytes(range(metrics["step"] * 7)))
        manager.register(str(src), metrics)

    def contents(ckpt):
        if ckpt is None:
            return None
        out = {}
        for dirpath, _, files in os.walk(ckpt.path):
            for name in files:
                full = os.path.join(dirpath, name)
                with open(full, "rb") as f:
                    out[os.path.relpath(full, ckpt.path)] = f.read()
        return out

    return {"records": [(r["index"], r["metrics"]) for r in manager.records],
            "latest": contents(manager.latest()),
            "best": contents(manager.best())}


@pytest.mark.parametrize("num_to_keep,attr,order", [
    (None, None, "max"), (2, None, "max"), (2, "score", "max"),
    (3, "score", "min")], ids=["keep_all", "keep_2", "best_2_max",
                               "best_3_min"])
def test_checkpoint_manager_matches_jax(tmp_path, num_to_keep, attr, order):
    """The same reports through both managers, each in its own run
    directory: the kept records, the pruning by score, and the files of the
    ``latest()`` and ``best()`` directories."""
    pytest.importorskip("jax")
    from ray_tpu.train.checkpoint import CheckpointManager as JaxManager
    from ray_tpu_torch.train import CheckpointManager

    got = _manager_run(CheckpointManager, tmp_path / "port", tmp_path / "a",
                       num_to_keep, attr, order)
    want = _manager_run(JaxManager, tmp_path / "jax", tmp_path / "b",
                        num_to_keep, attr, order)
    assert got == want
    assert len(got["records"]) == (num_to_keep or len(REPORTS))


VIEWS = [{}, {"CPU": 1.0}, {"CPU": 3.0, "ACC": 3.0}, {"CPU": 8.0, "ACC": 7.0},
         {"CPU": 16.0, "ACC": 16.0}, {"CPU": 5.0, "ACC": 12.0},
         {"CPU": 64.0, "ACC": 2.0}]


@pytest.mark.parametrize("granularity", ["pow2", 2, 3])
def test_scaling_policies_match_jax(granularity):
    """``FixedScalingPolicy`` and ``ElasticScalingPolicy`` against the JAX
    ones on the same resource views, with ``GPU`` where JAX counts
    ``TPU``."""
    pytest.importorskip("jax")
    from ray_tpu.train.config import ScalingConfig as JaxScaling
    from ray_tpu.train.scaling_policy import (
        make_scaling_policy as jax_policy)
    from ray_tpu.train.scaling_policy import sized as jax_sized
    from ray_tpu_torch.train.scaling_policy import make_scaling_policy, sized

    for elastic in (False, True):
        for min_workers in (1, 2):
            common = dict(num_workers=8, resources_per_worker={"CPU": 1.0},
                          elastic=elastic, min_workers=min_workers,
                          elastic_granularity=granularity)
            port = ScalingConfig(use_gpu=True, gpus_per_worker=1, **common)
            jax = JaxScaling(use_tpu=True, chips_per_worker=1, **common)
            assert port.bundle() == {"CPU": 1.0, "GPU": 1.0}
            p, j = make_scaling_policy(port), jax_policy(jax)
            assert type(p).__name__ == type(j).__name__
            for view in VIEWS:
                pv = {k.replace("ACC", "GPU"): v for k, v in view.items()}
                jv = {k.replace("ACC", "TPU"): v for k, v in view.items()}
                assert p.initial_size(pv) == j.initial_size(jv), view
                for current in (1, 4, 8):
                    assert (p.size_after_failure(current, pv)
                            == j.size_after_failure(current, jv)), view
            assert sized(port, 3).num_workers == jax_sized(jax, 3).num_workers


# ---------------------------------------------------------------------------
# the slice as a whole: a tiny LM trained by TorchTrainer, crashed, resumed
# ---------------------------------------------------------------------------

# as tests/test_torch_train.py: 2 layers at head_dim 64, fp32 compute
SHAPE = dict(d_model=128, n_heads=2, n_kv_heads=1)
OPT = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
BATCH, SEQ, STEPS = 4, 32, 5
CKPT_AFTER, CRASH_AFTER = 2, 3
LOSS_RTOL = 1e-5  # fp32 training parity (ROADMAP "How a slice is held")


def _lm_loop(config):
    """The tiny LM's steps through ``TrainStepBundle`` on the config's
    device: a checkpoint (params and optimizer state by ``torch.save``)
    after step ``ckpt_after``; on the first incarnation, once that
    checkpoint's manifest is committed, ``os._exit`` after step
    ``crash_after``. Each step's loss goes to ``report`` and to the log."""
    import dataclasses
    import tempfile
    import time

    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import CONFIGS
    from ray_tpu_torch.parallel import OptState, TrainStepBundle, make_optimizer
    from ray_tpu_torch.train.checkpoint import checkpoint_store

    ctx = train.get_context()
    cfg = dataclasses.replace(CONFIGS["tiny"], dtype=torch.float32,
                              remat=False, **config["shape"])
    bundle = TrainStepBundle(cfg, device=config["device"],
                             optimizer=make_optimizer(**config["opt"]))
    ckpt = train.get_checkpoint()
    if ckpt is None:
        params, start = config["params"], 0
        opt = bundle.optimizer.init(params)
    else:
        state = torch.load(os.path.join(ckpt.as_directory(), "state.pt"),
                           weights_only=True)
        params, start = state["params"], state["step"]
        opt = OptState(state["count"], state["mu"], state["nu"])
    batch = {k: torch.as_tensor(v) for k, v in config["batch"].items()}
    for step in range(start, config["steps"]):
        params, opt, loss = bundle.step(params, opt, batch)
        metrics = {"step": step + 1, "loss": loss.item(), "pid": os.getpid(),
                   "start": start}
        with open(config["log"], "a") as f:
            f.write(json.dumps(metrics) + "\n")
        if step + 1 == config["ckpt_after"]:
            with tempfile.TemporaryDirectory() as d:
                torch.save({"params": {k: p.detach() for k, p in params.items()},
                            "count": opt.count, "mu": opt.mu, "nu": opt.nu,
                            "step": step + 1}, os.path.join(d, "state.pt"))
                train.report(metrics, checkpoint=train.Checkpoint(d))
        else:
            train.report(metrics)
        if step + 1 == config["crash_after"] and not os.path.exists(
                config["marker"]):
            store = checkpoint_store(ctx.run_dir)
            while (store.latest() is None
                   or store.latest().step != config["ckpt_after"]):
                time.sleep(0.05)  # the checkpoint commits in the background
            open(config["marker"], "w").close()
            os._exit(1)
    return {"resumed_from": start}


def _jax_losses():
    """The JAX bundle's STEPS fp32 steps on one batch, its initial
    parameters and the batch, as numpy."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from ray_tpu.models.transformer import CONFIGS as JAX_CONFIGS
    from ray_tpu.parallel import TrainStepBundle as JaxBundle
    from ray_tpu.parallel import create_mesh
    from ray_tpu.parallel import make_optimizer as jax_make_optimizer

    cfg = dataclasses.replace(JAX_CONFIGS["tiny"], dtype=jnp.float32,
                              remat=False, **SHAPE)
    mesh = create_mesh({"data": 1, "fsdp": 1, "seq": 1, "tensor": 1,
                        "expert": 1}, devices=jax.devices()[:1])
    bundle = JaxBundle(cfg, mesh, optimizer=jax_make_optimizer(**OPT))
    params, opt = bundle.init(jax.random.PRNGKey(0))
    init = jax.tree_util.tree_map(np.asarray, params)
    batch = bundle.make_batch(np.random.default_rng(0), BATCH, SEQ)
    losses = []
    for _ in range(STEPS):
        params, opt, loss = bundle.step(params, opt, batch)
        losses.append(float(loss))
    return init, jax.tree_util.tree_map(np.asarray, batch), losses


def test_tiny_lm_trained_crashed_and_resumed_matches_jax(cluster, tmp_path):
    """``TorchTrainer`` with one ``use_gpu`` worker on the declared card
    trains the tiny LM from the JAX parameters on the JAX batch: a
    checkpoint after step 2, a crash after step 3, one re-form in a fresh
    process that resumes from step 2; every step's loss, both
    incarnations', within LOSS_RTOL of the JAX bundle's."""
    pytest.importorskip("flax")
    from ray_tpu_torch.models import from_jax_params

    init, batch, want = _jax_losses()
    log = tmp_path / "steps.jsonl"
    marker = tmp_path / "died_once"
    trainer = TorchTrainer(
        _lm_loop,
        train_loop_config={
            "params": from_jax_params(init), "batch": dict(batch),
            "shape": SHAPE, "opt": OPT, "device": "cpu", "steps": STEPS,
            "ckpt_after": CKPT_AFTER, "crash_after": CRASH_AFTER,
            "marker": str(marker), "log": str(log)},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True,
                                     resources_per_worker={"CPU": 1,
                                                           "GPU": 1}),
        run_config=RunConfig(storage_path=str(tmp_path), name="tiny_lm",
                             failure_config=FailureConfig(max_failures=1)),
    )
    result = fit_within(trainer)
    assert result.error is None and result.metrics["step"] == STEPS
    assert marker.exists()
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3, 3, 4, 5]
    assert [r["start"] for r in rows] == [0, 0, 0, 2, 2, 2]
    assert len({r["pid"] for r in rows[:3]} | {rows[3]["pid"]}) == 2
    for r in rows:
        np.testing.assert_allclose(r["loss"], want[r["step"] - 1],
                                   rtol=LOSS_RTOL, err_msg=str(r))


# ---------------------------------------------------------------------------
# a fit with cloudpickle, msgpack and the JAX package blocked
# ---------------------------------------------------------------------------

_BLOCKED = ("cloudpickle", "msgpack", "jax", "ray_tpu")

_DRIVER = textwrap.dedent("""
    import json, os, sys, tempfile
    import ray_tpu_torch as rt
    from ray_tpu_torch import train

    rt.init(num_cpus=3, device="cpu")

    def make(k):
        def loop(config):
            ctx = train.get_context()
            start = 0
            if train.get_checkpoint() is not None:
                with open(os.path.join(train.get_checkpoint().as_directory(),
                                       "s.json")) as f:
                    start = json.load(f)["step"]
            for step in range(start, 3):
                if step == 2 and not os.path.exists(config["marker"]):
                    open(config["marker"], "w").close()
                    os._exit(1)
                with tempfile.TemporaryDirectory() as d:
                    with open(os.path.join(d, "s.json"), "w") as f:
                        json.dump({"step": step + 1}, f)
                    train.report({"step": step + 1, "k": k,
                                  "loaded": [n for n in BLOCKED
                                             if n in sys.modules]},
                                 checkpoint=train.Checkpoint(d))
            return start
        return loop

    marker = os.path.join(os.getcwd(), "died")
    result = train.TorchTrainer(
        make(7), train_loop_config={"marker": marker},
        run_config=train.RunConfig(
            storage_path=os.getcwd(), name="blocked",
            failure_config=train.FailureConfig(max_failures=1))).fit()
    print(json.dumps(result.metrics), os.path.exists(marker))
    rt.shutdown()
""")


def test_fit_without_cloudpickle_msgpack_or_jax(tmp_path):
    """A loop defined inside a function crosses to the worker by value and
    trains, crashes once and resumes on a port cluster in which
    ``cloudpickle``, ``msgpack`` and the JAX package fail to import in the
    driver, the GCS, the raylet, the controller and every worker."""
    shim = tmp_path / "shim"
    shim.mkdir()
    for name in _BLOCKED:
        (shim / f"{name}.py").write_text(
            f"raise ImportError('{name} is blocked in this test')\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAY_TPU_TORCH_")}
    env["PYTHONPATH"] = f"{shim}{os.pathsep}{REPO}"
    out = subprocess.run(
        [sys.executable, "-c", f"BLOCKED = {_BLOCKED!r}\n" + _DRIVER],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    metrics, crashed = out.stdout.strip().rsplit(" ", 1)
    assert json.loads(metrics) == {"step": 3, "k": 7, "loaded": []}
    assert crashed == "True"
