"""Import hygiene of the port: ``ray_tpu_torch`` and ``chip_smoke.py`` stand
alone beside the JAX package, import nothing outside the card machine's
installs, and importing the port builds no kernel and no host library."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_tpu",
             # the JAX runtime's third-party imports, which the card lacks
             "cloudpickle", "msgpack", "psutil", "boto3",
             # the JAX Serve's HTTP and gRPC ingress
             "aiohttp", "grpc")
# what the card's machine installs besides the standard library
ALLOWED = ("torch", "numpy", "scipy", "einops", "triton", "ray_tpu_torch")
# optional adapters imported inside the function that needs them, by file
LAZY_ADAPTERS = {"ray_tpu_torch/llm/tokenizer.py": {"transformers"},
                 # the Dataset's parquet and pandas interchange (it raises
                 # naming the package where it is missing)
                 "ray_tpu_torch/data/block.py": {"pandas", "pyarrow"},
                 # a pip runtime env runs ``python -m pip install`` in the
                 # env's venv, only for a task or actor that asks for one
                 "ray_tpu_torch/_private/runtime_env.py": {"pip"},
                 # an env name the port does not hold goes to gymnasium
                 # (``envs.make`` raises naming the env where it is missing)
                 "ray_tpu_torch/rl/envs.py": {"gymnasium"}}


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "ray_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _named_module(node):
    """The module a call imports by name (``importlib.import_module(...)``,
    ``__import__(...)``) or a ``[..., "-m", "<module>", ...]`` command
    spawns, where the name is a literal or an f-string's literal start."""
    def literal(arg):
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return arg.value
        if isinstance(arg, ast.JoinedStr) and arg.values and isinstance(
                arg.values[0], ast.Constant):
            return arg.values[0].value
        return None

    if isinstance(node, ast.Call) and node.args:
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
            fn, "id", "")
        if name in ("import_module", "__import__"):
            return literal(node.args[0])
    if isinstance(node, (ast.List, ast.Tuple)):
        elts = node.elts
        for i, e in enumerate(elts[:-1]):
            if literal(e) == "-m":
                return literal(elts[i + 1])
    return None


def _imports(path):
    """(root module, line, at module level) of every absolute import, at
    any depth: import statements, imports by name, and the modules of
    ``python -m`` commands."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    top = set()
    for node in tree.body:
        if isinstance(node, (ast.If, ast.Try)):  # guarded top-level imports
            top.update(id(n) for n in ast.walk(node))
        top.add(id(node))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno, id(node) in top
        else:
            named = _named_module(node)
            if named:
                yield named.split(".")[0], node.lineno, id(node) in top


def _imported_roots(path):
    for mod, line, _ in _imports(path):
        yield mod, line


def test_the_walk_covers_the_dag_and_pipeline_packages():
    """The compiled-graph plane and the pipeline plane are in the walk, each
    of their modules checked by the two tests below."""
    rel = {os.path.relpath(p, REPO) for p in _port_files()}
    want = {f"ray_tpu_torch/dag/{m}.py"
            for m in ("__init__", "channels", "executor")}
    want |= {f"ray_tpu_torch/train/pipeline/{m}.py"
             for m in ("__init__", "schedule", "partition", "stage",
                       "controller")}
    assert want <= rel, sorted(want - rel)


def test_the_walk_covers_the_rl_package():
    """The RL library and its nets are in the walk, each module checked by
    the two tests below."""
    rel = {os.path.relpath(p, REPO) for p in _port_files()}
    want = {f"ray_tpu_torch/rl/{m}.py"
            for m in ("__init__", "algorithm", "appo", "dqn", "env_runner",
                      "envs", "impala", "learner", "learner_group",
                      "multi_agent", "offline", "optim", "ppo",
                      "replay_buffer", "sac")}
    want.add("ray_tpu_torch/models/actor_critic.py")
    assert want <= rel, sorted(want - rel)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_no_jax_nor_reference_package(path):
    bad = [(mod, line) for mod, line in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_only_the_card_machines_installs(path):
    """Module-level imports: the standard library and ALLOWED alone (a
    copied ``cloudpickle`` would fail on the card); inside functions, also
    the adapters LAZY_ADAPTERS names for the file."""
    rel = os.path.relpath(path, REPO)
    lazy = LAZY_ADAPTERS.get(rel, set())
    bad = [(mod, line) for mod, line, top in _imports(path)
           if mod not in sys.stdlib_module_names and mod not in ALLOWED
           and (top or mod not in lazy)]
    assert not bad, f"{rel} imports {bad}"


def test_named_imports_are_seen(tmp_path):
    """The walk finds imports inside functions, imports by name and spawned
    ``-m`` modules, so the two tests above cover them."""
    src = ("import os\n"
           "def f():\n"
           "    import msgpack\n"
           "    importlib.import_module('boto3.session')\n"
           "    __import__('cloudpickle')\n"
           "    return [sys.executable, '-m', 'ray_tpu._private.gcs']\n"
           "def g(name):\n"
           "    return importlib.import_module(f'jax.{name}')\n")
    path = tmp_path / "_imports_probe.py"
    path.write_text(src)
    got = [(mod, top) for mod, _, top in _imports(str(path))]
    assert got == [("os", True), ("msgpack", False), ("boto3", False),
                   ("cloudpickle", False), ("ray_tpu", False),
                   ("jax", False)]


def test_runtime_imports_load_no_torch_nor_third_party_codecs():
    """The runtime's modules (what every worker, raylet and GCS imports),
    Serve's (what its controller, proxy and replicas import), the weight
    store's, the Dataset's (what its tasks import), the PD router's and the
    batch processor's load neither torch nor a package the card lacks; the
    zygote's
    pre-import, torch included, leaves CUDA uninitialised."""
    code = (
        "import sys\n"
        "import ray_tpu_torch\n"
        "from ray_tpu_torch import actor, cluster_utils, exceptions, "
        "object_ref, remote_function, runtime_context\n"
        "from ray_tpu_torch._private import (async_util, common, "
        "core_worker, cpp_store, external_storage, gcs, ids, logs, "
        "memory_monitor, msgpack, node, object_store, pull_manager, raylet, "
        "reference_counter, rpc, runtime_env, serialization, store_client, "
        "task_events, wire, worker, worker_main)\n"
        "from ray_tpu_torch._private.provisioner import framing, pool, "
        "zygote\n"
        "from ray_tpu_torch.util import accelerators, events, tracing\n"
        "from ray_tpu_torch.ckpt.tier import object_plane\n"
        "from ray_tpu_torch.serve import api, multiplex\n"
        "from ray_tpu_torch.serve.autoscale import ingress, policy, router, "
        "window\n"
        "from ray_tpu_torch.experimental import device_objects, "
        "internal_kv\n"
        "from ray_tpu_torch.weights import store, transport\n"
        "from ray_tpu_torch.data import block, context, dataset, "
        "datasources\n"
        "from ray_tpu_torch.data._internal import executor, operators, "
        "tasks\n"
        "from ray_tpu_torch.llm import data_llm, pd\n"
        "from ray_tpu_torch.util import state\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('torch',)!r}]\n"
        "assert not bad, bad\n"
        "loaded = zygote.preimport(preimport_torch=True)\n"
        "assert 'torch' in loaded, loaded\n"
        "assert not sys.modules['torch'].cuda.is_initialized()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_import_builds_and_loads_no_kernel():
    code = (
        "import sys, ray_tpu_torch\n"
        "from ray_tpu_torch import collective, llm, models, ops, parallel, "
        "utils\n"
        "from ray_tpu_torch.llm import engine, serve_llm, model_runner\n"
        "from ray_tpu_torch.models import convert, transformer, vit\n"
        "from ray_tpu_torch.parallel import fsdp, mesh, tensor_parallel, "
        "train\n"
        "from ray_tpu_torch.collective import bucketed, collective_group, "
        "quant\n"
        "from ray_tpu_torch.util import goodput, metrics, tracing\n"
        "from ray_tpu_torch.ops import ring_attention\n"
        "from ray_tpu_torch import ckpt, data, experimental, serve, train, "
        "weights\n"
        "from ray_tpu_torch.serve import api, multiplex\n"
        "from ray_tpu_torch.weights import store, transport\n"
        "from ray_tpu_torch.ckpt import manifest, restore, saver, store\n"
        "from ray_tpu_torch.ckpt.tier import backend, bucket, "
        "object_plane, pario, sweeper, tiered\n"
        "from ray_tpu_torch.util import events\n"
        "from ray_tpu_torch.data import token_loader\n"
        "from ray_tpu_torch.weights import plan, spec\n"
        "from ray_tpu_torch.train import scaling_policy\n"
        "from ray_tpu_torch._private import config, native_build, "
        "serialization\n"
        "from ray_tpu_torch.ops import _build\n"
        "assert not _build.is_loaded('flash_fwd')\n"
        "assert not _build.is_loaded('flash_bwd')\n"
        "assert not native_build._loaded\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# the Dataset, PD serving and batch inference with pyarrow, pandas,
# cloudpickle and the JAX package blocked
# ---------------------------------------------------------------------------

_BLOCKED = ("pyarrow", "pandas", "cloudpickle", "msgpack", "jax", "ray_tpu")

_DRIVER = """
import sys, tempfile
import numpy as np
import ray_tpu_torch as rt
from ray_tpu_torch import data as rd
from ray_tpu_torch.llm import (EngineConfig, LLMConfig, SamplingParams,
                               build_llm_processor)
from ray_tpu_torch.llm.pd import build_pd_openai_app

rt.init(num_cpus=6, device="cpu")
ds = rd.from_items([{"k": i % 3, "v": float(i)} for i in range(30)],
                   parallelism=3)
print(sorted((r["k"], r["sum(v)"]) for r in ds.groupby("k").sum("v")
             .take_all()))
print([r["v"] for r in ds.sort("v", descending=True).take(2)])
users = rd.from_items([{"k": i, "name": f"u{i}"} for i in range(3)])
print(sorted(r["name"] for r in ds.join(users, on="k").take_all())[::10])
d = tempfile.mkdtemp()
ds.write_csv(d)
print(rd.read_csv(d).count())
print([float(b["v"].sum()) for b in ds.map_batches(
    lambda b: {"v": b["v"] * 2}).iter_device_batches(batch_size=10,
                                                      device="cpu")])
for fn in (lambda: ds.write_parquet(d), lambda: rd.read_parquet(d),
           ds.to_pandas):
    try:
        fn()
    except ImportError as e:
        print("needs pyarrow" in str(e) or "needs pandas" in str(e))
print(sorted({n for r in ds.map(lambda r: {"loaded": [
    m for m in BLOCKED if m in sys.modules]}).take_all()
              for n in r["loaded"]}))
cfg = LLMConfig(model_id="tiny", engine_config=EngineConfig(
    max_num_seqs=4, max_model_len=128, page_size=16, prefill_bucket_min=16),
    model_overrides={"dtype": "float32"},
    ray_actor_options={"num_cpus": 0.5})
from ray_tpu_torch.llm.engine import TorchLLMEngine
want = TorchLLMEngine(cfg, device="cpu").generate(
    ["hi there", "b"], SamplingParams(max_tokens=4))
h = build_pd_openai_app(cfg, device="cpu")
out = rt.get(h.remote({"prompt": "hi there", "max_tokens": 4,
                       "return_token_ids": True}), timeout=120)
print(out["choices"][0]["token_ids"] == want[0].token_ids)
proc = build_llm_processor(cfg, sampling_params=SamplingParams(max_tokens=4),
                           device="cpu")
rows = proc(rd.from_items([{"prompt": "hi there"}, {"prompt": "b"}],
                          parallelism=1)).take_all()
print([r["generated_text"] for r in rows] == [o.text for o in want])
proc.shutdown()
print([n for n in BLOCKED if n in sys.modules])
rt.shutdown()
"""


def test_dataset_pd_and_batch_inference_without_arrow_pandas_or_jax(
        tmp_path):
    """The Dataset (groupby, sort, join, CSV, device batches), PD serving
    and batch inference run in a cluster whose driver, GCS, raylet and
    workers cannot import pyarrow, pandas, cloudpickle, msgpack or the JAX
    package (shadowed on ``PYTHONPATH`` by modules that raise); parquet and
    pandas calls raise ImportError naming their package."""
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
        timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[:12] == [
        "[(0, 135.0), (1, 145.0), (2, 155.0)]", "[29.0, 28.0]",
        "['u0', 'u1', 'u2']", "30", "[90.0, 290.0, 490.0]", "True", "True",
        "True", "[]", "True", "True", "[]"], out.stdout


# ---------------------------------------------------------------------------
# the RL library without gymnasium, JAX, flax or optax
# ---------------------------------------------------------------------------

_RL_BLOCKED = ("gymnasium", "jax", "flax", "optax", "cloudpickle", "ray_tpu")

_RL_SCRIPT = """
import sys
import ray_tpu_torch as rt
from ray_tpu_torch import rl
from ray_tpu_torch.rl import (algorithm, appo, dqn, env_runner, envs, impala,
                              learner, learner_group, multi_agent, offline,
                              optim, ppo, replay_buffer, sac)
from ray_tpu_torch.models import actor_critic
print([m for m in sys.modules if m.split(".")[0] in BLOCKED])
try:
    envs.make("MountainCar-v0")
except ImportError as e:
    print("ImportError", "MountainCar-v0" in str(e), "gymnasium" in str(e))
rt.init(num_cpus=4, device="cpu")
algo = rl.PPOConfig(num_env_runners=1, num_envs_per_runner=2,
                    rollout_length=16, epochs=1, device="cpu").build()
print(algo.train()["num_env_steps_sampled"])
print(rt.get(algo.runners[0].cuda_initialized.remote(), timeout=60))
algo.stop()
rt.shutdown()
print([m for m in sys.modules if m.split(".")[0] in BLOCKED])
"""


def test_rl_runs_without_gymnasium_jax_flax_or_optax(tmp_path):
    """Every RL module imports, and PPO trains one iteration on a port
    cluster (env runners on the port's CartPole), in processes that cannot
    import gymnasium, JAX, flax, optax, cloudpickle or the JAX package
    (shadowed on ``PYTHONPATH`` by modules that raise); none of them is
    loaded; ``envs.make`` of a name the port does not hold raises an
    ImportError naming the env and gymnasium."""
    shim = tmp_path / "shim"
    shim.mkdir()
    for name in _RL_BLOCKED:
        (shim / f"{name}.py").write_text(
            f"raise ImportError('{name} is blocked in this test')\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAY_TPU_TORCH_")}
    env["PYTHONPATH"] = f"{shim}{os.pathsep}{REPO}"
    out = subprocess.run(
        [sys.executable, "-c", f"BLOCKED = {_RL_BLOCKED!r}\n" + _RL_SCRIPT],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[:5] == [
        "[]", "ImportError True True", "32", "False", "[]"], out.stdout


# ---------------------------------------------------------------------------
# Tune, jobs, the dashboard, the CLI and the microbenchmark without aiohttp,
# psutil, cloudpickle, pandas, requests, grpc or JAX
# ---------------------------------------------------------------------------

_SERVICES_BLOCKED = ("aiohttp", "psutil", "cloudpickle", "pandas", "requests",
                     "grpc", "jax", "ray_tpu")

_SERVICES_SCRIPT = """
import json, sys, time, urllib.request
import ray_tpu_torch as rt
from ray_tpu_torch import dashboard, job, tune
from ray_tpu_torch.scripts import cli
from ray_tpu_torch._private import microbenchmark
print([m for m in sys.modules if m.split(".")[0] in BLOCKED])
w = rt.init(num_cpus=4, include_dashboard=True, device="cpu")
addr = w.node_supervisor.dashboard_address
with urllib.request.urlopen(f"http://{addr}/api/summary", timeout=30) as r:
    print(json.loads(r.read())["num_nodes"])

def trainable(config):
    import sys
    for t in (1, 2):
        tune.report({"score": config["x"] * t, "training_iteration": t})
    return {"loaded": [m for m in sys.modules if m.split(".")[0] in BLOCKED]}

grid = tune.Tuner(trainable, param_space={"x": tune.grid_search([1, 2])},
                  tune_config=tune.TuneConfig(metric="score")).fit()
print(grid.get_best_result().config, [r.metrics["loaded"] for r in grid.results])
try:
    grid.get_dataframe()
except ImportError as e:
    print("needs pandas" in str(e))
req = urllib.request.Request(
    f"http://{addr}/api/jobs", method="POST",
    data=json.dumps({"entrypoint": "python -c 'print(41 + 1)'"}).encode())
with urllib.request.urlopen(req, timeout=60) as r:
    sid = json.loads(r.read())["submission_id"]
client = job.JobSubmissionClient()
print(client.wait_until_finished(sid, timeout=120),
      client.get_job_logs(sid).strip())
print([m for m in sys.modules if m.split(".")[0] in BLOCKED])
rt.shutdown()
"""


def test_cluster_services_run_without_aiohttp_psutil_or_jax(tmp_path):
    """Tune, jobs, the dashboard head and agent, the CLI and the
    microbenchmark import, a head with the dashboard answers over HTTP, a
    two-trial sweep runs and a job submitted through the REST succeeds, in
    processes (driver, GCS, raylet, dashboard, workers, the job) that
    cannot import aiohttp, psutil, cloudpickle, pandas, requests, grpc or
    the JAX package (shadowed on ``PYTHONPATH`` by modules that raise);
    ``get_dataframe`` raises ImportError naming pandas."""
    shim = tmp_path / "shim"
    shim.mkdir()
    for name in _SERVICES_BLOCKED:
        (shim / f"{name}.py").write_text(
            f"raise ImportError('{name} is blocked in this test')\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAY_TPU_TORCH_")}
    env["PYTHONPATH"] = f"{shim}{os.pathsep}{REPO}"
    out = subprocess.run(
        [sys.executable, "-c",
         f"BLOCKED = {_SERVICES_BLOCKED!r}\n" + _SERVICES_SCRIPT],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[:6] == [
        "[]", "1", "{'x': 2} [[], []]", "True", "SUCCEEDED 42", "[]"], \
        out.stdout
