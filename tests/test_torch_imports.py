"""Import hygiene of the port: ``ray_tpu_torch`` and ``chip_smoke.py`` stand
alone beside the JAX package, import nothing outside the card machine's
installs, and importing the port builds no kernel and no host library."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_tpu")
# what the card's machine installs besides the standard library
ALLOWED = ("torch", "numpy", "scipy", "einops", "triton", "ray_tpu_torch")
# optional adapters imported inside the function that needs them, by file
LAZY_ADAPTERS = {"ray_tpu_torch/llm/tokenizer.py": {"transformers"}}


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "ray_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imports(path):
    """(root module, line, at module level) of every absolute import."""
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


def _imported_roots(path):
    for mod, line, _ in _imports(path):
        yield mod, line


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
        "from ray_tpu_torch import ckpt, data, train, weights\n"
        "from ray_tpu_torch.ckpt import manifest, restore, saver, store\n"
        "from ray_tpu_torch.ckpt.tier import backend, bucket, pario, "
        "sweeper, tiered\n"
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
