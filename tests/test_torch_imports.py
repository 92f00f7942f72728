"""Import hygiene of the port: ``ray_tpu_torch`` and ``chip_smoke.py`` stand
alone beside the JAX package, and importing the port builds no kernel."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "ray_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_no_jax_nor_reference_package(path):
    bad = [(mod, line) for mod, line in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


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
        "from ray_tpu_torch.ops import _build\n"
        "assert not _build.is_loaded('flash_fwd')\n"
        "assert not _build.is_loaded('flash_bwd')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
