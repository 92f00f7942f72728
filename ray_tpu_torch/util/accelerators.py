"""GPU detection for the raylet: the port of ``ray_tpu/util/accelerators.py``
(``detect_tpu``), which advertises a node's ``TPU`` chips; this module finds
its ``GPU`` cards.

Detection order:

1. an explicit override, ``RAY_TPU_TORCH_GPUS`` (a count, or a
   comma-separated list of device ids);
2. ``CUDA_VISIBLE_DEVICES``: the cards it lists, ``"0"`` being card 0
   (empty, or ``-1``, means none);
3. ``nvidia-smi -L``, one line per card, ids 0 to n - 1.

The raylet hands each ``GPU`` lease its own cards out of these ids, and the
worker that runs it sees only them through ``CUDA_VISIBLE_DEVICES``.

It never imports torch: a raylet that imported it would pay its start-up,
and one that touched CUDA would hand a CUDA context to every worker it
forks.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.common import LABEL_ACCELERATOR_TYPE

OVERRIDE_ENV = "RAY_TPU_TORCH_GPUS"


def _ids(spec: str) -> List[str]:
    """The cards a ``CUDA_VISIBLE_DEVICES``-style list names, in order: CUDA
    stops at the first ``-1``, so ``""`` and ``"-1"`` name none."""
    ids = []
    for part in spec.split(","):
        part = part.strip()
        if not part or part.startswith("-"):
            break
        ids.append(part)
    return ids


def _nvidia_smi_names() -> Optional[List[str]]:
    """The card names ``nvidia-smi -L`` lists, or None without nvidia-smi."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run([exe, "-L"], capture_output=True, text=True,
                             timeout=10).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    names = []
    for line in out.splitlines():
        # "GPU 0: NVIDIA H100 80GB HBM3 (UUID: GPU-...)"
        if line.startswith("GPU "):
            names.append(line.split(":", 1)[1].split("(UUID")[0].strip())
    return names


def detect_gpu_ids() -> Tuple[List[str], Dict[str, str]]:
    """Returns (the ids of this host's cards, labels). An id is what
    ``CUDA_VISIBLE_DEVICES`` takes to show a worker that card alone."""
    labels: Dict[str, str] = {}
    override = os.environ.get(OVERRIDE_ENV)
    if override is not None:
        if override.strip().isdigit() and "," not in override:
            return [str(i) for i in range(int(override))], labels
        return _ids(override), labels
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    names = _nvidia_smi_names() if visible != "" else None
    if visible is not None:
        ids = _ids(visible)
        if names is not None:
            ids = ids[:len(names)]
    else:
        ids = [str(i) for i in range(len(names or ()))]
    if ids and names:
        labels[LABEL_ACCELERATOR_TYPE] = names[0]
    return ids, labels


def detect_gpus() -> Tuple[int, Dict[str, str]]:
    """Returns (number of cards on this host, labels)."""
    ids, labels = detect_gpu_ids()
    return len(ids), labels


def num_gpus_on_host() -> int:
    return detect_gpus()[0]
