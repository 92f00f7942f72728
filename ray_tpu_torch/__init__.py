"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package of its own beside ``ray_tpu`` (the JAX reference), importing none
of it. Ported so far: the runtime's single-node core (``init``, ``@remote``
tasks and actors, ``put``/``get``/``wait``, the GCS, the raylet, the core
worker and the shared-memory object store, under ``_private``), the paged-KV
LLM serving path with prefill/decode disaggregation and batch inference
(``llm``), the decoder LMs and the ViT (``models``), their training step on
one device or on a mesh of five axes, traced or not (``parallel``), the
collective group on ``torch.distributed`` with its codecs and bucketed tier
(``collective``), metrics, spans, the goodput ledger, GPU detection and the
state API (``util``), the streaming Dataset and the token-file loader
(``data``), the checkpoint plane with its storage tiers (``ckpt``, over the
mesh geometry of ``weights``), the train plane on the runtime (``train``:
``TorchTrainer``, its controller and worker groups on placement groups,
``util.placement_group``), Serve (``serve``: deployments, the controller,
handles, autoscaling and an HTTP proxy on the standard library), the weight
plane (``weights``: the versioned weight store and its transports), the RL
library (``rl``: PPO, IMPALA/APPO, DQN, SAC, BC/MARWIL and multi-agent PPO,
learners on the card, env runners on its numpy environments), Tune
(``tune``: the Tuner, its searchers and schedulers), job submission
(``job``), the dashboard's head and node agent (``dashboard``), the CLI
(``scripts.cli``), the GCS KV API and device objects (``experimental``),
and the flash-attention
forward and backward as CUDA kernels with ring and Ulysses attention on them
(``ops``). Entry points run on the card unless given ``device="cpu"``;
``init`` starts a cluster whose raylet advertises the host's cards as the
``GPU`` resource.

Like the JAX package's ``__init__``, this module imports the runtime's API
and nothing heavy: the other submodules load lazily, neither torch nor a
kernel is loaded by importing the package, and kernels are built only when
first launched.
"""

import importlib

from ray_tpu_torch._private.worker import (
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    init,
    is_initialized,
    kill,
    nodes,
    put,
    remote,
    shutdown,
    wait,
)
from ray_tpu_torch.actor import method
from ray_tpu_torch.object_ref import ObjectRef
from ray_tpu_torch.runtime_context import get_runtime_context
from ray_tpu_torch import exceptions

_SUBMODULES = ("autoscaler", "ckpt", "cluster_utils", "collective",
               "dashboard", "data", "experimental", "job", "llm", "models",
               "ops", "parallel", "rl", "scripts", "serve", "train", "tune",
               "util", "utils", "weights")


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"ray_tpu_torch.{name}")
    raise AttributeError(name)


__version__ = "0.1.0"

__all__ = [
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "method",
    "get",
    "put",
    "wait",
    "kill",
    "cancel",
    "get_actor",
    "get_runtime_context",
    "cluster_resources",
    "available_resources",
    "nodes",
    "ObjectRef",
    "exceptions",
    "__version__",
] + list(_SUBMODULES)
