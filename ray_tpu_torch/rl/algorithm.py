"""Algorithm base API: the port of ``ray_tpu/rl/algorithm.py`` (reference:
rllib/algorithms/algorithm.py:212).

``AlgorithmConfig.build() -> Algorithm`` with ``train() -> result dict``
and checkpointing. ``device`` is where the learners run: the card unless
the config names the CPU (no card then raises); env runners always step
and sample on the CPU.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Dict, Optional


@dataclass
class AlgorithmConfig:
    env: str = "CartPole-v1"
    seed: int = 0
    # the learners' device: None (the card) or "cpu"
    device: Optional[str] = None

    algo_cls = None  # set by subclasses

    def build(self) -> "Algorithm":
        if self.algo_cls is None:
            raise NotImplementedError("config does not name an algo_cls")
        return self.algo_cls(self)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


def ensure_runtime(device) -> None:
    """Start a port cluster for the env runners where none is up: one that
    advertises the card when the learners take it, none on the CPU."""
    import ray_tpu_torch

    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(device=device.type)


def config_blob(cfg) -> bytes:
    """The config as the runners receive it (the port's pickler)."""
    from ray_tpu_torch._private.serialization import dumps

    return dumps(cfg)


def load_config(blob: bytes):
    from ray_tpu_torch._private.serialization import loads_trusted

    # the blob is authored by the driving Algorithm (trusted producer)
    return loads_trusted(blob)


def kill_all(actors) -> None:
    import ray_tpu_torch

    for actor in actors:
        try:
            ray_tpu_torch.kill(actor)
        except Exception:
            pass


class Algorithm:
    """Base trainable: subclasses implement ``training_step`` and params
    accessors; ``train`` adds iteration bookkeeping."""

    def __init__(self, config):
        self.config = config
        self.iteration = 0

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def train(self) -> Dict[str, Any]:
        result = self.training_step()
        self.iteration += 1
        result.setdefault("training_iteration", self.iteration)
        return result

    # -- checkpointing (reference: rllib/utils/checkpoints.py Checkpointable)

    def get_state(self) -> Dict[str, Any]:
        raise NotImplementedError

    def set_state(self, state: Dict[str, Any]) -> None:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str) -> str:
        """Commit the algorithm state through the checkpoint plane
        (``ray_tpu_torch.ckpt``): the dir becomes a manifest + content-
        addressed chunk store, so repeated saves of a mostly-unchanged state
        write only the delta and a torn save never becomes visible."""
        from ray_tpu_torch.ckpt import CheckpointStore, save_checkpoint

        store = CheckpointStore(checkpoint_dir, name="rl")
        save_checkpoint(store, {"iteration": self.iteration,
                                "state": self.get_state()},
                        step=self.iteration)
        return checkpoint_dir

    def restore_from_checkpoint(self, checkpoint_dir: str) -> None:
        from ray_tpu_torch.ckpt import CheckpointStore, restore_tree

        store = CheckpointStore(checkpoint_dir, name="rl")
        if store.latest_id() is None:
            raise FileNotFoundError(f"no checkpoint in {checkpoint_dir}")
        blob = restore_tree(store)
        self.iteration = int(blob["iteration"])
        self.set_state(blob["state"])

    def stop(self) -> None:
        pass
