"""ray_tpu_torch.train.pipeline: MPMD pipeline-parallel training across
stage actors — stage partitioning, the 1F1B schedule, stage actors
streaming microbatches over the channel plane, and the recovering
controller. The port of ``ray_tpu.train.pipeline``
(``ray_tpu/train/pipeline/README.md`` has the design).

Public surface::

    from ray_tpu_torch.train.pipeline import (
        PipelineConfig, PipelineTrainer, build_schedule, simulate)

    trainer = PipelineTrainer(cfg, PipelineConfig(num_stages=2,
                                                  num_microbatches=8),
                              ckpt_root="/mnt/ckpts/run1")
    stats = trainer.train(num_steps=1000)
"""

# Lazy exports (PEP 562): stage/controller pull in the runtime and torch;
# the schedule geometry stays importable without them.
_EXPORTS = {
    "Op": "schedule", "build_schedule": "schedule",
    "build_interleaved_schedule": "schedule", "simulate": "schedule",
    "bubble_upper_bound": "schedule",
    "max_inflight_activations": "schedule",
    "partition_layers": "partition", "stage_param_keys": "partition",
    "rank_chunk_keys": "partition",
    "split_params": "partition", "merge_params": "partition",
    "StagePrograms": "partition", "make_stage_optimizer": "partition",
    "PipelineStage": "stage",
    "PipelineConfig": "controller", "PipelineTrainer": "controller",
    "make_microbatches": "controller",
    "repartition_manifest_leaves": "controller",
}


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'ray_tpu_torch.train.pipeline' has no attribute "
            f"{name!r}")
    import importlib

    return getattr(importlib.import_module(
        f"ray_tpu_torch.train.pipeline.{mod}"), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


__all__ = list(_EXPORTS)
