"""The port's train plane. Today only ``scaling_policy.mesh_spec_for``, the
mesh an elastic worker group of a given size saves and restores against;
the controller, worker groups and ``CheckpointManager`` of
``ray_tpu/train`` come with the runtime's port."""
