"""Device meshes and logical sharding rules: the port of
``ray_tpu/parallel/mesh.py``.

The parallelism vocabulary is the JAX package's (``AXES``): ``data`` (data
parallel), ``fsdp`` (data parallel with sharded parameters), ``seq``
(sequence parallel: ring and Ulysses attention), ``tensor`` (heads, MLP,
vocabulary) and ``expert``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group with those axis names. Each parameter's logical axes
(``param_logical_axes``, what the JAX model declares with
``nn.with_logical_partitioning``) map onto mesh axes by ``LOGICAL_RULES``
with flax's priority rule (``logical_to_mesh_axes``), and from there onto
DTensor placements (``mesh_placements``).

The train step holds each leaf as this rank's piece: ``param_layout`` gives,
for each flax path, the dim that each of the ``fsdp`` and ``tensor`` axes
splits (what the JAX bundle's ``param_shardings`` put on them);
``cut_leaf`` takes a rank's piece of a whole leaf and ``gather_leaf`` puts
the pieces back together.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ray_tpu_torch.utils import DeviceLike, resolve_device

AXES = ("data", "fsdp", "seq", "tensor", "expert")

# logical axis -> mesh axis (or tuple); None = replicated
LOGICAL_RULES = (
    ("batch", ("data", "fsdp")),
    ("seq", "seq"),
    ("embed", "fsdp"),
    ("heads", "tensor"),
    ("kv_heads", "tensor"),
    ("head_dim", None),
    ("mlp", "tensor"),
    ("vocab", "tensor"),
    ("expert", "expert"),
)

MeshAxes = Union[None, str, Tuple[str, ...]]


def create_mesh(axes: Dict[str, int], device: DeviceLike = None):
    """A ``DeviceMesh`` with the named axes over the ranks of the default
    process group (``init_collective_group`` creates it), on the card unless
    ``device`` is the CPU. The sizes must multiply to the world size."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs the default process group: "
                           "call init_collective_group first")
    world = dist.get_world_size()
    total = math.prod(axes.values()) if axes else 1
    if total != world:
        raise ValueError(f"mesh axes {axes} need {total} devices, have "
                         f"{world}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, tuple(axes.values()),
                            mesh_dim_names=tuple(axes.keys()))


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def default_mesh_axes(n_devices: int) -> Dict[str, int]:
    """The JAX package's decomposition for n devices: tensor within a
    host's reach, fsdp for the rest, pure data parallel kept at 1."""
    tensor = 1
    for cand in (8, 4, 2):
        if n_devices % cand == 0 and n_devices >= cand * 2:
            tensor = cand
            break
    if n_devices <= 4:
        tensor = 1
    return {"data": 1, "fsdp": n_devices // tensor, "seq": 1,
            "tensor": tensor, "expert": 1}


def param_logical_axes(cfg) -> Dict[str, Tuple[str, ...]]:
    """Flax path -> the logical axis name of each dim, as the JAX model
    declares them (``nn.with_logical_partitioning`` in
    ``ray_tpu/models/transformer.py``; what ``nn.get_partition_spec`` reads
    back), for a dense or MoE ``TransformerConfig``."""
    from ray_tpu_torch.models.transformer import state_dict_shapes

    by_name = {
        "embed": ("vocab", "embed"),
        "lm_head": ("embed", "vocab"),
        "scale": ("embed",),
        "q_proj.kernel": ("embed", "heads", "head_dim"),
        "k_proj.kernel": ("embed", "kv_heads", "head_dim"),
        "v_proj.kernel": ("embed", "kv_heads", "head_dim"),
        "o_proj.kernel": ("heads", "head_dim", "embed"),
        "mlp.gate_proj.kernel": ("embed", "mlp"),
        "mlp.up_proj.kernel": ("embed", "mlp"),
        "mlp.down_proj.kernel": ("mlp", "embed"),
        "router.kernel": ("embed", "expert"),
        "moe.gate_proj": ("expert", "embed", "mlp"),
        "moe.up_proj": ("expert", "embed", "mlp"),
        "moe.down_proj": ("expert", "mlp", "embed"),
    }
    out = {}
    for path in state_dict_shapes(cfg):
        names = [v for k, v in by_name.items()
                 if path == k or path.endswith("." + k)]
        if len(names) != 1:
            raise KeyError(f"no logical axes for {path}")
        out[path] = names[0]
    return out


def logical_to_mesh_axes(names: Sequence[Optional[str]]) -> List[MeshAxes]:
    """The mesh axes of each dim, by flax's rule: LOGICAL_RULES are taken
    in order, and a rule assigns its mesh axes to the dim of its logical
    name unless that dim is assigned already or one of the axes is taken by
    another dim; what is left unassigned is replicated (None)."""
    unassigned = object()
    result: List = [unassigned if isinstance(n, str) else n for n in names]

    def taken() -> set:
        return {a for r in result if r is not unassigned and r is not None
                for a in ((r,) if isinstance(r, str) else r)}

    for logical, mesh_axes in LOGICAL_RULES:
        if logical not in names:
            continue
        pos = list(names).index(logical)
        wanted = (() if mesh_axes is None else (mesh_axes,)
                  if isinstance(mesh_axes, str) else tuple(mesh_axes))
        if result[pos] is unassigned and not set(wanted) & taken():
            result[pos] = mesh_axes
    return [None if r is unassigned else r for r in result]


def mesh_placements(mesh, names: Sequence[Optional[str]]) -> tuple:
    """DTensor placements (one a mesh dim) of a tensor whose dims have the
    logical ``names``: ``Shard(d)`` on each mesh axis that dim d maps to,
    ``Replicate()`` on the others (LOGICAL_RULES)."""
    from torch.distributed.tensor import Replicate, Shard

    dims = {}
    for d, axes in enumerate(logical_to_mesh_axes(names)):
        for axis in (() if axes is None else (axes,) if isinstance(axes, str)
                     else axes):
            dims[axis] = d
    return tuple(Shard(dims[a]) if a in dims else Replicate()
                 for a in mesh.mesh_dim_names)


# the axes whose pieces of a leaf a rank holds (ZeRO-3 and Megatron); data
# and seq keep whole leaves, expert splits MoE stacks (not ported yet)
SHARDED_AXES = ("fsdp", "tensor")
# a leaf's pieces: mesh axis -> the dim it splits
LeafDims = Dict[str, int]


def param_layout(cfg, sizes: Mapping[str, int]) -> Dict[str, LeafDims]:
    """Flax path -> {mesh axis: the dim it splits} for the SHARDED_AXES of
    a mesh with these axis sizes (an axis the mesh lacks splits nothing; one
    of size 1 is kept, so that its collectives run). Raises ``ValueError``,
    naming the leaf and the axis, where a dim does not divide by its
    axis's size."""
    from ray_tpu_torch.models.transformer import state_dict_shapes

    shapes = state_dict_shapes(cfg)
    layout = {}
    for path, names in param_logical_axes(cfg).items():
        dims = {}
        for d, axes in enumerate(logical_to_mesh_axes(names)):
            for axis in (() if axes is None else (axes,)
                         if isinstance(axes, str) else axes):
                if axis not in SHARDED_AXES or axis not in sizes:
                    continue
                if shapes[path][d] % sizes[axis]:
                    raise ValueError(
                        f"{path} {shapes[path]}: dim {d} ({names[d]}, "
                        f"{shapes[path][d]}) does not split over the "
                        f"{axis} axis's {sizes[axis]} ranks")
                dims[axis] = d
        layout[path] = dims
    return layout


def piece_shape(shape: Sequence[int], dims: LeafDims,
                sizes: Mapping[str, int]) -> Tuple[int, ...]:
    """The shape of one rank's piece of a leaf of ``shape``."""
    out = list(shape)
    for axis, d in dims.items():
        out[d] //= sizes[axis]
    return tuple(out)


def cut_leaf(x: torch.Tensor, dims: LeafDims, sizes: Mapping[str, int],
             coords: Mapping[str, int]) -> torch.Tensor:
    """The piece of the whole leaf ``x`` at mesh coordinates ``coords``
    (axis -> index), as a contiguous tensor of its own."""
    for axis, d in dims.items():
        x = x.chunk(sizes[axis], d)[coords[axis]]
    return x.clone(memory_format=torch.contiguous_format)


def gather_leaf(piece: torch.Tensor, dims: LeafDims, groups) -> torch.Tensor:
    """The whole leaf (a new tensor) from every rank's ``piece``:
    all-gathered over each axis's group (``groups``: axis -> ``TorchGroup``)
    along the dim it splits, in rank order."""
    x = piece.clone(memory_format=torch.contiguous_format) if not dims \
        else piece
    for axis, d in dims.items():
        x = groups[axis].allgather(x.movedim(d, 0)).movedim(0, d)
    return x.contiguous()


__all__ = ["AXES", "LOGICAL_RULES", "SHARDED_AXES", "create_mesh",
           "cut_leaf", "default_mesh_axes", "gather_leaf",
           "logical_to_mesh_axes", "mesh_axis_sizes", "mesh_placements",
           "param_layout", "param_logical_axes", "piece_shape"]
