"""Mesh / sharding specs and pytrees for the weight and checkpoint planes:
the port of ``ray_tpu/weights/spec.py``, hardware-free by design.

Reference: a device mesh with named axes, a per-dimension partition of each
array over them, and the shard index map they induce (what a JAX
``NamedSharding`` describes), and the array-redistribution formulation of
"Memory-efficient array redistribution through portable collective
communication" (PAPERS.md): a resharding is fully described by (src mesh,
src partition, dst mesh, dst partition) and lowers to a set of shard-slice
exchanges. The planner (``plan.py``) needs only the *index geometry* of both
sides, never live devices, so plans can be computed (and unit-tested) on
any host.

Conventions:

- Devices of a mesh are numbered row-major over ``shape``; they are split
  contiguously across ``hosts`` (earlier devices on earlier hosts).
- A leaf's partition is a per-dimension tuple of mesh axis names (or None
  for replicated dims), one axis per dim.
- Boxes are tuples of ``(start, stop)`` pairs in GLOBAL array coordinates.

Trees (``flatten_tree``, ``unflatten_tree``) differ from the JAX module's in
two ways. A dataclass of this package (``parallel.train.OptState``) is
walked field by field, by reference, and rebuilt; the JAX module keeps any
dataclass whole, as one pickled leaf. And a named tuple is rebuilt only
from a class of this package or from ``OPTAX_STATES``, the optax states
that a JAX-written optimizer state holds, as plain named tuples with the
same fields: no module outside this package is imported. Any other class
comes back as a plain tuple, as the JAX module's does when its import
fails.
"""

from __future__ import annotations

import dataclasses
import importlib
from collections import namedtuple
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

Box = Tuple[Tuple[int, int], ...]  # ((start, stop), ...) per dim


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


@dataclass(frozen=True)
class MeshSpec:
    """Abstract device mesh: named axes over row-major devices, split
    contiguously across hosts."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    hosts: Tuple[str, ...]

    def __post_init__(self):
        shape = tuple(int(s) for s in self.shape)
        names = tuple(self.axis_names)
        hosts = tuple(self.hosts)
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "hosts", hosts)
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {shape} vs axis_names {names}")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate mesh axis names: {names}")
        if not hosts:
            raise ValueError("mesh needs at least one host")
        if self.size % len(hosts) != 0:
            raise ValueError(
                f"{self.size} devices do not split evenly over "
                f"{len(hosts)} hosts")

    @property
    def size(self) -> int:
        return _prod(self.shape)

    @property
    def devices_per_host(self) -> int:
        return self.size // len(self.hosts)

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def host_of(self, device: int) -> str:
        return self.hosts[device // self.devices_per_host]

    def host_rank(self, host: str) -> int:
        return self.hosts.index(host)

    def device_coords(self, device: int) -> Tuple[int, ...]:
        coords = []
        rem = device
        for s in reversed(self.shape):
            coords.append(rem % s)
            rem //= s
        return tuple(reversed(coords))

    @classmethod
    def host_mesh(cls, hosts, axis: str = "hosts") -> "MeshSpec":
        """1-D mesh with one device per host (serve replica sets, learner
        broadcast groups — any destination that is just N processes)."""
        hosts = tuple(hosts)
        return cls(shape=(len(hosts),), axis_names=(axis,), hosts=hosts)


def shard_box(mesh: MeshSpec, part: Tuple[Optional[str], ...],
              shape: Tuple[int, ...], device: int) -> Box:
    """The global-coordinate box of ``device``'s shard of an array."""
    if len(part) > len(shape):
        raise ValueError(f"partition {part} longer than array shape {shape}")
    coords = mesh.device_coords(device)
    box: List[Tuple[int, int]] = []
    for i, dim in enumerate(shape):
        axis = part[i] if i < len(part) else None
        if axis is None:
            box.append((0, dim))
            continue
        n = mesh.axis_size(axis)
        if dim % n != 0:
            raise ValueError(
                f"dim {i} ({dim}) not divisible by mesh axis "
                f"{axis!r} ({n})")
        chunk = dim // n
        c = coords[mesh.axis_names.index(axis)]
        box.append((c * chunk, (c + 1) * chunk))
    return tuple(box)


def unique_boxes(mesh: MeshSpec, part: Tuple[Optional[str], ...],
                 shape: Tuple[int, ...]) -> Dict[Box, Tuple[str, ...]]:
    """box -> hosts holding a replica of it (deduped, host order)."""
    out: Dict[Box, List[str]] = {}
    for d in range(mesh.size):
        box = shard_box(mesh, part, shape, d)
        holders = out.setdefault(box, [])
        h = mesh.host_of(d)
        if h not in holders:
            holders.append(h)
    return {b: tuple(hs) for b, hs in out.items()}


def host_boxes(mesh: MeshSpec, part: Tuple[Optional[str], ...],
               shape: Tuple[int, ...], host: str) -> Tuple[Box, ...]:
    """The distinct shard boxes resident on ``host`` (its devices' shards)."""
    per = mesh.devices_per_host
    rank = mesh.host_rank(host)
    seen: List[Box] = []
    for d in range(rank * per, (rank + 1) * per):
        box = shard_box(mesh, part, shape, d)
        if box not in seen:
            seen.append(box)
    return tuple(seen)


def box_nbytes(box: Box, itemsize: int) -> int:
    return _prod(stop - start for start, stop in box) * itemsize


def intersect_box(a: Box, b: Box) -> Optional[Box]:
    out = []
    for (a0, a1), (b0, b1) in zip(a, b):
        lo, hi = max(a0, b0), min(a1, b1)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)


def box_slices(box: Box) -> Tuple[slice, ...]:
    return tuple(slice(start, stop) for start, stop in box)


def rel_slices(box: Box, within: Box) -> Tuple[slice, ...]:
    """``box`` as slices relative to the origin of ``within`` (for indexing
    into a shard held locally)."""
    return tuple(slice(b0 - w0, b1 - w0)
                 for (b0, b1), (w0, _) in zip(box, within))


# ---------------------------------------------------------------------------
# PyTrees: flatten to {path: leaf} + a rebuildable skeleton
# ---------------------------------------------------------------------------


_PKG = "ray_tpu_torch"

# The optax states of the JAX package's ``make_optimizer`` chain, by class
# name, with their fields: what ``models.convert.from_jax_opt_state`` reads
# from a JAX-written optimizer state.
OPTAX_STATES = {
    "ScaleByAdamState": namedtuple("ScaleByAdamState", ["count", "mu", "nu"]),
    "ScaleByScheduleState": namedtuple("ScaleByScheduleState", ["count"]),
    "EmptyState": namedtuple("EmptyState", []),
}


def _class_name(cls) -> str:
    return f"{cls.__module__}:{cls.__qualname__}"


def _own_class(name: str):
    """The class ``"module:qualname"`` of this package, or None for a class
    of any other package (which is never imported)."""
    mod, _, qual = name.partition(":")
    if mod != _PKG and not mod.startswith(_PKG + "."):
        return None
    try:
        cls = importlib.import_module(mod)
        for part in qual.split("."):
            cls = getattr(cls, part)
    except (ImportError, AttributeError):
        return None
    return cls


def flatten_tree(tree: Any, _prefix: str = "") -> Tuple[Any, Dict[str, Any]]:
    """Flatten a nested dict/list/tuple pytree into (skeleton, leaves).

    The skeleton mirrors the nesting with each leaf replaced by its path
    string — it is JSON-encodable (plain containers + strings) and
    ``unflatten_tree(skeleton, leaves)`` rebuilds the original structure.
    A dataclass of this package is walked field by field (its fields are
    read, never copied); any other object is a leaf.
    """
    leaves: Dict[str, Any] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in sorted(node.items())}
        if isinstance(node, (list, tuple)):
            out = [walk(v, f"{prefix}{i}/") for i, v in enumerate(node)]
            if isinstance(node, list):
                return out
            if type(node) is not tuple and hasattr(node, "_fields"):
                # a namedtuple (optimizer states are trees of these):
                # remember the concrete class so unflatten can rebuild it
                # instead of degrading to a plain tuple
                return ["__namedtuple__", _class_name(type(node))] + out
            return ["__tuple__"] + out
        if (dataclasses.is_dataclass(node) and not isinstance(node, type)
                and _own_class(_class_name(type(node))) is type(node)):
            return ["__dataclass__", _class_name(type(node)),
                    {f.name: walk(getattr(node, f.name),
                                  f"{prefix}{f.name}/")
                     for f in dataclasses.fields(node)}]
        path = prefix.rstrip("/") or "leaf"
        if path in leaves:
            raise ValueError(f"duplicate leaf path {path!r}")
        leaves[path] = node
        return path

    skeleton = walk(tree, _prefix)
    return skeleton, leaves


def unflatten_tree(skeleton: Any, leaves: Dict[str, Any]) -> Any:
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            if node and node[0] == "__tuple__":
                return tuple(walk(v) for v in node[1:])
            if node and node[0] == "__namedtuple__":
                values = [walk(v) for v in node[2:]]
                mod, _, qual = node[1].partition(":")
                cls = _own_class(node[1])
                if cls is None and mod.split(".")[0] == "optax":
                    cls = OPTAX_STATES.get(qual.rsplit(".", 1)[-1])
                if cls is None:
                    return tuple(values)  # class unknown here: degrade
                return cls(*values)
            if node and node[0] == "__dataclass__":
                cls = _own_class(node[1])
                if cls is None:
                    raise ValueError(f"dataclass {node[1]!r} is not a class "
                                     f"of {_PKG}")
                return cls(**{k: walk(v) for k, v in node[2].items()})
            return [walk(v) for v in node]
        return leaves[node]

    return walk(skeleton)


# ---------------------------------------------------------------------------
# Sharded tree spec: one side of a reshard
# ---------------------------------------------------------------------------


@dataclass
class ShardedTreeSpec:
    """Which mesh holds the tree, how each leaf is partitioned, and every
    leaf's (shape, dtype) — everything the planner needs about one side."""

    mesh: MeshSpec
    parts: Dict[str, Tuple[Optional[str], ...]]  # leaf path -> partition
    meta: Dict[str, Tuple[Tuple[int, ...], str]]  # path -> (shape, dtype str)

    def part_of(self, path: str) -> Tuple[Optional[str], ...]:
        return tuple(self.parts.get(path, ()))

    def leaf_nbytes(self, path: str) -> int:
        import numpy as np

        shape, dtype = self.meta[path]
        return _prod(shape) * np.dtype(dtype).itemsize

    @classmethod
    def from_tree(cls, tree: Any, mesh: MeshSpec,
                  parts: Optional[Dict[str, Tuple[Optional[str], ...]]] = None,
                  default_part: Tuple[Optional[str], ...] = (),
                  ) -> "ShardedTreeSpec":
        """Spec for a tree of array-likes (numpy arrays or tensors). ``parts`` maps leaf paths to
        partitions; unlisted leaves use ``default_part`` (default:
        fully replicated)."""
        _, leaves = flatten_tree(tree)
        meta = {}
        out_parts = {}
        for path, leaf in leaves.items():
            meta[path] = leaf_meta(leaf)
            out_parts[path] = tuple((parts or {}).get(path, default_part))
        return cls(mesh=mesh, parts=out_parts, meta=meta)

    @classmethod
    def replicated(cls, tree: Any, hosts) -> "ShardedTreeSpec":
        """Fully-replicated spec over one device per host — the broadcast
        destination shape (N env-runners, N serve replicas)."""
        return cls.from_tree(tree, MeshSpec.host_mesh(hosts))

    def total_unique_bytes(self) -> int:
        """Sum over leaves of unique (deduplicated) shard bytes."""
        import numpy as np

        total = 0
        for path, (shape, dtype) in self.meta.items():
            item = np.dtype(dtype).itemsize
            for box in unique_boxes(self.mesh, self.part_of(path), shape):
                total += box_nbytes(box, item)
        return total


def leaf_meta(leaf: Any) -> Tuple[Tuple[int, ...], str]:
    """(shape, numpy dtype string) of an array-like leaf; a tensor's is read
    without copying it off its device (a bf16 one raises ``TypeError``:
    numpy has no bf16 without ``ml_dtypes``, which the card lacks)."""
    import numpy as np
    import torch

    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape),
                torch.empty(0, dtype=leaf.dtype).numpy().dtype.str)
    arr = np.asarray(leaf)
    return tuple(arr.shape), arr.dtype.str


def spec_payload(spec: ShardedTreeSpec) -> dict:
    """The spec as the JSON payload a manifest records (the JAX package's
    ``weights/store.py:_spec_payload``)."""
    return {
        "mesh": {"shape": list(spec.mesh.shape),
                 "axis_names": list(spec.mesh.axis_names),
                 "hosts": list(spec.mesh.hosts)},
        "parts": {k: list(v) for k, v in spec.parts.items()},
        "meta": {k: [list(shape), dtype] for k, (shape, dtype) in
                 spec.meta.items()},
    }


def spec_from_payload(d: dict) -> ShardedTreeSpec:
    m = d["mesh"]
    return ShardedTreeSpec(
        mesh=MeshSpec(tuple(m["shape"]), tuple(m["axis_names"]),
                      tuple(m["hosts"])),
        parts={k: tuple(v) for k, v in d["parts"].items()},
        meta={k: (tuple(v[0]), v[1]) for k, v in d["meta"].items()},
    )
