"""Typed, versioned wire schema for control-plane RPC payloads.

Reference: ``src/ray/protobuf/{common,gcs_service,node_manager}.proto`` — the
reference gives every control-plane message a typed, versioned schema; a
pickle-speaking control port is arbitrary-code-execution for anyone who can
reach it, and has zero cross-version compatibility. Here every control-plane
payload is strict msgpack: only primitives, containers, and an explicit
registry of framework structs (encoded as msgpack ext types with per-class
field lists) can cross the wire.

Security property: :func:`loads` never executes user-controlled code. Decoding
rehydrates only classes in the fixed registry below, by constructing them from
plain field values. A pickled blob fed to :func:`loads` raises — it is never
unpickled. User payloads (task args, results, exceptions, function blobs)
remain opaque ``bytes`` fields inside these typed envelopes and are
deserialized only in user-trust context (the owning driver or the executing
worker), exactly like the reference keeps user data inside ``bytes`` protobuf
fields.

Versioning: :data:`WIRE_VERSION` rides in every RPC frame header (rpc.py);
frames with a missing or mismatched version are rejected before the payload is
touched. Struct fields are encoded by NAME, so adding a field with a default
is forward- and backward-compatible within a version; renames/removals bump
``WIRE_VERSION``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple, Type

from ray_tpu_torch._private import msgpack

WIRE_VERSION = 1

_EXT_STRUCT = 1  # registered framework struct: packb([tag, {field: value}])
_EXT_ID = 2  # framework id: packb([tag, binary])
_EXT_SET = 3  # set: packb([items])
_EXT_NDARRAY = 5  # numpy array: packb([dtype_str, shape, raw_bytes])


class WireError(TypeError):
    """A value outside the typed schema tried to cross the control plane."""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

# raylint: disable=FRK001 import-time append-only registry, identical in parent and child: register_* runs at module import, so the zygote image and a fresh process hold the same entries and a reset would only re-register them
_STRUCTS: Dict[str, tuple] = {}  # tag -> (cls, fields, decode)
_STRUCT_TAGS: Dict[Type, str] = {}
_IDS: Dict[str, Type] = {}
_ID_TAGS: Dict[Type, str] = {}


def register_struct(cls: Type, fields: Tuple[str, ...] = None, tag: str = None,
                    decode: Callable[[dict], Any] = None) -> Type:
    """Allow ``cls`` on the wire, encoded as its named fields.

    Decoding calls ``cls(**fields)`` for dataclass-style types — missing
    fields (older sender) fall back to constructor defaults; unknown fields
    (newer sender) are dropped. Pass ``decode`` when the constructor's
    parameter names differ from the attribute names.
    """
    if fields is None:
        import dataclasses

        fields = tuple(f.name for f in dataclasses.fields(cls))
    tag = tag or cls.__name__
    if tag in _STRUCTS and _STRUCTS[tag][0] is not cls:
        raise ValueError(f"wire tag collision: {tag}")
    _STRUCTS[tag] = (cls, fields, decode)
    _STRUCT_TAGS[cls] = tag
    return cls


def register_id(cls: Type, tag: str = None) -> Type:
    tag = tag or cls.__name__
    _IDS[tag] = cls
    _ID_TAGS[cls] = tag
    return cls


def _register_builtin_types():
    from ray_tpu_torch._private import common, ids

    for c in (ids.JobID, ids.NodeID, ids.WorkerID, ids.ActorID, ids.TaskID,
              ids.ObjectID, ids.PlacementGroupID):
        register_id(c)
    for c in (common.NodeInfo, common.TaskOptions, common.ActorOptions,
              common.TaskSpec, common.Bundle, common.PlacementGroupSpec,
              common.WorkerLease):
        register_struct(c)
    from ray_tpu_torch.util import scheduling_strategies as ss

    for c in (ss.PlacementGroupSchedulingStrategy, ss.NodeAffinitySchedulingStrategy,
              ss.NodeLabelSchedulingStrategy, ss.SpreadSchedulingStrategy):
        register_struct(c)
    from ray_tpu_torch.util.placement_group import PlacementGroup

    register_struct(
        PlacementGroup, fields=("id", "bundle_specs"),
        decode=lambda f: PlacementGroup(f["id"], f["bundle_specs"]))

    # weight plane (weights/): mesh geometry + transfer-plan edges
    # cross the control plane (store manifests, dashboard stats)
    from ray_tpu_torch.weights.plan import TransferEdge
    from ray_tpu_torch.weights.spec import MeshSpec

    register_struct(
        MeshSpec, fields=("shape", "axis_names", "hosts"),
        decode=lambda f: MeshSpec(tuple(f["shape"]), tuple(f["axis_names"]),
                                  tuple(f["hosts"])))
    register_struct(
        TransferEdge,
        fields=("leaf", "src_host", "dst_host", "box", "src_box", "dst_box",
                "nbytes", "local"),
        decode=lambda f: TransferEdge(
            leaf=f["leaf"], src_host=f["src_host"], dst_host=f["dst_host"],
            box=tuple(tuple(p) for p in f["box"]),
            src_box=tuple(tuple(p) for p in f["src_box"]),
            dst_box=tuple(tuple(p) for p in f["dst_box"]),
            nbytes=f["nbytes"], local=f["local"]))


# ---------------------------------------------------------------------------
# Codec
# ---------------------------------------------------------------------------


def _default(obj: Any):
    cls = type(obj)
    tag = _ID_TAGS.get(cls)
    if tag is not None:
        return msgpack.ExtType(
            _EXT_ID, msgpack.packb([tag, obj.binary()]))
    tag = _STRUCT_TAGS.get(cls)
    if tag is not None:
        _, fields, _ = _STRUCTS[tag]
        payload = {name: getattr(obj, name) for name in fields}
        return msgpack.ExtType(
            _EXT_STRUCT,
            msgpack.packb([tag, payload], default=_default))
    if cls is set or cls is frozenset:
        return msgpack.ExtType(
            _EXT_SET,
            msgpack.packb(sorted(obj, key=repr), default=_default))
    import numpy as np

    if isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        if arr.dtype.hasobject:
            raise WireError("object-dtype arrays cannot cross the control plane")
        return msgpack.ExtType(
            _EXT_NDARRAY,
            msgpack.packb([arr.dtype.str, list(arr.shape), arr.tobytes()]))
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    raise WireError(
        f"{cls.__module__}.{cls.__name__} is not wire-typed; control-plane "
        f"messages may only carry primitives, containers, and registered "
        f"framework structs (register_struct/register_id)")


def _ext_hook(code: int, data: bytes):
    if code == _EXT_ID:
        tag, binary = msgpack.unpackb(data)
        cls = _IDS.get(tag)
        if cls is None:
            raise WireError(f"unknown wire id tag {tag!r}")
        return cls(binary)
    if code == _EXT_STRUCT:
        tag, fields = msgpack.unpackb(data, ext_hook=_ext_hook)
        entry = _STRUCTS.get(tag)
        if entry is None:
            raise WireError(f"unknown wire struct tag {tag!r}")
        cls, known, decode = entry
        fields = {k: v for k, v in fields.items() if k in known}
        return decode(fields) if decode is not None else cls(**fields)
    if code == _EXT_SET:
        return set(msgpack.unpackb(data, ext_hook=_ext_hook))
    if code == _EXT_NDARRAY:
        import numpy as np

        dtype_str, shape, raw = msgpack.unpackb(data)
        return np.frombuffer(raw, dtype=np.dtype(dtype_str)).reshape(shape)
    raise WireError(f"unknown wire ext code {code}")


def dumps(obj: Any) -> bytes:
    """Encode a control-plane message. Raises WireError on unregistered types."""
    if not _STRUCTS:
        _register_builtin_types()
    try:
        return msgpack.packb(obj, default=_default)
    except WireError:
        raise
    except (TypeError, ValueError) as e:
        raise WireError(f"cannot wire-encode {type(obj).__name__}: {e}") from e


def loads(blob: bytes) -> Any:
    """Decode a control-plane message. Never executes code; raises WireError
    on malformed input (including pickle blobs)."""
    if not _STRUCTS:
        _register_builtin_types()
    if not blob:
        return None
    try:
        return msgpack.unpackb(blob, ext_hook=_ext_hook)
    except WireError:
        raise
    except Exception as e:
        raise WireError(f"malformed wire payload: {e}") from e
