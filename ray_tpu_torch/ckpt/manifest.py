"""Checkpoint manifests: the durable unit of the checkpoint plane. The port
of ``ray_tpu/ckpt/manifest.py``, with the same on-disk format, so either
package reads the other's checkpoints.

A checkpoint is an immutable *manifest* plus a set of content-addressed
*chunk* files:

- a chunk is the bytes of one shard box of one array leaf (or one opaque
  pickled non-array leaf), named by the SHA-256 of its bytes and stored
  under ``<root>/chunks/<hh>/<hash>``. Identical bytes — e.g. a frozen
  embedding table that did not change between steps — hash to the same
  file, so consecutive saves share chunks and an incremental save writes
  only the delta;
- the manifest records the tree skeleton, the sharded-tree geometry
  (``weights.spec.ShardedTreeSpec`` payload), every leaf's chunk list
  ``(box, hash, nbytes)``, the parent checkpoint id, user metrics, and
  byte-accounting stats. It is serialized as JSON under
  ``<root>/manifests/<ckpt_id>.json``.

Atomicity invariant: every file of the checkpoint layout — chunks,
manifests, the ``LATEST`` pointer, pins, saver part-files — is written
through :func:`atomic_write` (write temp + fsync + rename). A reader can
never observe a torn file: either the old bytes or the new bytes, and
``LATEST`` only moves *after* its manifest (and all chunks the manifest
names) are durable. A crash mid-save leaves stray temp files and possibly
orphan chunks (garbage-collected by retention), never a visible partial
checkpoint. No checkpoint-plane code opens a file for writing outside this
helper.

The geometry intentionally matches the weight plane: the same
``(leaf, box)`` chunk model means restore-time resharding reuses
``weights/plan.py`` verbatim — a restore onto a different mesh reads only
the chunk bytes intersecting each host's destination boxes and never
gathers a full leaf anywhere.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import uuid
from typing import Any, Dict, List, Optional, Tuple

Box = Tuple[Tuple[int, int], ...]

# leaf kinds
ND = "nd"  # numpy array: raw C-order bytes, shardable by box
PY = "py"  # opaque python leaf: serialization.dumps_oob bytes, never sharded

MANIFEST_DIR = "manifests"
CHUNK_DIR = "chunks"
PART_DIR = "parts"
LATEST_FILE = "LATEST"
PINS_FILE = "PINS"


# ---------------------------------------------------------------------------
# the single write chokepoint
# ---------------------------------------------------------------------------


def atomic_write(path: str, data: bytes) -> None:
    """Crash-safe file write: temp file + fsync + rename into place.

    The rename is atomic on POSIX, so concurrent readers see either the
    previous content or the full new content — never a torn file. The
    temp name carries pid+nonce so concurrent writers of the same target
    (two hosts racing on the same content-addressed chunk) cannot clobber
    each other's temp file; last rename wins with identical bytes.
    """
    path = os.fspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    with open(tmp, "wb") as f:  # this IS the helper
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    # make the rename itself durable (the dirent lives in the directory)
    try:
        dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


# ---------------------------------------------------------------------------
# boxes / chunk keys (same codec as the weight plane)
# ---------------------------------------------------------------------------


def encode_box(box: Optional[Box]) -> str:
    if box is None:
        return ""
    return ",".join(f"{a}:{b}" for a, b in box)


def decode_box(s: str) -> Optional[Box]:
    if not s:
        return None
    return tuple(tuple(int(x) for x in part.split(":")) for part in s.split(","))


def chunk_hash(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def chunk_path(root: str, h: str) -> str:
    return os.path.join(root, CHUNK_DIR, h[:2], h)


def write_chunk(root: str, data: bytes) -> Tuple[str, bool]:
    """Store ``data`` content-addressed. Returns ``(hash, created)`` —
    ``created=False`` is the dedup hit: the bytes already exist on disk
    and nothing is written."""
    h = chunk_hash(data)
    path = chunk_path(root, h)
    if os.path.exists(path):
        return h, False
    atomic_write(path, data)
    return h, True


def read_chunk(root: str, h: str) -> bytes:
    with open(chunk_path(root, h), "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# manifest
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LeafEntry:
    """One leaf's chunk list. For ``kind == ND``, ``chunks`` maps encoded
    shard boxes (global coordinates) to ``(hash, nbytes)``; for ``PY`` a
    single entry under the empty box."""

    kind: str
    shape: Tuple[int, ...]
    dtype: str
    chunks: Dict[str, Tuple[str, int]]

    def to_json(self) -> dict:
        return {"kind": self.kind, "shape": list(self.shape),
                "dtype": self.dtype,
                "chunks": {k: [h, n] for k, (h, n) in self.chunks.items()}}

    @classmethod
    def from_json(cls, d: dict) -> "LeafEntry":
        return cls(kind=d["kind"], shape=tuple(d["shape"]), dtype=d["dtype"],
                   chunks={k: (v[0], int(v[1]))
                           for k, v in d["chunks"].items()})


@dataclasses.dataclass
class Manifest:
    ckpt_id: str
    step: int
    ts: float
    parent: Optional[str]
    skeleton: Any
    spec: Optional[dict]  # ShardedTreeSpec payload (weights.spec codec)
    leaves: Dict[str, LeafEntry]
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # -- accounting ----------------------------------------------------

    def chunk_set(self) -> Dict[str, int]:
        """hash -> nbytes over every chunk this manifest references
        (deduplicated: a chunk shared by two leaves counts once)."""
        out: Dict[str, int] = {}
        for entry in self.leaves.values():
            for h, n in entry.chunks.values():
                out[h] = n
        return out

    def total_bytes(self) -> int:
        return sum(n for _, entry in sorted(self.leaves.items())
                   for _, n in entry.chunks.values())

    def to_json(self) -> dict:
        return {
            "version": 1,
            "ckpt_id": self.ckpt_id,
            "step": self.step,
            "ts": self.ts,
            "parent": self.parent,
            "skeleton": self.skeleton,
            "spec": self.spec,
            "leaves": {k: v.to_json() for k, v in sorted(self.leaves.items())},
            "metrics": self.metrics,
            "stats": self.stats,
        }

    @classmethod
    def from_json(cls, d: dict) -> "Manifest":
        return cls(
            ckpt_id=d["ckpt_id"], step=int(d["step"]), ts=float(d["ts"]),
            parent=d.get("parent"), skeleton=d["skeleton"],
            spec=d.get("spec"),
            leaves={k: LeafEntry.from_json(v)
                    for k, v in d["leaves"].items()},
            metrics=d.get("metrics") or {},
            stats=d.get("stats") or {},
        )


def new_ckpt_id(step: int) -> str:
    """Sortable-by-step, collision-free id."""
    return f"step{int(step):010d}-{uuid.uuid4().hex[:8]}"


def manifest_path(root: str, ckpt_id: str) -> str:
    return os.path.join(root, MANIFEST_DIR, f"{ckpt_id}.json")


def write_manifest(root: str, manifest: Manifest) -> str:
    """Persist the manifest (atomically). Does NOT move ``LATEST`` — that
    is the separate, last step of a commit (see ``commit``)."""
    path = manifest_path(root, manifest.ckpt_id)
    atomic_write(path, json.dumps(manifest.to_json(), sort_keys=True,
                                  default=_json_default).encode())
    return path


def _json_default(v):
    try:
        import numpy as np

        if isinstance(v, np.generic):
            return v.item()
        if isinstance(v, np.ndarray):
            return v.tolist()
    except ImportError:
        pass
    raise TypeError(f"manifest field of type {type(v).__name__} is not "
                    f"JSON-encodable")


def read_manifest(root: str, ckpt_id: str) -> Manifest:
    with open(manifest_path(root, ckpt_id)) as f:
        return Manifest.from_json(json.load(f))


def commit(root: str, manifest: Manifest) -> None:
    """The atomic publish: manifest file first, then the ``LATEST``
    pointer. A crash between the two leaves a valid (restorable, listable)
    checkpoint that simply is not ``latest`` yet; a crash before the
    manifest write leaves only orphan chunks, invisible to every reader."""
    write_manifest(root, manifest)
    atomic_write(os.path.join(root, LATEST_FILE),
                 json.dumps({"ckpt_id": manifest.ckpt_id,
                             "step": manifest.step,
                             "ts": manifest.ts}).encode())


def read_latest_id(root: str) -> Optional[str]:
    """The committed ``LATEST`` pointer, validated against the manifest it
    names (a pointer to a missing/torn manifest is ignored — restore then
    falls back to the newest listable checkpoint)."""
    try:
        with open(os.path.join(root, LATEST_FILE)) as f:
            ckpt_id = json.load(f)["ckpt_id"]
    except (FileNotFoundError, json.JSONDecodeError, KeyError):
        return None
    try:
        read_manifest(root, ckpt_id)
    except (FileNotFoundError, json.JSONDecodeError, KeyError, ValueError):
        return None
    return ckpt_id


def list_manifest_ids(root: str) -> List[str]:
    """Every *valid* manifest id, sorted oldest-first (step, then commit
    ts). Torn or unparsable manifest files are skipped, not raised — a
    crashed save must not poison listing."""
    mdir = os.path.join(root, MANIFEST_DIR)
    try:
        names = os.listdir(mdir)
    except FileNotFoundError:
        return []
    rows = []
    for name in names:
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(mdir, name)) as f:
                d = json.load(f)
            rows.append((int(d["step"]), float(d["ts"]), d["ckpt_id"]))
        except (json.JSONDecodeError, KeyError, ValueError, OSError):
            continue
    rows.sort()
    return [cid for _, _, cid in rows]


# ---------------------------------------------------------------------------
# diff: what actually changed between two checkpoints
# ---------------------------------------------------------------------------


def diff_manifests(a: Manifest, b: Manifest) -> Dict[str, Any]:
    """Chunk-level delta between two checkpoints: shared bytes (stored
    once thanks to content addressing), bytes only in each side, and the
    leaves whose chunk sets differ."""
    ca, cb = a.chunk_set(), b.chunk_set()
    shared = set(ca) & set(cb)
    only_a = set(ca) - shared
    only_b = set(cb) - shared
    changed_leaves = sorted(
        leaf for leaf in set(a.leaves) | set(b.leaves)
        if (ea := a.leaves.get(leaf)) is None or (eb := b.leaves.get(leaf)) is None
        or {h for h, _ in ea.chunks.values()} != {h for h, _ in eb.chunks.values()})
    total_b = sum(cb.values())
    return {
        "a": a.ckpt_id, "b": b.ckpt_id,
        "shared_chunks": len(shared),
        "shared_bytes": sum(ca[h] for h in shared),
        "only_a_chunks": len(only_a),
        "only_a_bytes": sum(ca[h] for h in only_a),
        "only_b_chunks": len(only_b),
        "only_b_bytes": sum(cb[h] for h in only_b),
        "changed_leaves": changed_leaves,
        "dedup_ratio": (sum(cb[h] for h in shared) / total_b)
        if total_b else 1.0,
    }
