"""Versioned WeightStore: a named handle for sharded weight hand-off, the
port of ``ray_tpu/weights/store.py`` on this package's runtime, checkpoint
plane (the durable cold tier) and codecs (``collective/quant.py``, on
tensors: chunks are numpy arrays here as there, and go through torch only
to be encoded or decoded). A leaf may be a numpy array or a CPU or CUDA
tensor; it is published as its numpy value. The chunk keys, the sha256
content addresses, the manifests and the stats are the JAX store's.

Reference: the reference ships weights learner->workers through
``ray.put`` + polling named actors (rllib) or NCCL broadcast groups; here
the hand-off is a first-class, versioned control point:

- ``WeightStoreActor`` is a named (GCS-registered), detached actor holding
  per-version chunk manifests. A chunk is one planner box of one leaf.
- Publishers either ship chunk BYTES to the actor, which re-``put``s them so
  the refs are owned by the store and survive publisher death
  (``durable=True`` — the elastic re-form path), or ``put`` chunks
  themselves and register only refs (``durable=False`` — zero extra copy;
  the learner-broadcast fast path, valid while the publisher lives).
- Consumers ``pull(version)`` a full tree (broadcast) or
  ``pull_shards(version, dst_spec, host)`` — only the chunks intersecting
  their destination boxes cross the wire, never a gathered array.
- ``subscribe()`` long-polls the actor for commits, giving N consumers a
  push-shaped broadcast without busy polling.

Version monotonicity: versions are ints; ``commit`` refuses to move
``latest`` backwards, and subscriptions only ever surface strictly newer
versions. Per-version transfer stats (bytes published/pulled, edges,
fan-out) are mirrored to the GCS KV ``weights`` namespace for the
dashboard's ``/api/weights``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.weights.spec import (
    Box,
    MeshSpec,
    ShardedTreeSpec,
    box_slices,
    flatten_tree,
    unflatten_tree,
)

_STORE_PREFIX = "rtpu_weight_store:"
_KEEP_VERSIONS = 2  # committed versions retained (older chunks freed)

_obs_lock = threading.Lock()
_obs_metrics: Optional[dict] = None


def _obs() -> dict:
    """Lazily-created weight-plane metrics on the shared registry (always
    on: every publish/pull edge lands in ``/metrics``)."""
    global _obs_metrics
    with _obs_lock:
        if _obs_metrics is None:
            from ray_tpu_torch.util.metrics import Histogram

            bounds = [0.01, 0.1, 1, 10, 100]
            _obs_metrics = {
                "publish": Histogram(
                    "ray_tpu.weights.publish_seconds",
                    "one publisher's chunk publish into a weight store",
                    boundaries=bounds),
                "pull": Histogram(
                    "ray_tpu.weights.pull_seconds",
                    "one consumer's chunk pull/assembly from a weight "
                    "store", boundaries=bounds),
                "reshard": Histogram(
                    "ray_tpu.weights.reshard_seconds",
                    "collective/XLA-tier reshard execution",
                    boundaries=bounds),
            }
        return _obs_metrics


def _encode_box(box: Box) -> str:
    return ",".join(f"{a}:{b}" for a, b in box)


def _decode_box(s: str) -> Box:
    if not s:
        return ()
    return tuple(tuple(int(x) for x in part.split(":")) for part in s.split(","))


def _chunk_key(leaf: str, box: Box) -> str:
    return f"{leaf}|{_encode_box(box)}"


def _as_numpy(value: Any) -> np.ndarray:
    """A leaf's value as a numpy array (a tensor is copied to the host)."""
    if hasattr(value, "detach") and hasattr(value, "cpu"):
        value = value.detach().cpu()
        if str(value.dtype) == "torch.bfloat16":
            raise TypeError("numpy has no bfloat16: publish the leaf in "
                            "float32 (or pass compression='bf16')")
        return value.numpy()
    return np.asarray(value)


def _tensor(arr: np.ndarray):
    """A CPU tensor over ``arr``'s buffer (copied when it is read-only, as
    an object-store value is)."""
    import torch

    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


def _decode_chunk(val: Any, chunk_entry: dict) -> np.ndarray:
    """Undo a chunk's manifest-recorded quantized encoding (a no-op for
    plain chunks) — pulls are transparent to the publisher's codec."""
    enc = chunk_entry.get("enc")
    if enc is None:
        return np.asarray(val)
    from ray_tpu_torch.collective.quant import decode_array

    # the manifest names the dtype as numpy does (the JAX store's "<f4");
    # the codec names it as torch does ("float32")
    enc = dict(enc, dtype=np.dtype(enc["dtype"]).name)
    return decode_array(_tensor(np.asarray(val)), enc).numpy()


def _split_key(key: str) -> Tuple[str, Box]:
    leaf, _, flat = key.rpartition("|")
    return leaf, _decode_box(flat)


def _spec_payload(spec: ShardedTreeSpec) -> dict:
    return {
        "mesh": {"shape": list(spec.mesh.shape),
                 "axis_names": list(spec.mesh.axis_names),
                 "hosts": list(spec.mesh.hosts)},
        "parts": {k: list(v) for k, v in spec.parts.items()},
        "meta": {k: [list(shape), dtype] for k, (shape, dtype) in
                 spec.meta.items()},
    }


def _spec_from_payload(d: dict) -> ShardedTreeSpec:
    m = d["mesh"]
    return ShardedTreeSpec(
        mesh=MeshSpec(tuple(m["shape"]), tuple(m["axis_names"]),
                      tuple(m["hosts"])),
        parts={k: tuple(v) for k, v in d["parts"].items()},
        meta={k: (tuple(v[0]), v[1]) for k, v in d["meta"].items()},
    )


class WeightStoreActor:
    """Named actor holding versioned chunk manifests (sync methods run on
    executor threads, so object-plane calls are safe; only ``poll`` is
    async and costs no thread while parked)."""

    def __init__(self, name: str, durable_root: Optional[str] = None):
        self.name = name
        self._versions: Dict[int, dict] = {}
        self._latest = -1
        self._counter = 0
        # optional cold tier: durable publishes additionally persist as
        # PINNED checkpoint-plane manifests under this root (and ride a
        # TieredStore's remote backend when the root is tiered) — a
        # committed durable version then survives not just publisher
        # death but full-cluster death
        self._durable_root = durable_root
        self._dstore: Optional[Any] = None

    # -- publish side --------------------------------------------------

    def next_version(self) -> int:
        self._counter = max(self._counter, self._latest) + 1
        return self._counter

    def begin(self, version: int, skeleton: Any, spec_payload: dict,
              num_chunks: int) -> bool:
        """Open ``version`` for publishing. Idempotent across the source
        hosts (each calls begin with the same deterministic arguments)."""
        v = self._versions.get(version)
        if v is None and version <= self._latest:
            # a KNOWN version may be re-begun (a publisher whose plan gave
            # it zero chunks can arrive after the commit); an unknown one
            # below latest is a real monotonicity violation
            raise ValueError(
                f"version {version} not monotonic (latest is {self._latest})")
        if v is None:
            self._versions[version] = {
                "skeleton": skeleton, "spec": spec_payload,
                "num_chunks": int(num_chunks), "chunks": {},
                "committed": False, "ts": time.time(),
                "bytes_published": 0, "bytes_pulled": 0, "num_pulls": 0,
                "bytes_reused": 0,
            }
        return True

    def put_chunks(self, version: int, blobs: Dict[str, Any],
                   meta: Optional[Dict[str, dict]] = None) -> int:
        """Durable path: chunk bytes arrive as args; re-put them so the
        refs are OWNED by this actor and outlive the publisher. ``meta``
        carries per-key ``{"sha", "enc", "raw_nbytes"}`` — the content
        address (delta base) and the quantized encoding (pulls decode
        transparently)."""
        v = self._versions[version]
        meta = meta or {}
        for key, arr in blobs.items():
            if key in v["chunks"]:
                continue
            arr = np.asarray(arr)
            m = meta.get(key, {})
            v["chunks"][key] = {"ref": ray_tpu_torch.put(arr),
                                "nbytes": arr.nbytes,
                                "dtype": arr.dtype.str,
                                "sha": m.get("sha", ""),
                                "enc": m.get("enc"),
                                "owned": True,
                                "raw_nbytes": int(m.get("raw_nbytes",
                                                        arr.nbytes))}
            v["bytes_published"] += arr.nbytes
        self._maybe_commit(version)
        return len(v["chunks"])

    def register_chunks(self, version: int,
                        refs: Dict[str, List[Any]],
                        nbytes: Dict[str, int],
                        dtypes: Dict[str, str],
                        meta: Optional[Dict[str, dict]] = None) -> int:
        """Zero-copy path: the publisher ``put`` the chunks; we only hold
        the refs (valid while the publisher's owner process lives)."""
        v = self._versions[version]
        meta = meta or {}
        for key, boxed_ref in refs.items():
            if key in v["chunks"]:
                continue
            m = meta.get(key, {})
            v["chunks"][key] = {"ref": boxed_ref[0],
                                "nbytes": int(nbytes[key]),
                                "dtype": dtypes[key],
                                "sha": m.get("sha", ""),
                                "enc": m.get("enc"),
                                "owned": False,
                                "raw_nbytes": int(m.get("raw_nbytes",
                                                        nbytes[key]))}
            v["bytes_published"] += int(nbytes[key])
        self._maybe_commit(version)
        return len(v["chunks"])

    def chunk_shas(self, version: int) -> Dict[str, Tuple[str, Optional[str]]]:
        """Per-chunk ``(raw-byte sha, stored encoding spec or None)`` of a
        committed version (the delta base) — the publisher needs BOTH: a
        sha match alone is not enough to alias a chunk whose stored bytes
        are a lossy encoding of those raw bytes. Raises for unknown/
        uncommitted/retired versions — the publisher falls back to a full
        publish."""
        v = self._versions.get(version)
        if v is None or not v["committed"] or v.get("retired"):
            raise KeyError(
                f"weight store {self.name!r} version {version} is not "
                f"available as a delta base (unknown, uncommitted or "
                f"retired)")
        out = {}
        for k, c in v["chunks"].items():
            enc = c.get("enc")
            spec = f"{enc['codec']}:{enc['block']}" if enc else None
            out[k] = (c.get("sha", ""), spec)
        return out

    def reuse_chunks(self, version: int, keys: List[str],
                     from_version: int, durable: bool = False) -> int:
        """Delta publish: alias ``keys`` of ``from_version`` into
        ``version`` by content address — the chunk refs are shared, so no
        bytes move and retention of the SOURCE version later cannot
        invalidate them (the entry copies keep the refs alive). A
        ``durable`` target must OWN every chunk: refs borrowed from a
        zero-copy (non-durable) base are re-put here, or the durable
        guarantee would silently die with the base's publisher process."""
        v = self._versions[version]
        src = self._versions.get(from_version)
        if src is None or src.get("retired"):
            raise KeyError(f"delta base version {from_version} is gone")
        reused = 0
        for key in keys:
            if key in v["chunks"]:
                continue
            c = src["chunks"].get(key)
            if c is None:
                raise KeyError(
                    f"delta base version {from_version} has no chunk "
                    f"{key!r}")
            ent = dict(c)
            if durable and not c.get("owned"):
                ent["ref"] = ray_tpu_torch.put(np.asarray(ray_tpu_torch.get(c["ref"])))
                ent["owned"] = True
            v["chunks"][key] = ent
            v["bytes_reused"] += int(c.get("raw_nbytes", c["nbytes"]))
            reused += 1
        self._maybe_commit(version)
        return reused

    def _maybe_commit(self, version: int):
        v = self._versions[version]
        if v["committed"] or len(v["chunks"]) < v["num_chunks"]:
            return
        v["committed"] = True
        if version > self._latest:
            self._latest = version
        self._persist_durable(version)
        # bound retention: drop chunk refs of superseded versions (the
        # refcounter frees owned objects once nothing borrows them)
        committed = sorted(k for k, vv in self._versions.items()
                           if vv["committed"])
        for old in committed[:-_KEEP_VERSIONS]:
            if not self._versions[old].get("retired"):
                self._versions[old]["chunks"] = {}
                self._versions[old]["retired"] = True
                self._retire_durable(old)
        self._push_stats()

    # -- durable cold tier (checkpoint-plane persistence) --------------

    def _durable_store(self):
        """Lazy handle on the cold-tier store: a TieredStore when the
        root carries a TIER descriptor (durable versions then mirror to
        the remote chunk backend), a plain CheckpointStore otherwise."""
        if self._durable_root is None:
            return None
        if self._dstore is None:
            import os

            from ray_tpu_torch.ckpt.store import CheckpointStore
            from ray_tpu_torch.ckpt.tier.tiered import TIER_FILE, TieredStore

            root = self._durable_root
            if os.path.exists(os.path.join(root, TIER_FILE)):
                self._dstore = TieredStore(root, name=f"weights-{self.name}")
            else:
                self._dstore = CheckpointStore(
                    root, name=f"weights-{self.name}")
        return self._dstore

    def _durable_ckpt_id(self, version: int) -> str:
        return f"weights-{self.name}-v{int(version):010d}"

    def _persist_durable(self, version: int):
        """Mirror a fully-owned committed version into the checkpoint
        plane as a PINNED manifest (``weights-<name>-v<version>``): each
        chunk's stored (possibly quantized) bytes land content-addressed
        in the chunk pool, geometry/encoding ride the manifest stats, and
        the pin keeps retention and the cluster sweeper off the version
        until :meth:`_retire_durable` releases it. Versions holding any
        borrowed (zero-copy) ref are skipped — those bytes die with their
        publisher, so persisting them would fake durability. Best-effort
        by contract: cold-tier trouble must never fail a publish."""
        store = self._durable_store()
        if store is None:
            return
        v = self._versions[version]
        if not v["chunks"] or any(not c.get("owned")
                                  for c in v["chunks"].values()):
            return
        try:
            from ray_tpu_torch.ckpt import manifest as mf

            leaves: Dict[str, Any] = {}
            chunk_meta: Dict[str, dict] = {}
            for key, c in sorted(v["chunks"].items()):
                arr = np.ascontiguousarray(np.asarray(ray_tpu_torch.get(c["ref"])))
                data = arr.tobytes()
                h, _created = mf.write_chunk(store.root, data)
                # the manifest leaf is the stored byte payload (flat
                # uint8, like a file leaf); real geometry + encoding live
                # in stats so load_durable can rebuild the exact arrays
                leaves[key] = mf.LeafEntry(
                    kind=mf.ND, shape=(len(data),), dtype="|u1",
                    chunks={mf.encode_box(((0, len(data)),)):
                            (h, len(data))})
                chunk_meta[key] = {
                    "dtype": arr.dtype.str, "shape": list(arr.shape),
                    "enc": c.get("enc"), "sha": c.get("sha", ""),
                    "raw_nbytes": int(c.get("raw_nbytes", arr.nbytes))}
            cid = self._durable_ckpt_id(version)
            man = mf.Manifest(
                ckpt_id=cid, step=int(version), ts=time.time(),
                parent=None, skeleton=v["skeleton"], spec=v["spec"],
                leaves=leaves,
                stats={"weights_store": self.name,
                       "weights_version": int(version),
                       "chunks": chunk_meta})
            # write + pin, WITHOUT moving LATEST: the root may be shared
            # with a training checkpoint store whose restore-latest
            # semantics a weight publish must not hijack
            mf.write_manifest(store.root, man)
            store.pin(cid)
            enqueue = getattr(store, "enqueue_mirror", None)
            if enqueue is not None:
                enqueue(cid)
            v["durable_ckpt_id"] = cid
        except Exception as e:  # cold tier is best-effort by contract
            import logging

            logging.getLogger(__name__).warning(
                "weight store %s: durable persist of v%s failed: %r",
                self.name, version, e)

    def _retire_durable(self, version: int):
        """Unpin a retired version's cold-tier manifest so retention /
        the cluster sweeper may reclaim it (shared chunks stay as long
        as any live manifest references them)."""
        store = self._dstore  # never constructed just to unpin
        cid = self._versions[version].pop("durable_ckpt_id", None)
        if store is None or cid is None:
            return
        try:
            store.unpin(cid)
        except Exception:  # cold tier is best-effort by contract
            pass

    def note_pull(self, version: int, nbytes: int) -> bool:
        v = self._versions.get(version)
        if v is not None:
            v["bytes_pulled"] += int(nbytes)
            v["num_pulls"] += 1
        return True

    # -- consume side --------------------------------------------------

    def latest(self) -> int:
        return self._latest

    def manifest(self, version: Optional[int] = None) -> dict:
        if version is None:
            version = self._latest
        if version < 0 or version not in self._versions:
            raise KeyError(f"weight store {self.name!r} has no version "
                           f"{version}")
        v = self._versions[version]
        if not v["committed"]:
            raise KeyError(f"version {version} is not committed yet")
        if v.get("retired"):
            raise KeyError(f"version {version} was retired "
                           f"(keep={_KEEP_VERSIONS})")
        return {
            "version": version,
            "skeleton": v["skeleton"],
            "spec": v["spec"],
            "chunks": {k: {"ref": [c["ref"]], "nbytes": c["nbytes"],
                           "dtype": c["dtype"], "sha": c.get("sha", ""),
                           "enc": c.get("enc")}
                       for k, c in v["chunks"].items()},
        }

    async def poll(self, after_version: int, timeout: float = 25.0) -> int:
        """Long-poll: resolves with ``latest`` once it exceeds
        ``after_version`` (or on timeout, with the current latest)."""
        import asyncio

        deadline = time.monotonic() + timeout
        while self._latest <= after_version and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
        return self._latest

    def stats(self) -> dict:
        out = {
            "name": self.name,
            "latest": self._latest,
            "versions": {
                str(ver): {k: v.get(k, 0) for k in
                           ("committed", "ts", "num_chunks",
                            "bytes_published", "bytes_pulled", "num_pulls",
                            "bytes_reused", "durable_ckpt_id")}
                for ver, v in sorted(self._versions.items())
            },
        }
        if self._durable_root is not None:
            out["durable_root"] = self._durable_root
        return out

    def _push_stats(self):
        """Mirror stats into the GCS KV (``weights`` ns) for the dashboard.
        Best-effort: stats must never fail a publish."""
        try:
            from ray_tpu_torch._private import wire
            from ray_tpu_torch.experimental.internal_kv import _internal_kv_put

            _internal_kv_put(self.name.encode(), wire.dumps(self.stats()),
                             namespace="weights")
        except Exception:  # stats mirror is best-effort by contract
            pass


class WeightSubscription:
    """Consumer-side cursor over a store's committed versions."""

    def __init__(self, store: "WeightStore", start_after: int = -1):
        self._store = store
        self.last_version = start_after

    def poll(self, timeout: float = 0.0):
        """Return ``(version, tree)`` for the newest committed version
        strictly after the last one seen, or None. ``timeout`` > 0 long-polls
        on the store actor (costing no thread there)."""
        latest = self._store.poll_latest(self.last_version, timeout=timeout)
        if latest <= self.last_version:
            return None
        tree, version = self._store.pull(return_version=True)
        if version <= self.last_version:
            return None
        self.last_version = version
        return version, tree

    def poll_shards(self, dst_spec: ShardedTreeSpec, host: str,
                    timeout: float = 0.0):
        """Sharded flavor: returns ``(version, {leaf: {box: array}})``."""
        latest = self._store.poll_latest(self.last_version, timeout=timeout)
        if latest <= self.last_version:
            return None
        shards, version = self._store.pull_shards(
            dst_spec, host, return_version=True)
        if version <= self.last_version:
            return None
        self.last_version = version
        return version, shards


class WeightStore:
    """Process-local handle on a named weight store (create-or-attach)."""

    def __init__(self, name: str, create: bool = True,
                 durable_root: Optional[str] = None):
        self.name = name
        actor_name = _STORE_PREFIX + name
        if create:
            actor_cls = ray_tpu_torch.remote(WeightStoreActor)
            self._actor = actor_cls.options(
                name=actor_name, lifetime="detached", get_if_exists=True,
                max_concurrency=32, num_cpus=0.1).remote(
                    name, durable_root)
        else:
            self._actor = ray_tpu_torch.get_actor(actor_name)

    # -- publish -------------------------------------------------------

    def next_version(self) -> int:
        return ray_tpu_torch.get(self._actor.next_version.remote(), timeout=60)

    def publish(self, tree: Any, *, version: Optional[int] = None,
                spec: Optional[ShardedTreeSpec] = None,
                durable: bool = False, timeout: float = 300.0,
                delta_from: Optional[int] = None,
                compression: Any = None) -> int:
        """Publish a FULL tree from this process (the single-source case:
        a learner broadcasting to env-runners, a driver seeding replicas).
        For mesh-sharded publishers use :func:`publish_host_shards`.

        ``delta_from=prev_version`` hashes every leaf chunk against the
        previous manifest and ships ONLY the changed ones — unchanged
        leaves alias the prior version's chunks by content address (no
        bytes move; pulls are byte-exact regardless). A vanished/retired
        base falls back to a full publish, logged, never an error.

        ``compression`` ("int8"/"fp8"/"bf16", collective/quant.py)
        block-quantizes the chunk payloads on the wire; the encoding is
        recorded per chunk in the manifest and ``pull``/``pull_shards``
        decode transparently (lossy — delta hashing still uses the RAW
        bytes, so delta and quantized publishes compose)."""
        skeleton, leaves = flatten_tree(tree)
        arrays = {p: _as_numpy(v) for p, v in leaves.items()}
        if spec is None:
            spec = ShardedTreeSpec.from_tree(
                unflatten_tree(skeleton, arrays), MeshSpec.host_mesh(["src"]))
        if version is None:
            version = self.next_version()
        chunks = {_chunk_key(p, tuple((0, s) for s in a.shape)): a
                  for p, a in arrays.items()}
        self._publish_chunks(version, skeleton, spec, chunks,
                             num_chunks=len(chunks), durable=durable,
                             timeout=timeout, delta_from=delta_from,
                             compression=compression)
        return version

    def _publish_chunks(self, version: int, skeleton: Any,
                        spec: ShardedTreeSpec, chunks: Dict[str, np.ndarray],
                        num_chunks: int, durable: bool, timeout: float,
                        delta_from: Optional[int] = None,
                        compression: Any = None):
        import hashlib

        from ray_tpu_torch.collective.quant import encode_array, resolve_codec
        from ray_tpu_torch.util import tracing

        codec = resolve_codec(compression)
        t0 = time.perf_counter()
        with tracing.profile("weights.publish", category="weights",
                             store=self.name, version=version):
            # hash the array buffer directly — tobytes() would copy every
            # chunk; ascontiguousarray is a no-op for the (typical)
            # already-contiguous case. Hashing on EVERY publish is what
            # lets any version serve as a later delta base. The dtype
            # prefixes the digest: identical bytes under a different
            # dtype are a DIFFERENT chunk (aliasing one would value-cast
            # on pull).
            def _sha(a: np.ndarray) -> str:
                h = hashlib.sha256(a.dtype.str.encode())
                h.update(np.ascontiguousarray(a))
                return h.hexdigest()

            shas = {k: _sha(a) for k, a in chunks.items()}
            ray_tpu_torch.get(self._actor.begin.remote(
                version, skeleton, _spec_payload(spec), num_chunks),
                timeout=timeout)
            todo = dict(chunks)
            if delta_from is not None:
                # any base-unavailable condition (retired by retention,
                # unknown version, a race against retirement mid-reuse —
                # surfaced as a wrapped TaskError) degrades to a FULL
                # publish: correctness never depends on the delta base
                try:
                    prev = ray_tpu_torch.get(
                        self._actor.chunk_shas.remote(delta_from),
                        timeout=timeout)
                    cspec = codec.spec() if codec is not None else None

                    def _reusable(k: str) -> bool:
                        ent = prev.get(k)
                        if ent is None or ent[0] != shas[k]:
                            return False
                        if ent[1] is None:
                            return True  # base chunk is exact raw bytes
                        # the base chunk is a LOSSY encoding of the same
                        # raw bytes: aliasing it is only correct when this
                        # publish would encode the chunk identically (the
                        # codecs are deterministic) — never under a
                        # different codec or an exact (compression=None)
                        # publish, whose pulls must stay byte-exact
                        return (ent[1] == cspec and
                                np.issubdtype(chunks[k].dtype,
                                              np.floating))

                    unchanged = [k for k in shas if _reusable(k)]
                    if unchanged:
                        ray_tpu_torch.get(self._actor.reuse_chunks.remote(
                            version, unchanged, delta_from, durable),
                            timeout=timeout)
                        for k in unchanged:
                            todo.pop(k)
                except Exception as e:
                    import logging

                    logging.getLogger(__name__).warning(
                        "weight store %s: delta base v%s unavailable "
                        "(%s); publishing v%s in full", self.name,
                        delta_from, e, version)
            payloads: Dict[str, np.ndarray] = {}
            meta: Dict[str, dict] = {}
            for k, a in todo.items():
                m = {"sha": shas[k], "enc": None, "raw_nbytes": int(a.nbytes)}
                if codec is not None and np.issubdtype(a.dtype, np.floating):
                    wire, enc = encode_array(_tensor(a), codec)
                    payloads[k] = wire.numpy()
                    enc["dtype"] = a.dtype.str  # as the JAX manifest has it
                    m["enc"] = enc
                else:
                    payloads[k] = a
                meta[k] = m
            if durable:
                # ship bytes; the store re-puts so refs survive this process
                ray_tpu_torch.get(self._actor.put_chunks.remote(
                    version, payloads, meta), timeout=timeout)
            else:
                refs = {k: [ray_tpu_torch.put(a)] for k, a in payloads.items()}
                nbytes = {k: int(a.nbytes) for k, a in payloads.items()}
                dtypes = {k: a.dtype.str for k, a in payloads.items()}
                ray_tpu_torch.get(self._actor.register_chunks.remote(
                    version, refs, nbytes, dtypes, meta), timeout=timeout)
        _obs()["publish"].observe(time.perf_counter() - t0)

    # -- consume -------------------------------------------------------

    def latest(self) -> int:
        return ray_tpu_torch.get(self._actor.latest.remote(), timeout=60)

    def poll_latest(self, after_version: int, timeout: float = 0.0) -> int:
        if timeout <= 0:
            return self.latest()
        return ray_tpu_torch.get(
            self._actor.poll.remote(after_version, timeout),
            timeout=timeout + 30)

    def manifest(self, version: Optional[int] = None) -> dict:
        return ray_tpu_torch.get(self._actor.manifest.remote(version), timeout=120)

    def pull(self, version: Optional[int] = None, *,
             return_version: bool = False, timeout: float = 300.0):
        """Assemble the FULL tree of ``version`` (default: latest). Only
        for replicated consumers — sharded consumers use
        :meth:`pull_shards` and never hold a gathered array."""
        from ray_tpu_torch.util import tracing

        t0 = time.perf_counter()
        with tracing.profile("weights.pull", category="weights",
                             store=self.name):
            man = self.manifest(version)
            leaves: Dict[str, np.ndarray] = {}
            spec = _spec_from_payload(man["spec"])
            pulled = 0
            by_leaf: Dict[str, List[Tuple[Box, dict]]] = {}
            for key, c in man["chunks"].items():
                leaf, box = _split_key(key)
                by_leaf.setdefault(leaf, []).append((box, c))
            for leaf, (shape, dtype) in spec.meta.items():
                out = np.empty(shape, dtype=np.dtype(dtype))
                for box, c in by_leaf.get(leaf, ()):
                    val = _decode_chunk(
                        ray_tpu_torch.get(c["ref"][0], timeout=timeout), c)
                    out[box_slices(box)] = val.reshape(
                        tuple(b - a for a, b in box))
                    pulled += c["nbytes"]
                leaves[leaf] = out
            self._actor.note_pull.remote(man["version"], pulled)
            tree = unflatten_tree(man["skeleton"], leaves)
        _obs()["pull"].observe(time.perf_counter() - t0)
        return (tree, man["version"]) if return_version else tree

    def pull_shards(self, dst_spec: ShardedTreeSpec, host: str,
                    version: Optional[int] = None, *,
                    return_version: bool = False, timeout: float = 300.0):
        """Pull exactly this host's destination shards, assembling each from
        the intersecting published chunks. Returns
        ``{leaf: {dst_box: array}}``; never materializes a full leaf unless
        the destination box IS the full leaf."""
        from ray_tpu_torch.util import tracing
        from ray_tpu_torch.weights.spec import (host_boxes, intersect_box,
                                          rel_slices)

        t0 = time.perf_counter()
        with tracing.profile("weights.pull", category="weights",
                             store=self.name, host=host):
            man = self.manifest(version)
            spec = _spec_from_payload(man["spec"])
            by_leaf: Dict[str, List[Tuple[Box, dict]]] = {}
            for key, c in man["chunks"].items():
                leaf, box = _split_key(key)
                by_leaf.setdefault(leaf, []).append((box, c))
            out: Dict[str, Dict[Box, np.ndarray]] = {}
            pulled = 0
            cache: Dict[str, np.ndarray] = {}
            for leaf, (shape, dtype) in dst_spec.meta.items():
                dt = np.dtype(dtype)
                out[leaf] = {}
                for dbox in host_boxes(dst_spec.mesh, dst_spec.part_of(leaf),
                                       shape, host):
                    shard = np.empty(tuple(b - a for a, b in dbox), dtype=dt)
                    for cbox, c in by_leaf.get(leaf, ()):
                        inter = intersect_box(dbox, cbox)
                        if inter is None:
                            continue
                        key = _chunk_key(leaf, cbox)
                        chunk = cache.get(key)
                        if chunk is None:
                            chunk = _decode_chunk(
                                ray_tpu_torch.get(c["ref"][0], timeout=timeout), c
                            ).reshape(tuple(b - a for a, b in cbox))
                            cache[key] = chunk
                            pulled += c["nbytes"]
                        shard[rel_slices(inter, dbox)] = chunk[
                            rel_slices(inter, cbox)]
                    out[leaf][dbox] = shard
            self._actor.note_pull.remote(man["version"], pulled)
        _obs()["pull"].observe(time.perf_counter() - t0)
        return (out, man["version"]) if return_version else out

    def subscribe(self, start_after: Optional[int] = None
                  ) -> WeightSubscription:
        return WeightSubscription(
            self, self.latest() if start_after is None else start_after)

    def stats(self) -> dict:
        return ray_tpu_torch.get(self._actor.stats.remote(), timeout=60)

    def shutdown(self):
        try:
            ray_tpu_torch.kill(self._actor)
        except Exception:
            pass


# ---------------------------------------------------------------------------
# cold-tier restore (no actor, no cluster): the full-restart path
# ---------------------------------------------------------------------------


def _attach_durable(root: str):
    """Store handle on a durable-weights root: tiered when the root
    carries a TIER descriptor (read-through to the remote backend, no
    mirror pump), plain otherwise."""
    import os

    from ray_tpu_torch.ckpt.store import CheckpointStore
    from ray_tpu_torch.ckpt.tier.tiered import TIER_FILE, TieredStore

    if os.path.exists(os.path.join(root, TIER_FILE)):
        return TieredStore(root, mirror=False)
    return CheckpointStore(root)


def _durable_index(store, name: Optional[str]) -> Dict[int, str]:
    out: Dict[int, str] = {}
    for man in store.list():
        st = man.stats or {}
        if "weights_version" not in st:
            continue  # a training checkpoint sharing the root
        if name is not None and st.get("weights_store") != name:
            continue
        out[int(st["weights_version"])] = man.ckpt_id
    return out


def durable_versions(root: str, name: Optional[str] = None) -> Dict[int, str]:
    """Durable weight versions persisted under ``root`` as
    ``{version: ckpt_id}`` — optionally filtered to one store ``name``
    (a root may hold several stores, and training checkpoints besides)."""
    return _durable_index(_attach_durable(root), name)


def load_durable(root: str, name: Optional[str] = None,
                 version: Optional[int] = None) -> Tuple[int, Any]:
    """Rebuild a durable weight version from its cold-tier manifest with
    NO store actor (and no cluster) alive — the full-restart path of
    ``publish(..., durable=True)`` on a store with a ``durable_root``.
    Chunk bytes read through the storage tiers (an evicted local pool
    fetches from the remote backend, sha256-verified) and any quantized
    encoding is undone. Returns ``(version, tree)`` for the newest
    version, or the one requested."""
    store = _attach_durable(root)
    index = _durable_index(store, name)
    if not index:
        raise FileNotFoundError(
            f"no durable weight versions under {root!r}"
            + (f" for store {name!r}" if name else ""))
    if version is None:
        version = max(index)
    cid = index.get(int(version))
    if cid is None:
        raise KeyError(f"no durable manifest for version {version} under "
                       f"{root!r} (have {sorted(index)})")
    man = store.read(cid)
    spec = _spec_from_payload(man.spec)
    meta = man.stats["chunks"]
    key_hash: Dict[str, str] = {}
    sizes: Dict[str, int] = {}
    for key, entry in man.leaves.items():
        h, n = next(iter(entry.chunks.values()))
        key_hash[key] = h
        sizes[h] = n
    fetch = getattr(store, "fetch_chunks", None)
    if fetch is not None:
        blobs = fetch(sizes)
    else:
        from ray_tpu_torch.ckpt import manifest as mf

        blobs = {h: mf.read_chunk(store.root, h) for h in sizes}
    by_leaf: Dict[str, List[Tuple[Box, np.ndarray]]] = {}
    for key, h in key_hash.items():
        leaf, box = _split_key(key)
        info = meta[key]
        arr = np.frombuffer(blobs[h], dtype=np.dtype(info["dtype"]))
        arr = arr.reshape(tuple(info["shape"]))
        arr = _decode_chunk(arr, {"enc": info.get("enc")})
        by_leaf.setdefault(leaf, []).append((box, arr))
    leaves: Dict[str, np.ndarray] = {}
    for leaf, (shape, dtype) in spec.meta.items():
        out = np.empty(shape, dtype=np.dtype(dtype))
        for box, arr in by_leaf.get(leaf, ()):
            out[box_slices(box)] = np.asarray(arr).reshape(
                tuple(b - a for a, b in box))
        leaves[leaf] = out
    return int(version), unflatten_tree(man.skeleton, leaves)
