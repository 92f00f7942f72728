"""Retention sweeper: keep-last/pinned/grace policy applied across tiers.
The port of ``ray_tpu/ckpt/tier/sweeper.py``.

The sweeper is a standalone pass any process can run against any store
root, so retention keeps working after the training driver (the process
that calls ``retention()``) is gone. In the JAX package the GCS runs it over
every store that registered a sweep policy; the port has no GCS yet, and
``sweep_registered`` takes such a registry from its caller.

Safety invariants, in order of authority:

1. a chunk referenced by ANY live manifest — local or remote tier,
   pinned or not, including durable weight versions (which publish as
   pinned manifests) — is never reaped;
2. a chunk referenced by an in-flight sharded save (named in a
   ``parts/<ckpt_id>/`` part-file that has not committed yet) is never
   reaped;
3. a chunk younger than ``grace_s`` is never reaped, on either tier — an
   async saver or a mirror pump writes chunks BEFORE the manifest that
   names them exists. On the remote tier a chunk whose upload time is
   *unknown* (``chunk_mtime() is None``) is treated as young forever:
   the sweeper refuses to guess;
4. only then does keep-last apply: unpinned manifests beyond the newest
   ``keep_last`` drop, then unreferenced chunks.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.ckpt import manifest as mf

_metrics_lock = threading.Lock()
_metrics: Optional[dict] = None


def _obs() -> dict:
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            from ray_tpu_torch.util.metrics import Counter

            _metrics = {
                "runs": Counter(
                    "ray_tpu.ckpt.tier.sweep_runs",
                    "retention sweeper passes completed"),
                "reaped_manifests": Counter(
                    "ray_tpu.ckpt.tier.sweep_reaped_manifests",
                    "manifests dropped by the retention sweeper, both tiers"),
                "reaped_bytes": Counter(
                    "ray_tpu.ckpt.tier.sweep_reaped_bytes",
                    "chunk bytes reclaimed by the retention sweeper, "
                    "both tiers"),
            }
        return _metrics


@dataclasses.dataclass
class SweepPolicy:
    """What a store asks the sweeper to enforce. ``keep_last=None`` keeps
    every checkpoint (the sweeper then only GCs orphan chunks)."""

    keep_last: Optional[int] = None
    grace_s: Optional[float] = None  # None -> RAY_CONFIG.ckpt_sweep_grace_s
    keep_ids: tuple = ()

    def resolved_grace(self) -> float:
        if self.grace_s is not None:
            return float(self.grace_s)
        from ray_tpu_torch._private.config import RAY_CONFIG

        return float(RAY_CONFIG.ckpt_sweep_grace_s)

    def to_dict(self) -> Dict[str, Any]:
        return {"keep_last": self.keep_last, "grace_s": self.grace_s,
                "keep_ids": list(self.keep_ids)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SweepPolicy":
        return cls(keep_last=d.get("keep_last"),
                   grace_s=d.get("grace_s"),
                   keep_ids=tuple(d.get("keep_ids") or ()))


def _inflight_chunks(root: str) -> Dict[str, int]:
    """Chunk hashes referenced by un-committed part-files of in-flight
    sharded saves — protected regardless of age (a slow peer host must
    not lose its already-written chunks to a sweep racing the commit)."""
    out: Dict[str, int] = {}
    pdir = os.path.join(root, mf.PART_DIR)
    if not os.path.isdir(pdir):
        return out
    for cid in os.listdir(pdir):
        sub = os.path.join(pdir, cid)
        if not os.path.isdir(sub):
            continue
        for name in os.listdir(sub):
            if not name.endswith(".json") or ".tmp." in name:
                continue
            try:
                with open(os.path.join(sub, name)) as f:
                    part = json.load(f)
                for leaf in (part.get("leaves") or {}).values():
                    for h, nb in leaf.values():
                        out[h] = int(nb)
            except (json.JSONDecodeError, OSError, KeyError, ValueError,
                    TypeError):
                continue
    return out


def sweep_store(root: str, policy: SweepPolicy,
                name: Optional[str] = None) -> Dict[str, Any]:
    """One retention pass over one store root, both tiers. Returns the
    report; never raises for per-object failures (a sweep must not die
    half way and strand the other stores in the loop). ``name`` keeps the
    report keyed by the store's REGISTERED name — the KV stats mirror and
    the sweep report must land under the same key in the state API."""
    from ray_tpu_torch.ckpt.store import CheckpointStore
    from ray_tpu_torch.ckpt.tier.tiered import TieredStore, _read_tier_file

    grace = policy.resolved_grace()
    backend, _sweep = _read_tier_file(root)
    if backend is not None:
        store: CheckpointStore = TieredStore(root, name, backend=backend,
                                             mirror=False)
    else:
        store = CheckpointStore(root, name)
    inflight = _inflight_chunks(root)
    report: Dict[str, Any] = {"root": store.root, "name": store.name,
                              "ts": time.time(),
                              "policy": policy.to_dict()}
    # -- local tier: the store's own retention, part-files protected ----
    report["local"] = store.retention(
        keep_last=policy.keep_last, keep_ids=list(policy.keep_ids),
        grace_s=grace)
    # -- remote tier ----------------------------------------------------
    if backend is not None:
        report["remote"] = _sweep_remote(store, backend, policy, grace,
                                         inflight)
    obs = _obs()
    obs["runs"].inc(1)
    reaped_m = report["local"].get("dropped_manifests", 0)
    reaped_b = report["local"].get("dropped_bytes", 0)
    if "remote" in report:
        reaped_m += report["remote"]["dropped_manifests"]
        reaped_b += report["remote"]["dropped_bytes"]
    obs["reaped_manifests"].inc(reaped_m)
    obs["reaped_bytes"].inc(reaped_b)
    report["dropped_manifests"] = reaped_m
    report["dropped_bytes"] = reaped_b
    return report


def _sweep_remote(store, backend, policy: SweepPolicy, grace: float,
                  inflight: Dict[str, int]) -> Dict[str, Any]:
    """Remote-tier half: drop remote manifests that survive neither
    locally nor under keep-last, then GC remote chunks no live manifest
    (either tier) or in-flight save references and whose upload age has
    cleared the grace window."""
    now = time.time()
    local_ids = set(store.list_ids())  # post-local-retention survivors
    pins = set(store.pins()) | set(policy.keep_ids)
    remote_ids = backend.list_manifests()
    # newest keep_last by id (ids sort by step; a remote-only manifest
    # has no local step row to consult); pinned ids are kept anyway and
    # must not consume keep-last slots
    if policy.keep_last is None:
        keep = set(remote_ids)
    elif policy.keep_last > 0:
        unpinned = [cid for cid in sorted(remote_ids) if cid not in pins]
        keep = set(unpinned[-policy.keep_last:])
    else:
        keep = set()
    keep |= local_ids | pins
    dropped_manifests = 0
    live: Dict[str, int] = dict(inflight)
    for cid in remote_ids:
        if cid not in keep:
            try:
                backend.delete_manifest(cid)
                dropped_manifests += 1
            except Exception:
                keep.add(cid)  # failed delete: keep its chunks live
    # live chunk set: every surviving manifest on either tier
    for cid in set(backend.list_manifests()) | local_ids:
        data = None
        try:
            data = backend.get_manifest(cid)
        except Exception:
            pass
        if data is None:
            try:
                with open(mf.manifest_path(store.root, cid), "rb") as f:
                    data = f.read()
            except OSError:
                continue
        try:
            live.update(mf.Manifest.from_json(json.loads(data)).chunk_set())
        except (json.JSONDecodeError, KeyError, ValueError):
            continue
    dropped_chunks = dropped_bytes = 0
    try:
        remote_chunks = backend.list_chunks()
    except Exception:
        remote_chunks = {}
    for h, n in remote_chunks.items():
        if h in live:
            continue
        mtime = None
        try:
            mtime = backend.chunk_mtime(h)
        except Exception:
            pass
        if mtime is None or now - mtime < grace:
            continue  # age unknown or young: may be an in-flight mirror
        try:
            backend.delete(h)
            dropped_chunks += 1
            dropped_bytes += n
        except Exception:
            continue
    return {"dropped_manifests": dropped_manifests,
            "dropped_chunks": dropped_chunks,
            "dropped_bytes": dropped_bytes}


def sweep_registered(entries: Dict[str, Dict[str, Any]],
                     ) -> List[Dict[str, Any]]:
    """Sweep every store whose stats carry a ``sweep`` policy — the
    cluster-wide pass. ``entries`` is {store_name: stats}, as the JAX
    package's GCS keeps them in its ns="ckpt" namespace."""
    reports = []
    for name, stats in sorted(entries.items()):
        policy_d = stats.get("sweep")
        root = stats.get("root")
        if not policy_d or not root or not os.path.isdir(str(root)):
            continue
        try:
            reports.append(sweep_store(str(root),
                                       SweepPolicy.from_dict(policy_d),
                                       name=name))
        except Exception as e:
            reports.append({"root": root, "name": name, "ts": time.time(),
                            "error": repr(e)})
    return reports
