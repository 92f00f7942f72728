"""Placement groups: gang resource reservation across nodes, the port of
``ray_tpu/util/placement_group.py``.

Reference: python/ray/util/placement_group.py + GCS 2PC scheduling
(``gcs_placement_group_scheduler.h:115-118``). Strategies: PACK, SPREAD,
STRICT_PACK, STRICT_SPREAD; bundles may carry label selectors. A bundle may
hold ``GPU``: reserving it takes the node's ``GPU`` count, and a lease
inside the bundle is bound to its cards when it is granted, as any ``GPU``
lease is (``_private/raylet.py:_take_cards``). The JAX package's TPU slice
groups (``ray_tpu/util/tpu.py``) have no counterpart.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch._private.common import Bundle, PlacementGroupSpec
from ray_tpu_torch._private.ids import PlacementGroupID
from ray_tpu_torch.exceptions import PlacementGroupError


def _core():
    from ray_tpu_torch._private import worker as worker_mod

    return worker_mod.global_worker()


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]]):
        self.id = pg_id
        self.bundle_specs = bundles

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def ready(self, timeout: float = 300.0) -> bool:
        core = _core()
        reply = core._run(core._gcs_call("WaitPlacementGroupReady", {
            "pg_id": self.id.binary(), "timeout": timeout}, timeout=timeout + 10))
        if reply["status"] == "ready":
            return True
        if reply["status"] == "timeout":
            return False
        raise PlacementGroupError(f"placement group state: {reply['status']}")

    def wait(self, timeout_seconds: float = 300.0) -> bool:
        return self.ready(timeout_seconds)

    def bundle_nodes(self) -> List[str]:
        core = _core()
        info = core._run(core._gcs_call("GetPlacementGroup",
                                        {"pg_id": self.id.binary()}))["info"]
        return info["bundle_nodes"] if info else []

    def __reduce__(self):
        return (_rebuild_pg, (self.id.binary(), self.bundle_specs))


def _rebuild_pg(id_bytes, bundles):
    return PlacementGroup(PlacementGroupID(id_bytes), bundles)


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
    lifetime: str = "ref_counted",
    bundle_label_selector: Optional[List[Dict[str, str]]] = None,
) -> PlacementGroup:
    if strategy not in ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if not bundles:
        raise ValueError("placement group needs at least one bundle")
    core = _core()
    selectors = bundle_label_selector or [{}] * len(bundles)
    spec = PlacementGroupSpec(
        pg_id=PlacementGroupID.from_random(),
        bundles=[Bundle(resources=dict(b), label_selector=dict(s))
                 for b, s in zip(bundles, selectors)],
        strategy=strategy,
        name=name,
        lifetime=lifetime,
        creator_job=core.job_id,
    )
    core._run(core._gcs_call("CreatePlacementGroup", {"spec": spec}))
    return PlacementGroup(spec.pg_id, [dict(b) for b in bundles])


def remove_placement_group(pg: PlacementGroup):
    core = _core()
    core._run(core._gcs_call("RemovePlacementGroup", {"pg_id": pg.id.binary()}))


def get_placement_group_state(pg: PlacementGroup) -> Optional[dict]:
    core = _core()
    return core._run(core._gcs_call("GetPlacementGroup", {"pg_id": pg.id.binary()}))["info"]
