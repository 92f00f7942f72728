"""The port's autoscaler v2 instance lifecycle: a mirror of
``tests/test_instance_manager.py`` (reference:
python/ray/autoscaler/v2/instance_manager/ + its unit tests), and one script
of provider and GCS events driving both packages' ``InstanceManager`` to the
same state histories, with each package's ``dump()`` restored in the other.
"""

import pytest

from ray_tpu_torch.autoscaler.config import NodeTypeConfig
from ray_tpu_torch.autoscaler.instance_manager import (ALLOCATED,
                                                 ALLOCATION_FAILED, QUEUED,
                                                 RAY_RUNNING, RAY_STOPPING,
                                                 REQUESTED, TERMINATED,
                                                 TERMINATING,
                                                 InstanceManager,
                                                 InvalidTransition)


class FakeProvider:
    """Synchronous fake with controllable failures."""

    def __init__(self, fail_launches: int = 0):
        self.nodes = {}
        self._n = 0
        self.fail_launches = fail_launches
        self.terminated = []

    def create_nodes(self, node_type, count):
        if self.fail_launches > 0:
            self.fail_launches -= 1
            raise RuntimeError("quota exceeded")
        out = []
        for _ in range(count):
            self._n += 1

            class N:
                pass

            n = N()
            n.node_id = f"prov-{self._n}"
            n.node_type = getattr(node_type, "name", "cpu")
            n.slice_name = ""
            self.nodes[n.node_id] = n
            out.append(n)
        return out

    def terminate_node(self, node):
        self.nodes.pop(node.node_id, None)
        self.terminated.append(node.node_id)

    def non_terminated_nodes(self):
        return list(self.nodes.values())


def _types():
    return {"cpu": NodeTypeConfig(name="cpu", resources={"CPU": 4.0},
                                  min_workers=0, max_workers=10)}


def _gcs_view(provider, alive=True):
    from ray_tpu_torch.autoscaler.autoscaler import PROVIDER_ID_LABEL

    return [{"node_id": f"gcs-{pid}", "alive": alive,
             "labels": {PROVIDER_ID_LABEL: pid}}
            for pid in provider.nodes]


def test_full_lifecycle_to_running():
    im = InstanceManager()
    prov = FakeProvider()
    im.set_targets({"cpu": 2})
    assert len(im.by_state(QUEUED)) == 2
    im.step(prov, _types())  # launch -> ALLOCATED (sync provider)
    assert len(im.by_state(ALLOCATED)) == 2
    im.step(prov, _types(), gcs_nodes=_gcs_view(prov))
    assert len(im.by_state(RAY_RUNNING)) == 2
    assert all(i.raylet_node_id for i in im.by_state(RAY_RUNNING))


def test_allocation_failure_retries_with_backoff_then_gives_up():
    im = InstanceManager(max_allocation_retries=2, retry_backoff_s=0.0)
    prov = FakeProvider(fail_launches=99)
    im.set_targets({"cpu": 1})
    for _ in range(1 + 2 * 2 + 2):  # enough passes for 2 retries + give-up
        im.step(prov, _types())
    assert im.instances == {}  # gave up -> TERMINATED and forgotten
    assert prov.nodes == {}


def test_retry_succeeds_after_transient_failure():
    im = InstanceManager(max_allocation_retries=3, retry_backoff_s=0.0)
    prov = FakeProvider(fail_launches=1)
    im.set_targets({"cpu": 1})
    im.step(prov, _types())  # fails -> ALLOCATION_FAILED
    im.step(prov, _types())  # requeued
    im.step(prov, _types())  # relaunched ok
    assert len(im.by_state(ALLOCATED)) == 1
    inst = im.by_state(ALLOCATED)[0]
    assert inst.retries == 1


def test_stuck_allocated_instance_terminated():
    im = InstanceManager(ray_start_timeout_s=0.0)
    prov = FakeProvider()
    im.set_targets({"cpu": 1})
    im.step(prov, _types())
    assert len(im.by_state(ALLOCATED)) == 1
    # no gcs registration ever arrives; next pass times it out
    im.step(prov, _types(), gcs_nodes=[])
    im.step(prov, _types(), gcs_nodes=[])
    assert prov.terminated, "stuck instance should be terminated"
    assert im.instances == {}


def test_scale_down_drains_running_instances():
    im = InstanceManager()
    prov = FakeProvider()
    im.set_targets({"cpu": 2})
    im.step(prov, _types())
    im.step(prov, _types(), gcs_nodes=_gcs_view(prov))
    assert len(im.by_state(RAY_RUNNING)) == 2
    drained = []
    im.set_targets({"cpu": 1})
    assert len(im.by_state(RAY_STOPPING)) == 1
    im.step(prov, _types(), gcs_nodes=_gcs_view(prov),
            drain=lambda nid: drained.append(nid))
    im.step(prov, _types(), gcs_nodes=_gcs_view(prov))
    assert drained and len(prov.terminated) == 1
    assert im.active_count("cpu") == 1


def test_dead_node_detected_and_cleaned():
    im = InstanceManager()
    prov = FakeProvider()
    im.set_targets({"cpu": 1})
    im.step(prov, _types())
    im.step(prov, _types(), gcs_nodes=_gcs_view(prov))
    assert len(im.by_state(RAY_RUNNING)) == 1
    im.step(prov, _types(), gcs_nodes=_gcs_view(prov, alive=False))
    assert len(im.by_state(TERMINATING)) + len(prov.terminated) >= 1


def test_persistence_roundtrip():
    store = {}
    im = InstanceManager(store=store)
    prov = FakeProvider()
    im.set_targets({"cpu": 2})
    im.step(prov, _types())
    assert len(store) == 2
    # a restarted manager resumes the same instances (no double-launch)
    im2 = InstanceManager(store=store)
    assert im2.active_count("cpu") == 2
    assert len(im2.by_state(ALLOCATED)) == 2
    im2.step(prov, _types(), gcs_nodes=_gcs_view(prov))
    assert len(im2.by_state(RAY_RUNNING)) == 2
    assert len(prov.nodes) == 2  # never launched extras


def test_invalid_transition_rejected():
    im = InstanceManager()
    inst = im.add("cpu")
    with pytest.raises(InvalidTransition):
        im.transition(inst, RAY_RUNNING)  # QUEUED cannot jump to RUNNING


def test_scale_down_sheds_allocated_before_running():
    im = InstanceManager()
    prov = FakeProvider()
    im.set_targets({"cpu": 2})
    im.step(prov, _types())  # both ALLOCATED
    im.set_targets({"cpu": 1})
    assert len(im.by_state(TERMINATING)) == 1  # ALLOCATED shed immediately
    im.step(prov, _types())
    assert im.active_count("cpu") == 1 and len(prov.terminated) == 1


def test_async_provider_node_adopted_not_leaked():
    """A provider that provisions asynchronously (create_nodes returns [])
    must have its late node adopted by the REQUESTED instance instead of
    leaking it and double-launching."""
    im = InstanceManager(request_timeout_s=3600.0)
    prov = FakeProvider()

    real_create = prov.create_nodes

    def async_create(node_type, count):
        real_create(node_type, count)  # provisions, but reports nothing
        return []

    prov.create_nodes = async_create
    im.set_targets({"cpu": 1})
    im.step(prov, _types())  # REQUESTED, no provider_node_id yet
    assert len(im.by_state(REQUESTED)) == 1
    im.step(prov, _types())  # adopts the orphan from the provider view
    assert len(im.by_state(ALLOCATED)) == 1
    assert im.by_state(ALLOCATED)[0].provider_node_id
    assert len(prov.nodes) == 1  # no double-launch


def test_vanished_node_detected_after_grace():
    im = InstanceManager(request_timeout_s=0.0)
    prov = FakeProvider()
    im.set_targets({"cpu": 1})
    im.step(prov, _types())
    im.step(prov, _types(), gcs_nodes=_gcs_view(prov))
    assert len(im.by_state(RAY_RUNNING)) == 1
    # the node's GCS entry disappears entirely (evicted/tombstoned)
    import time as _t

    _t.sleep(0.01)
    im.step(prov, _types(), gcs_nodes=[])
    # detected, drained through TERMINATING, and (same pass) the provider
    # node was reclaimed
    assert prov.terminated, "vanished node should be reclaimed"
    assert not im.by_state(RAY_RUNNING)


def _script(pkg):
    """One run of provider and GCS events through ``pkg``'s manager: two
    types, a launch that fails and is retried, registration, a node that
    dies, one that vanishes, a shrink that drains, an async provider node
    adopted. Returns each instance's (from, to, why) history in creation
    order, the dumps of the instances alive at the end and the provider's
    terminations."""
    import importlib
    import time as _t

    im_mod = importlib.import_module(f"{pkg}.autoscaler.instance_manager")
    cfg_mod = importlib.import_module(f"{pkg}.autoscaler.config")
    label = importlib.import_module(
        f"{pkg}.autoscaler.autoscaler").PROVIDER_ID_LABEL
    types = {name: cfg_mod.NodeTypeConfig(name=name, resources=res,
                                          max_workers=10)
             for name, res in (("cpu", {"CPU": 4.0}),
                               ("gpu", {"CPU": 2.0, "GPU": 1.0}))}

    def view(prov, dead=(), gone=()):
        return [{"node_id": f"gcs-{pid}", "alive": pid not in dead,
                 "labels": {label: pid}}
                for pid in prov.nodes if pid not in gone]

    store = {}
    im = im_mod.InstanceManager(store=store, request_timeout_s=0.0,
                                ray_start_timeout_s=3600.0,
                                max_allocation_retries=2, retry_backoff_s=0.0)
    made = []
    real_add = im.add

    def add(node_type):
        inst = real_add(node_type)
        made.append(inst)
        return inst

    im.add = add
    prov = FakeProvider(fail_launches=1)
    drained = []
    im.set_targets({"cpu": 3, "gpu": 1})
    im.step(prov, types)  # one launch fails
    im.step(prov, types, gcs_nodes=view(prov))
    im.step(prov, types, gcs_nodes=view(prov))
    im.step(prov, types, gcs_nodes=view(prov))
    _t.sleep(0.01)
    first, second = sorted(prov.nodes)[:2]
    im.step(prov, types, gcs_nodes=view(prov, dead=[first], gone=[second]))
    im.set_targets({"cpu": 1, "gpu": 0})
    im.step(prov, types, gcs_nodes=view(prov), drain=drained.append)
    im.step(prov, types, gcs_nodes=view(prov), drain=drained.append)
    real_create = prov.create_nodes

    def async_create(node_type, count):
        real_create(node_type, count)
        return []

    prov.create_nodes = async_create
    im.set_targets({"cpu": 2, "gpu": 1})
    for _ in range(3):
        im.step(prov, types, gcs_nodes=view(prov), drain=drained.append)
    return ([[h[1:] for h in inst.history] for inst in made],
            sorted((d for d in store.values()), key=lambda d: d["created_at"]),
            prov.terminated, len(drained))


def test_state_histories_and_dumps_equal_the_jax_package():
    from ray_tpu.autoscaler import instance_manager as jim
    from ray_tpu_torch.autoscaler import instance_manager as tim

    want = _script("ray_tpu")
    got = _script("ray_tpu_torch")
    assert got[0] == want[0]
    assert got[2:] == want[2:]
    # the run reached every state, not only the happy path
    states = {h[1] for hist in want[0] for h in hist}
    assert states == {REQUESTED, ALLOCATED, ALLOCATION_FAILED, QUEUED,
                      RAY_RUNNING, RAY_STOPPING, TERMINATING, TERMINATED}
    skip = ("instance_id", "created_at", "state_since", "last_seen")
    assert [{k: v for k, v in d.items() if k not in skip} for d in got[1]] \
        == [{k: v for k, v in d.items() if k not in skip} for d in want[1]]
    # each package's records restore in the other, field for field
    for dumps, other in ((want[1], tim), (got[1], jim)):
        assert dumps
        for d in dumps:
            assert other.Instance.restore(dict(d)).dump() == d
        resumed = other.InstanceManager(
            store={d["instance_id"]: dict(d) for d in dumps})
        assert sorted(i.dump()["instance_id"]
                      for i in resumed.instances.values()) \
            == sorted(d["instance_id"] for d in dumps)
