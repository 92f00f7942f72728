"""The port's autoscaler: a mirror of ``tests/test_autoscaler.py`` on port
clusters (CPU only) with the fake multi-node provider, and the demand
scheduler held against the JAX package's on seeded draws of catalogs,
counts, free views, demands, strict-spread groups and idle views (pure
Python: the decisions must be equal, with no tolerance)."""

import copy
import dataclasses
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.autoscaler import (
    Autoscaler,
    ClusterConfig,
    FakeMultiNodeProvider,
    NodeTypeConfig,
)
from ray_tpu_torch.autoscaler.resource_demand_scheduler import (
    get_nodes_to_launch,
    get_nodes_to_terminate,
)
from ray_tpu_torch.cluster_utils import Cluster


# ---------------------------------------------------------------------------
# pure bin-packing units (no cluster)
# ---------------------------------------------------------------------------


def _config(**kw):
    types = {
        "cpu4": NodeTypeConfig("cpu4", {"CPU": 4.0}, max_workers=5),
        "cpu16": NodeTypeConfig("cpu16", {"CPU": 16.0}, max_workers=2),
    }
    return ClusterConfig(node_types=types, **kw)


def test_scheduler_launches_for_unmet_demand():
    launch = get_nodes_to_launch(
        _config(), existing_by_type={}, node_available=[],
        demands=[{"CPU": 2.0}, {"CPU": 2.0}, {"CPU": 2.0}])
    # 3x CPU:2 pack onto 2x cpu4 (smallest fitting type), capped by
    # upscaling budget >= 1
    assert launch.get("cpu4", 0) >= 1


def test_scheduler_respects_existing_capacity():
    launch = get_nodes_to_launch(
        _config(), existing_by_type={"cpu4": 1},
        node_available=[{"CPU": 4.0}],
        demands=[{"CPU": 2.0}, {"CPU": 2.0}])
    assert launch == {}


def test_scheduler_min_workers():
    cfg = _config()
    cfg.node_types["cpu4"].min_workers = 2
    launch = get_nodes_to_launch(cfg, existing_by_type={}, node_available=[],
                                 demands=[])
    assert launch == {"cpu4": 2}


def test_scheduler_max_workers_cap():
    cfg = _config(upscaling_speed=100.0)
    launch = get_nodes_to_launch(
        cfg, existing_by_type={"cpu4": 5}, node_available=[],
        demands=[{"CPU": 4.0}] * 10)
    assert launch.get("cpu4", 0) == 0  # at max; the big type takes them
    assert launch.get("cpu16", 0) <= 2


def test_scheduler_big_shape_picks_big_type():
    launch = get_nodes_to_launch(
        _config(), existing_by_type={}, node_available=[],
        demands=[{"CPU": 12.0}])
    assert launch == {"cpu16": 1}


def test_scale_down_idle_above_min():
    cfg = _config(idle_timeout_s=5.0)
    cfg.node_types["cpu4"].min_workers = 1
    nodes = [
        {"node_type": "cpu4", "idle_s": 100.0, "used": False},
        {"node_type": "cpu4", "idle_s": 100.0, "used": False},
        {"node_type": "cpu4", "idle_s": 0.0, "used": True},
    ]
    victims = get_nodes_to_terminate(cfg, nodes)
    assert len(victims) == 2  # 3 nodes, min 1... but only 2 idle
    cfg.node_types["cpu4"].min_workers = 2
    victims = get_nodes_to_terminate(cfg, nodes)
    assert len(victims) == 1


def test_scheduler_selector_demand_needs_matching_type():
    types = {
        "plain": NodeTypeConfig("plain", {"CPU": 8.0}, max_workers=5),
        "gpu": NodeTypeConfig("gpu", {"CPU": 8.0, "GPU": 1.0},
                              labels={"accelerator": "h100"}, max_workers=5),
    }
    cfg = ClusterConfig(node_types=types)
    # plenty of free CPU on an unlabeled node, but the selector targets h100
    launch = get_nodes_to_launch(
        cfg, existing_by_type={"plain": 1},
        node_available=[{"available": {"CPU": 8.0}, "labels": {}}],
        demands=[{"shape": {"CPU": 1.0},
                  "selector": {"accelerator": "h100"}}])
    assert launch == {"gpu": 1}


def test_slice_type_scales_as_gang():
    types = {"v5e-16": NodeTypeConfig(
        "v5e-16", {"CPU": 8.0, "TPU": 4.0}, hosts_per_slice=4, max_workers=2)}
    cfg = ClusterConfig(node_types=types, upscaling_speed=100.0)
    launch = get_nodes_to_launch(
        cfg, existing_by_type={}, node_available=[],
        demands=[{"TPU": 4.0}])
    assert launch == {"v5e-16": 1}  # one slice = 4 hosts


# ---------------------------------------------------------------------------
# the same decisions as the JAX package's scheduler
# ---------------------------------------------------------------------------

_KINDS = ("CPU", "GPU", "TPU", "BIG")
_LABELS = ({}, {"accelerator": "h100"}, {"accelerator": "v5e"},
           {"zone": "a"})


def _shape(rng, kinds):
    picked = rng.choice(kinds, size=min(len(kinds), int(rng.integers(1, 3))),
                        replace=False)
    return {str(k): float(rng.choice([0.5, 1.0, 2.0, 3.0, 4.0, 8.0]))
            for k in picked}


def _draw(rng) -> dict:
    """One scheduling situation as plain data: a config dict (the cluster
    YAML's shape), existing counts, free views, demands, strict-spread
    groups and idle views."""
    n_types = int(rng.integers(1, 5))
    types = {}
    for i in range(n_types):
        types[f"t{i}"] = {
            "resources": _shape(rng, _KINDS[:int(rng.integers(1, 5))]),
            "labels": dict(_LABELS[int(rng.integers(len(_LABELS)))]),
            "min_workers": int(rng.integers(0, 3)),
            "max_workers": int(rng.integers(1, 6)),
            "hosts_per_slice": int(rng.choice([1, 1, 1, 2, 4])),
        }
    config = {"available_node_types": types,
              "idle_timeout_s": float(rng.choice([0.0, 5.0, 60.0])),
              "upscaling_speed": float(rng.choice([0.5, 1.0, 2.0, 100.0])),
              "max_total_nodes": int(rng.integers(1, 30))}
    existing = {name: int(rng.integers(0, 4)) for name in types
                if rng.random() < 0.6}
    free = []
    for _ in range(int(rng.integers(0, 4))):
        avail = _shape(rng, _KINDS)
        if rng.random() < 0.5:
            free.append(avail)
        else:
            free.append({"available": avail,
                         "labels": dict(_LABELS[int(rng.integers(4))])})
    demands = []
    for _ in range(int(rng.integers(0, 12))):
        shape = _shape(rng, _KINDS)
        if rng.random() < 0.5:
            demands.append(shape)
        else:
            demands.append({"shape": shape, "selector": dict(
                _LABELS[int(rng.integers(len(_LABELS)))])})
    spread = [[_shape(rng, _KINDS[:2]) for _ in range(int(rng.integers(1, 5)))]
              for _ in range(int(rng.integers(0, 3)))]
    views = []
    for _ in range(int(rng.integers(0, 10))):
        views.append({"node_type": f"t{int(rng.integers(n_types + 1))}",
                      "idle_s": float(rng.choice([0.0, 3.0, 10.0, 100.0])),
                      "used": bool(rng.random() < 0.3),
                      "slice_name": f"s{int(rng.integers(3))}"})
    return {"config": config, "existing": existing, "free": free,
            "demands": demands, "spread": spread, "views": views}


def _decide(pkg, situation):
    config = pkg.ClusterConfig.from_dict(copy.deepcopy(situation["config"]))
    launch = pkg.get_nodes_to_launch(
        config, copy.deepcopy(situation["existing"]),
        copy.deepcopy(situation["free"]), copy.deepcopy(situation["demands"]),
        copy.deepcopy(situation["spread"]))
    views = copy.deepcopy(situation["views"])
    victims = pkg.get_nodes_to_terminate(config, views)
    return (dataclasses.asdict(config), launch,
            [next(i for i, v in enumerate(views) if v is victim)
             for victim in victims])


class _Package:
    def __init__(self, config_mod, scheduler_mod):
        self.ClusterConfig = config_mod.ClusterConfig
        self.get_nodes_to_launch = scheduler_mod.get_nodes_to_launch
        self.get_nodes_to_terminate = scheduler_mod.get_nodes_to_terminate


@pytest.mark.parametrize("seed", range(8))
def test_scheduler_decisions_equal_the_jax_package(seed):
    from ray_tpu.autoscaler import config as jconfig
    from ray_tpu.autoscaler import resource_demand_scheduler as jsched
    from ray_tpu_torch.autoscaler import config as tconfig
    from ray_tpu_torch.autoscaler import resource_demand_scheduler as tsched

    jax_pkg, port = _Package(jconfig, jsched), _Package(tconfig, tsched)
    rng = np.random.default_rng(seed)
    launched = terminated = 0
    for _ in range(40):
        situation = _draw(rng)
        want = _decide(jax_pkg, situation)
        got = _decide(port, situation)
        assert got == want, situation
        launched += bool(want[1])
        terminated += bool(want[2])
    # the draws reach both decisions, not only empty ones
    assert launched and terminated


# ---------------------------------------------------------------------------
# end-to-end against a live cluster + fake provider
# ---------------------------------------------------------------------------


@pytest.fixture
def scaling_cluster():
    ray_tpu_torch.shutdown()
    cluster = Cluster(head_node_args={"resources": {"CPU": 1.0}})
    ray_tpu_torch.init(address=cluster.address, device="cpu")
    yield cluster
    ray_tpu_torch.shutdown()
    cluster.shutdown()


def test_autoscaler_scales_up_for_pending_task(scaling_cluster):
    provider = FakeMultiNodeProvider(scaling_cluster)
    config = ClusterConfig(node_types={
        "worker": NodeTypeConfig("worker", {"CPU": 4.0, "BIG": 1.0},
                                 max_workers=3),
    })
    scaler = Autoscaler(config, provider, scaling_cluster.address)

    @ray_tpu_torch.remote(resources={"BIG": 1.0}, num_cpus=1)
    def needs_big():
        return "scaled"

    ref = needs_big.remote()  # unplaceable: no BIG anywhere
    time.sleep(1.0)  # let the demand register in the GCS

    deadline = time.monotonic() + 60
    launched = False
    while time.monotonic() < deadline:
        status = scaler.step()
        if status["launched"]:
            launched = True
            break
        time.sleep(0.5)
    assert launched, "autoscaler never launched a node for pending demand"
    assert ray_tpu_torch.get(ref, timeout=120) == "scaled"


def test_autoscaler_scales_up_for_pending_placement_group(scaling_cluster):
    provider = FakeMultiNodeProvider(scaling_cluster)
    config = ClusterConfig(node_types={
        "worker": NodeTypeConfig("worker", {"CPU": 4.0}, max_workers=3),
    }, upscaling_speed=100.0)
    scaler = Autoscaler(config, provider, scaling_cluster.address)
    scaler.start(interval_s=0.5)
    try:
        from ray_tpu_torch.util.placement_group import placement_group

        pg = placement_group([{"CPU": 3.0}, {"CPU": 3.0}], strategy="SPREAD")
        assert pg.ready(timeout=120)  # needs 2 new nodes
    finally:
        scaler.stop()
    assert len(provider.non_terminated_nodes()) >= 2


def test_autoscaler_scales_down_idle_node(scaling_cluster):
    provider = FakeMultiNodeProvider(scaling_cluster)
    config = ClusterConfig(node_types={
        "worker": NodeTypeConfig("worker", {"CPU": 2.0}, max_workers=3),
    }, idle_timeout_s=2.0)
    scaler = Autoscaler(config, provider, scaling_cluster.address)

    nodes = provider.create_nodes(config.node_types["worker"], 1)
    assert len(nodes) == 1
    scaling_cluster.wait_for_nodes(2)

    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        scaler.step()
        if not provider.non_terminated_nodes():
            break
        time.sleep(0.5)
    assert provider.non_terminated_nodes() == []
    alive = [n for n in ray_tpu_torch.nodes() if n["alive"]]
    assert len(alive) == 1  # only the head remains
