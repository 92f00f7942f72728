"""A mirror of ``tests/test_refcounting_chaos.py`` on the port's runtime
(``ray_tpu_torch``, on the CPU): the same scenarios and assertions.

Borrow-protocol chaos: the owner-initiated watch (reference:
WaitForRefRemoved in reference_counter.cc) must survive transient RPC
failures without freeing live borrows, and must reclaim borrows from dead
borrowers (worker death) instead of pinning objects forever.
"""

import gc
import os
import time

import numpy as np
import pytest

from ray_tpu_torch._private import wire
import ray_tpu_torch


def _store_objects():
    w = ray_tpu_torch._private.worker.global_worker()
    return wire.loads(w._run(w.raylet.call("StoreStats", b"")))["num_objects"]


def _wait_store_below(n, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if _store_objects() <= n:
            return True
        time.sleep(0.25)
    return False


@pytest.fixture
def chaos_cluster():
    """Fresh cluster with driver-side chaos on the borrow-watch probes."""
    ray_tpu_torch.shutdown()
    os.environ["RAY_TPU_TESTING_RPC_FAILURE"] = "WaitBorrowsDone=2:0"
    try:
        ray_tpu_torch.init(num_cpus=4, device="cpu")
        yield ray_tpu_torch
    finally:
        del os.environ["RAY_TPU_TESTING_RPC_FAILURE"]
        ray_tpu_torch.shutdown()


@pytest.fixture
def cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
class Holder:
    def __init__(self):
        self.box = None

    def stash(self, box):
        self.box = box  # keeps the contained ref: becomes a borrower
        return "ok"

    def read(self):
        return float(ray_tpu_torch.get(self.box[0])[0])

    def drop(self):
        self.box = None
        return "dropped"


def test_watch_survives_transient_probe_failures(chaos_cluster):
    """The first two WaitBorrowsDone probes fail (injected); the owner must
    NOT treat the borrower as dead and free a live borrow."""
    h = Holder.remote()
    ref = ray_tpu_torch.put(np.full(300_000, 5.0))
    assert ray_tpu_torch.get(h.stash.remote([ref]), timeout=60) == "ok"
    del ref
    gc.collect()
    time.sleep(6.0)  # grace + both injected probe failures elapse
    assert ray_tpu_torch.get(h.read.remote(), timeout=60) == 5.0
    # and release still frees once the borrower drops it
    before = _store_objects()
    assert ray_tpu_torch.get(h.drop.remote(), timeout=60) == "dropped"
    assert _wait_store_below(before - 1, timeout=60.0), (
        "object not freed after borrower release (watch wedged by chaos?)")


def test_dead_borrower_reclaimed(cluster):
    """A killed borrower must not pin the object forever: the owner's watch
    detects unreachability and reclaims the borrow."""
    h = Holder.remote()
    before = _store_objects()
    ref = ray_tpu_torch.put(np.full(300_000, 8.0))
    assert ray_tpu_torch.get(h.stash.remote([ref]), timeout=60) == "ok"
    time.sleep(1.0)  # let the borrow register
    del ref
    gc.collect()
    time.sleep(2.0)  # owner-zero + grace pass; borrow alone pins it
    assert _store_objects() >= before + 1
    from ray_tpu_torch._private.config import RAY_CONFIG

    old = RAY_CONFIG.borrower_death_timeout_s
    RAY_CONFIG.borrower_death_timeout_s = 10.0  # keep the test fast
    try:
        ray_tpu_torch.kill(h)  # borrower dies holding the borrow
        assert _wait_store_below(before, timeout=90.0), (
            "dead borrower still pins the object (watch did not reclaim)")
    finally:
        RAY_CONFIG.borrower_death_timeout_s = old
